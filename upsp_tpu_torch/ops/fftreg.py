"""FFT phase-correlation translation estimate (the ECC initialisation).

Port of ``upsp_tpu/ops/fftreg.py`` on ``torch.fft``, batched over frames:
decimate by average pooling, centre-crop to powers of two, Hann window,
cross-power spectrum, Gaussian prior on the wrapped displacement, argmax
and a 3-point parabolic sub-pixel fit per axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


def default_decimate(h: int, w: int) -> int:
    """Largest power of two keeping the pooled image at least 256 px."""
    k = 1
    while min(h, w) // (2 * k) >= 256:
        k *= 2
    return k


def _pool_matrix(n: int, k: int, device) -> torch.Tensor:
    """(n//k, n) average-pooling matrix: row i averages source block i."""
    m = n // k
    rows = torch.arange(m, device=device)[:, None]
    cols = torch.arange(n, device=device)[None, :]
    one = torch.tensor(1.0 / k, dtype=torch.float32, device=device)
    return torch.where(cols // k == rows, one, torch.zeros_like(one))


def pool_matrices(h: int, w: int, k: int, device):
    """(P_h, P_w^T) of :func:`decimate_image` for (h, w) images; None when
    k == 1."""
    if k == 1:
        return None
    return (_pool_matrix((h // k) * k, k, device),
            _pool_matrix((w // k) * k, k, device).T)


def decimate_image(img: torch.Tensor, k: int, pools=None) -> torch.Tensor:
    """k x k average pool of (..., H, W), cropped to a multiple of k first
    (P_h @ img @ P_w^T, as the JAX package computes it).  ``pools``: the
    :func:`pool_matrices` of this size and device, made here when None."""
    img = img.to(torch.float32)
    if k == 1:
        return img
    h, w = img.shape[-2:]
    if pools is None:
        pools = pool_matrices(h, w, k, img.device)
    p_h, p_wt = pools
    return p_h @ img[..., : p_h.shape[1], : p_wt.shape[0]] @ p_wt


def _pow2_floor(n: int) -> int:
    k = 1
    while k * 2 <= n:
        k *= 2
    return k


def pow2_center_crop(img: torch.Tensor) -> torch.Tensor:
    """Centre-crop the last two axes to the largest powers of two."""
    h, w = img.shape[-2:]
    h2, w2 = _pow2_floor(h), _pow2_floor(w)
    y0, x0 = (h - h2) // 2, (w - w2) // 2
    return img[..., y0 : y0 + h2, x0 : x0 + w2]


def _hann(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def _parabolic(c, l, r):
    """Sub-sample peak offset from (left, centre, right) values."""
    denom = l - 2.0 * c + r
    safe = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    return (0.5 * (l - r) / safe).clamp(-0.5, 0.5)


class CorrelationTemplate(NamedTuple):
    spectrum: torch.Tensor  # (h, w//2+1) complex64
    window: torch.Tensor  # (h, w) float32
    decimate: int
    hw: tuple  # pooled, cropped (h, w)
    prior: torch.Tensor  # (h, w) float32 peak prior
    # decimate_image's (P_h, P_w^T) for the template's size (None if
    # decimate == 1), made once so that correlate copies nothing to the
    # device
    pools: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def _displacement_prior(h: int, w: int, sigma: float, device) -> torch.Tensor:
    """Gaussian prior over the wrapped displacement, centred at zero."""
    ar_h = torch.arange(h, dtype=torch.float32, device=device)
    ar_w = torch.arange(w, dtype=torch.float32, device=device)
    dy = torch.minimum(ar_h, h - ar_h)
    dx = torch.minimum(ar_w, w - ar_w)
    py = torch.exp(-0.5 * (dy / sigma) ** 2)
    px = torch.exp(-0.5 * (dx / sigma) ** 2)
    return py[:, None] * px[None, :]


def prepare_template(ref: torch.Tensor, decimate: int = 1,
                     prior_sigma_px: float = 12.0, window: bool = True
                     ) -> CorrelationTemplate:
    """Template spectrum for :func:`correlate` (prior width in
    full-resolution pixels; ``window``: the Hann window, else none)."""
    pools = pool_matrices(*ref.shape[-2:], decimate, ref.device)
    small = pow2_center_crop(decimate_image(ref, decimate, pools))
    h, w = small.shape
    win = (_hann(h, ref.device)[:, None] * _hann(w, ref.device)[None, :] if window
           else torch.ones((h, w), dtype=torch.float32, device=ref.device))
    prior = _displacement_prior(h, w, prior_sigma_px / decimate, ref.device)
    return CorrelationTemplate(
        spectrum=torch.fft.rfft2(small * win), window=win, decimate=decimate,
        hw=(h, w), prior=prior, pools=pools,
    )


def correlate(tmpl: CorrelationTemplate, imgs: torch.Tensor) -> torch.Tensor:
    """(..., 2) float32 [tx, ty] in full-resolution pixels for (..., H, W)
    frames of the template's size: sampling a frame at (x + tx, y + ty)
    reproduces the template.  A template whose spectrum is stacked, (C, h,
    w//2+1) (the cameras' templates of one size share the window, prior
    and pooling), correlates (B, C, H, W) frames, camera c against its
    own."""
    h, w = tmpl.hw
    lead = imgs.shape[:-2]
    small = pow2_center_crop(decimate_image(imgs, tmpl.decimate, tmpl.pools))
    img_f = torch.fft.rfft2(small * tmpl.window)
    cross = tmpl.spectrum * torch.conj(img_f)
    cross = cross / (cross.abs() + 1e-8)
    surf = torch.fft.irfft2(cross, s=(h, w)) * tmpl.prior  # (..., h, w)
    flat = surf.reshape(-1, h * w)
    idx = torch.argmax(flat, dim=1)
    py = idx // w
    px = idx % w
    ym, yp = (py - 1) % h, (py + 1) % h
    xm, xp = (px - 1) % w, (px + 1) % w

    def at(yy, xx):
        return flat.gather(1, (yy * w + xx)[:, None])[:, 0]

    c = at(py, px)
    oy = _parabolic(c, at(ym, px), at(yp, px))
    ox = _parabolic(c, at(py, xm), at(py, xp))
    fy = py.to(torch.float32) + oy
    fx = px.to(torch.float32) + ox
    dy = torch.where(fy > h / 2, fy - h, fy)
    dx = torch.where(fx > w / 2, fx - w, fx)
    t = (torch.stack([-dx, -dy], dim=1) * tmpl.decimate).to(torch.float32)
    return t.reshape(lead + (2,))


def make_phase_correlator(ref: torch.Tensor, window: bool = True, decimate: int = 1):
    """Bind the template: returns ``fn(img) -> (2,) float32 (tx, ty)``
    (``upsp_tpu/ops/fftreg.py:203-214``).  A convenience for tests and
    host-side use; the chunk program prepares its templates once a chunk
    and calls :func:`correlate` on each batch."""
    tmpl = prepare_template(torch.as_tensor(ref, dtype=torch.float32), decimate,
                            window=window)

    def fn(img: torch.Tensor) -> torch.Tensor:
        return correlate(tmpl, torch.as_tensor(img, dtype=torch.float32))

    return fn


def translation_warp(t: torch.Tensor) -> torch.Tensor:
    """(B, 2) [tx, ty] -> (B, 2, 3) warps [[1, 0, tx], [0, 1, ty]]."""
    b = t.shape[0]
    eye = torch.eye(2, dtype=torch.float32, device=t.device).expand(b, 2, 2)
    return torch.cat([eye, t.reshape(b, 2, 1).to(torch.float32)], dim=2)
