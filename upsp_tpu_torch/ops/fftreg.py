"""FFT phase-correlation translation estimate (the ECC initialisation).

Port of ``upsp_tpu/ops/fftreg.py`` on ``torch.fft``, batched over frames:
decimate by average pooling, centre-crop to powers of two, Hann window,
cross-power spectrum, Gaussian prior on the wrapped displacement, argmax
and a 3-point parabolic sub-pixel fit per axis.

| wrapper | kernel | replaces |
| --- | --- | --- |
| :func:`decimate_image` | K10 ``pool_kernel<T, K>`` (csrc/fftreg.cu) | the XLA dot of ``upsp_tpu/ops/fftreg.py:74`` (no Pallas kernel) |

The pooling is a fixed-order block mean instead of the JAX package's
dense ``P_h @ img @ P_w^T``: on the card cuBLAS folds the batch into such
a GEMM and picks its algorithm by the batch size, so a frame's pooled
image (and the ECC start it seeds) depended on its batch.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from upsp_tpu_torch.ops.cuda_lib import (
    CudaLibrary,
    check_rc,
    count_launch,
    register_kernels,
    stream_of,
)


def default_decimate(h: int, w: int) -> int:
    """Largest power of two keeping the pooled image at least 256 px."""
    k = 1
    while min(h, w) // (2 * k) >= 256:
        k *= 2
    return k


KERNELS = register_kernels(("pool", "pool_bf16"))


def _bind(lib: ctypes.CDLL) -> None:
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("upsp_fftreg_pool", "upsp_fftreg_pool_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, i, i, i, q, q, i, ctypes.c_float, p]
        fn.restype = i


LIBRARY = CudaLibrary("fftreg", _bind)
MAX_POOLED_ROWS = 65535  # K10's grid rows


def _inv(k: int) -> float:
    """1/k rounded to float32, as the JAX package's pooling matrices hold
    it (a Python float of that value: torch rounds it to f32 exactly)."""
    return float(np.float32(1.0 / k))


def decimate_plain(img: torch.Tensor, k: int) -> torch.Tensor:
    """K10's plain twin: the k x k block mean of (..., H, W) float32 or
    bfloat16 frames, cropped to a multiple of k, in float32.  Summed in a
    fixed order from strided slices and elementwise products and sums
    only: for each source column of a block its k rows in order, each
    times 1/k, then the k column sums in order, each times 1/k -- the
    order of the JAX package's ``P_h @ img @ P_w^T`` on the CPU.  Every
    pooled pixel is the same scalar sequence whatever the batch."""
    h, w = img.shape[-2:]
    x = img[..., : (h // k) * k, : (w // k) * k]
    inv = _inv(k)

    def term(t):
        return t.to(torch.float32) * inv

    rows = term(x[..., 0::k, :])
    for r in range(1, k):
        rows = rows + term(x[..., r::k, :])
    out = rows[..., 0::k] * inv
    for c in range(1, k):
        out = out + rows[..., c::k] * inv
    return out


def decimate_image(img: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool of (..., H, W) frames, cropped to a multiple of k
    first, in float32 (``upsp_tpu/ops/fftreg.py:decimate_image``).

    K10: on a CUDA tensor of float32 or bfloat16 frames it launches
    ``pool_kernel`` (csrc/fftreg.cu), which reads the frames where they
    lie (a camera's slice of a chunk or a crop: strided rows, contiguous
    pixels) and widens bf16 on load; on a CPU tensor it runs
    :func:`decimate_plain`.  Both sum in one fixed order, so a frame's
    pooled image does not depend on its batch.  Other dtypes are cast to
    float32 first, as the JAX package casts them.  (In the JAX package's
    dense products one non-finite pixel makes every pooled pixel NaN
    through the zero products; here it stays in its block.)"""
    if img.dtype not in (torch.float32, torch.bfloat16):
        img = img.to(torch.float32)
    if k == 1:
        return img.to(torch.float32)
    if img.device.type == "cpu":
        return decimate_plain(img, k)
    if img.device.type != "cuda":
        raise ValueError(f"pool: unsupported device {img.device}")
    h, w = img.shape[-2:]
    ho, wo = h // k, w // k
    if ho > MAX_POOLED_ROWS:
        raise ValueError(f"pool: {ho} pooled rows exceed the kernel's {MAX_POOLED_ROWS}")
    lead = img.shape[:-2]
    out = torch.empty(lead + (ho, wo), dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    x = img.reshape(-1, h, w)  # a view where the leading dims allow one
    if x.stride(2) != 1:
        x = x.contiguous()
    kname = "pool" if x.dtype == torch.float32 else "pool_bf16"
    rc = getattr(LIBRARY.lib(), f"upsp_fftreg_{kname}")(
        x.data_ptr(), out.data_ptr(), x.shape[0], ho, wo, x.stride(0), x.stride(1),
        k, _inv(k), stream_of(x))
    check_rc(rc, kname)
    count_launch(kname)
    return out


FFT_GROUP = 8  # frames a call of torch.fft transforms in correlate


def _in_groups(fft, x: torch.Tensor) -> torch.Tensor:
    """``fft`` over the last two axes of (..., h, w) ``x`` in calls of
    exactly FFT_GROUP frames, the last call's group filled up with zero
    frames.  cuFFT picks its algorithm by the batch size, so one call over
    the whole batch would make a frame's transform depend on its batch; in
    a group of a fixed size it is the same wherever the frame lies (the
    frame program's batch of 8 is one call, as before)."""
    lead = x.shape[:-2]
    flat = x.reshape((-1,) + tuple(x.shape[-2:]))
    n = flat.shape[0]
    pad = -n % FFT_GROUP
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,) + tuple(flat.shape[1:]))])
    groups = [fft(g) for g in flat.split(FFT_GROUP)]
    out = groups[0] if len(groups) == 1 else torch.cat(groups)
    return out[:n].reshape(lead + tuple(out.shape[-2:]))


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
    small = pow2_center_crop(decimate_image(ref, decimate))
    h, w = small.shape
    win = (_hann(h, ref.device)[:, None] * _hann(w, ref.device)[None, :] if window
           else torch.ones((h, w), dtype=torch.float32, device=ref.device))
    prior = _displacement_prior(h, w, prior_sigma_px / decimate, ref.device)
    return CorrelationTemplate(
        spectrum=torch.fft.rfft2(small * win), window=win, decimate=decimate,
        hw=(h, w), prior=prior,
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
    small = pow2_center_crop(decimate_image(imgs, tmpl.decimate))
    img_f = _in_groups(torch.fft.rfft2, small * tmpl.window)
    cross = tmpl.spectrum * torch.conj(img_f)
    cross = cross / (cross.abs() + 1e-8)
    surf = _in_groups(lambda c: torch.fft.irfft2(c, s=(h, w)), cross) * tmpl.prior
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
