"""Sub-pixel target localization: batched super-Gaussian Levenberg–Marquardt.

Port of ``upsp_tpu/ops/localization.py`` (parity with the reference's
gaussian_localization_methods.py:17-436, which fits one target at a time
with scipy.curve_fit).  Every target fits at once: fixed-size crops are
gathered into a (T, K, K) batch and a fixed 40-step LM loop runs on the
whole batch, Jacobians from ``torch.func.jacfwd`` under ``torch.func.vmap``,
each target's accept or reject by ``torch.where``, so the loop makes no
host sync.  f32 throughout, as in the JAX package (even under x64).

Bounds go through the reference's "nobounds" reparameterisation (log
amplitude / log sigma / p = exp(lnp) + 1).  Model, on the NEGATED image so
dark dots become peaks:
  g(x, y) = A * exp(-(a dx^2 + 2 b dx dy + c dy^2)^p) + offset
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

SUPER_GAUSS_POWER_UPPER_BOUND = 20.0

# parameter vector: [ln_amp, xo, yo, ln_sx, ln_sy, theta, offset, ln_p]
N_PARAMS = 8


def super_gaussian(params: torch.Tensor, xg: torch.Tensor,
                   yg: torch.Tensor) -> torch.Tensor:
    """Evaluate the super 2D Gaussian on a pixel grid (reparameterised)."""
    amp = torch.exp(params[0])
    xo, yo = params[1], params[2]
    sx = torch.exp(params[3])
    sy = torch.exp(params[4])
    theta = params[5]
    offset = params[6]
    p = torch.exp(params[7]) + 1.0

    dx = xg - xo
    dy = yg - yo
    cos_sq = torch.cos(theta) ** 2
    sin_sq = torch.sin(theta) ** 2
    sin2 = torch.sin(2.0 * theta)
    a = cos_sq / (2 * sx * sx) + sin_sq / (2 * sy * sy)
    b = -sin2 / (4 * sx * sx) + sin2 / (4 * sy * sy)
    c = sin_sq / (2 * sx * sx) + cos_sq / (2 * sy * sy)
    quad = a * dx * dx + 2 * b * dx * dy + c * dy * dy
    # clamp the base so quad**p stays finite under jacfwd at quad -> 0
    quad = torch.clamp_min(quad, 1e-12)
    return amp * torch.exp(-torch.pow(quad, p)) + offset


def _residuals(params, patch, xg, yg, mask):
    return ((super_gaussian(params, xg, yg) - patch) * mask).reshape(-1)


def _grid(K: int, device):
    r = torch.arange(K, dtype=torch.float32, device=device)
    yg, xg = torch.meshgrid(r, r, indexing="ij")
    return xg, yg


def fit_super_gaussian(
    patch: torch.Tensor,  # (T, K, K) or (K, K) negated crops (peak positive)
    init: torch.Tensor,  # (T, 8) or (8,) initial parameter vectors
    mask: torch.Tensor,  # (T, K, K) or (K, K) valid-pixel weights
    n_iters: int = 40,
):
    """Levenberg–Marquardt fit of each crop; returns (params, rms), batched
    over the leading axis when there is one (``upsp_tpu/ops/localization.py
    :61-102`` per crop)."""
    if patch.dim() == 2:
        p, rms = fit_super_gaussian(patch[None], init[None], mask[None], n_iters)
        return p[0], rms[0]
    xg, yg = _grid(patch.shape[-1], patch.device)

    def r_fn(p, pt, m):
        return _residuals(p, pt, xg, yg, m)

    res = torch.func.vmap(r_fn)
    jac = torch.func.vmap(torch.func.jacfwd(r_fn))
    params = init
    lam = torch.full(init.shape[:1], 1e-2, dtype=torch.float32, device=init.device)
    for _ in range(n_iters):
        r = res(params, patch, mask)
        J = jac(params, patch, mask)  # (T, K*K, 8)
        JTJ = J.transpose(1, 2) @ J
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        diag = torch.clamp_min(torch.diagonal(JTJ, dim1=1, dim2=2), 1e-8)
        A = JTJ + lam[:, None, None] * torch.diag_embed(diag)
        dp = torch.linalg.solve_ex(A, g)[0]
        new_params = params - dp
        new_r = res(new_params, patch, mask)
        improved = (new_r * new_r).sum(1) < (r * r).sum(1)
        params = torch.where(improved[:, None], new_params, params)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-7, 1e7)
    r = res(params, patch, mask)
    denom = torch.clamp_min(mask.sum((1, 2)), 1.0)
    return params, torch.sqrt((r * r).sum(1) / denom)


def default_init(patch: torch.Tensor, center_xy: torch.Tensor,
                 target_type_code: torch.Tensor) -> torch.Tensor:
    """Reference initial guess: amp = max-mean, offset = mean, sizes by type,
    batched over (T, K, K) patches.

    type codes: 0 = dot (size 1.2, p 3.2), 1 = kulite (size 0.8, p 1.8),
    2 = unknown (size 0.75, p 2.6).
    """
    flat = patch.reshape(patch.shape[0], -1)
    mean = flat.mean(1)
    amp0 = torch.clamp_min(flat.amax(1) - mean, 1e-3)
    dot, kulite = target_type_code == 0, target_type_code == 1

    def select(a, b, c):
        return torch.where(dot, a, torch.where(kulite, b, c)).to(torch.float32)

    size = select(1.2, 0.8, 0.75)
    p0 = select(3.2, 1.8, 2.6)
    return torch.stack([
        torch.log(amp0), center_xy[:, 0], center_xy[:, 1], torch.log(size),
        torch.log(size), torch.zeros_like(mean), mean, torch.log(p0 - 1.0),
    ], dim=1)


class LocalizeResult(NamedTuple):
    centers: torch.Tensor  # (T, 2) refined positions (full-image coords)
    valid: torch.Tensor  # (T,) bool — fit accepted
    rms: torch.Tensor  # (T,)


def localize_targets(
    img: torch.Tensor,  # (H, W)
    centers: torch.Tensor,  # (T, 2) float initial positions (x, y)
    type_codes: torch.Tensor,  # (T,) int 0=dot 1=kulite 2=other
    pads: torch.Tensor,  # (T,) int per-target pad radius
    crop_size: int = 11,
    max_localize_delta: Optional[torch.Tensor] = None,  # (T,) or None -> pad-2
    n_iters: int = 40,
) -> LocalizeResult:
    """Batched sub-pixel localization of all targets in one image, on the
    image's device.

    Filtering parity with subpixel_localize (target_detection.py:18-180):
    out-of-bounds crops rejected; fits that move the center more than
    max_localize_delta (default pad-2) rejected.  A crop's start is clamped
    to [0, H-K] x [0, W-K], as ``lax.dynamic_slice`` clamps it.
    """
    H, W = img.shape
    dev = img.device
    imgf = -img.to(torch.float32)  # dark dots -> peaks
    centers = centers.to(dev)
    pads = pads.to(dev)
    type_codes = type_codes.to(dev)

    center_px = torch.round(centers).to(torch.int64)  # (T, 2) x, y
    half = crop_size // 2
    x0 = center_px[:, 0] - half
    y0 = center_px[:, 1] - half

    # bbox validity uses the per-target pad (reference semantics)
    in_bounds = (
        (center_px[:, 0] - pads >= 0)
        & (center_px[:, 1] - pads >= 0)
        & (center_px[:, 0] + pads + 1 < W)
        & (center_px[:, 1] + pads + 1 < H)
    )

    k = torch.arange(crop_size, device=dev)
    ys = y0.clamp(0, H - crop_size)[:, None] + k[None, :]
    xs = x0.clamp(0, W - crop_size)[:, None] + k[None, :]
    patches = imgf[ys[:, :, None], xs[:, None, :]]  # (T, K, K)

    # mask off pixels beyond each target's own pad radius (square mask)
    off = (k - half).abs()
    sq_mask = (
        (off[None, None, :] <= pads[:, None, None])
        & (off[None, :, None] <= pads[:, None, None])
    ).to(torch.float32)

    x0y0 = torch.stack([x0, y0], dim=1)
    local_init_xy = centers - x0y0.to(centers.dtype)
    inits = default_init(patches, local_init_xy.to(torch.float32), type_codes)
    params, rms = fit_super_gaussian(patches, inits, sq_mask, n_iters=n_iters)

    local_xy = params[:, 1:3]
    refined = local_xy + x0y0.to(torch.float32)

    if max_localize_delta is None:
        max_delta = (pads - 2).to(torch.float32)
    else:
        max_delta = max_localize_delta.to(dev)
    moved = torch.linalg.norm(refined - centers.to(torch.float32), dim=1)
    # also reject fits whose center left the crop
    inside_crop = (
        (local_xy[:, 0] >= 0)
        & (local_xy[:, 0] <= crop_size - 1)
        & (local_xy[:, 1] >= 0)
        & (local_xy[:, 1] <= crop_size - 1)
    )
    valid = in_bounds & inside_crop & (moved <= torch.clamp_min(max_delta, 0.5))
    return LocalizeResult(centers=refined, valid=valid, rms=rms)


TYPE_CODES = {"dot": 0, "kulite": 1}


def type_code(target_type: str) -> int:
    return TYPE_CODES.get(target_type, 2)
