"""Per-frame ECC affine registration, fixed-iteration kernel form.

Port of ``upsp_tpu/ops/registration.py`` (``ecc_affine`` / ``_ecc_core``)
in the form the JAX package runs on its kernel path (``body_pallas``,
:298-343): a fixed number of Gauss-Newton steps, each one K2 warp and one
K3 statistics pass, then the 6x6 solve by an unrolled Cholesky.  Batched
over frames: one template, (B, H, W) inputs, (B, 2, 3) warps.

Conventions (as the reference): the warp maps template pixel coordinates
to input coordinates, ``out(x) = input(W @ [x, y, 1])``; the pre-blur is a
ksize-5 Gaussian (K1); with ``valid_shift`` (the fft integer pre-shift) the
statistics are masked by the composed warp.  If either image is bfloat16,
template and image are blurred and warped in bfloat16 (the JAX
``_ecc_core`` rule, registration.py:259-269); warps, statistics and the
solve stay f32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from upsp_tpu_torch.ops.ecc_kernels import (
    MAX_TAPS,
    blur,
    ecc_gn_moments,
    ecc_statistics_from_moments,
    template_shift,
    warp_affine_banded,
)
from upsp_tpu_torch.ops.image import gaussian_blur, gaussian_kernel_1d


def identity_warp(batch: int = 1, device=None) -> torch.Tensor:
    """(batch, 2, 3) identity warps."""
    eye = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=device)
    return eye.expand(batch, 2, 3).contiguous()


def chol_factor_unrolled(hmat: torch.Tensor, n: int = 6) -> List[List]:
    """Unrolled Cholesky of a batch of small SPD matrices (B, n, n);
    returns L as nested lists of (B,) tensors (pivots clamped at 1e-30)."""
    L: List[List[Optional[torch.Tensor]]] = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = hmat[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s.clamp_min(1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def chol_solve_unrolled(L, b: torch.Tensor, n: int = 6) -> torch.Tensor:
    """Solve (L L^T) x = b for (B, n) right-hand sides."""
    y: List[Optional[torch.Tensor]] = [None] * n
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x: List[Optional[torch.Tensor]] = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=1)


def ecc_blur(imgs: torch.Tensor, gauss_size: int = 5) -> torch.Tensor:
    """The ECC pre-blur of (B, H, W) float32 or bfloat16 images, same dtype
    out: kernel K1 up to 7 taps, the plain Gaussian beyond (as the JAX
    package falls back to XLA)."""
    if gauss_size <= MAX_TAPS:
        taps = tuple(float(t) for t in gaussian_kernel_1d(gauss_size))
        return blur(imgs.contiguous(), taps)
    return gaussian_blur(imgs, gauss_size).contiguous()


def _gn_step(img, tmpl, kshift, warp, rho_prev, valid_shift):
    """One Gauss-Newton step (``body_pallas``): K2 warp, K3 statistics
    (``kshift``: the template's brightness shift), closed-form ECC
    update.  K2 then K3, not K9 (``ecc_gn_fused``, the same statistics in
    one kernel): on the H100 K9 is the faster of the two at 1024x1024 but
    not at the full configuration's 1200x1800 (PERF.md section 6)."""
    iw = warp_affine_banded(img, warp)
    if valid_shift is None:
        mask_warp = warp
    else:
        mask_warp = torch.cat(
            [warp[:, :, :2], (warp[:, :, 2] + valid_shift)[:, :, None]], dim=2
        ).contiguous()
    return _gn_update(ecc_gn_moments(iw, tmpl, warp, mask_warp, kshift), warp,
                      rho_prev)


def _gn_update(mom, warp, rho_prev):
    """The closed-form ECC update from a step's (B, 128) statistics: (new
    warps, rho, |rho - rho_prev|)."""
    hmat, i_proj, t_proj, iw_norm2, corr, tmpl_norm, _ = (
        ecc_statistics_from_moments(mom)
    )
    eye = torch.eye(6, dtype=hmat.dtype, device=hmat.device)
    trace = hmat.diagonal(dim1=1, dim2=2).sum(dim=1)
    reg = 1e-9 * trace / 6.0 + 1e-12
    lc = chol_factor_unrolled(hmat + reg[:, None, None] * eye)
    hinv_i = chol_solve_unrolled(lc, i_proj)
    hinv_t = chol_solve_unrolled(lc, t_proj)
    num = iw_norm2 - (i_proj * hinv_i).sum(dim=1)
    den = corr - (t_proj * hinv_i).sum(dim=1)
    den = torch.where(den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
    lam = num / den
    dp = lam[:, None] * hinv_t - hinv_i
    dwarp = torch.stack(
        [dp[:, [0, 2, 4]], dp[:, [1, 3, 5]]], dim=1
    )  # [[a00 a01 tx], [a10 a11 ty]] increments
    new_warp = warp + dwarp
    new_warp = torch.where(torch.isfinite(new_warp), new_warp, warp).contiguous()
    rho = corr / (tmpl_norm * torch.sqrt(iw_norm2.clamp_min(0.0))).clamp_min(1e-12)
    rho = torch.where(torch.isfinite(rho), rho, torch.full_like(rho, -1.0))
    return new_warp, rho, (rho - rho_prev).abs()


def ecc_affine(
    ref: torch.Tensor,
    inp: torch.Tensor,
    warp_init: Optional[torch.Tensor] = None,
    max_iters: int = 2,
    gauss_size: int = 5,
    valid_shift: Optional[torch.Tensor] = None,
    tmpl_blurred: Optional[torch.Tensor] = None,
    tmpl_shift: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Align (B, H, W) ``inp`` to the (H, W) template ``ref`` by a fixed
    number of ECC Gauss-Newton steps.

    Returns (warps (B, 2, 3), rho (B,), drho (B,)): ``drho`` is the final
    |rho - rho_prev|, the convergence signal of the fixed-iteration form.
    ``tmpl_blurred`` passes a template already blurred by :func:`ecc_blur`
    in the images' dtype (the chunk processor blurs each camera's template
    once), and ``tmpl_shift`` its :func:`template_shift` (computed here
    when None).
    """
    b = inp.shape[0]
    dev = inp.device
    im_dtype = (
        torch.bfloat16
        if torch.bfloat16 in (ref.dtype, inp.dtype) else torch.float32
    )
    tmpl = (
        tmpl_blurred if tmpl_blurred is not None
        else ecc_blur(ref.to(im_dtype)[None], gauss_size)[0]
    ).contiguous()
    kshift = template_shift(tmpl) if tmpl_shift is None else tmpl_shift
    img = ecc_blur(inp.to(im_dtype), gauss_size)
    warp = (
        identity_warp(b, dev) if warp_init is None
        else warp_init.to(torch.float32).contiguous()
    )
    if valid_shift is not None:
        valid_shift = valid_shift.to(torch.float32)
    rho = torch.full((b,), -1.0, device=dev)
    drho = torch.full((b,), float("inf"), device=dev)
    for _ in range(max_iters):
        warp, rho, drho = _gn_step(img, tmpl, kshift, warp, rho, valid_shift)
    return warp, rho, drho
