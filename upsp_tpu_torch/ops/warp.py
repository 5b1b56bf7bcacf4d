"""Affine-warp helpers of the phase-1 frame program.

Port of ``upsp_tpu/ops/warp.py``.  The order-2 warp itself
(``warp_affine_mxu`` semantics) is kernel K2,
``ops/ecc_kernels.warp_affine_banded``: the JAX package resamples with
tent-matrix matmuls because the TPU has no fast gather, the port samples
the two tent taps per axis directly.  This module holds the validity mask,
the integer pre-shift and the pyramid helpers (``downsample2``,
``scale_warp``), plain PyTorch as XLA ran them.
"""

from __future__ import annotations

from typing import Tuple

import torch

MAX_INTEGER_SHIFT = 64  # px; see integer_shift


def warp_validity_mask(shape_hw: Tuple[int, int], warps: torch.Tensor):
    """(B, H, W) float mask: 1 where the separable sample is in bounds."""
    h, w = shape_hw
    dev = warps.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    cy = (h - 1) * 0.5
    cx = (w - 1) * 0.5
    y_sep = (
        warps[:, 1, 1, None] * ys + warps[:, 1, 2, None]
        + warps[:, 1, 0, None] * cx
    )
    x_sep = (
        warps[:, 0, 0, None] * xs + warps[:, 0, 2, None]
        + warps[:, 0, 1, None] * cy
    )
    my = ((y_sep >= 0.0) & (y_sep <= h - 1.0)).to(torch.float32)
    mx = ((x_sep >= 0.0) & (x_sep <= w - 1.0)).to(torch.float32)
    return my[:, :, None] * mx[:, None, :]


def integer_shift(imgs: torch.Tensor, t_int: torch.Tensor,
                  max_shift: int = MAX_INTEGER_SHIFT) -> torch.Tensor:
    """Zero-filled integer translation per image:
    out[b, y, x] = img[b, y + ty_b, x + tx_b], zero where that leaves the
    image.  ``t_int`` is (B, 2) [tx, ty], integer-valued; shifts beyond
    ``max_shift`` clamp, as in the JAX package (callers clamp their shift
    record the same way)."""
    b, h, w = imgs.shape
    t = t_int.to(torch.int64).clamp(-max_shift, max_shift)
    dev = imgs.device
    ys = torch.arange(h, device=dev)[None, :] + t[:, 1:2]  # (B, H)
    xs = torch.arange(w, device=dev)[None, :] + t[:, 0:1]  # (B, W)
    rows = imgs.gather(1, ys.clamp(0, h - 1)[:, :, None].expand(b, h, w))
    out = rows.gather(2, xs.clamp(0, w - 1)[:, None, :].expand(b, h, w))
    valid = ((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :]
    return torch.where(valid, out, torch.zeros_like(out))


def downsample2(imgs: torch.Tensor) -> torch.Tensor:
    """2x box decimation of the last two axes (a pyramid level): the mean
    of each 2x2 block, an odd last row or column dropped."""
    h, w = imgs.shape[-2:]
    h2, w2 = h // 2, w // 2
    x = imgs[..., : h2 * 2, : w2 * 2]
    return x.reshape(x.shape[:-2] + (h2, 2, w2, 2)).mean(dim=(-3, -1))


def scale_warp(warps: torch.Tensor, factor: float) -> torch.Tensor:
    """(..., 2, 3) warps between pyramid levels: the translation scales by
    ``factor``, the linear part does not."""
    return torch.cat([warps[..., :2], warps[..., 2:] * factor], dim=-1)
