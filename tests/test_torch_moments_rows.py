"""K3's row-factored statistics against the plain twin and the JAX kernel.

``moments_kernel`` (upsp_tpu_torch/csrc/ecc.cu) does not form the 42 GN
statistics pixel by pixel.  Per image row it sums 27 terms that depend on
x alone -- sum f x^2, f x, f for the three Hessian products f = gx gx,
gx gy, gy gy; sum g x, g for the six gradient-times-z products g = gx t,
gy t, gx i, gy i, gx, gy; the six masked sums -- and folds the row's f x,
f and g sums with y and y^2.  Validity under the mask warp is a row test
and a column test, evaluated once each.  ``moments_rows`` below is that
algebra in torch, summed in f64, so the tests check the algebra; the
kernel's f32 rounding is checked against the twin on the card
(tests/test_torch_cuda.py).

Tolerance: 2e-4 relative per statistic group with a floor of 2e-4 of the
group's largest member (f32 fields, other summation order), as
tests/test_torch_ecc_kernels.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from upsp_tpu.ops import pallas_ecc as P
from upsp_tpu_torch.ops import ecc_kernels as K

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_cuda import GROUPS, clipped_mask_warps, images, warps  # noqa: E402

SHAPES = [(2, 96, 128), (2, 97, 131), (2, 90, 131)]


def _mask_axes(h, w, mw):
    """Row and column validity of the separable sample under the mask
    warps, with the rounding of ``warp_validity_mask`` (and the kernel's
    affine_pos): (B, H) and (B, W) bool."""
    ys = torch.arange(h, dtype=torch.float32)
    xs = torch.arange(w, dtype=torch.float32)
    y_sep = mw[:, 1, 1, None] * ys + mw[:, 1, 2, None] + mw[:, 1, 0, None] * ((w - 1) * 0.5)
    x_sep = mw[:, 0, 0, None] * xs + mw[:, 0, 2, None] + mw[:, 0, 1, None] * ((h - 1) * 0.5)
    return (y_sep >= 0) & (y_sep <= h - 1.0), (x_sep >= 0) & (x_sep <= w - 1.0)


def moments_rows(iw, tmpl, warps_t, mask_warps):
    """(B, 128) statistics from 27 per-row x-only sums folded with y, y^2."""
    kshift = K.template_shift(tmpl)
    iw = iw.float()
    b, h, w = iw.shape
    a00, a01, _, a10, a11, _ = (v[:, None, None] for v in warps_t.reshape(-1, 6).unbind(1))
    gix = torch.zeros_like(iw)
    giy = torch.zeros_like(iw)
    gix[:, :, 1:-1] = 0.5 * (iw[:, :, 2:] - iw[:, :, :-2])
    giy[:, 1:-1, :] = 0.5 * (iw[:, 2:, :] - iw[:, :-2, :])
    inv_det = 1.0 / (a00 * a11 - a01 * a10)
    gx = (a11 * gix - a10 * giy) * inv_det
    gy = (-a01 * gix + a00 * giy) * inv_det
    iv = iw - kshift
    tv = (tmpl.float() - kshift).expand(b, h, w)
    rows, cols = _mask_axes(h, w, mask_warps)
    m = (rows[:, :, None] & cols[:, None, :]).double()
    x = torch.arange(w, dtype=torch.float64)
    y = torch.arange(h, dtype=torch.float64)[None, :, None]

    def row_sums(v):  # (B, H, 1): the row's masked sum, as the kernel's
        return (v.double() * m).sum(2, keepdim=True)

    def fold(v):  # (B,): the strip's sum of a row-summed term
        return v.sum(dim=(1, 2))

    out = torch.zeros((b, 128), dtype=torch.float32)
    vals = []
    for f in (gx * gx, gx * gy, gy * gy):
        rfx = row_sums(f * x.float())
        rf = row_sums(f)
        vals += [fold(row_sums(f * x.float() * x.float())), fold(y * rfx),
                 fold(y * y * rf), fold(rfx), fold(y * rf), fold(rf)]
    for z in (tv, iv, None):
        gs = (gx, gy) if z is None else (gx * z, gy * z)
        rgx = [row_sums(g * x.float()) for g in gs]
        rg = [row_sums(g) for g in gs]
        vals += [fold(rgx[0]), fold(rgx[1]), fold(y * rg[0]), fold(y * rg[1]),
                 fold(rg[0]), fold(rg[1])]
    one = torch.ones_like(iv)
    vals += [fold(row_sums(v)) for v in (one, tv, iv, tv * tv, iv * iv, tv * iv)]
    out[:, :42] = torch.stack(vals, dim=1).float()
    return out


def _inputs(shape, dtype):
    x = images(30, *shape)
    tm = images(31, 1, *shape[1:])[0]
    w = warps(30, shape[0])
    mw = clipped_mask_warps(*shape)
    dt = getattr(torch, dtype)
    return x, tm, w, mw, torch.tensor(x).to(dt), torch.tensor(tm).to(dt)


def assert_groups_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert not got[:, 42:].any()
    for lo, hi in GROUPS:
        scale = np.abs(want[:, lo:hi]).max(axis=1, keepdims=True)
        err = np.abs(got[:, lo:hi] - want[:, lo:hi])
        assert (err <= 2e-4 * np.abs(want[:, lo:hi]) + 2e-4 * scale).all(), (
            lo, hi, float(err.max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_row_factored_matches_twin_and_jax_kernel(shape, dtype):
    """Against ``moments_plain`` and ``_moments_batched`` (interpret mode
    off-TPU) under a mask warp whose valid rectangle is clipped on all
    four sides."""
    x, tm, w, mw, xt, tt = _inputs(shape, dtype)
    got = moments_rows(xt, tt, torch.tensor(w), torch.tensor(mw))
    assert_groups_close(got, K.moments_plain(xt, tt, torch.tensor(w), torch.tensor(mw)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax.vmap(P.ecc_gn_moments, in_axes=(0, None, 0, 0))(
        jnp.asarray(x, jdt), jnp.asarray(tm, jdt), jnp.asarray(w), jnp.asarray(mw)))
    assert_groups_close(got, want)
