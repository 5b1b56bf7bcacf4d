"""The port's ECC kernels (upsp_tpu_torch/ops/ecc_kernels.py) against the
JAX package.

On the CPU every wrapper runs its plain twin; those are held against the
Pallas kernels of ``upsp_tpu/ops/pallas_ecc.py`` (interpret mode off-TPU)
and against ``warp_affine_mxu(order=2)``, whose matmuls are exact f32 on
the CPU.  tests/test_torch_cuda.py holds each hand-written kernel against
its twin on the card.

Tolerances and why:
- images: atol 1e-3 on ~1000-3500-count data (f32 rounding of the tap
  sums), except where a sample straddles the zero border: there the value
  moves by the full pixel value per pixel of position, and the sides round
  the position differently (XLA may contract it into an FMA; the TPU
  kernel computes ``y_sep - g`` rather than ``y_sep``), so those pixels
  get the position-rounding bound instead.  The 7-tap filter of a warped
  image sums 49 products after the warp's own roundings and may differ by
  6 ulps (1.5e-3 at ~2500 counts);
- moments: rtol 2e-4 (f32 reduction order), with an absolute floor of
  2e-4 of each statistic group's scale for the near-zero shifted sums;
- the GN update from the same moments: atol 1e-5.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from upsp_tpu.ops import pallas_ecc as P
from upsp_tpu.ops.registration import (
    _chol_factor_unrolled,
    _chol_solve_unrolled,
)
from upsp_tpu.ops.warp import warp_affine_mxu
from upsp_tpu_torch.ops import ecc_kernels as K
from upsp_tpu_torch.ops.registration import (
    chol_factor_unrolled,
    chol_solve_unrolled,
)

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_cuda import (
    BOX5,
    GAUSS,
    SHAPES,
    assert_images_close,
    images,
    warps,
)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("taps", [GAUSS[3], GAUSS[5], GAUSS[7], BOX5])
def test_blur_twin_matches_make_blur(shape, taps):
    x = images(1, *shape)
    want = np.asarray(jax.vmap(P.make_blur(taps))(jnp.asarray(x)))
    got = K.blur(torch.tensor(x), taps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_warp_twin_matches_mxu(shape):
    x = images(2, *shape)
    w = warps(2, shape[0])
    want = np.stack([
        np.asarray(warp_affine_mxu(jnp.asarray(x[i]), jnp.asarray(w[i]), order=2))
        for i in range(shape[0])
    ])
    got = K.warp_affine_banded(torch.tensor(x), torch.tensor(w)).numpy()
    assert_images_close(got, want, w)


@pytest.mark.parametrize("shape", SHAPES)
def test_warp_twin_matches_banded_kernel(shape):
    x = images(3, *shape)
    w = warps(3, shape[0])
    want = np.asarray(jax.vmap(P.warp_affine_banded)(jnp.asarray(x), jnp.asarray(w)))
    got = K.warp_affine_banded(torch.tensor(x), torch.tensor(w)).numpy()
    assert_images_close(got, want, w)


def _moments_pair(shape, seed):
    x = images(seed, *shape)
    tm = images(seed + 100, 1, *shape[1:])[0]
    w = warps(seed, shape[0])
    mw = w.copy()
    mw[:, :, 2] += np.array([1.0, -2.0], np.float32)  # composed pre-shift
    want = np.asarray(jax.vmap(P.ecc_gn_moments, in_axes=(0, None, 0, 0))(
        jnp.asarray(x), jnp.asarray(tm), jnp.asarray(w), jnp.asarray(mw)))
    got = K.ecc_gn_moments(torch.tensor(x), torch.tensor(tm), torch.tensor(w),
                           torch.tensor(mw)).numpy()
    return got, want


@pytest.mark.parametrize("shape", SHAPES)
def test_moments_twin_matches_kernel(shape):
    got, want = _moments_pair(shape, 4)
    assert not got[:, 42:].any()
    for lo, hi in [(0, 18), (18, 24), (24, 30), (30, 36), (36, 37),
                   (37, 39), (39, 42)]:
        scale = np.abs(want[:, lo:hi]).max(axis=1, keepdims=True)
        err = np.abs(got[:, lo:hi] - want[:, lo:hi])
        assert (err <= 2e-4 * np.abs(want[:, lo:hi]) + 2e-4 * scale).all(), (
            lo, hi, err.max()
        )


@pytest.mark.parametrize("shape", SHAPES)
def test_gn_update_from_moments(shape):
    """Same moments in, same Gauss-Newton update out (atol 1e-5)."""
    _, mom = _moments_pair(shape, 5)
    hm, ip, tp, n2, corr, _, _ = K.ecc_statistics_from_moments(torch.tensor(mom))
    reg = 1e-9 * hm.diagonal(dim1=1, dim2=2).sum(1) / 6.0 + 1e-12
    lt = chol_factor_unrolled(hm + reg[:, None, None] * torch.eye(6))
    hi_t = chol_solve_unrolled(lt, ip)
    ht_t = chol_solve_unrolled(lt, tp)
    lam = (n2 - (ip * hi_t).sum(1)) / (corr - (tp * hi_t).sum(1))
    got = (lam[:, None] * ht_t - hi_t).numpy()
    for b in range(mom.shape[0]):
        H, i_proj, t_proj, iw_norm2, c, _, _ = P.ecc_statistics_from_moments(
            jnp.asarray(mom[b]))
        rg = 1e-9 * jnp.trace(H) / 6.0 + 1e-12
        L = _chol_factor_unrolled(H + rg * jnp.eye(6, dtype=jnp.float32))
        hi = _chol_solve_unrolled(L, i_proj)
        ht = _chol_solve_unrolled(L, t_proj)
        lam_j = (iw_norm2 - i_proj @ hi) / (c - t_proj @ hi)
        want = np.asarray(lam_j * ht - hi, np.float32)
        np.testing.assert_allclose(got[b], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_warped", [False, True])
@pytest.mark.parametrize("taps", [GAUSS[3], GAUSS[7], BOX5, ()])
def test_warp_filter_twin_matches_kernel(shape, with_warped, taps):
    x = images(6, *shape)
    w = warps(6, shape[0])
    fn = P.make_warp_filter(taps, with_warped)
    want = jax.vmap(fn)(jnp.asarray(x), jnp.asarray(w))
    got = K.warp_filter(torch.tensor(x), torch.tensor(w), taps, with_warped)
    if not with_warped:
        want, got = (want,), (got,)
    for k, (g, wa) in enumerate(zip(got, want)):
        halo = len(taps) // 2 if k == 0 else 0  # the filter spreads the edge
        atol = 1.5e-3 if (k == 0 and len(taps) == 7) else 1e-3
        assert_images_close(g.numpy(), np.asarray(wa), w, atol=atol, halo=halo)


def test_wrappers_reject_bad_input():
    x = torch.zeros((1, 16, 16))
    with pytest.raises(TypeError):
        K.warp_affine_banded(x.double(), torch.zeros((1, 2, 3)))
    with pytest.raises(ValueError):
        K.warp_affine_banded(x, torch.zeros((2, 2, 3)))
    with pytest.raises(ValueError):
        K.blur(x, (0.25, 0.25, 0.25, 0.25))
    with pytest.raises(ValueError):
        K.blur(x.transpose(1, 2), GAUSS[3])


def test_displacement_bound_matches():
    w = warps(7, 3)
    want = [float(P.warp_displacement_bound(jnp.asarray(w[i]), 97, 131))
            for i in range(3)]
    got = K.warp_displacement_bound(torch.tensor(w), 97, 131).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
