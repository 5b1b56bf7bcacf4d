"""K9, the fused Gauss-Newton step (``ecc_kernels.ecc_gn_fused``), against
the JAX package's ``pallas_ecc.ecc_gn_fused`` (interpret mode off-TPU)
and against the port's own K2 then K3.

On a CPU tensor the wrapper runs ``gn_fused_plain``: the f32 warp of the
unwarped (blurred) images, not rounded to a bf16 image's dtype, then the
42 statistics.  Tolerance (``test_torch_cuda.assert_stats_close``): 2e-4
relative per statistic group, with an absolute floor of 2e-4 of the
group's scale (K3's bound; f32 reduction order), and for S_t and S_i,
which nearly cancel, area x 8 f32 ulps of the brightness shift that each
side takes in its own order.  The frames include heights the CUDA
kernel's 32-row tile does not divide (90, 97), so its seams fall inside
the frame; the CUDA kernel itself is held against these twins in
tests/test_torch_cuda.py.
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

from test_torch_cuda import assert_stats_close, images, warps  # noqa: E402

def _inputs(seed, shape, pre_shift):
    x = images(seed, *shape)
    tm = images(seed + 100, 1, *shape[1:])[0]
    w = warps(seed, shape[0])
    mw = w.copy()
    if pre_shift:
        mw[:, :, 2] += np.array([2.0, -1.0], np.float32)  # composed pre-shift
    return x, tm, w, mw


def _jax_batched(x, tm, w, mw):
    return np.asarray(jax.vmap(P.ecc_gn_fused, in_axes=(0, None, 0, 0))(
        jnp.asarray(x), jnp.asarray(tm), jnp.asarray(w), jnp.asarray(mw)))


def _port(x, tm, w, mw, dtype=torch.float32):
    return K.ecc_gn_fused(torch.tensor(x).to(dtype), torch.tensor(tm).to(dtype),
                          torch.tensor(w), torch.tensor(mw)).numpy()


@pytest.mark.parametrize("shape", [(2, 90, 128), (2, 97, 131), (3, 64, 160)])
@pytest.mark.parametrize("pre_shift", [False, True])
def test_gn_fused_matches_jax(shape, pre_shift):
    """The batched form (the vmap of tests/test_pallas_ecc.py:218-226)."""
    x, tm, w, mw = _inputs(11, shape, pre_shift)
    assert_stats_close(_port(x, tm, w, mw), _jax_batched(x, tm, w, mw), tm)


def test_gn_fused_single_frame_matches_jax():
    """The unbatched JAX call on each frame gives the batched rows."""
    x, tm, w, mw = _inputs(12, (2, 90, 131), True)
    got = _port(x, tm, w, mw)
    for i in range(2):
        want = np.asarray(P.ecc_gn_fused(jnp.asarray(x[i]), jnp.asarray(tm),
                                         jnp.asarray(w[i]), jnp.asarray(mw[i])))
        assert_stats_close(got[i], want, tm)


@pytest.mark.parametrize("shape", [(2, 90, 128), (2, 97, 131)])
def test_gn_fused_equals_warp_then_moments(shape):
    """In f32 K9 is K2 then K3 (the same warp values, summed otherwise)."""
    x, tm, w, mw = _inputs(13, shape, True)
    xt, tt, wt, mt = (torch.tensor(a) for a in (x, tm, w, mw))
    want = K.ecc_gn_moments(K.warp_affine_banded(xt, wt), tt, wt, mt).numpy()
    assert_stats_close(_port(x, tm, w, mw), want, tm)
    assert_stats_close(K.gn_fused_plain(xt, tt, wt, mt).numpy(),
                       K.moments_plain(K.warp_plain(xt, wt), tt, wt, mt).numpy(), tm)


def test_gn_fused_bf16_matches_jax():
    """bf16 images and template: the warped rows stay f32 on both sides
    (``_sep_rows_block`` widens), the brightness shift is the bf16 mean."""
    x, tm, w, mw = _inputs(14, (2, 90, 131), True)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    tb = np.asarray(jnp.asarray(tm, jnp.bfloat16), np.float32)
    want = np.asarray(jax.vmap(P.ecc_gn_fused, in_axes=(0, None, 0, 0))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(tm, jnp.bfloat16),
        jnp.asarray(w), jnp.asarray(mw)))
    assert_stats_close(_port(xb, tb, w, mw, torch.bfloat16), want, tb)


def test_gn_fused_step_matches_split_pair_update():
    """A whole GN step from K9's statistics equals the split pair's to the
    f32 solve's rounding (the Cholesky update of registration._gn_step)."""
    from upsp_tpu_torch.ops.registration import chol_factor_unrolled, chol_solve_unrolled

    x, tm, w, mw = _inputs(15, (2, 97, 131), True)
    xt, tt, wt, mt = (torch.tensor(a) for a in (x, tm, w, mw))

    def update(mom):
        hm, ip, tp, n2, corr, _, _ = K.ecc_statistics_from_moments(mom)
        reg = 1e-9 * hm.diagonal(dim1=1, dim2=2).sum(1) / 6.0 + 1e-12
        lt = chol_factor_unrolled(hm + reg[:, None, None] * torch.eye(6))
        hi_t = chol_solve_unrolled(lt, ip)
        lam = (n2 - (ip * hi_t).sum(1)) / (corr - (tp * hi_t).sum(1))
        return (lam[:, None] * chol_solve_unrolled(lt, tp) - hi_t).numpy()

    fused = update(K.ecc_gn_fused(xt, tt, wt, mt))
    split = update(K.ecc_gn_moments(K.warp_affine_banded(xt, wt), tt, wt, mt))
    np.testing.assert_allclose(fused, split, atol=1e-5, rtol=0)


def test_gn_fused_rejects_bad_input():
    x = torch.zeros((2, 16, 16))
    w = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]] * 2)
    with pytest.raises(ValueError):
        K.ecc_gn_fused(x, torch.zeros((16, 17)), w, w)
    with pytest.raises(ValueError):
        K.ecc_gn_fused(x, torch.zeros((16, 16)), w[:1], w)
    with pytest.raises(TypeError):
        K.ecc_gn_fused(x.double(), torch.zeros((16, 16)).double(), w, w)
