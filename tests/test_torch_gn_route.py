"""The Gauss-Newton step's route: K2 then K3, with K9 the same step in f32.

``registration._gn_step`` computes a step's statistics with K2 then K3
in both dtypes: K9 (``ecc_gn_fused``) measured slower than the pair on
the H100 at the full configuration's 1200x1800 (PERF.md section 6).  On
the CPU both routes are the plain twins, and in f32 they are the same
function: K9's twin is K3's twin of K2's twin's f32 warp, which K2's twin
rounds to f32, a no-op.  So the step gives the same new warp, rho and
drho through either route, bit for bit, in f32; in bf16 the routes differ
(K9 keeps the warped image f32 where the JAX reference's bf16 step rounds
it), and the step takes K2 then K3.  The card holds K9 against K2 then K3
within the statistics' bounds (tests/test_torch_cuda.py, ``chip_smoke.py``).
"""

import sys
from pathlib import Path

import pytest
import torch

from upsp_tpu_torch.ops import ecc_kernels as K
from upsp_tpu_torch.ops import registration as R

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_cuda import images, warps  # noqa: E402


@pytest.fixture
def calls(monkeypatch):
    """Counts of the statistics kernels' wrappers that the step calls."""
    n = {"gn_fused": 0, "warp": 0, "moments": 0}
    for key, name in (("gn_fused", "ecc_gn_fused"), ("warp", "warp_affine_banded"),
                      ("moments", "ecc_gn_moments")):
        fn = getattr(K, name)

        def counted(*a, _fn=fn, _key=key, **k):
            n[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(R, name, counted, raising=False)
    return n


def _step_inputs(dtype, shape=(2, 97, 131)):
    img = R.ecc_blur(torch.tensor(images(60, *shape)).to(dtype))
    tmpl = R.ecc_blur(torch.tensor(images(60, 1, *shape[1:])).to(dtype))[0]
    warp = torch.tensor(warps(60, shape[0]))
    shift = torch.tensor([[1.0, -2.0], [0.0, 1.0]])[: shape[0]]
    return img, tmpl, K.template_shift(tmpl), warp, torch.full((shape[0],), 0.5), shift


def _mask(warp, valid_shift):
    return torch.cat([warp[:, :, :2], (warp[:, :, 2] + valid_shift)[:, :, None]],
                     dim=2).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_runs_k2_then_k3(calls, dtype):
    img, tmpl, kshift, warp, rho, shift = _step_inputs(dtype)
    got = R._gn_step(img, tmpl, kshift, warp, rho, shift)
    assert calls == {"gn_fused": 0, "warp": 1, "moments": 1}
    mom = K.ecc_gn_moments(K.warp_affine_banded(img, warp), tmpl, warp,
                           _mask(warp, shift), kshift)
    for g, w in zip(got, R._gn_update(mom, warp, rho)):
        assert torch.equal(g, w)
    assert torch.isfinite(got[0]).all() and got[1][0] > 0.9  # frame 0 is the template


def test_f32_step_through_k9_is_the_same_step():
    """In f32 the step from K9's statistics is the step, bit for bit."""
    img, tmpl, kshift, warp, rho, shift = _step_inputs(torch.float32)
    want = R._gn_step(img, tmpl, kshift, warp, rho, shift)
    mom = K.ecc_gn_fused(img, tmpl, warp, _mask(warp, shift), kshift)
    for g, w in zip(R._gn_update(mom, warp, rho), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ecc_affine_steps_by_dtype(calls, dtype):
    """``ecc_affine``'s two steps: two K2 and two K3 calls, no K9."""
    img, tmpl, kshift, warp, _, shift = _step_inputs(dtype)
    ref = torch.tensor(images(60, 1, 97, 131))[0].to(dtype)
    R.ecc_affine(ref, img, warp_init=warp, max_iters=2, unroll=True,
                 valid_shift=shift, tmpl_blurred=tmpl, tmpl_shift=kshift)
    assert calls == {"gn_fused": 0, "warp": 2, "moments": 2}
