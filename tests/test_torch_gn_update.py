"""The Gauss-Newton update in K3's reduce stage.

On the card ``registration._gn_step`` is K2 then one K3 launch that also
computes the closed-form update (``ecc_kernels.ecc_gn_moments_update``,
``moments_reduce_kernel<true>``): the host issues a handful of ops a step
where the twin, ``registration._gn_update`` of K3's statistics, issues
~420.  The epilogue rounds every operation as torch's CUDA kernels round
the twin's, so on the card its new warps, rho and |drho| equal the twin's
bit for bit, guard lanes included (zero valid area, a denominator under
1e-12, a non-finite new warp).  On the CPU the step is the twin, as
before, and a recording counts ``gn.update.host`` a step.

The ``cuda`` cases skip where torch has no CUDA device (the kernel has no
CPU mode):

    python -m pytest --noconftest -m cuda tests/test_torch_gn_update.py
"""

import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from upsp_tpu_torch.ops import ecc_kernels as K
from upsp_tpu_torch.ops import registration as R
from upsp_tpu_torch.utils import timing

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_cuda import cuda, images, warps  # noqa: E402,F401

HW = (97, 131)
SHIFT = (1.0, -2.0)


def parent_step(img, tmpl, kshift, warp, rho_prev, valid_shift):
    """The step as the host computed it before the epilogue: K2, K3 on
    the host-composed mask warp, then the twin."""
    iw = K.warp_affine_banded(img, warp)
    mom = K.ecc_gn_moments(iw, tmpl, warp, R._mask_warp(warp, valid_shift), kshift)
    return R._gn_update(mom, warp, rho_prev)


def step_inputs(b, dtype, shift, seed=60):
    img = torch.tensor(images(seed, b, *HW)).to(dtype)
    tmpl = torch.tensor(images(seed, 1, *HW))[0].to(dtype)  # lane 0's frame
    warp = torch.tensor(warps(seed, b))
    vs = torch.tensor([SHIFT]).repeat(b, 1) if shift else None
    rho = torch.linspace(-1.0, 0.9, b)
    return img, tmpl, K.template_shift(tmpl), warp, rho, vs


def guard_lanes(img, tmpl, kshift, warp):
    """Lanes 5-7 of a batch of 8 turned into the update's guard cases:
    5 has no valid pixel (its warp moves the frame off the template), 6 is
    the template's brightness shift everywhere under the identity warp (no
    gradient and no image variance: numerator 0, denominator 0 < 1e-12),
    7 is bright enough that its statistics overflow (a non-finite new
    warp and rho)."""
    img, warp = img.clone(), warp.clone()
    warp[5, :, 2] = torch.tensor([4.0e4, -3.0e4])
    img[6] = kshift.to(img.dtype)
    warp[6] = R.identity_warp()
    img[7] = img[7].float().mul(1e18).to(img.dtype)
    return img, tmpl, kshift, warp


def assert_guards_taken(mom, warp, got):
    """Lanes 5-7 of ``guard_lanes`` took their guards: the warp unmoved
    (lane 7: its non-finite update refused), rho 0 or -1."""
    _, i_proj, t_proj, _, corr, _, _ = K.ecc_statistics_from_moments(mom)
    area = mom[:, 36]
    assert area[5] == 0 and area[6] > 0
    assert corr[6] == 0 and not t_proj[6].any() and not i_proj[6].any()
    assert not torch.isfinite(mom[7]).all()
    for lane in (5, 6, 7):
        assert torch.equal(got[0][lane], warp[lane]), lane
    assert got[1][5] == got[1][6] == 0 and got[1][7] == -1.0
    assert torch.isfinite(got[0]).all()
    assert not torch.equal(got[0][:5], warp[:5])


def bits(t):
    return t.contiguous().view(torch.int32)


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(bits(g), bits(w)), (g, w)


# ---------------------------------------------------------------------------
# the CPU: the step is the twin, as before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [False, True])
def test_cpu_step_is_the_twin(dtype, shift):
    args = step_inputs(3, dtype, shift)
    assert_bit_equal(R._gn_step(*args), parent_step(*args))


@pytest.mark.parametrize("mode", ["fft", "identity"])
def test_cpu_solve_unchanged_in_both_start_modes(monkeypatch, mode):
    """``ecc_affine`` as the chunk program calls it in each start mode,
    through ``_gn_step`` and through the step as it was: equal bit for
    bit, and one ``gn.update.host`` a step."""
    img, tmpl, _, warp, _, vs = step_inputs(4, torch.float32, mode == "fft")
    ref = tmpl
    kw = (dict(max_iters=2, unroll=True, coarse_iters=1, valid_shift=vs,
               warp_init=warp) if mode == "fft" else dict(max_iters=6, epsilon=1e-4))
    with timing.recording() as rec:
        got = R.ecc_affine(ref, img, return_iters=True, **kw)
    monkeypatch.setattr(R, "_gn_step", parent_step)
    want = R.ecc_affine(ref, img, return_iters=True, **kw)
    assert_bit_equal(got[:2], want[:2])
    assert torch.equal(got[2], want[2])
    c = rec.counters[None]
    steps = 3 if mode == "fft" else c["gn.steps"]
    assert c["gn.update.host"] == steps > 0
    assert "gn.update.kernel" not in c


def test_cpu_dense_step_counts_host_updates():
    img, tmpl, _, warp, _, _ = step_inputs(2, torch.float32, False)
    with timing.recording() as rec:
        R.ecc_affine(tmpl, img, max_iters=2, unroll=True, impl="jnp")
    assert rec.counter("gn.update.host", None) == 2
    assert rec.counter("gn.update.kernel", None) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_guard_lanes_take_the_guards_in_the_twin(dtype):
    img, tmpl, kshift, warp, rho, vs = step_inputs(8, dtype, True)
    img, tmpl, kshift, warp = guard_lanes(img, tmpl, kshift, warp)
    iw = K.warp_affine_banded(img, warp)
    mom = K.ecc_gn_moments(iw, tmpl, warp, R._mask_warp(warp, vs), kshift)
    assert_guards_taken(mom, warp, R._gn_step(img, tmpl, kshift, warp, rho, vs))


def test_update_kernel_refuses_cpu_tensors():
    img, tmpl, kshift, warp, rho, vs = step_inputs(2, torch.float32, True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.ecc_gn_moments_update(img, tmpl, warp, vs, kshift, rho)


# ---------------------------------------------------------------------------
# the card


def on(dev, args):
    return [None if a is None else a.to(dev) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("shift", [False, True])
def test_update_equals_twin_on_card(cuda, dtype, b, shift):
    """The epilogue's new warps, rho and drho equal the twin's of the same
    statistics, bit for bit; the statistics equal K3's alone (the pre-shift
    composed in the kernel as on the host); at B = 8 lanes 5-7 take the
    guards."""
    img, tmpl, kshift, warp, rho, vs = step_inputs(b, dtype, shift, seed=70 + b)
    if b == 8:
        img, tmpl, kshift, warp = guard_lanes(img, tmpl, kshift, warp)
    img, tmpl, kshift, warp, rho, vs = on(cuda, (img, tmpl, kshift, warp, rho, vs))
    iw = K.warp_affine_banded(img, warp)
    before = K.launch_counts()
    got = K.ecc_gn_moments_update(iw, tmpl, warp, vs, kshift, rho)
    sfx = "" if dtype == torch.float32 else "_bf16"
    assert K.launch_counts()[f"moments_update{sfx}"] == before[f"moments_update{sfx}"] + 1
    mom = K.ecc_gn_moments(iw, tmpl, warp, R._mask_warp(warp, vs), kshift)
    assert torch.equal(bits(got[3]), bits(mom))  # lane 7's NaN too
    want = R._gn_update(mom, warp, rho)
    assert_bit_equal(got[:3], want)
    assert_bit_equal(R._gn_step(img, tmpl, kshift, warp, rho, vs), want)
    if b == 8:
        assert_guards_taken(mom, warp, got)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fft", "identity"])
def test_solve_on_card_steps_through_the_kernel(cuda, mode):
    """``ecc_affine`` on the card: one ``gn.update.kernel`` a step and no
    host update; equal bit for bit to the solve with the twin's step."""
    img, tmpl, _, warp, _, vs = on(cuda, step_inputs(4, torch.float32, mode == "fft"))
    kw = (dict(max_iters=2, unroll=True, coarse_iters=1, valid_shift=vs,
               warp_init=warp) if mode == "fft" else dict(max_iters=6, epsilon=1e-4))
    with timing.recording() as rec:
        got = R.ecc_affine(tmpl, img, return_iters=True, **kw)
    c = rec.counters[None]
    steps = 3 if mode == "fft" else c["gn.steps"]
    assert c["gn.update.kernel"] == steps > 0 and "gn.update.host" not in c
    real = R._gn_step
    try:
        R._gn_step = parent_step
        want = R.ecc_affine(tmpl, img, return_iters=True, **kw)
    finally:
        R._gn_step = real
    assert_bit_equal(got[:2], want[:2])
    assert torch.equal(got[2], want[2])


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
def test_card_step_issues_few_host_ops(cuda, shift):
    """A step on the card issues at most 12 aten ops on the host (the twin
    issues ~420): K2's output, K3's partials and statistics, and the new
    warps, rho and drho."""
    args = on(cuda, step_inputs(8, torch.float32, shift))
    R._gn_step(*args)  # built and warm
    with timing.recording() as rec, _OpCount() as mode:
        R._gn_step(*args)
    assert len(mode.ops) <= 12, mode.ops
    assert rec.counter("gn.update.kernel", None) == 1
    assert rec.counter("gn.update.host", None) == 0
