"""No host-to-device copy in the per-batch program once it is set up.

A ``torch.tensor(..., device=cuda)`` copies host memory to the card and
waits for it.  The phase-1 program builds what such copies made once, at
set-up: the phase correlation pools with K10 (``fftreg.decimate_image``),
which takes 1/k as a scalar argument and builds no pooling matrix,
``warp_displacement_bound`` keeps its corner tensor per size and device,
and K3 takes each camera template's brightness shift (``template_shift``)
from the chunk processor; K9 takes it from its caller too.  These tests
count the calls that made those copies (``torch.tensor``,
``ecc_kernels.template_shift``) during calls after set-up, and hold the
outputs bit for bit to what the per-call construction gives (or, for the
pooling, to its plain twin) and to the JAX package within tests/test_torch_ops.py's and
tests/test_torch_ecc_kernels.py's bounds.  On the CPU the calls are the
same; only the device differs.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from upsp_tpu.ops import fftreg as JF
from upsp_tpu.ops import pallas_ecc as P
from upsp_tpu_torch.ops import ecc_kernels as K
from upsp_tpu_torch.ops import fftreg as TF
from upsp_tpu_torch.ops import registration as R
from upsp_tpu_torch.pipeline import phase1 as P1
from upsp_tpu_torch.pipeline.synthetic import scene_spectrum, shift_field

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_cuda import images, warps  # noqa: E402


@pytest.fixture
def count(monkeypatch):
    """Counts of calls to the functions that copied to the device."""
    calls = {"tensor": 0, "shift": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(torch, "tensor", counted("tensor", torch.tensor))
    shift = counted("shift", K.template_shift)
    for mod in (K, R, P1):  # every module that calls it
        monkeypatch.setattr(mod, "template_shift", shift)
    return calls


def _scene(h, w, shifts):
    rng = np.random.default_rng(3)
    spec = scene_spectrum(rng, (h, w))
    return np.stack([np.rint(2000.0 + shift_field(spec, (h, w), dx, dy))
                     for dx, dy in shifts]).astype(np.float32)


@pytest.mark.parametrize("decimate", [1, 2, 4])
def test_correlate_copies_nothing(count, decimate):
    shifts = [(0.0, 0.0), (1.3, -0.6), (-1.8, 1.1)]
    x = _scene(96, 128, shifts)
    tmpl = TF.prepare_template(torch.from_numpy(x[0]), decimate)
    built = dict(count)
    got = TF.correlate(tmpl, torch.from_numpy(x))
    assert count == built  # nothing made per call
    # the template's pooled image is its plain twin's, cropped
    small = TF.pow2_center_crop(TF.decimate_plain(torch.from_numpy(x[0]), decimate))
    assert tmpl.hw == tuple(small.shape)
    assert torch.equal(tmpl.spectrum, torch.fft.rfft2(small * tmpl.window))
    jt = JF.prepare_template(jnp.asarray(x[0]), decimate)
    want = np.stack([np.asarray(JF.correlate(jt, jnp.asarray(f))) for f in x])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


def test_displacement_bound_copies_nothing(count):
    w = torch.tensor(warps(7, 3))
    K.warp_displacement_bound(w, 97, 131)  # set-up: the corners, once
    built = dict(count)
    got = K.warp_displacement_bound(w, 97, 131)
    assert count == built
    corners = torch.tensor([[0.0, 0.0], [130.0, 0.0], [0.0, 96.0], [130.0, 96.0]])
    pos = torch.einsum("kj,bij->bki", corners, w[:, :, :2]) + w[:, None, :, 2]
    assert torch.equal(got, (pos - corners).abs().amax(dim=(1, 2)))
    want = [float(P.warp_displacement_bound(jnp.asarray(w[i].numpy()), 97, 131))
            for i in range(3)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moments_take_the_shift(count, dtype):
    shape = (2, 64, 96)
    x = torch.tensor(images(4, *shape)).to(dtype)
    tm = torch.tensor(images(104, 1, *shape[1:])[0]).to(dtype)
    w = torch.tensor(warps(4, 2))
    mw = w.clone()
    mw[:, :, 2] += torch.tensor([1.0, -2.0])
    kshift = K.template_shift(tm)  # set-up, once per template
    built = dict(count)
    got = K.ecc_gn_moments(x, tm, w, mw, kshift)
    assert count == built
    assert torch.equal(got, K.ecc_gn_moments(x, tm, w, mw))  # computed per call
    if dtype == torch.float32:
        want = np.asarray(P.ecc_gn_moments(jnp.asarray(x[0].numpy()), jnp.asarray(tm.numpy()),
                                           jnp.asarray(w[0].numpy()), jnp.asarray(mw[0].numpy())))
        for lo, hi in [(0, 18), (18, 24), (24, 30), (30, 36), (36, 37), (37, 39), (39, 42)]:
            g, v = got[0, lo:hi].numpy(), want[lo:hi]
            assert (np.abs(g - v) <= 2e-4 * np.abs(v) + 2e-4 * np.abs(v).max()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_fused_takes_the_shift(count, dtype):
    """K9 takes the template's shift from its caller, as K3 does: no
    ``template_shift`` call and no copy when it is given, and the same
    statistics as when K9 computes it."""
    shape = (2, 64, 96)
    x = torch.tensor(images(5, *shape)).to(dtype)
    tm = torch.tensor(images(105, 1, *shape[1:])[0]).to(dtype)
    w = torch.tensor(warps(5, 2))
    mw = w.clone()
    mw[:, :, 2] += torch.tensor([2.0, -1.0])
    kshift = K.template_shift(tm)  # set-up, once per template
    built = dict(count)
    got = K.ecc_gn_fused(x, tm, w, mw, kshift)
    assert count == built
    assert torch.equal(got, K.ecc_gn_fused(x, tm, w, mw))  # computed per call
    if dtype == torch.float32:
        assert torch.equal(got, K.ecc_gn_moments(K.warp_affine_banded(x, w), tm, w, mw,
                                                 kshift))


def test_chunk_program_copies_nothing(count, tmp_path):
    """The whole per-batch program (hot pixels, phase correlation at
    decimation 2, integer shift, ECC, tail, gather) after set-up and a
    first batch (which keeps the displacement bound's corners): no
    copy-making call, and the same intensities again."""
    from upsp_tpu_torch.pipeline.config import read_input_deck
    from upsp_tpu_torch.pipeline.phase0 import run_phase0
    from upsp_tpu_torch.pipeline.synthetic import write_datapoint

    dp = write_datapoint(str(tmp_path), image_hw=(512, 528), n_frames=2, n_distinct=2,
                         grid_shape=(24, 20), n_targets=4, seed=3, max_shift_px=1.5)
    assert TF.default_decimate(512, 528) == 2
    frames = dp["frames"]
    state = run_phase0(read_input_deck(dp["deck"]),
                       [frames[0, c] for c in range(frames.shape[1])],
                       [12] * frames.shape[1], device="cpu")
    proc = P1.make_chunk_processor(state, with_telemetry=True, warm_start="fft",
                                   frame_batch=8)
    assert count["shift"] > 0  # made at set-up
    sol, tele = proc(frames)
    built = dict(count)
    sol2, tele2 = proc(frames)
    assert count == built
    np.testing.assert_array_equal(sol.numpy(), sol2.numpy())
    np.testing.assert_array_equal(tele.numpy(), tele2.numpy())
