"""The port's camera-batched phase 1 (``make_chunk_processor(
vmap_cameras=True)``) against the JAX package's and against the port's
per-camera loop.

Scene: ``make_synthetic_state`` of both packages (3 cameras of 96 x 128,
a 40 x 32-node plate, best view, polynomial patches; the builders give
equal arrays, tests/test_torch_vendored.py) and 4 frames of
``make_frame_batch``, in batches of 2.  The loop form is the one the
batched path stands for: the dense "jnp" step without the pre-shift.
Tolerances are tests/test_phase1_cams.py's: fft mode, intensities rtol
1e-4 / atol 1e-2 with NaN counts equal, telemetry columns 2-3 (the
translations) within 1e-3 px; without registration rtol 1e-5 / atol 1e-3.
The port's loop form writes its displacement bound into column 4, the
batched form 0 (as the JAX package's dense path), so column 4 is held to
JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from upsp_tpu.pipeline import phase1 as JP1
from upsp_tpu.pipeline import synthetic as JS
from upsp_tpu_torch.pipeline import phase1 as P1
from upsp_tpu_torch.pipeline import synthetic as TS

KW = dict(n_cameras=3, image_hw=(96, 128), grid_shape=(40, 32))


@pytest.fixture(scope="module")
def scene():
    js = JS.make_synthetic_state(**KW)
    ts = TS.make_synthetic_state(device="cpu", **KW)
    return js, ts, TS.make_frame_batch(ts, 4)


def _no_registration(state):
    return dataclasses.replace(
        state, config=dataclasses.replace(state.config, registration="none"))


def _port(state, frames, warm_start="fft", **kw):
    sol, tele = P1.make_chunk_processor(state, with_telemetry=True, frame_batch=2,
                                        warm_start=warm_start, **kw)(frames)
    return sol.numpy(), tele.numpy()


def _jax(state, frames):
    fn = JP1.make_chunk_processor(state, with_telemetry=True, warm_start="fft",
                                  frame_batch=2, vmap_cameras=True)
    return tuple(np.asarray(a) for a in fn(jnp.asarray(frames)))


def _close(got, want, rtol, atol, tele=True):
    (sol, t), (w_sol, w_t) = got, want
    assert np.isnan(sol).sum() == np.isnan(w_sol).sum()
    m = ~np.isnan(w_sol)
    np.testing.assert_allclose(sol[m], w_sol[m], rtol=rtol, atol=atol)
    if tele:
        np.testing.assert_allclose(t[..., 2:4], w_t[..., 2:4], atol=1e-3)


@pytest.mark.parametrize("mode", ["fft", "none"])
def test_camera_batch_matches_jax_and_loop(scene, mode):
    js, ts, frames = scene
    if mode == "none":
        js, ts = _no_registration(js), _no_registration(ts)
    rtol, atol = (1e-4, 1e-2) if mode == "fft" else (1e-5, 1e-3)
    got = _port(ts, frames, vmap_cameras=True)
    want = _jax(js, frames)
    _close(got, want, rtol, atol)
    np.testing.assert_array_equal(got[1][..., 4], want[1][..., 4])
    np.testing.assert_allclose(got[1][..., :2], want[1][..., :2], atol=1e-3)
    loop = _port(ts, frames, vmap_cameras=False, ecc_impl="jnp", pre_shift=False)
    _close(got, loop, rtol, atol)
    if mode == "fft":
        assert np.abs(got[1][..., 2:4]).max() > 0.1  # the frames moved


def test_camera_batch_refusals(scene):
    """``ecc_impl="kernels"`` raises (K3 takes one template), as the JAX
    package's Pallas moments do on batched templates; ``auto`` runs."""
    _, ts, frames = scene
    with pytest.raises(NotImplementedError, match="one template"):
        P1.make_chunk_processor(ts, warm_start="fft", vmap_cameras=True,
                                ecc_impl="kernels")
    with pytest.raises(NotImplementedError, match="valid_shift"):
        P1.process_frames_cams_batched(
            frames[:1], P1.phase1_params(ts), "pixel", True, "gaussian", 3,
            valid_shift=np.zeros((1, 3, 2)))
    # scan starts do not batch the cameras: the option is ignored, as in JAX
    a = _port(ts, frames[:2], vmap_cameras=True, warm_start="scan")
    b = _port(ts, frames[:2], warm_start="scan")
    np.testing.assert_array_equal(a[0], b[0])
