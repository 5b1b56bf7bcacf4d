"""The port's phase-1 chunk processor against the JAX package's.

Both are fed one phase-0 state (the JAX ``run_phase0`` result, carried
over by ``from_jax_state``) and the same frames: a two-camera synthetic
datapoint with fiducial patches, so the fused warp+filter tail runs with
its patch overlays, and sub-pixel jitter up to 2 px, so the integer
pre-shift is non-zero on most frames.  The JAX side is
``make_chunk_processor(warm_start="fft", pre_shift=True,
slab_gather=False, with_telemetry=True)`` with ``ecc_impl="pallas"``
(interpret mode on the CPU) and again with ``ecc_impl="jnp"``.

Tolerances follow tests/test_pallas_ecc.py:514-520: intensities rtol 1e-4,
atol 0.2; rho atol 1e-3; translations atol 0.05; column 4 (the
displacement bound) within 1e-3 px of the Pallas run's.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu.pipeline.phase0 import run_phase0 as j_run_phase0
from upsp_tpu.pipeline.phase1 import make_chunk_processor as j_make_chunk_processor
from upsp_tpu.pipeline.phase1 import phase1_params as j_phase1_params
from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
from upsp_tpu_torch.pipeline.synthetic import write_datapoint
from upsp_tpu_torch.state import from_jax_state


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    dp = write_datapoint(str(tmp_path_factory.mktemp("p1")), n_frames=8,
                         n_distinct=8, seed=0, max_shift_px=2.0)
    cfg = read_input_deck(dp["deck"])
    frames = dp["frames"]
    js = j_run_phase0(cfg, [frames[0, c] for c in range(frames.shape[1])], [12, 12])
    jp = j_phase1_params(js)
    # the overlay path must be live: patched cameras with affected nodes
    assert any(c is not None for c in jp.patch_corr)
    assert any(n is not None and len(n[0]) for n in jp.corr_nodes)
    ts = from_jax_state(js, "cpu", jp)
    sols, teles = make_chunk_processor(ts, with_telemetry=True, warm_start="fft",
                                       frame_batch=8)(frames)
    pallas = j_make_chunk_processor(
        js, warm_start="fft", ecc_impl="pallas", pre_shift=True,
        slab_gather=False, with_telemetry=True,
    )(jnp.asarray(frames))
    return frames, sols.numpy(), teles.numpy(), [np.asarray(a) for a in pallas], js


def _compare(sols, teles, j_sols, j_teles):
    assert sols.shape == j_sols.shape and teles.shape == j_teles.shape
    np.testing.assert_array_equal(np.isnan(sols), np.isnan(j_sols))
    v = np.isfinite(j_sols)
    np.testing.assert_allclose(sols[v], j_sols[v], rtol=1e-4, atol=0.2)
    np.testing.assert_allclose(teles[..., 0], j_teles[..., 0], atol=1e-3)
    np.testing.assert_allclose(teles[..., 2:4], j_teles[..., 2:4], atol=0.05)


def test_chunk_matches_pallas(setup):
    frames, sols, teles, (j_sols, j_teles), _ = setup
    _compare(sols, teles, j_sols, j_teles)
    np.testing.assert_allclose(teles[..., 4], j_teles[..., 4], atol=1e-3)
    # the pre-shift was exercised: some total shift beyond half a pixel
    assert np.abs(teles[..., 2:4]).max() > 1.0


def test_chunk_matches_jnp(setup):
    frames, sols, teles, (_, p_teles), js = setup
    j_sols, j_teles = (np.asarray(a) for a in j_make_chunk_processor(
        js, warm_start="fft", ecc_impl="jnp", pre_shift=True,
        slab_gather=False, with_telemetry=True,
    )(jnp.asarray(frames)))
    _compare(sols, teles, j_sols, j_teles)
    assert (j_teles[..., 4] == 0).all()  # the dense path has no bound
    np.testing.assert_allclose(teles[..., 4], p_teles[..., 4], atol=1e-3)


def test_frame_batch_does_not_change_results(setup):
    frames, sols, teles, _, js = setup
    ts = from_jax_state(js, "cpu")  # the port derives its own parameters
    s3, t3 = make_chunk_processor(ts, with_telemetry=True, warm_start="fft",
                                  frame_batch=3)(frames)
    np.testing.assert_allclose(s3.numpy(), sols, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(t3.numpy(), teles, atol=1e-5)


def test_chunk_without_registration(tmp_path):
    """registration = none: hot pixels, patches, filter and projection
    only (the sequential tail with a full-image patch scatter)."""
    dp = write_datapoint(str(tmp_path), n_frames=4, n_distinct=4, seed=5,
                         options=["registration = none"])
    cfg = read_input_deck(dp["deck"])
    assert cfg.registration == "none"
    frames = dp["frames"]
    js = j_run_phase0(cfg, [frames[0, c] for c in range(frames.shape[1])], [12, 12])
    j_sols, j_teles = (np.asarray(a) for a in j_make_chunk_processor(
        js, with_telemetry=True)(jnp.asarray(frames)))
    sols, teles = make_chunk_processor(from_jax_state(js, "cpu"),
                                       with_telemetry=True, warm_start="fft",
                                       frame_batch=8)(frames)
    np.testing.assert_array_equal(np.isnan(sols.numpy()), np.isnan(j_sols))
    v = np.isfinite(j_sols)
    np.testing.assert_allclose(sols.numpy()[v], j_sols[v], rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(teles.numpy(), j_teles)
