"""The port as a drop-in for ``upsp_tpu``: the calls a JAX caller writes,
with the same arguments (defaults included), give the JAX package's
results, on the CPU.  ``tests/test_torch_api_parity.py`` holds the
signatures; this file holds what the calls return.

The same seeded numpy inputs go through both packages.  The datapoint is
2 cameras of 64x96 12-bit frames, 5 frames jittered by up to 1.5 px, a
21x17 grid with 3 targets; the datapoint runs' is the same with a jitter
under half a pixel (the ``sub_pixel`` fixture says why).  Bounds:

- intensities: PERF.md section 2's f32 bounds, rtol 1e-4 / atol 0.2
  counts, NaN at the same nodes;
- warps and rho: tests/test_pallas_ecc.py:514-520's, translations atol
  0.05 px, linear entries atol 1e-3, rho atol 1e-3;
- ``StageClock`` (on a shared fake clock), ``identity_warp``,
  ``CameraParams.camera_matrix``, ``PatchOperator.empty``, the visible
  target lists and the supersession identity of ``process_frame``: bit for
  bit.
"""

import dataclasses
import itertools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsp_tpu.camera import model as JM
from upsp_tpu.io.flatfile import read_flat
from upsp_tpu.ops import patching as JPa
from upsp_tpu.ops import registration as J
from upsp_tpu.pipeline import phase0 as J0
from upsp_tpu.pipeline import phase1 as JP1
from upsp_tpu.pipeline import run as JR
from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu.utils import timing as JT
from upsp_tpu_torch.camera import model as TM
from upsp_tpu_torch.io.tgts import read_tgts
from upsp_tpu_torch.ops import patching as TPa
from upsp_tpu_torch.ops import registration as R
from upsp_tpu_torch.pipeline import phase0 as P0
from upsp_tpu_torch.pipeline import phase1 as P1
from upsp_tpu_torch.pipeline import run as TR
from upsp_tpu_torch.pipeline.config import read_input_deck as t_read_input_deck
from upsp_tpu_torch.pipeline.synthetic import write_datapoint
from upsp_tpu_torch.state import from_jax_state
from upsp_tpu_torch.utils import timing as TT

from test_torch_registration import _hold, _hold_counts, _j_solve, _scenes

N_FRAMES = 5
JAX_STREAM_LABELS = ["phase0", "phase1_stream", "disk_transpose", "phase2_blocks"]


def _intensities(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    v = np.isfinite(want)
    np.testing.assert_allclose(got[v], want[v], rtol=1e-4, atol=0.2)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    dp = write_datapoint(str(tmp_path_factory.mktemp("drop_in")), image_hw=(64, 96),
                         n_frames=N_FRAMES, n_distinct=N_FRAMES, grid_shape=(21, 17),
                         n_targets=3, seed=3, max_shift_px=1.5)
    frames = dp["frames"]
    js = J0.run_phase0(read_input_deck(dp["deck"]),
                       [frames[0, c] for c in range(frames.shape[1])], [12, 12])
    return dp, frames, js, from_jax_state(js, "cpu", JP1.phase1_params(js))


# -- make_chunk_processor's defaults -----------------------------------------


def test_chunk_processor_defaults(scene):
    """``make_chunk_processor(state)`` with nothing past the state: scan
    starts a frame at a time, as the JAX package's defaults."""
    _, frames, js, ts = scene
    want = JP1.make_chunk_processor(js)(jnp.asarray(frames))
    got = P1.make_chunk_processor(ts)(frames)
    _intensities(got.numpy(), want)
    explicit = P1.make_chunk_processor(ts, warm_start="scan", frame_batch=1)(frames)
    np.testing.assert_array_equal(got.numpy(), explicit.numpy())


# -- ecc_affine's return arity ------------------------------------------------


def test_ecc_affine_returns_warp_and_rho():
    """The default form is (warp, rho), ``return_iters=True`` adds the
    iteration counts; on a batch and on one (H, W) frame as JAX takes it."""
    ref, frames = _scenes()
    out = R.ecc_affine(torch.tensor(ref), torch.tensor(frames))
    assert len(out) == 2
    warp, rho = (t.numpy() for t in out)
    j_warp, j_rho, j_iters = _j_solve(ref, frames)
    _hold(warp, rho, j_warp, j_rho)
    full = R.ecc_affine(torch.tensor(ref), torch.tensor(frames), return_iters=True)
    assert len(full) == 3
    np.testing.assert_array_equal(full[0].numpy(), warp)
    np.testing.assert_array_equal(full[1].numpy(), rho)
    _hold_counts(full[2].numpy(), j_iters, "return_iters")
    # one frame, the JAX package's call and shapes, positionally
    w1, r1 = R.ecc_affine(torch.tensor(ref), torch.tensor(frames[2]), 50, 1e-3, 5)
    jw, jr = J.ecc_affine(jnp.asarray(ref), jnp.asarray(frames[2]), 50, 1e-3, 5)
    assert w1.shape == (2, 3) and r1.shape == ()
    _hold(w1.numpy()[None], r1.numpy()[None], np.asarray(jw)[None], np.array([float(jr)]))
    np.testing.assert_array_equal(w1.numpy(), warp[2])
    w3, r3, n3 = R.ecc_affine(torch.tensor(ref), torch.tensor(frames[2]),
                              warp_init=torch.tensor(j_warp[2]), return_iters=True)
    jw3, jr3, jn3 = J.ecc_affine(jnp.asarray(ref), jnp.asarray(frames[2]),
                                 warp_init=jnp.asarray(j_warp[2]), return_iters=True)
    _hold(w3.numpy()[None], r3.numpy()[None], np.asarray(jw3)[None],
          np.array([float(jr3)]))
    assert abs(int(n3) - int(jn3)) <= 1


# -- process_frame(adjust_overlap) ----------------------------------------------


@pytest.fixture(scope="module")
def superseded(scene):
    """The scene with copies: a few non-skipped nodes superseded by
    overlaid nodes and a few by plain ones (tests/test_torch_gather.py's
    construction)."""
    _, frames, js, _ = scene
    jp = JP1.phase1_params(js)
    overlaid = np.concatenate([np.asarray(cn[0]) for cn in jp.corr_nodes
                               if cn is not None])
    assert overlaid.size >= 3
    sup = np.arange(js.model.size, dtype=np.int32)
    live = np.nonzero(~np.asarray(js.skipped))[0]
    others = np.setdiff1d(live, overlaid)
    sup[others[:3]] = overlaid[:3]
    sup[others[3:6]] = others[6:9]
    js = dataclasses.replace(js, superseded_by=jnp.asarray(sup))
    jp = JP1.phase1_params(js)
    return frames, jp, P1.phase1_params(from_jax_state(js, "cpu", jp)), sup


@pytest.mark.parametrize("adjust_overlap", [False, True])
def test_process_frame_adjust_overlap(superseded, adjust_overlap):
    frames, jp, tp, _ = superseded
    want = JP1.process_frame(jnp.asarray(frames[1]), jp, adjust_overlap=adjust_overlap)
    got = P1.process_frame(frames[1], tp, adjust_overlap=adjust_overlap)
    _intensities(got.numpy(), want)


@pytest.mark.parametrize("route", ["gather", "projection"])
def test_supersession_is_an_index(superseded, route):
    """With supersession = without it indexed by ``superseded_by``, bit for
    bit, on K5's plan and on the per-camera projection."""
    frames, _, tp, sup = superseded
    if route == "projection":
        tp = dataclasses.replace(tp, gather=None)
    with_ = P1.process_frame(frames[1], tp)
    without = P1.process_frame(frames[1], tp, adjust_overlap=False)
    assert not np.array_equal(with_.numpy(), without.numpy(), equal_nan=True)
    np.testing.assert_array_equal(with_.numpy(), without.numpy()[sup])


# -- run_datapoint(_streaming)'s frame_batch and stage_clock --------------------


def _cfg(deck, out_dir, reader=t_read_input_deck):
    cfg = reader(deck)
    cfg.out_dir = out_dir
    return cfg


@pytest.fixture(scope="module")
def sub_pixel(tmp_path_factory):
    """The datapoint runs' datapoint: jitter under half a pixel.  On the CPU the
    JAX package takes the dense step without the integer pre-shift, the
    port the kernel route with it (the JAX package's route on its
    accelerator).  They are the same algebra only where the pre-shift is
    zero (with one, the reference blurs the zero-filled strip into the ECC
    statistics: ROADMAP.md queue 3), as in tests/test_torch_slice.py."""
    return write_datapoint(str(tmp_path_factory.mktemp("runs")), image_hw=(64, 96),
                           n_frames=N_FRAMES, n_distinct=N_FRAMES,
                           grid_shape=(21, 17), n_targets=3, seed=3, max_shift_px=0.4)


def test_run_datapoint_frame_batch(sub_pixel, tmp_path):
    dp = sub_pixel
    kw = dict(frame_batch=2, device_unpack=False)
    JR.run_datapoint(_cfg(dp["deck"], str(tmp_path / "jax"), read_input_deck), **kw)
    TR.run_datapoint(_cfg(dp["deck"], str(tmp_path / "port")), device="cpu", **kw)
    _intensities(read_flat(str(tmp_path / "port" / "intensity")),
                 read_flat(str(tmp_path / "jax" / "intensity")))


def test_streaming_frame_batch_and_stage_clock(sub_pixel, tmp_path):
    """``run_datapoint_streaming(frame_batch=2, stage_clock=StageClock())``:
    the intensities within bounds, the caller's clock given the JAX
    package's labels in its order, and ``stage_times`` its own keys."""
    dp = sub_pixel
    j_clock, t_clock, times = JT.StageClock(), TT.StageClock(), {}
    JR.run_datapoint_streaming(_cfg(dp["deck"], str(tmp_path / "jax"), read_input_deck),
                               frame_batch=2, stage_clock=j_clock, device_unpack=False)
    TR.run_datapoint_streaming(_cfg(dp["deck"], str(tmp_path / "port")), device="cpu",
                               frame_batch=2, stage_clock=t_clock, stage_times=times,
                               device_unpack=False)
    for name in ("intensity", "intensity_transpose"):
        _intensities(read_flat(str(tmp_path / "port" / name)),
                     read_flat(str(tmp_path / "jax" / name)))
    assert [r[0] for r in j_clock.records] == JAX_STREAM_LABELS
    assert [r[0] for r in t_clock.records] == JAX_STREAM_LABELS
    assert list(times) == ["phase0.walk", "phase0.walk_recheck", "phase0.walk_rechecked",
                           "phase0", "phase1_setup", "phase1", "disk_transpose",
                           "phase2", "outputs"]


# -- StageClock ------------------------------------------------------------------


@pytest.mark.parametrize("enabled", [True, False])
def test_stage_clock(monkeypatch, caplog, enabled):
    """The same points on the same clock readings give the same records,
    summary and log lines."""
    out = {}
    for name, mod in (("jax", JT), ("port", TT)):
        ticks = itertools.count(0.0, 0.25)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="upsp_tpu.timing"):
            clock = mod.StageClock(lambda: None, enabled)
            for label in ("phase0", "phase1", "phase2"):
                clock.point(label)
        out[name] = (clock.records, clock.summary(),
                     [r.getMessage() for r in caplog.records])
    assert out["port"] == out["jax"]
    assert len(out["port"][2]) == (3 if enabled else 0)
    assert TT.StageClock().enabled and TT.StageClock().records == []


def test_stage_clock_keeps_times():
    times = {}
    clock = TT.StageClock(barrier=lambda: None, enabled=False, times=times)
    clock.point("a")
    clock.split("b")
    clock.point("c")
    assert list(times) == ["a", "barrier", "b", "c"]
    assert [r[0] for r in clock.records] == ["a", "c"]
    assert times["c"] == clock.records[1][2]


# -- identity_warp -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, "bfloat16", "float64"])
def test_identity_warp(dtype):
    """``identity_warp()`` and ``identity_warp(dtype)`` as JAX's; the
    batched form by keyword."""
    got = R.identity_warp() if dtype is None else R.identity_warp(getattr(torch, dtype))
    want = J.identity_warp() if dtype is None else J.identity_warp(getattr(jnp, dtype))
    assert got.shape == want.shape == (2, 3)
    assert str(got.dtype) == f"torch.{want.dtype}"
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    batch = R.identity_warp(batch=3, device="cpu")
    assert batch.shape == (3, 2, 3) and batch.dtype == torch.float32
    np.testing.assert_array_equal(batch.numpy(), np.broadcast_to(want, (3, 2, 3)))


# -- CameraParams.camera_matrix, PatchOperator.empty -------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_camera_matrix(dtype):
    rng = np.random.default_rng(14)
    rmat = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    tvec = rng.normal(size=3)
    cm = np.array([[210.5, 0.0, 47.25], [0.0, 208.75, 31.5], [0.0, 0.0, 1.0]])
    dist = rng.normal(0, 1e-3, 5)
    want = JM.make_camera_params(rmat, tvec, cm, dist, getattr(jnp, dtype)).camera_matrix
    got = TM.make_camera_params(rmat, tvec, cm, dist, getattr(torch, dtype)).camera_matrix
    assert got.shape == (3, 3) and str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_clusters", [0, 2])
def test_patch_operator_empty(n_clusters):
    z = np.zeros((n_clusters, 1, 1), np.float32)
    i = np.zeros((n_clusters, 1), np.int64)
    want = JPa.PatchOperator(jnp.asarray(z), jnp.asarray(i), jnp.asarray(i), n_clusters)
    got = TPa.PatchOperator(torch.tensor(z), torch.tensor(i), torch.tensor(i), n_clusters)
    assert got.empty is want.empty is (n_clusters == 0)


# -- visible_targets, build_patcher_for_camera --------------------------------


def _names(targets):
    return [(t.name, tuple(np.asarray(t.uv).tolist())) for t in targets]


@pytest.mark.parametrize("cam", [0, 1])
def test_visible_targets_positional(scene, cam):
    """The JAX package's positional call on both; the port's without any
    BVH builds its own and sees the same targets."""
    dp, _, js, ts = scene
    cfg = ts.config
    targets = read_tgts(cfg.cameras[cam].targets)
    oblique = min(cfg.oblique_angle + 5.0, 90.0)
    want = J0.visible_targets(targets, js.cam_params[cam], js.bvh_dev, js.model,
                              oblique, js.image_hw, 4, js.bvh)
    got = P0.visible_targets(targets, ts.cam_params[cam], ts.bvh_dev, ts.model,
                             oblique, ts.image_hw, 4, ts.bvh)
    own = P0.visible_targets(targets, ts.cam_params[cam], None, ts.model, oblique,
                             ts.image_hw)
    assert want, "no target is visible: the case checks nothing"
    assert _names(got) == _names(want) == _names(own)


def test_build_patcher_positional(scene):
    """The JAX package's positional call (``bit_depth``, ``max_leaf``,
    ``flat_bvh`` last) on both; the port's with the defaults and no BVH
    gives the same patches."""
    dp, frames, js, ts = scene
    cfg = ts.config
    want_op, want_diag = J0.build_patcher_for_camera(
        cfg, js.cam_params[0], js.bvh_dev, js.model, frames[0, 0],
        cfg.cameras[0].targets, js.image_hw, 12, 4, js.bvh)
    for got_op, got_diag in (
        P0.build_patcher_for_camera(cfg, ts.cam_params[0], ts.bvh_dev, ts.model,
                                    frames[0, 0], cfg.cameras[0].targets,
                                    ts.image_hw, 12, 4, ts.bvh),
        P0.build_patcher_for_camera(cfg, ts.cam_params[0], None, ts.model,
                                    frames[0, 0], cfg.cameras[0].targets,
                                    ts.image_hw),
    ):
        assert want_op is not None and got_op.n_clusters == want_op.n_clusters
        np.testing.assert_array_equal(got_diag["uv"], want_diag["uv"])
        np.testing.assert_array_equal(got_diag["cluster_of"], want_diag["cluster_of"])
        assert got_diag["names"] == want_diag["names"]
        for name in ("M", "boundary_idx", "internal_idx"):
            np.testing.assert_array_equal(getattr(got_op, name).numpy(),
                                          np.asarray(getattr(want_op, name)))
