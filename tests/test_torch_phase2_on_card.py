"""Phase 2 from one device's rows (``pipeline/run.py`` ``_DeviceRows`` and
``_finish_on_device``), on the CPU.

Each chunk's rows stay on the device, and phase 2 takes its f64
statistics (``_node_statistics``, the mesh route's) and delta-Cp from
there; ``resume`` uploads the intensity file's rows and runs the same
body.  Here the body runs on CPU tensors, driven directly and through
``run_datapoint``, against a host reference (the f64 statistics in numpy,
the matrix transposed on the host and converted by ``run_phase2``):

- ``intensity`` bit for bit;
- ``intensity_avg``, ``intensity_rms`` and ``intensity_ratio_0`` within
  one f32 ulp (the f64 sums run in another order), NaN where a frame is
  NaN;
- delta-Cp, its ``avg`` and ``rms`` and the ``gain`` within one f32 ulp,
  and bit for bit on every node whose ``intensity_avg`` agrees;
- ``coverage``, ``steady_state`` and ``model_temp`` equal;
- two datapoints in a row return arrays of their own;
- ``resume`` gives the run's outputs bit for bit;
- every flat file within the JAX package's bounds of the JAX package's
  ``run_datapoint`` on the same deck (identity starts on both).

The card's own run (page-locked copies on a side stream, the counters of
its bus traffic) is ``tests/test_torch_phase2_card.py``.
"""

import os

import numpy as np
import pytest
import torch

from upsp_tpu_torch.io.flatfile import FLAT_FILES, read_flat
from upsp_tpu_torch.pipeline import run as R
from upsp_tpu_torch.pipeline.config import read_input_deck
from upsp_tpu_torch.pipeline.phase0 import run_phase0
from upsp_tpu_torch.pipeline.phase2 import Phase2Outputs
from upsp_tpu_torch.pipeline.synthetic import write_datapoint
from upsp_tpu_torch.utils import timing

N_FRAMES, CHUNK = 12, 5
NAN_AT = ((0, 7), (5, 40), (11, 40), (3, 101))  # (frame, node): frame 0 too
INTENSITY = {"intensity", "intensity_transpose", "intensity_avg", "intensity_rms"}
RATIO = {"intensity_ratio_0", "pressure_transpose", "avg", "rms"}


def within_ulp(got, want):
    """Equal NaN positions, and every other value within one f32 ulp."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    ulp = np.spacing(np.maximum(np.abs(got[ok]), np.abs(want[ok])))
    assert (np.abs(got[ok] - want[ok]) <= ulp).all()


def host_reference(cfg, state, intensity: np.ndarray) -> dict:
    """Statistics, coverage and phase 2 of an (F, N) host matrix: the f64
    moments in numpy (psp_process.cpp:1725-1730), the matrix transposed on
    the host and converted by ``run_phase2`` on the state's device."""
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = intensity.mean(axis=0, dtype=np.float64).astype(np.float32)
        rms = np.sqrt(np.einsum("fn,fn->n", intensity, intensity, dtype=np.float64)
                      / intensity.shape[0]).astype(np.float32)
        ratio0 = avg / intensity[0] - 1.0
    cov = (R.proj_coverage(state.projections, *state.image_hw)
           [state.superseded_by]).cpu().numpy()
    dev = state.device
    phase2 = R.run_phase2(
        cfg, *(torch.as_tensor(a, device=dev)
               for a in (np.ascontiguousarray(intensity.T), avg, cov)),
        *R._phase2_conditions(cfg), model=state.model)
    return dict(intensity_avg=avg, intensity_rms=rms, intensity_ratio_0=ratio0,
                coverage=cov, phase2=Phase2Outputs(*(
                    None if v is None else v.cpu().numpy() for v in phase2)))


@pytest.fixture(scope="module")
def datapoint(tmp_path_factory):
    """(deck, cfg, Phase0State, an (F, N) intensity with NaN frames)."""
    root = str(tmp_path_factory.mktemp("on_card"))
    dp = write_datapoint(root, n_frames=N_FRAMES, n_distinct=N_FRAMES, seed=5,
                         max_shift_px=1.0)
    cfg = read_input_deck(dp["deck"])
    frames = dp["frames"]
    state = run_phase0(cfg, [frames[0, c] for c in range(frames.shape[1])],
                       [12] * frames.shape[1], device="cpu")
    rng = np.random.default_rng(5)
    base = rng.uniform(1500.0, 3000.0, state.n_nodes)
    intensity = (base * (1.0 + 0.02 * rng.standard_normal((N_FRAMES, state.n_nodes)))
                 ).astype(np.float32)
    for f, n in NAN_AT:
        intensity[f, n] = np.nan
    return dp["deck"], cfg, state, intensity


def on_device(cfg, state, intensity, write_outputs=False):
    """``intensity`` through ``_DeviceRows`` on CPU tensors in chunks, as
    phase 1 hands them over, then ``_finish_on_device``."""
    rows = R._DeviceRows(intensity.shape[0], intensity.shape[1], state.n_cameras,
                         torch.device("cpu"))
    for s in range(0, intensity.shape[0], CHUNK):
        out = torch.from_numpy(intensity[s : s + CHUNK].copy())
        rows.add(s, out, torch.zeros((out.shape[0], state.n_cameras, 5)))
    return R._finish_on_device(cfg, state, rows, write_outputs=write_outputs)


def with_out_dir(deck, out_dir, reader=read_input_deck):
    cfg = reader(deck)
    cfg.out_dir = out_dir
    return cfg


@pytest.fixture(scope="module")
def routes(datapoint, tmp_path_factory):
    """{"card": (DatapointOutputs, its output directory), "host": the
    host reference's arrays}."""
    deck, cfg, state, intensity = datapoint
    d = str(tmp_path_factory.mktemp("card"))
    res = on_device(with_out_dir(deck, d), state, intensity, write_outputs=True)
    return {"card": (res, d), "host": host_reference(cfg, state, intensity.copy())}


def test_intensity_bit_for_bit(routes, datapoint):
    card = routes["card"][0]
    np.testing.assert_array_equal(card.intensity, datapoint[3])
    assert card.n_frames == N_FRAMES


@pytest.mark.parametrize("name", ["intensity_avg", "intensity_rms", "intensity_ratio_0"])
def test_statistics_within_one_ulp(routes, name):
    got = read_flat(os.path.join(routes["card"][1], name))
    within_ulp(got, routes["host"][name])
    nan_nodes = sorted({n for _, n in NAN_AT})
    assert np.isnan(got[nan_nodes]).all()  # a NaN frame, also one after frame 0
    if name != "intensity_ratio_0":
        res = routes["card"][0]
        np.testing.assert_array_equal(
            got, res.intensity_avg if name == "intensity_avg" else res.intensity_rms)


@pytest.mark.parametrize("field", ["pressure_transpose", "avg", "rms", "gain"])
def test_phase2_within_one_ulp(routes, field):
    card, host = routes["card"][0], routes["host"]
    got, want = getattr(card.phase2, field), getattr(host["phase2"], field)
    within_ulp(got, want)
    agree = (card.intensity_avg == host["intensity_avg"]) | (
        np.isnan(card.intensity_avg) & np.isnan(host["intensity_avg"]))
    assert agree.mean() > 0.9
    np.testing.assert_array_equal(got[agree], want[agree])


@pytest.mark.parametrize("field", ["coverage", "steady_state", "model_temp"])
def test_node_vectors_equal(routes, field):
    card, host = routes["card"][0], routes["host"]
    if field == "coverage":
        got, want = card.coverage, host["coverage"]
    else:
        got, want = getattr(card.phase2, field), getattr(host["phase2"], field)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["intensity", "intensity_transpose",
                                  "pressure_transpose", "coverage", "avg", "rms"])
def test_files_within_one_ulp(routes, datapoint, name):
    """The flat files against the host reference (the intensity's bit for
    bit)."""
    got = read_flat(os.path.join(routes["card"][1], name))
    host, intensity = routes["host"], datapoint[3]
    want = {"intensity": intensity, "intensity_transpose": intensity.T,
            "coverage": host["coverage"]}.get(name)
    if want is None:
        want = getattr(host["phase2"], name)
    want = np.ravel(want)
    if name.startswith("intensity"):
        np.testing.assert_array_equal(got, want)
    within_ulp(got, want)


def test_two_datapoints_keep_their_arrays(datapoint):
    _, cfg, state, intensity = datapoint
    first = on_device(cfg, state, intensity)
    kept = _arrays_copy(first)
    second = on_device(cfg, state, intensity * np.float32(1.25))
    for k, v in _arrays(first).items():
        np.testing.assert_array_equal(v, kept[k])
        assert not np.shares_memory(v, _arrays(second)[k]), k
    np.testing.assert_array_equal(second.intensity, intensity * np.float32(1.25))


def _arrays(res):
    out = {"intensity": res.intensity, "intensity_avg": res.intensity_avg,
           "intensity_rms": res.intensity_rms, "coverage": res.coverage}
    out.update({f"phase2.{k}": v for k, v in res.phase2._asdict().items()})
    return out


def _arrays_copy(res):
    return {k: np.array(v, copy=True) for k, v in _arrays(res).items()}


# -- through run_datapoint ------------------------------------------------------


@pytest.fixture(scope="module")
def datapoints(datapoint):
    """run_datapoint on the CPU twice, under one recording: (recording,
    [(DatapointOutputs, its arrays copied)] x 2)."""
    deck = datapoint[0]
    res = []
    with timing.recording() as rec:
        for _ in range(2):
            got = R.run_datapoint(read_input_deck(deck), device="cpu",
                                  write_outputs=False, frames_per_chunk=CHUNK)
            res.append((got, _arrays_copy(got)))
    return rec, res


def test_phase2_spans(datapoints):
    rec, _ = datapoints
    names = {s.name for s in rec.spans}
    assert {"phase2.stats", "phase2.coverage", "phase2.device",
            "phase2.download"} <= names
    assert not {"phase2.host_stats", "phase2.upload"} & names
    for dp in rec.datapoints():
        assert len(rec.of(dp, "phase1.fetch")) == 1  # the telemetry, once
        assert len(rec.of(dp, "phase1.store")) == -(-N_FRAMES // CHUNK)


def test_run_datapoint_matches_host_reference(datapoints, datapoint):
    (got, _), _ = datapoints[1]
    cfg = read_input_deck(datapoint[0])
    host = host_reference(cfg, got.state, got.intensity.copy())
    for name in ("intensity_avg", "intensity_rms"):
        within_ulp(getattr(got, name), host[name])
    for field in ("pressure_transpose", "avg", "rms", "gain"):
        within_ulp(getattr(got.phase2, field), getattr(host["phase2"], field))
    np.testing.assert_array_equal(got.coverage, host["coverage"])


def test_run_datapoint_outputs_kept(datapoints):
    """The first datapoint's arrays are its own after the second ran."""
    (first, kept), (second, _) = datapoints[1]
    for k, v in _arrays(first).items():
        np.testing.assert_array_equal(v, kept[k])
        assert not np.shares_memory(v, _arrays(second)[k]), k


def test_resume_runs_the_same_phase2(datapoint, tmp_path, monkeypatch):
    """``resume`` uploads the intensity file's rows and gives the run's
    outputs bit for bit, with phase 1 skipped."""
    deck = datapoint[0]
    first = R.run_datapoint(with_out_dir(deck, str(tmp_path)), device="cpu",
                            frames_per_chunk=CHUNK)
    def no_phase1(*args, **kwargs):
        raise AssertionError("phase 1 ran")

    monkeypatch.setattr(R, "make_chunk_processor", no_phase1)
    with timing.recording() as rec:
        again = R.run_datapoint(with_out_dir(deck, str(tmp_path)), device="cpu",
                                resume=True)
    dp, = rec.datapoints()
    assert not rec.of(dp, "phase1.store")
    assert rec.of(dp, "phase2.stats")
    for k, v in _arrays(again).items():
        np.testing.assert_array_equal(v, _arrays(first)[k], err_msg=k)


# -- against the JAX package ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(datapoint, tmp_path_factory):
    """The port's and the JAX package's ``run_datapoint`` on the same deck
    with identity starts: {"port", "jax"}: output directory.  The JAX
    package is imported here alone, since tests/test_torch_phase2_card.py
    imports this module on the card, where it runs without it."""
    from upsp_tpu.pipeline.config import read_input_deck as j_read_input_deck
    from upsp_tpu.pipeline.run import run_datapoint as j_run_datapoint

    deck = datapoint[0]
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("port", "jax")}
    R.run_datapoint(with_out_dir(deck, dirs["port"]), device="cpu",
                    warm_start=False, frames_per_chunk=CHUNK)
    j_run_datapoint(with_out_dir(deck, dirs["jax"], j_read_input_deck),
                    warm_start=False, frames_per_chunk=CHUNK)
    return dirs


@pytest.mark.parametrize("name", FLAT_FILES)
def test_flat_file_matches_jax(jax_runs, name):
    """The bounds of tests/test_torch_run_modes.py for the intensities
    (rtol 1e-4, atol 0.2), 5e-4 on ratios and delta-Cp, and equal
    elsewhere."""
    got, want = (read_flat(os.path.join(jax_runs[k], name)) for k in ("port", "jax"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    tol = (dict(rtol=1e-4, atol=0.2) if name in INTENSITY else
           dict(rtol=0, atol=5e-4) if name in RATIO else dict(rtol=0, atol=0))
    v = np.isfinite(want)
    np.testing.assert_allclose(got[v], want[v], **tol)
