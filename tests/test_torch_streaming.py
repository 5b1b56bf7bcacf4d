"""Out-of-core streaming: the port's ``run_datapoint_streaming`` against
JAX ``run_datapoint_streaming`` and against the port's in-memory run, on
the CPU, from the same files on disk.

The datapoint is test_torch_slice's (2 cameras, 96x128 12-bit ``.mraw``,
12 frames, a 41x33 grid, jitter under 0.45 px), run in chunks of 5 frames
and phase-2 blocks of 64 nodes, so chunks and blocks end short.

Tolerances:
- port against JAX streaming: test_torch_slice's table (intensities and
  their frame statistics rtol 1e-4, atol 0.2 counts; ratio-derived values
  atol 5e-4; geometry, coverage, gain, steady state, model temperature
  exactly).  Both take ``intensity_avg`` as the NaN-skipping sum over the
  frame count, where the in-memory path takes the mean;
- port streaming against the port in memory: tests/test_outputs.py's
  streaming bounds (``intensity_avg`` rtol 1e-5, atol 1e-3; phase-2 rms
  and ``pressure_transpose`` rtol 1e-4, atol 1e-6), since the chunks
  batch frames differently and phase 2 runs per node block;
- a callable frame source against the same frames as an array: bit for
  bit.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import upsp_tpu_torch.pipeline.run as t_run
from upsp_tpu.io.flatfile import FLAT_FILES, read_flat
from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu.pipeline.run import run_datapoint_streaming as j_streaming
from upsp_tpu_torch.pipeline.config import read_input_deck as t_read_input_deck
from upsp_tpu_torch.pipeline.run import run_datapoint, run_datapoint_streaming
from upsp_tpu_torch.pipeline.synthetic import write_datapoint

INTENSITY = {"intensity", "intensity_transpose", "intensity_avg", "intensity_rms"}
RATIO = {"intensity_ratio_0", "pressure_transpose", "avg", "rms"}
N_FRAMES, CHUNK, BLOCK = 12, 5, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(deck, out_dir, reader=t_read_input_deck):
    cfg = reader(deck)
    cfg.out_dir = out_dir
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX streaming, the port streaming (phase-2 block sizes recorded),
    the port in memory, and the port streaming from the frames as an
    array and as a callable source."""
    root = str(tmp_path_factory.mktemp("stream"))
    dp = write_datapoint(root, n_frames=N_FRAMES, n_distinct=N_FRAMES, seed=1,
                         max_shift_px=0.4)
    dirs = {k: os.path.join(root, f"out_{k}")
            for k in ("jax", "port", "array", "callable")}
    dirs["memory"] = dp["out_dir"]
    j_streaming(_cfg(dp["deck"], dirs["jax"], read_input_deck),
                frames_per_chunk=CHUNK, node_block=BLOCK, device_unpack=False)
    blocks = []
    convert = t_run.phase2_convert

    def recording(intensity_transpose, *args):
        blocks.append(tuple(intensity_transpose.shape))
        return convert(intensity_transpose, *args)

    t_run.phase2_convert = recording
    try:
        port = run_datapoint_streaming(_cfg(dp["deck"], dirs["port"]),
                                       device="cpu", frames_per_chunk=CHUNK,
                                       node_block=BLOCK)
    finally:
        t_run.phase2_convert = convert
    memory = run_datapoint(_cfg(dp["deck"], dirs["memory"]), device="cpu")
    frames = dp["frames"]
    run_datapoint_streaming(_cfg(dp["deck"], dirs["array"]), device="cpu",
                            frames_per_chunk=CHUNK, node_block=BLOCK,
                            frames_array=frames)
    cfg = _cfg(dp["deck"], dirs["callable"])
    cfg.frames = N_FRAMES
    calls = []

    def source(start, count):
        calls.append((start, count))
        return torch.from_numpy(frames[start : start + count])

    run_datapoint_streaming(cfg, device="cpu", frames_per_chunk=CHUNK,
                            node_block=BLOCK, frames_array=source)
    return dict(dp=dp, dirs=dirs, port=port, memory=memory, blocks=blocks,
                calls=calls)


def _tol(name):
    if name in INTENSITY:
        return dict(rtol=1e-4, atol=0.2)
    if name in RATIO:
        return dict(rtol=0, atol=5e-4)
    return dict(rtol=0, atol=0)


def _read(runs, which, name):
    return read_flat(os.path.join(runs["dirs"][which], name))


@pytest.mark.parametrize("name", FLAT_FILES)
def test_flat_file_matches_jax_streaming(runs, name):
    a, b = _read(runs, "jax", name), _read(runs, "port", name)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    v = np.isfinite(a)
    np.testing.assert_allclose(b[v], a[v], **_tol(name))


def test_hdf5_matches_jax_streaming(runs):
    h5py = pytest.importorskip("h5py")
    d = runs["dirs"]
    with h5py.File(os.path.join(d["jax"], "output.h5")) as fj, \
            h5py.File(os.path.join(d["port"], "output.h5")) as ft:
        assert ft["frames"].shape == (41 * 33, N_FRAMES)
        for name in ("frames", "rms", "average", "coverage"):
            a, b = fj[name][()], ft[name][()]
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
            v = np.isfinite(a)
            tol = dict(rtol=0, atol=0) if name == "coverage" else dict(rtol=0, atol=5e-4)
            np.testing.assert_allclose(b[v], a[v], err_msg=name, **tol)
        # the HDF5 frames are the pressure_transpose flat file
        press = _read(runs, "port", "pressure_transpose").reshape(-1, N_FRAMES)
        np.testing.assert_array_equal(ft["frames"][()], press)


def test_streaming_matches_in_memory(runs):
    """tests/test_outputs.py::test_streaming_matches_in_memory's bounds."""
    s, m = runs["port"], runs["memory"]
    assert s.intensity is None and s.phase2.pressure_transpose is None
    np.testing.assert_allclose(s.intensity_avg, m.intensity_avg, rtol=1e-5,
                               atol=1e-3, equal_nan=True)
    np.testing.assert_allclose(s.phase2.rms, m.phase2.rms, rtol=1e-4, atol=1e-6,
                               equal_nan=True)
    mem = m.phase2.pressure_transpose.ravel()
    ok = np.isfinite(mem)
    disk = _read(runs, "port", "pressure_transpose")
    np.testing.assert_array_equal(np.isnan(disk), ~ok)
    np.testing.assert_allclose(disk[ok], mem[ok], rtol=1e-4, atol=1e-6)
    h5py = pytest.importorskip("h5py")
    with h5py.File(os.path.join(runs["dirs"]["port"], "output.h5")) as fh:
        np.testing.assert_allclose(fh["frames"][()].ravel()[ok], mem[ok],
                                   rtol=1e-4, atol=1e-6)
        for name in ("rms", "average", "coverage"):
            assert name in fh


def test_callable_source_matches_array(runs):
    """A callable source gives the same files as the same frames given as
    an array, bit for bit; it is asked for chunk by chunk."""
    assert runs["calls"][0] == (0, 1)  # phase 0's first frames
    assert runs["calls"][1:] == [(0, 5), (5, 5), (10, 2)]
    for name in FLAT_FILES:
        a, b = _read(runs, "array", name), _read(runs, "callable", name)
        assert a.tobytes() == b.tobytes(), name


def test_phase2_sees_node_blocks(runs):
    """Phase 2 converts blocks of at most ``node_block`` nodes, in order,
    covering every node once."""
    rows = [r for r, _ in runs["blocks"]]
    assert max(rows) <= BLOCK and sum(rows) == 41 * 33
    assert all(f == N_FRAMES for _, f in runs["blocks"])
    assert rows[:-1] == [BLOCK] * (len(rows) - 1)


@pytest.mark.parametrize("missing", ["paint_cal", "sds"])
def test_streaming_requires_phase2_inputs(runs, tmp_path, missing):
    cfg = _cfg(runs["dp"]["deck"], str(tmp_path / "out"))
    setattr(cfg, missing, "")
    with pytest.raises(ValueError, match="paint calibration"):
        run_datapoint_streaming(cfg, device="cpu")


def test_resume_skips_phase1(runs, tmp_path, monkeypatch):
    """``resume`` reuses the ``intensity`` file of an earlier run and gives
    its outputs without running phase 1."""
    out = str(tmp_path / "out")
    shutil.copytree(runs["dirs"]["memory"], out)
    before = {n: read_flat(os.path.join(out, n)) for n in FLAT_FILES}

    def no_phase1(*args, **kwargs):
        raise AssertionError("phase 1 ran")

    monkeypatch.setattr(t_run, "make_chunk_processor", no_phase1)
    res = run_datapoint(_cfg(runs["dp"]["deck"], out), device="cpu", resume=True)
    np.testing.assert_array_equal(res.intensity, before["intensity"].reshape(
        N_FRAMES, -1))
    for name in FLAT_FILES:
        assert read_flat(os.path.join(out, name)).tobytes() == \
            before[name].tobytes(), name


def test_run_datapoint_callable_source(runs):
    """The in-memory path takes the same callable source, with the same
    intensities as the frames given as an array."""
    frames = runs["dp"]["frames"]
    cfg = _cfg(runs["dp"]["deck"], "")
    cfg.frames = N_FRAMES
    got = run_datapoint(cfg, device="cpu", frames_per_chunk=CHUNK,
                        frames_array=lambda s, n: torch.from_numpy(frames[s : s + n]))
    want = run_datapoint(_cfg(runs["dp"]["deck"], ""), device="cpu",
                         frames_per_chunk=CHUNK, frames_array=frames)
    assert got.intensity.tobytes() == want.intensity.tobytes()


def test_write_outputs_false_writes_nothing(runs, tmp_path):
    out = tmp_path / "out"
    res = run_datapoint(_cfg(runs["dp"]["deck"], str(out)), device="cpu",
                        write_outputs=False, registration_telemetry=True)
    assert res.intensity.shape == (N_FRAMES, 41 * 33)
    assert not out.exists() or not any(out.iterdir())


def test_cli_streaming_on_cpu(tmp_path):
    dp = write_datapoint(str(tmp_path), image_hw=(64, 96), n_frames=3,
                         n_distinct=3, grid_shape=(21, 17), n_targets=3, seed=4)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "upsp-process-torch"),
         "-input_deck", dp["deck"], "--streaming", "--device", "cpu",
         "--frames-per-chunk", "2"],
        capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "processed 3 frames, 357 nodes" in r.stdout
    for name in FLAT_FILES:
        path = os.path.join(dp["out_dir"], name)
        assert os.path.getsize(path) == 4 * 357 * (
            3 if "transpose" in name or name == "intensity" else 1), name
