"""Packed on-device ingest, end to end on the CPU.

- A 12-bit ``.mraw`` datapoint with hot pixels: the port's
  ``run_datapoint`` with packed ingest (K7's plain twin) gives exactly what
  host decode and an in-memory frame array give (the same float32 frames
  reach the same frame program).
- A 10-bit packed ``.cine`` datapoint with hot pixels: the port (packed
  ingest, K8's plain twin with the 10->12-bit LUT) against the JAX
  ``run_datapoint`` on the same files (its packed path: the jnp unpacker
  and the LUT gather).  The JAX package on the CPU runs its dense ECC path
  without the integer pre-shift, so the jitter stays under 0.45 px, as in
  tests/test_torch_slice.py, whose tolerances hold here: intensities and
  their statistics rtol 1e-4, atol 0.2 counts; ratios and delta-Cp atol
  5e-4; everything else exactly.
"""

import os

import numpy as np
import pytest

from upsp_tpu.io.flatfile import FLAT_FILES, read_flat
from upsp_tpu.io.video import video_reader
from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu.pipeline.run import run_datapoint as j_run_datapoint
from upsp_tpu_torch.pipeline.run import packed_ingest_config, run_datapoint
from upsp_tpu_torch.pipeline.synthetic import write_datapoint

INTENSITY = {"intensity", "intensity_transpose", "intensity_avg", "intensity_rms"}
RATIO = {"intensity_ratio_0", "pressure_transpose", "avg", "rms"}


def _no_outputs(deck):
    cfg = read_input_deck(deck)
    cfg.out_dir = ""
    return cfg


def _readers(deck):
    rs = [video_reader(c.video) for c in read_input_deck(deck).cameras]
    for r in rs:
        r.open()
    return rs


@pytest.fixture(scope="module")
def mraw(tmp_path_factory):
    return write_datapoint(str(tmp_path_factory.mktemp("mraw")), image_hw=(64, 96),
                           n_frames=6, n_distinct=6, grid_shape=(21, 17),
                           n_targets=3, seed=3, hot_pixels=True)


def test_packed_ingest_equals_host_decode(mraw):
    cfg = read_input_deck(mraw["deck"])
    packed = run_datapoint(cfg, device="cpu", registration_telemetry=True)
    host = run_datapoint(_no_outputs(mraw["deck"]), device="cpu",
                         device_unpack=False)
    arr = run_datapoint(_no_outputs(mraw["deck"]), device="cpu",
                        frames_array=mraw["frames"])
    np.testing.assert_array_equal(packed.intensity, host.intensity)
    np.testing.assert_array_equal(packed.intensity, arr.intensity)
    assert np.isfinite(packed.intensity).all()
    # the hot pixels were written: frames 1-2 repairable, frame 3 not
    assert (mraw["frames"][1:4] == 4095).any(axis=(2, 3)).all()


def test_packed_ingest_config(mraw, tmp_path):
    cine = write_datapoint(str(tmp_path), image_hw=(64, 96), n_frames=2,
                           n_distinct=2, grid_shape=(21, 17), n_targets=3,
                           video_format="cine10")
    readers = _readers(mraw["deck"])
    cine_readers = _readers(cine["deck"])
    try:
        assert packed_ingest_config(readers, None, "auto") == (
            True, {"packed_bits": 12, "lut": None})
        assert packed_ingest_config(readers, None, False) == (False, {})
        assert packed_ingest_config(readers, mraw["frames"], "auto") == (False, {})
        mixed = readers[:1] + cine_readers[:1]
        assert packed_ingest_config(mixed, None, "auto") == (False, {})
        use, kw = packed_ingest_config(cine_readers, None, True)
        assert use and kw["packed_bits"] == 10 and kw["lut"].shape == (1024,)
    finally:
        for r in readers + cine_readers:
            r.close()


@pytest.fixture(scope="module")
def cine_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cine"))
    dp = write_datapoint(root, n_frames=8, n_distinct=8, seed=1, max_shift_px=0.4,
                         video_format="cine10", hot_pixels=True)
    cfg_j = read_input_deck(dp["deck"])
    cfg_j.out_dir = os.path.join(root, "out_jax")
    j = j_run_datapoint(cfg_j, device_unpack="auto", registration_telemetry=True)
    t = run_datapoint(read_input_deck(dp["deck"]), device="cpu",
                      registration_telemetry=True)
    return cfg_j.out_dir, dp, j, t


def _tol(name):
    if name in INTENSITY:
        return dict(rtol=1e-4, atol=0.2)
    if name in RATIO:
        return dict(rtol=0, atol=5e-4)
    return dict(rtol=0, atol=0)


@pytest.mark.parametrize("name", FLAT_FILES)
def test_cine10_flat_file_matches_jax(cine_runs, name):
    jdir, dp, _, _ = cine_runs
    a = read_flat(os.path.join(jdir, name))
    b = read_flat(os.path.join(dp["out_dir"], name))
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    v = np.isfinite(a)
    np.testing.assert_allclose(b[v], a[v], **_tol(name))


def test_cine10_frames_are_the_lut_values(cine_runs):
    """The datapoint's frames decode to the LUT's 12-bit values, and the
    packed run's intensities equal a run on those frames held in memory."""
    from upsp_tpu.io.video.cine import LUT_10_TO_12

    _, dp, _, t = cine_runs
    assert np.isin(dp["frames"], LUT_10_TO_12).all()
    arr = run_datapoint(_no_outputs(dp["deck"]), device="cpu",
                        frames_array=dp["frames"])
    np.testing.assert_array_equal(t.intensity, arr.intensity)
