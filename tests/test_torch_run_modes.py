"""Reference-parity datapoints: the port's ``run_datapoint`` and
``run_datapoint_streaming`` with ``warm_start=False`` (identity starts,
the while-loop ECC) against the JAX package's ``run_datapoint`` with the
same start, on the CPU, from the same files on disk; and the
registration-telemetry sidecar, readers and report against the JAX
package's.

The datapoint: 2 cameras, 96x128 12-bit ``.mraw``, 8 frames jittered by
up to 2 px, a 41x33 grid, run in chunks of 5 frames so a chunk ends
short.  Tolerances follow tests/test_pallas_ecc.py:514-520: intensities
rtol 1e-4, atol 0.2; rho atol 1e-3; translations atol 0.05 px; iteration
counts within one on every frame-camera and equal on most (printed).
Streaming against in memory (the same chunks): intensities bit for bit.
"""

import json
import os

import numpy as np
import pytest

from upsp_tpu.io.flatfile import read_flat
from upsp_tpu.pipeline import diagnostics as JD
from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu.pipeline.run import run_datapoint as j_run_datapoint
from upsp_tpu_torch.pipeline import diagnostics as TD
from upsp_tpu_torch.pipeline.config import read_input_deck as t_read_input_deck
from upsp_tpu_torch.pipeline.run import run_datapoint, run_datapoint_streaming
from upsp_tpu_torch.pipeline.synthetic import write_datapoint

N_FRAMES, CHUNK = 8, 5


def _cfg(deck, out_dir, reader=t_read_input_deck):
    cfg = reader(deck)
    cfg.out_dir = out_dir
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("modes"))
    dp = write_datapoint(root, n_frames=N_FRAMES, n_distinct=N_FRAMES, seed=2,
                         max_shift_px=2.0)
    dirs = {k: os.path.join(root, f"out_{k}") for k in ("jax", "port", "stream")}
    j_run_datapoint(_cfg(dp["deck"], dirs["jax"], read_input_deck), warm_start=False,
                    registration_telemetry=True, frames_per_chunk=CHUNK)
    run_datapoint(_cfg(dp["deck"], dirs["port"]), device="cpu", warm_start=False,
                  registration_telemetry=True, frames_per_chunk=CHUNK)
    run_datapoint_streaming(_cfg(dp["deck"], dirs["stream"]), device="cpu",
                            warm_start=False, frames_per_chunk=CHUNK)
    return dirs


def _read(d, name):
    return read_flat(os.path.join(d, name))


def test_intensity_matches_jax(runs):
    got, want = _read(runs["port"], "intensity"), _read(runs["jax"], "intensity")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    v = np.isfinite(want)
    np.testing.assert_allclose(got[v], want[v], rtol=1e-4, atol=0.2)


def test_streaming_matches_in_memory(runs):
    """Out of core, the same chunks give the in-memory intensities bit for
    bit, so the JAX package's within its bounds too."""
    got = _read(runs["stream"], "intensity")
    np.testing.assert_array_equal(got, _read(runs["port"], "intensity"))
    want = _read(runs["jax"], "intensity")
    v = np.isfinite(want)
    np.testing.assert_allclose(got[v], want[v], rtol=1e-4, atol=0.2)
    for name in ("intensity_avg", "intensity_rms"):
        np.testing.assert_allclose(_read(runs["stream"], name), _read(runs["port"], name),
                                   rtol=1e-5, atol=1e-3)


def test_telemetry_matches_jax(runs):
    path = os.path.join(runs["port"], "registration")
    meta = TD.read_registration_meta(path)
    assert meta["conv_semantics"] == "iters" and meta["columns"][1] == "iters"
    assert meta["band"] is None
    with open(os.path.join(runs["jax"], "registration.json")) as fh:
        j_meta = json.load(fh)
    assert {k: v for k, v in meta.items() if k != "band"} == {
        k: v for k, v in j_meta.items() if k != "band"}
    tele = TD.read_registration_telemetry(path, 2)
    j_tele = JD.read_registration_telemetry(os.path.join(runs["jax"], "registration"), 2)
    np.testing.assert_array_equal(tele, JD.read_registration_telemetry(path, 2))
    assert tele.shape == j_tele.shape == (N_FRAMES, 2, 5)
    n, jn = tele[..., 1], j_tele[..., 1]
    assert (n == np.rint(n)).all() and n.min() >= 1 and n.max() <= 50
    differ = int((n != jn).sum())
    print(f"iteration counts differ on {differ} of {n.size} frame-cameras "
          f"(port {n.ravel().tolist()}, JAX {jn.ravel().tolist()})")
    assert np.abs(n - jn).max() <= 1 and differ <= n.size // 4
    np.testing.assert_allclose(tele[..., 0], j_tele[..., 0], atol=1e-3)
    np.testing.assert_allclose(tele[..., 2:4], j_tele[..., 2:4], atol=0.05)
    assert (tele[..., 4] == 0).all() and (j_tele[..., 4] == 0).all()


def test_report_matches_jax(runs):
    """The report on the run's telemetry is the JAX package's on the same
    telemetry; so is a "drho" report on fixed-step telemetry whose bounds
    stay inside the JAX package's 3 px band.  Beyond it the port counts no
    band violation (it has no band)."""
    tele = TD.read_registration_telemetry(os.path.join(runs["port"], "registration"), 2)
    assert (TD.analyze_registration_telemetry(tele)
            == JD.analyze_registration_telemetry(tele))
    rng = np.random.default_rng(6)
    fixed = np.concatenate([rng.uniform(0.95, 1.0, (40, 2, 1)),
                            rng.uniform(0.0, 2e-3, (40, 2, 1)),
                            rng.uniform(-1.0, 1.0, (40, 2, 2)),
                            rng.uniform(0.0, 2.5, (40, 2, 1))], axis=2)
    kw = dict(conv_semantics="drho")
    assert (TD.analyze_registration_telemetry(fixed, **kw)
            == JD.analyze_registration_telemetry(fixed, **kw))
    fixed[:3, :, 4] = 4.0
    assert JD.analyze_registration_telemetry(fixed, **kw)["cameras"][0][
        "band_violations"] == 3
    assert all(c["band_violations"] == 0 for c in
               TD.analyze_registration_telemetry(fixed, **kw)["cameras"])
    with pytest.raises(ValueError, match="conv_semantics"):
        TD.analyze_registration_telemetry(fixed, conv_semantics="steps")


def test_meta_reader_defaults(tmp_path):
    """Without a sidecar both readers assume the while-loop contract."""
    path = str(tmp_path / "registration")
    assert TD.read_registration_meta(path) == JD.read_registration_meta(path)
    TD.write_registration_meta(str(tmp_path), "drho", ecc_iters=2)
    os.makedirs(tmp_path / "j")
    JD.write_registration_meta(str(tmp_path / "j"), "drho", ecc_iters=2)
    got = TD.read_registration_meta(path)
    want = JD.read_registration_meta(str(tmp_path / "j" / "registration"))
    assert got["band"] is None and want["band"] == 3
    assert {k: v for k, v in got.items() if k != "band"} == {
        k: v for k, v in want.items() if k != "band"}
