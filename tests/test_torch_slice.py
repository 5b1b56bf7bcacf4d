"""One whole datapoint through both packages: JAX ``run_datapoint`` against
the port's, on the CPU, from the same files on disk.

The datapoint (upsp_tpu_torch/pipeline/synthetic.py): 2 cameras, 96x128
12-bit ``.mraw`` videos with ``.cih`` headers, a 41x33 plate grid, camera
JSONs, fiducial targets, a ``.wtd``, a paint calibration and the deck.

The JAX package on the CPU runs its dense jnp ECC path without the integer
pre-shift; the port runs its kernel path with it.  The two are the same
algebra only while the pre-shift is zero (with a non-zero shift the
reference blurs the zero-filled strip into the ECC statistics; ROADMAP.md
queue 3), so this datapoint keeps its jitter under 0.45 px.  Tolerances,
from tests/test_pallas_ecc.py:491 (dense vs kernel path): intensities and
their frame statistics rtol 1e-4, atol 0.2 counts; quantities derived from
ratios of intensities (ratio_0, delta-Cp, its avg and rms) atol 5e-4,
which is 0.2 counts relative to ~2000; geometry, coverage, gain, steady
state and model temperature exactly.
"""

import json
import os
import shutil

import numpy as np
import pytest

from upsp_tpu.io.flatfile import FLAT_FILES, read_flat
from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu.pipeline.run import run_datapoint as j_run_datapoint
from upsp_tpu_torch.pipeline.run import run_datapoint
from upsp_tpu_torch.pipeline.synthetic import write_datapoint

INTENSITY = {"intensity", "intensity_transpose", "intensity_avg", "intensity_rms"}
RATIO = {"intensity_ratio_0", "pressure_transpose", "avg", "rms"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice"))
    dp = write_datapoint(root, n_frames=12, n_distinct=12, seed=1,
                         max_shift_px=0.4)
    cfg_j = read_input_deck(dp["deck"])
    cfg_j.out_dir = os.path.join(root, "out_jax")
    j = j_run_datapoint(cfg_j, device_unpack=False, registration_telemetry=True)
    t = run_datapoint(read_input_deck(dp["deck"]), device="cpu",
                      registration_telemetry=True)
    return cfg_j.out_dir, dp["out_dir"], j, t


def _tol(name):
    if name in INTENSITY:
        return dict(rtol=1e-4, atol=0.2)
    if name in RATIO:
        return dict(rtol=0, atol=5e-4)
    return dict(rtol=0, atol=0)


@pytest.mark.parametrize("name", FLAT_FILES)
def test_flat_file_matches(runs, name):
    jdir, tdir, _, _ = runs
    a = read_flat(os.path.join(jdir, name))
    b = read_flat(os.path.join(tdir, name))
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    v = np.isfinite(a)
    np.testing.assert_allclose(b[v], a[v], **_tol(name))


def test_phase2_outputs(runs):
    _, _, j, t = runs
    for key in ("pressure_transpose", "avg", "rms"):
        a = np.asarray(getattr(j.phase2, key), np.float32)
        b = getattr(t.phase2, key)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(b[np.isfinite(a)], a[np.isfinite(a)],
                                   atol=5e-4, rtol=0)
    assert np.isfinite(t.phase2.pressure_transpose).any()


def test_registration_telemetry(runs):
    jdir, tdir, _, _ = runs
    a = read_flat(os.path.join(jdir, "registration")).reshape(12, 2, 5)
    b = read_flat(os.path.join(tdir, "registration")).reshape(12, 2, 5)
    np.testing.assert_allclose(b[..., 0], a[..., 0], atol=1e-3)  # rho
    np.testing.assert_allclose(b[..., 1], a[..., 1], atol=1e-3)  # |drho|
    np.testing.assert_allclose(b[..., 2:4], a[..., 2:4], atol=0.05)
    # column 4: the dense JAX path records 0; the port records the bound
    assert (a[..., 4] == 0).all() and (b[..., 4] < 1.0).all()
    with open(os.path.join(jdir, "registration.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tdir, "registration.json")) as f:
        tm = json.load(f)
    # "band" differs by design: 3 px on the TPU kernels, none (null) here
    assert tm.pop("band") is None and jm.pop("band") == 3
    assert tm == jm


def test_hdf5_datasets(runs):
    h5py = pytest.importorskip("h5py")
    jdir, tdir, _, _ = runs
    with h5py.File(os.path.join(jdir, "output.h5")) as fj, \
            h5py.File(os.path.join(tdir, "output.h5")) as ft:
        names = []
        fj.visit(lambda n: names.append(n) if isinstance(fj[n], h5py.Dataset) else None)
        tnames = []
        ft.visit(lambda n: tnames.append(n) if isinstance(ft[n], h5py.Dataset) else None)
        assert sorted(names) == sorted(tnames)
        for n in names:
            a, b = np.asarray(fj[n][()]), np.asarray(ft[n][()])
            if a.dtype.kind == "f":
                leaf = n.split("/")[-1]
                tol = dict(atol=5e-4, rtol=0) if leaf in ("frames", "rms", "average") \
                    else dict(atol=0, rtol=0)
                np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=n)
                v = np.isfinite(a)
                np.testing.assert_allclose(b[v], a[v], err_msg=n, **tol)
            else:
                assert np.array_equal(a, b), n


@pytest.mark.parametrize("script", ["upsp-add-field", "upsp-xyz-scalar-to-tbl"])
def test_shared_script_reads_port_outputs(runs, tmp_path, script):
    """The scripts both packages share read the port's files as they read
    the JAX package's: ``upsp-add-field`` appends ``pressure_transpose`` to
    a copy of ``output.h5`` (the port's values exactly; against the JAX
    package's run within the ratio bound), ``upsp-xyz-scalar-to-tbl``
    tabulates X, Y, Z (exactly) and ``avg`` (ratio bound)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jdir, tdir, _, _ = runs
    out = {}
    for which, d in (("jax", jdir), ("port", tdir)):
        if script == "upsp-add-field":
            h5py = pytest.importorskip("h5py")
            dst = str(tmp_path / f"{which}.h5")
            shutil.copy(os.path.join(d, "output.h5"), dst)
            args = [dst, os.path.join(d, "pressure_transpose"), "--frames", "12",
                    "--block_nodes", "500"]
        else:
            dst = str(tmp_path / f"{which}.tbl")
            args = [f"--{a.lower()}={os.path.join(d, a)}" for a in "XYZ"]
            args += ["--scalar", os.path.join(d, "avg"), "--name", "avg", "--out", dst]
        r = subprocess.run([sys.executable, os.path.join(repo, "scripts", script), *args],
                           capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, PYTHONPATH=repo))
        assert r.returncode == 0, r.stderr[-3000:]
        if script == "upsp-add-field":
            with h5py.File(dst) as f:
                out[which] = (r.stdout, f["frames"][()])
        else:
            with open(dst) as fh:
                lines = fh.read().splitlines()
            rows = np.array([ln.split() for ln in lines[3:]], dtype=np.float64)
            out[which] = (r.stdout.replace(dst, ""), lines[:3], rows)
    assert out["port"][0] == out["jax"][0]
    if script == "upsp-add-field":
        got, want = out["port"][1], out["jax"][1]
        press = read_flat(os.path.join(tdir, "pressure_transpose")).reshape(got.shape)
        np.testing.assert_array_equal(got, press)
    else:
        assert out["port"][1] == out["jax"][1]
        np.testing.assert_array_equal(out["port"][2][:, :3], out["jax"][2][:, :3])
        got, want = out["port"][2][:, 3], out["jax"][2][:, 3]
        avg = read_flat(os.path.join(tdir, "avg"))
        np.testing.assert_array_equal(got, [float(f"{x:.7g}") for x in avg])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    v = np.isfinite(want)
    assert v.any()
    np.testing.assert_allclose(got[v], want[v], atol=5e-4, rtol=0)
