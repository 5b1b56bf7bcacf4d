"""The port's host-side entry points against the JAX package's scripts on the
same inputs, and the parity helpers with no caller in an entry point.

Entry points (each script run as a process; the JAX scripts under
``JAX_PLATFORMS=cpu``):
- ``upsp-make-processing-tree-torch``: the same tree byte for byte but for
  the launchers' script names, the generator strings and the date; the
  launchers run the port's scripts (the ``psp_process`` one is run against
  a stand-in script on ``PATH``), and the other two pass flags their
  scripts do not take, as the JAX package's do;
- ``upsp-kulite-comparison-torch``: the same CSV and selection-area images
  byte for byte, inputs built as tests/test_psd_kulites.py builds them;
- ``upsp-extract-frames-torch``: the same PNG pixels and frame count, from
  12-bit ``.mraw`` and 10-bit ``.cine``;
- ``upsp-plotting-torch``: the same rendered pixels and miniwall HTML.

Helpers: ``polyfit.monomial_coeffs`` (tests/test_torch_ops.py's detrend
bound, 1e-6 relative), ``fftreg.make_phase_correlator`` (its correlate
bound, 2e-3 px), ``timing.trace`` and ``timing.device_barrier`` on the CPU.
"""

import csv
import json
import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vendored import write_kulite_info

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _script(name, *args):
    """Run ``scripts/name`` with ``args``; JAX's scripts on the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, os.path.join(SCRIPTS, name), *map(str, args)],
                          capture_output=True, text=True, env=env, timeout=180)


def _ran(r):
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# ---------------------------------------------------------------------------
# the processing tree

TREE_DPS = {
    "3000101": {"run": 30001, "sequence": 1, "grid": "/g/a.grid",
                "camera_videos": ["/v/300010101.mraw", "/v/300010102.mraw"],
                "camera_calibrations": ["/c/cam01.json", "/c/cam02.json"],
                "targets": "/t/a.tgts", "sds": "/w/a.wtd",
                "paint_calibration": "/p/paint.cal"},
    "3000201": {"run": 30002, "sequence": 1, "grid": "/g/b_fine.grid",
                "camera_videos": ["/v/300020101.mraw"]},
}
TREE_PROC = {"processing": {"psp_process": {
    "filter": "gaussian", "filter_size": 3, "oblique_angle": 70,
    "__overlays__": [{"__regex__": {"grid": "fine"}, "filter_size": 5}]}}}
# the JAX package's launcher scripts against the port's
PORT_SCRIPTS = {"upsp-extract-frames": "upsp-extract-frames-torch",
                "upsp-external-calibration": "upsp-external-calibration-torch",
                "upsp-process": "upsp-process-torch"}


def _tree_configs(tmp, nas):
    paths = {}
    user = {"nas": {"qsub_args": {"q": "normal", "W": "group_list=a1"}}} if nas else {}
    for name, cfg in (("data", {"datapoints": TREE_DPS}), ("user", user),
                      ("proc", TREE_PROC), ("plot", {"plotting": {"fields": ["rms"]}})):
        paths[name] = tmp / f"{name}.json"
        paths[name].write_text(json.dumps(cfg))
    return paths


def _normalised(name, data):
    """A port tree file as the JAX package would write it: the JAX script
    names, the JAX generator strings, and the date left out."""
    if name.startswith("03_launchers") or name in ("qsub-step", "context.json"):
        text = data.decode()
        for j, t in PORT_SCRIPTS.items():
            text = text.replace(f" {t} ", f" {j} ")
        text = text.replace("generated by upsp_tpu_torch", "generated by upsp_tpu")
        text = text.replace('"generator": "upsp_tpu_torch"', '"generator": "upsp_tpu"')
        return re.sub(r'"__date__": "[^"]*"', '"__date__": ""', text).encode()
    return data


@pytest.mark.parametrize("nas", [False, True], ids=["plain", "qsub"])
def test_tree_matches_jax(tmp_path, nas):
    """Both scripts build their tree at the same path in turn (the path is
    written into the decks, launchers and context.json)."""
    paths = _tree_configs(tmp_path, nas)
    root = tmp_path / "tree"
    trees = {}
    for script in ("upsp-make-processing-tree", "upsp-make-processing-tree-torch"):
        r = _ran(_script(script, root, "--data", paths["data"], "--user", paths["user"],
                         "--proc", paths["proc"], "--plot", paths["plot"]))
        assert r.stdout.strip() == f"created processing tree at {root}"
        trees[script] = _files(root)
        shutil.rmtree(root)
    want, got = trees["upsp-make-processing-tree"], trees["upsp-make-processing-tree-torch"]
    assert sorted(got) == sorted(want)
    assert ("qsub-step" in got) == nas
    assert len(got) == 3 + 3 + 2 + 1 + nas  # configs, launchers, decks, context
    for name in want:
        assert _normalised(name, got[name]) == _normalised(name, want[name]), name
        if name.startswith("03_launchers"):
            assert b"-torch" in got[name] and b"upsp_tpu_torch" in got[name], name
    ctx = json.loads(got["context.json"])
    assert ctx["__meta__"]["generator"] == "upsp_tpu_torch"
    assert ctx["processing"]["3000201"]["psp_process"]["filter_size"] == 5


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    from upsp_tpu_torch.processing.tree import create

    tmp = tmp_path_factory.mktemp("port_tree")
    paths = _tree_configs(tmp, nas=False)
    return create(str(tmp / "tree"), *(str(paths[k]) for k in ("data", "user", "proc")))


@pytest.mark.parametrize("step,script", [
    ("extract-first-frame", "upsp-extract-frames-torch"),
    ("external-calibration", "upsp-external-calibration-torch"),
    ("psp_process", "upsp-process-torch"),
])
def test_tree_launcher_runs_its_script(port_tree, tmp_path, step, script):
    """Each launcher calls the port's script with ``--datapoint DP --root
    TREE``, for every datapoint or the ones it is given (a stand-in script
    of that name on ``PATH`` records its arguments).  Only
    ``upsp-process-torch`` takes those flags: the other two scripts refuse
    them, as in the JAX package (ROADMAP queue 3)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "calls"
    stub = bin_dir / script
    stub.write_text(f'#!/bin/sh\necho "$@" >> "{log}"\n')
    stub.chmod(0o755)
    launcher = os.path.join(port_tree, "03_launchers", f"step+{step}")
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    for args, dps in (([], list(TREE_DPS)), (["3000201"], ["3000201"])):
        log.write_text("")
        r = subprocess.run([launcher, *args], capture_output=True, text=True, env=env,
                           timeout=60)
        assert r.returncode == 0, r.stderr
        assert log.read_text().splitlines() == [
            f"--datapoint {dp} --root {port_tree}" for dp in dps]
    r = _script(script, "--datapoint", "3000101", "--root", port_tree, "--device", "cpu")
    if step == "psp_process":
        # tree mode reaches the datapoint's deck (whose inputs do not exist)
        assert "--datapoint" not in r.stderr and "unrecognized" not in r.stderr
        assert "/v/300010101.mraw" in r.stderr or "No such file" in r.stderr, r.stderr
    else:
        assert r.returncode == 2 and "the following arguments are required" in r.stderr


# ---------------------------------------------------------------------------
# kulite comparison


@pytest.fixture(scope="module")
def kulite_inputs(tmp_path_factory):
    """tests/test_psd_kulites.py's inputs: a plate grid, a tgts file with
    kulites at two mid-plate vertices, a (N, 16) pressure_transpose, the
    phase-0 diagnostics of a one-camera state, and kulite DAQ files."""
    pytest.importorskip("cv2")
    from upsp_tpu_torch.io.plot3d import write_p3d_grid
    from upsp_tpu_torch.pipeline.diagnostics import write_phase0_diagnostics
    from upsp_tpu_torch.pipeline.synthetic import make_plate_grid, make_synthetic_state

    tmp = tmp_path_factory.mktemp("kulites")
    state = make_synthetic_state(n_cameras=1, image_hw=(64, 96), grid_shape=(24, 20),
                                 n_patch_dots=3, registration="none", device="cpu")
    write_p3d_grid(str(tmp / "plate.grid"), make_plate_grid(24, 20))
    rows = []
    for k, v in enumerate((150, 301), 1):
        x, y, z = state.model.vertices[v]
        rows.append(f"{k} {x:.4f} {y:.4f} {z:.4f} 0.0 0.0 1.0 0.1 1 1 1 K{k:02d}\n")
    (tmp / "model.tgts").write_text("*Targets\n" + "".join(rows))
    np.random.default_rng(3).normal(0, 0.01, (state.model.size, 16)).astype("<f4").tofile(
        tmp / "pressure_transpose")
    write_phase0_diagnostics(state, str(tmp / "diag"))
    (tmp / "daq").mkdir()
    write_kulite_info(tmp / "daq", 123, 4)
    return tmp


@pytest.mark.parametrize("mode", ["radius", "up", "port"])
def test_kulite_comparison_matches_jax(kulite_inputs, tmp_path, mode):
    """Radius mode with the measured kulites (needs pandas); the displaced
    modes with the selection-area images."""
    d = kulite_inputs
    args = ["--pressure", d / "pressure_transpose", "--grid", d / "plate.grid",
            "--tgts", d / "model.tgts", "--frames", 16]
    if mode == "radius":
        pytest.importorskip("pandas")
        args += ["--radius", 0.3, "--kulite_dir", d / "daq", "--run", 123, "--seq", 4]
    else:
        args += ["--direction", mode, "--distance", 0.5, "--n-vertices", 6,
                 "--diag-dir", d / "diag"]
    out = {}
    for script in ("upsp-kulite-comparison", "upsp-kulite-comparison-torch"):
        o = tmp_path / script
        extra = [] if mode == "radius" else ["--images-out", o / "imgs"]
        r = _ran(_script(script, *args, *extra, "--out", o / "cmp.csv"))
        out[script] = (r.stdout.replace(str(o), ""), _files(o))
    want, got = out["upsp-kulite-comparison"], out["upsp-kulite-comparison-torch"]
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    for name in want[1]:
        assert got[1][name] == want[1][name], name
    with open(tmp_path / "upsp-kulite-comparison-torch" / "cmp.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert [r["kulite"] for r in rows] == ["K01", "K02"]
    assert all(float(r["upsp_rms_dcp"]) > 0 for r in rows)
    if mode == "radius":
        assert all(float(r["kulite_rms_psi"]) > 0 for r in rows)
    else:
        assert "imgs/cam01-selected-pixels.png" in got[1]


# ---------------------------------------------------------------------------
# frame extraction


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    from upsp_tpu_torch.pipeline.synthetic import write_datapoint

    tmp = tmp_path_factory.mktemp("videos")
    out = {}
    for fmt, ext in (("mraw12", "mraw"), ("cine10", "cine")):
        write_datapoint(str(tmp / fmt), image_hw=(40, 64), n_frames=5, n_distinct=5,
                        grid_shape=(9, 7), n_targets=2, seed=5, video_format=fmt,
                        hot_pixels=True)
        out[fmt] = tmp / fmt / f"cam01.{ext}"
    return out


@pytest.mark.parametrize("window", [(), ("-start", 1, "-count", 3), ("-count", 9)],
                         ids=["all", "start1_count3", "count_past_end"])
@pytest.mark.parametrize("fmt", ["mraw12", "cine10"])
def test_extract_frames_matches_jax(videos, tmp_path, fmt, window):
    cv2 = pytest.importorskip("cv2")
    frames = {}
    for script in ("upsp-extract-frames", "upsp-extract-frames-torch"):
        pattern = tmp_path / script / "f.%03d.png"
        r = _ran(_script(script, "-input", videos[fmt], "-output", pattern, *window))
        names = sorted(os.listdir(tmp_path / script))
        frames[script] = (r.stdout, names, [cv2.imread(str(tmp_path / script / n),
                                                       cv2.IMREAD_UNCHANGED) for n in names])
    want, got = frames["upsp-extract-frames"], frames["upsp-extract-frames-torch"]
    n = 3 if "-start" in window else 5
    assert got[0] == want[0] == f"wrote {n} frames\n"
    assert got[1] == want[1] and len(got[1]) == n
    for a, b in zip(got[2], want[2]):
        assert a.dtype == np.uint8 and a.shape == (40, 64)
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# plotting


def test_plotting_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    cv2 = pytest.importorskip("cv2")
    from upsp_tpu_torch.io.plot3d import write_p3d_grid
    from upsp_tpu_torch.pipeline.synthetic import make_plate_grid

    write_p3d_grid(str(tmp_path / "plate.grid"), make_plate_grid(12, 9))
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(6)
    for name in ("rms", "avg", "coverage"):
        rng.normal(0, 1, 12 * 9).astype("<f4").tofile(data / name)
    out = {}
    for script in ("upsp-plotting", "upsp-plotting-torch"):
        imgs = tmp_path / script / "images"
        r1 = _ran(_script(script, "render-images", "--grid", tmp_path / "plate.grid",
                          "--data_dir", data, "--out_dir", imgs / "301",
                          "--fields", "rms", "avg", "coverage", "missing"))
        (imgs / "302").mkdir()
        shutil.copy(imgs / "301" / "avg.png", imgs / "302" / "avg.png")
        r2 = _ran(_script(script, "generate-miniwall", "--images_root", imgs))
        out[script] = (r1.stdout.replace(str(tmp_path / script), ""), r1.stderr[-200:],
                       r2.stdout.replace(str(tmp_path / script), ""),
                       (imgs / "index.html").read_text(),
                       {n: cv2.imread(str(imgs / "301" / n)) for n in os.listdir(imgs / "301")})
    want, got = out["upsp-plotting"], out["upsp-plotting-torch"]
    assert got[:4] == want[:4]
    assert "skipping missing: not found" in got[1]
    assert "(2 datapoints)" in got[2]
    assert sorted(got[4]) == sorted(want[4]) == ["avg.png", "coverage.png", "rms.png"]
    for name, img in want[4].items():
        np.testing.assert_array_equal(got[4][name], img, err_msg=name)


# ---------------------------------------------------------------------------
# parity helpers


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_monomial_coeffs_matches_jax(dtype):
    from upsp_tpu.ops import polyfit as JPF
    from upsp_tpu_torch.ops import polyfit as TPF

    rng = np.random.default_rng(9)
    series = (1.0 + 0.01 * rng.standard_normal((50, 40))).astype(np.float32)
    jd, td = JPF.make_detrender(40, 6), TPF.make_detrender(40, 6)
    tc = TPF.fit_coeffs(td, torch.tensor(series)).to(dtype)
    got = TPF.monomial_coeffs(td, tc)
    assert got.dtype == dtype and got.device == tc.device
    # the same Q-basis coefficients through the JAX package's
    want = np.asarray(JPF.monomial_coeffs(jd, jnp.asarray(tc.numpy())))
    assert want.dtype == tc.numpy().dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the monomial polynomial is the fit, evaluated at f / F
    f = np.arange(40) / 40
    fit = TPF.eval_fit(td, tc.float()).double().numpy()
    mono = np.stack([f**c for c in range(7)], 1) @ got.double().numpy().T
    np.testing.assert_allclose(mono.T, fit, atol=1e-5)


@pytest.mark.parametrize("window,decimate", [(True, 1), (False, 1), (True, 2)])
def test_make_phase_correlator_matches_jax(window, decimate):
    from test_torch_ops import scene

    from upsp_tpu.ops import fftreg as JF
    from upsp_tpu_torch.ops import fftreg as TF

    shifts = [(0.0, 0.0), (1.3, -0.6), (-1.8, 1.1)]
    x = scene(3, shifts)
    jfn = JF.make_phase_correlator(jnp.asarray(x[0]), window, decimate)
    tfn = TF.make_phase_correlator(torch.tensor(x[0]), window, decimate)
    for k, img in enumerate(x):
        got = tfn(torch.tensor(img))
        assert got.shape == (2,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(img))),
                                   atol=2e-3, rtol=0)
        if window:  # and they find the shift
            np.testing.assert_allclose(got.numpy(), shifts[k], atol=0.35)


def test_trace_and_device_barrier(tmp_path):
    """``trace(None)`` does nothing; ``trace(dir)`` writes a Chrome trace
    naming the ops it saw; ``device_barrier`` returns on one CPU process."""
    from upsp_tpu_torch.utils.timing import device_barrier, trace

    with trace(None):
        (torch.ones(4) * 2).sum()
    assert not list(tmp_path.iterdir())
    with trace(str(tmp_path / "tr")):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    (path,) = (tmp_path / "tr").iterdir()
    assert path.name == "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    device_barrier()
