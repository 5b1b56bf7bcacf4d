"""The port's external calibration (``upsp_tpu_torch/camera/external.py``
and ``scripts/upsp-external-calibration-torch``) against
``upsp_tpu.camera.external`` on the CPU.

The synthetic case: ``write_datapoint``'s plate, 12 targets and two
camera JSONs at 256x320 (a faint texture, ``texture_scale=0.1``), with
``write_calibration_inputs``' test config, camera-tunnel poses perturbed
as tests/test_external_calibrate.py:65-67 perturbs them, and first-frame
PNGs.  Camera 1 through both packages' ``external_calibrate_two_stage``:
the same inlier targets, poses within 1e-6 of each other, both within
5e-3 (rmat) and 3e-2 (tvec) of the camera JSON's pose.  Then the CLI with
``--device cpu --joint_ba`` on both cameras writes the JSONs that the
same steps called in this process write.  Also: the visibility checker's
walks, target bumping, and the CLI's refusal of ``--device cuda`` without
CUDA.
"""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from upsp_tpu.camera import external as JE
from upsp_tpu.camera.visibility import VisibilityChecker as JVis
from upsp_tpu.geometry.grids import load_model as j_load_model
from upsp_tpu.io import read_test_config as j_read_test_config
from upsp_tpu.io import read_tgts as j_read_tgts
from upsp_tpu_torch import native
from upsp_tpu_torch.camera import external as TE
from upsp_tpu_torch.camera.visibility import VisibilityChecker as TVis
from upsp_tpu_torch.geometry.grids import load_model
from upsp_tpu_torch.io.camera_json import read_camera_json, read_test_config
from upsp_tpu_torch.io.tgts import read_tgts
from upsp_tpu_torch.pipeline.synthetic import write_calibration_inputs, write_datapoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "upsp-external-calibration-torch")
HW = (256, 320)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("extcal"))
    dp = write_datapoint(root, n_cameras=2, image_hw=HW, n_frames=1, n_distinct=1,
                         grid_shape=(41, 33), n_targets=12, seed=0, texture_scale=0.1)
    ci = write_calibration_inputs(root, dp["frames"])
    return dict(root=root, frames=dp["frames"], **ci)


def _inputs(case, c):
    img = cv2.imread(case["imgs"][c], cv2.IMREAD_GRAYSCALE + cv2.IMREAD_ANYDEPTH)
    cal = read_camera_json(os.path.join(case["cal_dir"], f"camera{c + 1:02d}.json"),
                           img.shape)
    return img, (cal.rmat, cal.tvec.reshape(3, 1)), (cal.camera_matrix, cal.dist_coeffs)


def test_two_stage_matches_jax(case):
    root = case["root"]
    img, (rmat0, tvec0), incal = _inputs(case, 0)
    true = read_camera_json(case["cams"][0], HW)
    j_vis = JVis(j_load_model(f"{root}/plate.grid"), 70.0, epsilon=1e-4)
    t_vis = TVis(load_model(f"{root}/plate.grid"), 70.0, epsilon=1e-4, device="cpu")
    j_tgts = JE.targets_to_dicts(j_read_tgts(f"{root}/plate.tgts"))
    t_tgts = TE.targets_to_dicts(read_tgts(f"{root}/plate.tgts"))
    timings = {}
    got = TE.external_calibrate_two_stage(img, rmat0, tvec0, incal, t_tgts,
                                          read_test_config(case["cfg"]), t_vis,
                                          timings=timings)
    want = JE.external_calibrate_two_stage(img, rmat0, tvec0, incal, j_tgts,
                                           j_read_test_config(case["cfg"]), j_vis)
    assert [t["name"] for t in got[2]] == [t["name"] for t in want[2]]
    assert len(got[2]) >= 10
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    for rmat, tvec in (got[:2], want[:2]):
        np.testing.assert_allclose(rmat, true.rmat, atol=5e-3)
        np.testing.assert_allclose(np.asarray(tvec).reshape(3), true.tvec, atol=3e-2)
    np.testing.assert_allclose(np.stack([i["center"] for i in got[3]]),
                               np.stack([i["center"] for i in want[3]]), atol=1e-3)
    assert set(timings) == set(TE.STAGES) and all(v > 0 for v in timings.values())


def _in_process(case):
    """The CLI's steps, called here: per camera the two-stage solve from the
    wtd, then the joint BA, then the JSON of each camera."""
    from upsp_tpu_torch.camera.ba import build_problem, bundle_adjust, poses_to_rmat_tvec
    from upsp_tpu_torch.camera.model import make_camera_params
    from upsp_tpu_torch.io.wtd import read_wtd

    root = case["root"]
    cfg = read_test_config(case["cfg"])
    cond = read_wtd(f"{root}/t.wtd")
    wtd = {"ALPHA": cond.alpha, "BETA": cond.beta, "PHI": cond.phi,
           "STRUTZ": cond.strutz}
    vis = TVis(load_model(f"{root}/plate.grid"), 70.0, epsilon=1e-4, device="cpu")
    tgts = TE.targets_to_dicts(read_tgts(f"{root}/plate.tgts"))
    cams, obs, key = [], [], {}
    for c in range(2):
        img, (rmat0, tvec0), (K, dist) = _inputs(case, c)
        r, t, ti, ii = TE.external_calibrate_two_stage_from_wtd(
            img, (rmat0, tvec0, K, dist), wtd, cfg, tgts, vis)
        cams.append(make_camera_params(r, t, K, dist))
        for tg, it in zip(ti, ii):
            key.setdefault(tg["name"], (len(key), tg["tvec"].reshape(3)))
            obs.append((c, key[tg["name"]][0], np.asarray(it["center"])))
    pts = np.array([v[1] for v in sorted(key.values(), key=lambda v: v[0])])
    res = bundle_adjust(build_problem(cams, pts, obs, prior_sigma=0.01, device="cpu"),
                        n_iters=30)
    return poses_to_rmat_tvec(res)


def test_cli_writes_the_in_process_result(case):
    out = os.path.join(case["root"], "out_cal")
    timings = os.path.join(case["root"], "timings.json")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, SCRIPT, "--tgts", f"{case['root']}/plate.tgts",
         "--grd", f"{case['root']}/plate.grid", "--wtd", f"{case['root']}/t.wtd",
         "--cfg", case["cfg"], "--cal_dir", case["cal_dir"], "--img", *case["imgs"],
         "--out_dir", out, "--joint_ba", "--device", "cpu", "--timings", timings],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "joint BA over 2 cameras" in r.stdout
    rmats, tvecs = _in_process(case)
    for c in range(2):
        with open(os.path.join(out, f"cam{c + 1:02d}-to-model.json")) as fh:
            got = json.load(fh)
        with open(case["cams"][c]) as fh:
            src = json.load(fh)
        np.testing.assert_allclose(got["rmat"], rmats[c], rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["tvec"], tvecs[c], rtol=0, atol=1e-12)
        assert got["uPSP_cameraMatrix"] == src["uPSP_cameraMatrix"]
        np.testing.assert_allclose(got["rmat"], src["rmat"], atol=5e-3)
        np.testing.assert_allclose(got["tvec"], src["tvec"], atol=3e-2)
    with open(timings) as fh:
        t = json.load(fh)
    assert t["device"] == "cpu" and t["ba_device"] == "cpu" and t["cameras"] == 2
    assert max(t["rms"]) < 1.0 and t["ba_rms"] < 1.0
    assert set(t["stages"]) == {"setup", *TE.STAGES, "ba", "writes"}


def test_cli_needs_cuda_unless_cpu(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, SCRIPT, "--tgts", "t", "--grd", "g", "--wtd", "w", "--cfg",
         case["cfg"], "--cal_dir", case["cal_dir"], "--img", case["imgs"][0],
         "--out_dir", os.path.join(case["root"], "never")],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=REPO),
        cwd=REPO, timeout=120)
    assert r.returncode != 0
    assert "RuntimeError: device 'cuda' requested" in r.stderr
    with pytest.raises(RuntimeError, match="cuda"):
        TVis(None, debug_nogrid=True)


def _no_library(mp):
    """The JAX package's rule without the library: none loaded, none to be
    built."""
    def fail():
        raise RuntimeError("the native BVH library is missing and cannot be built")

    mp.setattr(native, "native_library", fail)
    mp.setattr(native, "_LIB", None)


def test_visibility_walks_and_bumping(case, monkeypatch):
    """The checker's native and device walks agree on the targets; its incal
    filter and orientation helpers equal the JAX checker's; target bumping
    pushes a target sunk under the plate back above it and rewrites the
    tgts file as the JAX package does."""
    from upsp_tpu.camera.target_bumping import tgts_bumper as j_bumper
    from upsp_tpu_torch.camera.target_bumping import tgts_bumper

    root = case["root"]
    model = load_model(f"{root}/plate.grid")
    tgts = TE.targets_to_dicts(read_tgts(f"{root}/plate.tgts"))
    true = read_camera_json(case["cams"][0], HW)
    seen = {}
    for walk in ("native", "device"):
        with monkeypatch.context() as mp:
            if walk == "device":
                _no_library(mp)
            vis = TVis(model, 70.0, epsilon=1e-4, device="cpu")
        assert vis.walk == walk
        seen[walk] = [t["name"] for t in TE.get_visible_targets(true.rmat, true.tvec,
                                                               tgts, vis)]
    assert seen["native"] == seen["device"] and len(seen["native"]) == 12
    with monkeypatch.context() as mp:
        _no_library(mp)
        nogrid = TVis(None, debug_nogrid=True, device="cpu")
    assert nogrid.walk == "device"
    assert nogrid.is_visible(np.array([5.0, 4.0, 20.0]), np.zeros((3, 3)),
                             np.tile([0, 0, 1.0], (3, 1))).tolist() == [0, 1, 2]
    # the incal filter and the orientation helpers against the JAX checker's
    from upsp_tpu.camera.internal import incal_calibration_bounds as j_bounds
    from upsp_tpu_torch.camera.internal import incal_calibration_bounds

    j_vis = JVis(j_load_model(f"{root}/plate.grid"))
    nodes, normals = model.vertices[::7], model.normals[::7]
    centre = -(true.rmat.T @ true.tvec)
    fn = TE.make_project_fn(true.rmat, true.tvec, true.camera_matrix,
                            true.dist_coeffs, "cpu")
    board = np.random.default_rng(62).uniform([40, 30], [280, 230], (80, 2))
    for tb, jb in ((None, None), (incal_calibration_bounds(board, 0.02),
                                  j_bounds(board, 0.02))):
        got = vis.is_visible_and_inside_incal(centre, nodes, normals, fn, HW, tb)
        want = j_vis.is_visible_and_inside_incal(centre, nodes, normals, fn, HW, jb)
        np.testing.assert_array_equal(got, want)
        # the whole plate is in view; the board's coverage keeps part of it
        assert len(got) == len(nodes) if tb is None else 0 < len(got) < len(nodes)
    t = np.random.default_rng(63).normal(0, 1, (50, 3))
    n = np.random.default_rng(64).normal(0, 1, (50, 3))
    np.testing.assert_array_equal(vis.is_back_facing(t, n), j_vis.is_back_facing(t, n))
    np.testing.assert_array_equal(vis.angle_between(t, n), j_vis.angle_between(t, n))
    sunk = [dict(t) for t in tgts[:3]]
    sunk[0]["tvec"] = sunk[0]["tvec"] - np.array([[0], [0], [0.003]])
    got, bump, n = tgts_bumper(sunk, vis)
    want, jbump, jn = j_bumper(sunk, JVis(j_load_model(f"{root}/plate.grid")))
    assert n == jn == 1
    np.testing.assert_allclose(bump, jbump, rtol=0, atol=1e-7)  # 1e-6 of t
    assert got[0]["tvec"][2, 0] > 0 and got[1]["tvec"][2, 0] == sunk[1]["tvec"][2, 0]
    from upsp_tpu.camera.target_bumping import write_bumped_tgts as j_write
    from upsp_tpu_torch.camera.target_bumping import write_bumped_tgts

    out = os.path.join(root, "bumped")
    write_bumped_tgts(f"{root}/plate.tgts", out + ".t", got)
    j_write(f"{root}/plate.tgts", out + ".j", want)
    with open(out + ".t") as ft, open(out + ".j") as fj:
        assert ft.read() == fj.read()
