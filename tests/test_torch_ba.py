"""The port's bundle adjustment (``upsp_tpu_torch/camera/ba.py``) against
``upsp_tpu.camera.ba`` on the CPU, float64.

A 3-camera rig around a plate of 30 targets (tests/test_ba.py's rig),
noisy observations, perturbed poses and targets, one observation
weighted out: the solved poses and points within 1e-8 and the rms within
1e-10 of the JAX package's; the assembled problem, the dense Schur
system and ``poses_to_rmat_tvec`` equal; ``axis_name`` (a JAX mesh axis)
raises a TypeError that names ``mesh=``, its torch counterpart
(tests/test_torch_ba_mesh.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsp_tpu.camera import ba as JB
from upsp_tpu.camera import model as JM
from upsp_tpu_torch.camera import ba as TB
from upsp_tpu_torch.camera import model as TM


@pytest.fixture(scope="module")
def rig():
    rng = np.random.default_rng(51)
    K = np.array([[1200.0, 0, 512], [0, 1200.0, 400], [0, 0, 1]])
    dist = np.array([-0.05, 0.0, 0.0, 0.0, 0.0])
    pts = rng.uniform(-5, 5, size=(30, 3)) * [1, 0.8, 0.15]
    cams, obs, truth = [], [], []
    for c in range(3):
        rmat = JM.rot(8.0 * (c - 1), "y") @ JM.rot(4.0, "x") @ np.diag([1.0, -1.0, -1.0])
        tvec = np.array([0.3 * c - 0.3, 0.1, 16.0 + 0.5 * c])
        truth.append((rmat, tvec))
        uv = np.asarray(JM.project_points(JM.make_camera_params(rmat, tvec, K, dist),
                                          jnp.asarray(pts)))
        uv = uv + rng.normal(0, 0.05, uv.shape)
        for k in range(30):
            if (c, k) != (1, 7):  # one target unseen by one camera
                obs.append((c, k, uv[k]))
        rmat0 = JM.rot(0.15, "x") @ JM.rot(-0.1, "y") @ rmat
        cams.append((rmat0, tvec + np.array([0.03, -0.02, 0.05]), K, dist))
    pts0 = pts + rng.normal(0, 0.004, pts.shape)
    return dict(cams=cams, pts0=pts0, obs=obs, truth=truth)


def _problems(rig):
    j = JB.build_problem([JM.make_camera_params(*c) for c in rig["cams"]], rig["pts0"],
                         rig["obs"], prior_sigma=0.01)
    t = TB.build_problem([TM.make_camera_params(*c) for c in rig["cams"]], rig["pts0"],
                         rig["obs"], prior_sigma=0.01, device="cpu")
    # weight one observation out (an outlier), in both
    j = j._replace(weight=j.weight.at[5].set(0.0))
    t = t._replace(weight=t.weight.clone().index_fill_(0, torch.tensor([5]), 0.0))
    return j, t


def test_problem_assembly(rig):
    j, t = _problems(rig)
    for name in JB.BAProblem._fields:
        got, want = getattr(t, name), np.asarray(getattr(j, name))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        if got.is_floating_point():
            assert got.dtype == torch.float64, name
    rng = np.random.default_rng(52)
    hcc = rng.normal(size=(3, 6, 6))
    sb = rng.normal(size=(3, 3, 6, 6))
    np.testing.assert_array_equal(
        TB._blocks_to_dense(torch.from_numpy(hcc), torch.from_numpy(sb)).numpy(),
        np.asarray(JB._blocks_to_dense(jnp.asarray(hcc), jnp.asarray(sb))))


@pytest.mark.parametrize("n_iters", [1, 30])
def test_bundle_adjust_matches_jax(rig, n_iters):
    j, t = _problems(rig)
    want = JB.bundle_adjust(j, n_iters=n_iters)
    got = TB.bundle_adjust(t, n_iters=n_iters)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(got.rms), float(want.rms), rtol=0, atol=1e-10)
    assert got.n_iters == int(want.n_iters) == n_iters
    rj, tj = JB.poses_to_rmat_tvec(want)
    rt, tt = TB.poses_to_rmat_tvec(got)
    np.testing.assert_allclose(rt, rj, atol=1e-8)
    np.testing.assert_allclose(tt, tj, atol=1e-8)
    if n_iters == 30:  # the solve recovers the rig
        assert float(got.rms) < 0.3  # 0.05 px noise, targets held by the prior
        for c, (rmat, tvec) in enumerate(rig["truth"]):
            np.testing.assert_allclose(rt[c], rmat, atol=2e-3)
            np.testing.assert_allclose(tt[c], tvec, atol=2e-2)


def test_axis_name_is_not_ported(rig):
    _, t = _problems(rig)
    with pytest.raises(TypeError, match="mesh="):
        TB.bundle_adjust(t, n_iters=1, axis_name="x")
