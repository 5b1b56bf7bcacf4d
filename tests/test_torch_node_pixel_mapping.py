"""The port's keyframe mapping (``ops/node_pixel_mapping.py``) against
``upsp_tpu.ops.node_pixel_mapping`` in float64: ``keyframe_mapping``'s
positions and pose Jacobians, ``remap`` and ``remap_error_bound`` at a
nearby pose, within rtol 1e-10 (both evaluate the same f64 camera model;
the Jacobian by forward mode on both sides), and atol 1e-10 of the largest
entry for the Jacobian's entries near 0.  The first-order remap is
also held against a reprojection at the new pose, to O(|d|^2)."""

import jax.numpy as jnp
import numpy as np
import torch

from upsp_tpu.camera.model import make_camera_params as j_params
from upsp_tpu.ops import node_pixel_mapping as J
from upsp_tpu_torch.camera.model import make_camera_params, project_points
from upsp_tpu_torch.ops import node_pixel_mapping as T


def test_keyframe_mapping_matches_jax():
    rng = np.random.default_rng(21)
    rmat = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    tvec = np.array([-5.0, 4.0, 20.0])
    K = np.array([[1500.0, 0, 640.0], [0, 1510.0, 400.0], [0, 0, 1.0]])
    dist = np.array([-0.1, 0.02, 1e-3, -2e-3, 0.004])
    pts = np.c_[rng.uniform(0, 10, (500, 2)), rng.uniform(-0.5, 0.5, 500)]
    jm = J.keyframe_mapping(j_params(rmat, tvec, K, dist, dtype=jnp.float64),
                            jnp.asarray(pts))
    params = make_camera_params(rmat, tvec, K, dist, dtype=torch.float64)
    tm = T.keyframe_mapping(params, torch.from_numpy(pts))
    assert tm.jac.shape == (500, 2, 6)
    for k in ("uv", "jac", "pose"):
        np.testing.assert_allclose(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)),
                                   rtol=1e-10, atol=1e-10 * np.abs(np.asarray(getattr(jm, k))).max(),
                                   err_msg=k)
    step = np.array([2e-4, -1e-4, 3e-4, 1e-3, -2e-3, 1.5e-3])
    new = tm.pose.numpy() + step
    np.testing.assert_allclose(T.remap(tm, torch.from_numpy(new)).numpy(),
                               np.asarray(J.remap(jm, jnp.asarray(new))), rtol=1e-10)
    bound = T.remap_error_bound(tm, torch.from_numpy(new)).numpy()
    np.testing.assert_allclose(bound, np.asarray(J.remap_error_bound(jm, jnp.asarray(new))),
                               rtol=1e-10)
    # first order: the remap's error is far below the step it takes
    moved = params._replace(rvec=torch.from_numpy(new[:3]), tvec=torch.from_numpy(new[3:]))
    exact = project_points(moved, torch.from_numpy(pts)).numpy()
    err = np.linalg.norm(T.remap(tm, torch.from_numpy(new)).numpy() - exact, axis=1)
    assert bound.min() > 0.1 and (err < 0.01 * bound).all(), (bound.min(), err.max())
