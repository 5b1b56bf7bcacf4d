"""The port's camera model (``upsp_tpu_torch/camera/model.py``) against
``upsp_tpu.camera.model`` on the CPU, float64 (x64 as tests/conftest.py
sets it), rtol 1e-12.

One seeded camera with Brown distortion and points in front of it go
through both packages: projection, its 6- and 15-column Jacobians
(cv2's ordering), the flat parameterisation, undistortion, pixel rays,
reprojection error, Rodrigues (also batched and at zero), the camera
centre and the host helpers ``rot``/``inv_transform``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsp_tpu.camera import model as J
from upsp_tpu_torch.camera import model as T

RTOL = 1e-12


@pytest.fixture(scope="module")
def cam():
    rng = np.random.default_rng(7)
    K = np.array([[900.0, 0, 512], [0, 910.0, 256], [0, 0, 1]])
    dist = np.array([-0.08, 0.01, 0.001, -0.002, 0.003])
    rmat = J.rot(12.0, "x") @ J.rot(-8.0, "y") @ np.diag([1.0, -1.0, -1.0])
    tvec = np.array([0.5, -0.2, 14.0])
    obj = rng.uniform(-4, 4, size=(40, 3)) * np.array([1, 1, 0.2])
    pix = rng.uniform([0, 0], [1024, 512], size=(40, 2))
    return dict(
        j=J.make_camera_params(rmat, tvec, K, dist),
        t=T.make_camera_params(rmat, tvec, K, dist),
        obj=obj, pix=pix, rmat=rmat, tvec=tvec,
    )


def close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=0)


def test_params_and_flat(cam):
    for name in cam["t"]._fields:
        close(getattr(cam["t"], name), getattr(cam["j"], name))
        assert getattr(cam["t"], name).dtype == torch.float64
    flat = T.flatten_params(cam["t"])
    close(flat, J.flatten_params(cam["j"]))
    close(T._project_flat(flat, torch.from_numpy(cam["obj"])),
          J._project_flat(J.flatten_params(cam["j"]), jnp.asarray(cam["obj"])))
    assert all(torch.equal(a, b) for a, b in zip(T.unflatten_params(flat), cam["t"]))


@pytest.mark.parametrize("full", [False, True])
def test_projection_and_jacobian(cam, full):
    projs, jac = T.project_points_jac(cam["t"], torch.from_numpy(cam["obj"]), full=full)
    jp, jj = J.project_points_jac(cam["j"], jnp.asarray(cam["obj"]), full=full)
    assert jac.shape == (40, 2, 15 if full else 6)
    close(projs, jp)
    close(jac, jj)
    close(T.project_points(cam["t"], torch.from_numpy(cam["obj"])),
          J.project_points(cam["j"], jnp.asarray(cam["obj"])))


def test_undistort_rays_and_error(cam):
    xy = torch.from_numpy(np.random.default_rng(8).uniform(-0.4, 0.4, (50, 2)))
    for iters in (1, 8):
        close(T.undistort_normalized(xy, cam["t"].dist, iters),
              J.undistort_normalized(jnp.asarray(xy.numpy()), cam["j"].dist, iters))
    close(T.distort_normalized(xy, cam["t"].dist),
          J.distort_normalized(jnp.asarray(xy.numpy()), cam["j"].dist))
    close(T.pixel_rays(cam["t"], torch.from_numpy(cam["pix"])),
          J.pixel_rays(cam["j"], jnp.asarray(cam["pix"])))
    for got, want in zip(
        T.reprojection_error(cam["t"], torch.from_numpy(cam["obj"]),
                             torch.from_numpy(cam["pix"])),
        J.reprojection_error(cam["j"], jnp.asarray(cam["obj"]), jnp.asarray(cam["pix"])),
    ):
        close(got, want)


def test_rodrigues_center_and_host_helpers(cam):
    rng = np.random.default_rng(9)
    rvecs = np.concatenate([rng.normal(0, 1.0, (5, 3)), np.zeros((1, 3)),
                            np.full((1, 3), 1e-14)])
    want = np.stack([np.asarray(J.rodrigues(jnp.asarray(r))) for r in rvecs])
    close(T.rodrigues(torch.from_numpy(rvecs)), want)  # batched
    for r, w in zip(rvecs, want):
        close(T.rodrigues(torch.from_numpy(r)), w)
    close(T.cam_center(cam["t"]), J.cam_center(cam["j"]))
    for axis in "xyz":
        np.testing.assert_array_equal(T.rot(23.5, axis), J.rot(23.5, axis))
    with pytest.raises(ValueError):
        T.rot(1.0, "w")
    for got, want in zip(T.inv_transform(cam["rmat"], cam["tvec"]),
                         J.inv_transform(cam["rmat"], cam["tvec"])):
        np.testing.assert_array_equal(got, want)
