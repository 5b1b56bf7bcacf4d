"""Pinhole + Brown-distortion camera model (torch).

Port of ``upsp_tpu/camera/model.py``.  Phase 0 runs it on the host: the
parameters keep the dtype they were made with (float32 in phase 0, as in
the JAX package), and ``project_points`` computes in the wider of the
parameter and point dtypes, so float64 points project in float64.
Calibration (``camera/pnp.py``, ``camera/ba.py``) makes its parameters in
float64 on its device, as the JAX package does under x64.

Every function works on the device of its tensors, makes no host sync and
composes with ``torch.func`` (``jacfwd``, ``vmap``): Jacobians come from
``torch.func.jacfwd`` in cv2's ordering ``[drvec(3), dtvec(3), df(2),
dc(2), ddist(5)]``, as the JAX package takes them from ``jax.jacfwd``.

Conventions: ``x_cam = R @ X + t``; ``u = fx * x' + cx`` with (x', y') the
distorted normalised coordinates; camera centre ``-R^T t``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CameraParams(NamedTuple):
    rvec: torch.Tensor  # (3,) Rodrigues rotation object->camera
    tvec: torch.Tensor  # (3,)
    fx: torch.Tensor  # ()
    fy: torch.Tensor  # ()
    cx: torch.Tensor  # ()
    cy: torch.Tensor  # ()
    dist: torch.Tensor  # (5,) [k1 k2 p1 p2 k3]

    @property
    def camera_matrix(self) -> torch.Tensor:
        """The 3x3 intrinsic matrix, in ``fx``'s dtype and on its device."""
        z = torch.zeros((), dtype=self.fx.dtype, device=self.fx.device)
        o = torch.ones_like(z)
        return torch.stack([torch.stack(row) for row in (
            (self.fx, z, self.cx), (z, self.fy, self.cy), (z, z, o))])


def rmat_to_rvec(rmat: np.ndarray) -> np.ndarray:
    """Rotation matrix -> rotation vector (host numpy)."""
    R = np.asarray(rmat, np.float64)
    theta = np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # near 180 deg: axis from R + I, signs from the off-diagonals
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        if axis[0] > 0:
            axis[1] *= np.sign(A[0, 1]) if A[0, 1] != 0 else 1.0
            axis[2] *= np.sign(A[0, 2]) if A[0, 2] != 0 else 1.0
        elif axis[1] > 0:
            axis[2] *= np.sign(A[1, 2]) if A[1, 2] != 0 else 1.0
        return axis / np.linalg.norm(axis) * theta
    axis = np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    ) / (2.0 * np.sin(theta))
    return axis * theta


def make_camera_params(rmat, tvec, camera_matrix, dist_coeffs,
                       dtype=torch.float64, device=None) -> CameraParams:
    """CameraParams from OpenCV-style matrices, on ``device`` (the CPU by
    default)."""
    cm = np.asarray(camera_matrix)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    return CameraParams(
        rvec=t(rmat_to_rvec(np.asarray(rmat))),
        tvec=t(np.asarray(tvec).reshape(3)),
        fx=t(cm[0, 0]), fy=t(cm[1, 1]), cx=t(cm[0, 2]), cy=t(cm[1, 2]),
        dist=t(np.asarray(dist_coeffs).reshape(-1)[:5]),
    )


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector(s) (..., 3) -> rotation matrices (..., 3, 3), first
    order at theta <= 1e-12 (both branches computed, as in the JAX
    package, so there is no host sync)."""
    theta = torch.linalg.norm(rvec, dim=-1)
    big = theta > 1e-12
    safe = torch.where(big, theta, torch.ones_like(theta))
    K = _skew(rvec / safe[..., None])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    R = eye + s * K + (1.0 - c) * (K @ K)
    return torch.where(big[..., None, None], R, eye + _skew(rvec))


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Brown 5-coefficient distortion of normalised coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2, k3 = dist.unbind()
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xy_dist: torch.Tensor, dist: torch.Tensor,
                         iters: int = 8) -> torch.Tensor:
    """Invert Brown distortion by fixed-point iteration (like
    cv2.undistortPoints)."""
    k1, k2, p1, p2, k3 = dist.unbind()
    xy = xy_dist
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xy_dist[..., 0] - dx) / radial,
                          (xy_dist[..., 1] - dy) / radial], dim=-1)
    return xy


def project_points(params: CameraParams, points) -> torch.Tensor:
    """Project object-frame points (..., 3) to pixel coordinates (..., 2)."""
    points = torch.as_tensor(points)
    dt = torch.promote_types(points.dtype, params.fx.dtype)
    R = rodrigues(params.rvec).to(dt)
    xc = points.to(dt) @ R.T + params.tvec.to(dt)
    xy = xc[..., :2] / xc[..., 2:3]
    xyd = distort_normalized(xy, params.dist.to(dt))
    u = params.fx.to(dt) * xyd[..., 0] + params.cx.to(dt)
    v = params.fy.to(dt) * xyd[..., 1] + params.cy.to(dt)
    return torch.stack([u, v], dim=-1)


def _project_flat(flat_params: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Projection parameterised by cv2's Jacobian ordering (15 params)."""
    return project_points(unflatten_params(flat_params), points)


def unflatten_params(flat: torch.Tensor) -> CameraParams:
    """The inverse of :func:`flatten_params`."""
    return CameraParams(rvec=flat[0:3], tvec=flat[3:6], fx=flat[6], fy=flat[7],
                        cx=flat[8], cy=flat[9], dist=flat[10:15])


def flatten_params(params: CameraParams) -> torch.Tensor:
    return torch.cat([params.rvec, params.tvec,
                      torch.stack([params.fx, params.fy, params.cx, params.cy]),
                      params.dist])


def project_points_jac(params: CameraParams, points, full: bool = False):
    """Projection and its Jacobian in cv2.projectPoints' ordering: (projs
    (N, 2), jacs (N, 2, 6) or (N, 2, 15) with ``full``)."""
    points = torch.as_tensor(points)
    flat = flatten_params(params)
    projs = _project_flat(flat, points)
    jac = torch.func.jacfwd(_project_flat)(flat, points)  # (N, 2, 15)
    return projs, (jac if full else jac[..., :6])


def cam_center(params: CameraParams) -> torch.Tensor:
    """Camera centre in the object frame: -R^T t."""
    return -(rodrigues(params.rvec).T @ params.tvec)


def pixel_rays(params: CameraParams, pixels) -> torch.Tensor:
    """Unit rays (object frame) through pixels (..., 2), from the camera
    centre."""
    pixels = torch.as_tensor(pixels)
    xn = (pixels[..., 0] - params.cx) / params.fx
    yn = (pixels[..., 1] - params.cy) / params.fy
    xy = undistort_normalized(torch.stack([xn, yn], dim=-1), params.dist)
    d_cam = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    d_obj = d_cam @ rodrigues(params.rvec)  # R^T @ d per ray
    return d_obj / torch.linalg.norm(d_obj, dim=-1, keepdim=True)


def reprojection_error(params: CameraParams, points, pixels):
    """RMS and max reprojection error in pixels."""
    err = torch.linalg.norm(project_points(params, points) - torch.as_tensor(pixels),
                            dim=-1)
    return torch.sqrt(torch.mean(err**2)), torch.max(err)


# ---------------------------------------------------------------------------
# host-side mirrors of photogrammetry.py (numpy)


def rot(angle_deg: float, axis: str) -> np.ndarray:
    """Single-axis rotation matrix, angle in degrees (host-side)."""
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise ValueError("axis must be x, y or z")


def inv_transform(R: np.ndarray, t: np.ndarray):
    """Inverse of a rigid transform: (R^T, -R^T t)."""
    Rt = np.asarray(R).T
    return Rt, -(Rt @ np.asarray(t).reshape(3, 1))
