"""Pinhole + Brown-distortion camera model (host-side torch).

Port of ``upsp_tpu/camera/model.py`` (``CameraParams`` :27,
``make_camera_params`` :47, ``distort_normalized`` :111, ``project_points``
:141, ``cam_center`` :191).  Phase 0 runs it on the host: the parameters
keep the dtype they were made with (float32 in phase 0, as in the JAX
package), and ``project_points`` computes in the wider of the parameter
and point dtypes, so float64 points project in float64.

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
                       dtype=torch.float64) -> CameraParams:
    """CameraParams from OpenCV-style matrices."""
    cm = np.asarray(camera_matrix)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype)

    return CameraParams(
        rvec=t(rmat_to_rvec(np.asarray(rmat))),
        tvec=t(np.asarray(tvec).reshape(3)),
        fx=t(cm[0, 0]), fy=t(cm[1, 1]), cx=t(cm[0, 2]), cy=t(cm[1, 2]),
        dist=t(np.asarray(dist_coeffs).reshape(-1)[:5]),
    )


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> rotation matrix (first order near theta = 0)."""
    theta = torch.linalg.norm(rvec)
    eye = torch.eye(3, dtype=rvec.dtype)
    if float(theta) <= 1e-12:
        k0 = torch.zeros((3, 3), dtype=rvec.dtype)
        k0[0, 1], k0[0, 2] = -rvec[2], rvec[1]
        k0[1, 0], k0[1, 2] = rvec[2], -rvec[0]
        k0[2, 0], k0[2, 1] = -rvec[1], rvec[0]
        return eye + k0
    k = rvec / theta
    K = torch.zeros((3, 3), dtype=rvec.dtype)
    K[0, 1], K[0, 2] = -k[2], k[1]
    K[1, 0], K[1, 2] = k[2], -k[0]
    K[2, 0], K[2, 1] = -k[1], k[0]
    return eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Brown 5-coefficient distortion of normalised coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2, k3 = dist.unbind()
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


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


def cam_center(params: CameraParams) -> torch.Tensor:
    """Camera centre in the object frame: -R^T t."""
    return -(rodrigues(params.rvec).T @ params.tvec)
