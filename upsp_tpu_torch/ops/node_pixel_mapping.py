"""Keyframe node->pixel mapping with pose Jacobians, and the first-order
remap of nearby poses.

Port of ``upsp_tpu/ops/node_pixel_mapping.py`` (parity with
python/upsp/intensity_mapping/node_pixel_mapping.py:12-172): a keyframe
projects every node and differentiates its pixel position with respect to
the 6-DOF camera pose [rvec, tvec]; a frame at a nearby pose then maps by

    uv(pose + d) ~ uv(pose) + J @ d

which is exact to O(|d|^2).  The Jacobian comes from ``torch.func.jacfwd``
over the pose, as the JAX package takes it from ``jax.jacfwd``; every
tensor lives on the device of the points.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from upsp_tpu_torch.camera.model import CameraParams, project_points


class KeyframeMapping(NamedTuple):
    uv: torch.Tensor  # (N, 2) pixel positions at the keyframe pose
    jac: torch.Tensor  # (N, 2, 6) d(uv)/d[rvec, tvec]
    pose: torch.Tensor  # (6,) keyframe pose [rvec, tvec]


def _project_pose(pose6: torch.Tensor, params: CameraParams,
                  points: torch.Tensor) -> torch.Tensor:
    return project_points(params._replace(rvec=pose6[:3], tvec=pose6[3:6]), points)


def keyframe_mapping(params: CameraParams, points: torch.Tensor) -> KeyframeMapping:
    """Project ``points`` (N, 3) and differentiate with respect to the pose
    (forward mode), in the wider of the camera's and the points' dtypes."""
    points = torch.as_tensor(points)
    params = CameraParams(*(t.to(points.device) for t in params))
    pose = torch.cat([params.rvec, params.tvec])
    uv = _project_pose(pose, params, points)
    jac = torch.func.jacfwd(_project_pose)(pose, params, points)  # (N, 2, 6)
    return KeyframeMapping(uv=uv, jac=jac, pose=pose)


def _step(mapping: KeyframeMapping, new_pose) -> torch.Tensor:
    """J (pose' - pose), (N, 2)."""
    d = torch.as_tensor(new_pose).to(mapping.pose) - mapping.pose
    return torch.einsum("nij,j->ni", mapping.jac, d)


def remap(mapping: KeyframeMapping, new_pose) -> torch.Tensor:
    """First-order pixel positions at a nearby pose: uv + J (pose' - pose)."""
    return mapping.uv + _step(mapping, new_pose)


def remap_error_bound(mapping: KeyframeMapping, new_pose) -> torch.Tensor:
    """Per-node staleness: |J d| in pixels (when to take a new keyframe)."""
    return torch.linalg.norm(_step(mapping, new_pose), dim=-1)
