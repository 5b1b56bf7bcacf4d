"""Pose estimation: robust PnP as batched Levenberg–Marquardt + RANSAC (f64).

Port of ``upsp_tpu/camera/pnp.py``, which replaces
``cv2.solvePnPRansac(useExtrinsicGuess=True)`` (external_calibrate.py:1140):

- :func:`refine_pose` — fixed-iteration LM on the 6-DOF reprojection
  residual, batched over poses, Jacobians from ``torch.func.jacfwd`` of the
  camera model under ``torch.func.vmap``.
- :func:`solve_pnp_ransac` — the hypotheses (each a random minimal subset,
  started at the pose guess) refined as one batch, inlier counting at the
  reprojection threshold, the winner refined on its consensus set.

Pose math is float64 on the parameters' device.  The JAX package draws the
subsets with ``jax.random``; the port draws them from a ``torch.Generator``
seeded with ``seed`` and hands them to :func:`ransac_from_subsets`, which a
test can feed with JAX's own subsets.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from upsp_tpu_torch.camera.model import (
    CameraParams,
    make_camera_params,
    project_points,
    rodrigues,
)


class PnPResult(NamedTuple):
    rvec: torch.Tensor  # (3,)
    tvec: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool
    rms: torch.Tensor  # () inlier reprojection RMS


def _with_pose(params: CameraParams, pose6: torch.Tensor) -> CameraParams:
    return params._replace(rvec=pose6[..., :3], tvec=pose6[..., 3:6])


def _residuals(pose6, weights, params: CameraParams, obj_pts, img_pts):
    proj = project_points(_with_pose(params, pose6), obj_pts)
    return ((proj - img_pts) * weights[:, None]).reshape(-1)


def refine_pose(
    params: CameraParams,
    obj_pts: torch.Tensor,  # (N, 3)
    img_pts: torch.Tensor,  # (N, 2)
    weights: torch.Tensor,  # (N,) or (B, N) 0/1 masks or weights
    n_iters: int = 20,
    pose0: Optional[torch.Tensor] = None,  # (6,) or (B, 6); default params' pose
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LM refinement of (rvec, tvec) from the params' pose (or ``pose0``);
    a (B, N) ``weights`` refines B poses at once and returns (B, 3) each."""
    if weights.dim() == 1 and (pose0 is None or pose0.dim() == 1):
        p0 = None if pose0 is None else pose0[None]
        rv, tv = refine_pose(params, obj_pts, img_pts, weights[None], n_iters, p0)
        return rv[0], tv[0]
    B = weights.shape[0]
    if pose0 is None:
        pose0 = torch.cat([params.rvec, params.tvec])
    pose = pose0.expand(B, 6)

    def r_one(p6, w):
        return _residuals(p6, w, params, obj_pts, img_pts)

    res = torch.func.vmap(r_one)
    jac = torch.func.vmap(torch.func.jacfwd(r_one))
    lam = torch.full((B,), 1e-3, dtype=pose.dtype, device=pose.device)
    for _ in range(n_iters):
        r = res(pose, weights)
        J = jac(pose, weights)  # (B, 2N, 6)
        JTJ = J.transpose(1, 2) @ J
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        diag = torch.clamp_min(torch.diagonal(JTJ, dim1=1, dim2=2), 1e-10)
        A = JTJ + lam[:, None, None] * torch.diag_embed(diag)
        new_pose = pose - torch.linalg.solve_ex(A, g)[0]
        new_r = res(new_pose, weights)
        improved = (new_r * new_r).sum(1) < (r * r).sum(1)
        pose = torch.where(improved[:, None], new_pose, pose)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0), 1e-10, 1e6)
    return pose[:, :3], pose[:, 3:6]


def _errors(params, pose6, obj_pts, img_pts):
    return torch.linalg.norm(project_points(_with_pose(params, pose6), obj_pts)
                             - img_pts, dim=-1)


def draw_subsets(valid: torch.Tensor, n_hypotheses: int, sample_size: int,
                 generator: torch.Generator) -> torch.Tensor:
    """(n_hypotheses, sample_size) indices of random minimal subsets of the
    valid points, drawn as ``upsp_tpu/camera/pnp.py:99-101`` draws them:
    uniform scores, invalid points pushed last, the lowest scores taken."""
    N = valid.shape[0]
    u = torch.rand((n_hypotheses, N), generator=generator, dtype=torch.float64,
                   device=generator.device).to(valid.device)
    scores = u + (~valid).to(u.dtype) * 10.0
    return torch.argsort(scores, dim=1)[:, :sample_size]


def ransac_from_subsets(
    params: CameraParams,
    obj_pts: torch.Tensor,
    img_pts: torch.Tensor,
    valid: torch.Tensor,
    subsets: torch.Tensor,  # (n_hypotheses, sample_size) point indices
    reproj_threshold: float = 6.0,
    n_iters: int = 15,
) -> PnPResult:
    """RANSAC PnP from an extrinsic guess (the params' pose) over the given
    minimal subsets, refined as one batch (``upsp_tpu/camera/pnp.py:
    103-137`` after the draw)."""
    N = obj_pts.shape[0]
    vmask = valid.to(obj_pts.dtype)
    w = torch.zeros((subsets.shape[0], N), dtype=obj_pts.dtype, device=obj_pts.device)
    w = w.scatter(1, subsets.to(obj_pts.device), 1.0) * vmask
    # the extrinsic guess itself competes as a hypothesis (refined on all pts)
    w = torch.cat([w, vmask[None]])
    rvs, tvs = refine_pose(params, obj_pts, img_pts, w, n_iters=n_iters)
    poses = torch.cat([rvs, tvs], 1)
    err = torch.func.vmap(lambda p: _errors(params, p, obj_pts, img_pts))(poses)
    counts = ((err < reproj_threshold) & valid).sum(1)
    best = poses[torch.argmax(counts)]
    inliers = (_errors(params, best, obj_pts, img_pts) < reproj_threshold) & valid

    # final polish on the consensus set
    rv, tv = refine_pose(params, obj_pts, img_pts, inliers.to(obj_pts.dtype),
                         n_iters=n_iters, pose0=best)
    err = _errors(params, torch.cat([rv, tv]), obj_pts, img_pts)
    inliers = (err < reproj_threshold) & valid
    n_in = torch.clamp_min(inliers.sum(), 1)
    rms = torch.sqrt(torch.where(inliers, err * err, torch.zeros_like(err)).sum() / n_in)
    return PnPResult(rvec=rv, tvec=tv, inliers=inliers, rms=rms)


def solve_pnp_ransac(
    params: CameraParams,
    obj_pts: torch.Tensor,  # (N, 3)
    img_pts: torch.Tensor,  # (N, 2)
    valid: torch.Tensor,  # (N,) bool — padded entries False
    seed: int = 0,
    reproj_threshold: float = 6.0,
    n_hypotheses: int = 64,
    sample_size: int = 4,
    n_iters: int = 15,
) -> PnPResult:
    """Vectorised RANSAC PnP from an extrinsic guess (the params' pose);
    the subsets come from a ``torch.Generator`` on the points' device seeded
    with ``seed``."""
    gen = torch.Generator(device=obj_pts.device).manual_seed(int(seed))
    subsets = draw_subsets(valid, n_hypotheses, sample_size, gen)
    return ransac_from_subsets(params, obj_pts, img_pts, valid, subsets,
                               reproj_threshold=reproj_threshold, n_iters=n_iters)


def solve_pnp(
    rmat_init: np.ndarray,
    tvec_init: np.ndarray,
    camera_matrix: np.ndarray,
    dist_coeffs: np.ndarray,
    obj_pts: np.ndarray,
    img_pts: np.ndarray,
    reproj_threshold: float = 6.0,
    seed: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Host-friendly wrapper: arrays in, (rmat, tvec, inlier_idx, rms) out;
    the solve runs in float64 on ``device``."""
    params = make_camera_params(rmat_init, tvec_init, camera_matrix, dist_coeffs,
                                device=device)
    n = obj_pts.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    res = solve_pnp_ransac(params, t(obj_pts), t(img_pts),
                           torch.ones(n, dtype=torch.bool, device=device), seed,
                           reproj_threshold=reproj_threshold)
    return (
        rodrigues(res.rvec).cpu().numpy(),
        res.tvec.cpu().numpy().reshape(3, 1),
        np.nonzero(res.inliers.cpu().numpy())[0],
        float(res.rms),
    )
