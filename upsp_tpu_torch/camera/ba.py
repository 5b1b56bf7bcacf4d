"""Joint multi-camera bundle adjustment with Schur-complement reduction (f64).

Port of ``upsp_tpu/camera/ba.py``.  All camera poses and the 3D target
positions refine together against every observation, with a prior keeping
targets near their surveyed tgts-file coordinates (they fix the gauge).
Levenberg–Marquardt on

    sum_obs || proj(pose_c, X_k) - uv_obs ||^2  +  sum_k ||X_k - X0_k||^2 / s^2

The point blocks (3x3) are eliminated by a Schur complement onto the
camera system (6C x 6C).  Per-observation Jacobians come from
``torch.func.jacfwd`` under ``torch.func.vmap``; the block sums
(``jax.ops.segment_sum`` in the JAX package) are products with 0/1
segment matrices, so they are summed in the same order on every call
(``index_add_`` accumulates with atomics on CUDA, in an order that
changes from call to call).

Across ranks (``mesh=``, a :class:`~upsp_tpu_torch.parallel.mesh.Mesh`):
each rank passes its own block of the observations (``cam_idx``,
``pt_idx``, ``uv``, ``weight``; blocks may be uneven or empty) and the
same poses, points, prior and intrinsics.  The block sums go through
:func:`~upsp_tpu_torch.parallel.mesh.all_reduce` where the JAX package
``psum``s them (``axis_name``): the normal-equation blocks of a step, the
data term of the cost, and the final sum of squares with the observation
count.  The solve that follows is the same on every rank, so the ranks
take the same steps and return the same result.  The points' prior is
added once, after the reduction, in the cost as in the step (the JAX
package adds it to the cost on every rank before its ``psum``), so any
world size solves the problem of ``mesh=None``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from upsp_tpu_torch.camera.model import CameraParams, project_points, rodrigues
from upsp_tpu_torch.parallel.mesh import Mesh, all_reduce


class BAProblem(NamedTuple):
    """Static-shape bundle-adjustment problem."""

    poses: torch.Tensor  # (C, 6) [rvec, tvec] per camera
    points: torch.Tensor  # (K, 3) target positions (initial = surveyed)
    points0: torch.Tensor  # (K, 3) survey prior centers
    intrinsics: torch.Tensor  # (C, 9) [fx fy cx cy k1 k2 p1 p2 k3]
    cam_idx: torch.Tensor  # (O,) observation -> camera
    pt_idx: torch.Tensor  # (O,) observation -> point
    uv: torch.Tensor  # (O, 2) measured pixel positions
    weight: torch.Tensor  # (O,) 0 disables (padding / outliers)
    prior_sigma: torch.Tensor  # () target-position prior stddev (model units)


class BAResult(NamedTuple):
    poses: torch.Tensor  # (C, 6)
    points: torch.Tensor  # (K, 3)
    rms: torch.Tensor  # () weighted reprojection RMS (pixels)
    n_iters: int


def _params_from(intr: torch.Tensor, pose6: torch.Tensor) -> CameraParams:
    return CameraParams(rvec=pose6[:3], tvec=pose6[3:6], fx=intr[0], fy=intr[1],
                        cx=intr[2], cy=intr[3], dist=intr[4:9])


def _residual_one(pose6, point, intr, uv):
    return project_points(_params_from(intr, pose6), point[None, :])[0] - uv


_residuals = torch.func.vmap(_residual_one)
_jac_pose = torch.func.vmap(torch.func.jacfwd(_residual_one, argnums=0))
_jac_point = torch.func.vmap(torch.func.jacfwd(_residual_one, argnums=1))


def _all_residuals(poses, points, prob: BAProblem):
    if prob.uv.shape[0] == 0:  # a rank with no observations
        return prob.uv.new_zeros((0, 2))
    r = _residuals(poses[prob.cam_idx], points[prob.pt_idx],
                   prob.intrinsics[prob.cam_idx], prob.uv)
    return r * prob.weight[:, None]


def _segments(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """The (n, O) 0/1 matrix of segment ids ``idx``: row s picks the
    observations of segment s."""
    return (idx[None, :] == torch.arange(n, device=idx.device)[:, None]).to(dtype)


def _segment_sum(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of ``x`` (O, ...) by the segment matrix ``seg``."""
    return (seg @ x.flatten(1)).reshape((seg.shape[0],) + x.shape[1:])


def _reduce(mesh: Optional[Mesh], *blocks: torch.Tensor):
    """The sums of ``blocks`` over the mesh's ranks, in one collective;
    the blocks themselves without a reduction."""
    if mesh is None or mesh.group is None:
        return blocks
    flat = all_reduce(mesh, torch.cat([b.reshape(-1) for b in blocks]))
    parts = flat.split([b.numel() for b in blocks])
    return tuple(p.reshape(b.shape) for p, b in zip(parts, blocks))


def bundle_adjust(prob: BAProblem, n_iters: int = 30, mesh: Optional[Mesh] = None,
                  axis_name: Optional[str] = None) -> BAResult:
    """LM with Schur elimination of point blocks (``upsp_tpu/camera/ba.py
    :80-183``), on the problem's device; over ``mesh``'s ranks, each with
    its own block of the observations, when given (module docstring)."""
    if axis_name is not None:
        raise TypeError(
            "bundle_adjust(axis_name=...) names a JAX mesh axis, which has no "
            "torch meaning: pass mesh= (a upsp_tpu_torch.parallel.mesh.Mesh) and "
            "each rank's block of the observations")
    C = prob.poses.shape[0]
    K = prob.points.shape[0]
    inv_ps2 = 1.0 / (prob.prior_sigma**2)
    ci, pi = prob.cam_idx.long(), prob.pt_idx.long()
    seg_c = _segments(ci, C, prob.uv.dtype)  # (C, O)
    seg_p = _segments(pi, K, prob.uv.dtype)  # (K, O)

    def cost(poses, points):
        r = _all_residuals(poses, points, prob)
        prior = (points - prob.points0).reshape(-1)
        (data,) = _reduce(mesh, (r * r).sum())
        return data + inv_ps2 * (prior * prior).sum()

    def step(poses, points, lam):
        args = (poses[ci], points[pi], prob.intrinsics[ci], prob.uv)
        w = prob.weight[:, None, None]
        if ci.shape[0]:
            Jc = _jac_pose(*args) * w  # (O, 2, 6)
            Jp = _jac_point(*args) * w  # (O, 2, 3)
        else:  # a rank with no observations: its block sums are zeros
            Jc, Jp = prob.uv.new_zeros((0, 2, 6)), prob.uv.new_zeros((0, 2, 3))
        r = _all_residuals(poses, points, prob)  # (O, 2)

        Hcc = _segment_sum(torch.einsum("oic,oid->ocd", Jc, Jc), seg_c)  # (C,6,6)
        Hpp = _segment_sum(torch.einsum("oic,oid->ocd", Jp, Jp), seg_p)  # (K,3,3)
        gc = _segment_sum(torch.einsum("oic,oi->oc", Jc, r), seg_c)  # (C,6)
        gp = _segment_sum(torch.einsum("oic,oi->oc", Jp, r), seg_p)  # (K,3)
        # dense camera-point coupling blocks W[c,k] (rigs are small): the
        # camera's blocks side by side, summed by point
        JcJp = torch.einsum("oic,oid->ocd", Jc, Jp).reshape(ci.shape[0], 1, 18)
        JcJp = seg_c.T[:, :, None] * JcJp  # (O, C, 18)
        W = _segment_sum(JcJp, seg_p).reshape(K, C, 6, 3).transpose(0, 1)  # (C,K,6,3)
        Hcc, Hpp, gc, gp, W = _reduce(mesh, Hcc, Hpp, gc, gp, W)

        # survey prior on the points + LM damping
        eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
        Hpp = Hpp + (inv_ps2 + lam) * eye3[None]
        gp = gp + inv_ps2 * (points - prob.points0)
        Hcc = Hcc + lam * torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)[None]

        # Schur complement onto cameras: S = Hcc - W Hpp^-1 W^T
        Hpp_inv = torch.linalg.inv_ex(Hpp)[0]  # (K,3,3)
        WHinv = torch.einsum("ckab,kbd->ckad", W, Hpp_inv)  # (C,K,6,3)
        S_blocks = torch.einsum("ckad,mkbd->cmab", WHinv, W)  # (C,C,6,6)
        S = _blocks_to_dense(Hcc, S_blocks)
        rhs = (gc - torch.einsum("ckad,kd->ca", WHinv, gp)).reshape(C * 6)
        d_cam = torch.linalg.solve_ex(S, rhs)[0].reshape(C, 6)
        # back-substitute point updates
        d_pt = torch.einsum("kab,kb->ka", Hpp_inv,
                            gp - torch.einsum("ckad,ca->kd", W, d_cam))
        return poses - d_cam, points - d_pt

    poses, points = prob.poses, prob.points
    lam = torch.tensor(1e-3, dtype=poses.dtype, device=poses.device)
    best_cost = cost(poses, points)
    for _ in range(n_iters):
        new_poses, new_points = step(poses, points, lam)
        new_cost = cost(new_poses, new_points)
        improved = new_cost < best_cost
        poses = torch.where(improved, new_poses, poses)
        points = torch.where(improved, new_points, points)
        best_cost = torch.where(improved, new_cost, best_cost)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 6.0), 1e-9, 1e8)
    r = _all_residuals(poses, points, prob)
    ssq, n_obs = _reduce(mesh, (r * r).sum(), (prob.weight > 0).sum().to(r.dtype))
    rms = torch.sqrt(ssq / torch.clamp_min(n_obs, 1))
    return BAResult(poses=poses, points=points, rms=rms, n_iters=n_iters)


def _blocks_to_dense(Hcc: torch.Tensor, S_blocks: torch.Tensor) -> torch.Tensor:
    """Assemble dense (6C,6C) Schur system: diag(Hcc) - S_blocks."""
    C = Hcc.shape[0]
    S = -S_blocks.transpose(1, 2).reshape(C * 6, C * 6)
    return S + torch.block_diag(*Hcc.unbind(0))


def build_problem(
    cam_params: list,
    target_xyz: np.ndarray,
    observations: list,
    prior_sigma: float = 0.01,
    dtype=torch.float64,
    device="cuda",
) -> BAProblem:
    """Host-side assembly, the problem on ``device``.

    ``observations``: list of (cam_index, point_index, (u, v)).
    ``prior_sigma``: how far targets may drift from their surveyed positions
    (model units — 0.01 in is tight, matching tgts-file survey accuracy).
    """
    C = len(cam_params)
    poses = np.zeros((C, 6))
    intr = np.zeros((C, 9))
    for c, p in enumerate(cam_params):
        poses[c, :3] = p.rvec.detach().cpu().numpy()
        poses[c, 3:] = p.tvec.detach().cpu().numpy()
        intr[c] = [float(p.fx), float(p.fy), float(p.cx), float(p.cy),
                   *p.dist.detach().cpu().numpy()]
    cam_idx = np.array([o[0] for o in observations], np.int64)
    pt_idx = np.array([o[1] for o in observations], np.int64)
    uv = np.array([o[2] for o in observations], np.float64).reshape(-1, 2)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)

    return BAProblem(
        poses=t(poses), points=t(target_xyz), points0=t(target_xyz),
        intrinsics=t(intr), cam_idx=t(cam_idx, torch.int64),
        pt_idx=t(pt_idx, torch.int64), uv=t(uv),
        weight=torch.ones(len(observations), dtype=dtype, device=device),
        prior_sigma=torch.tensor(prior_sigma, dtype=dtype, device=device),
    )


def poses_to_rmat_tvec(result: BAResult):
    """(C,3,3) rotation matrices + (C,3) translations from the BA result."""
    return (rodrigues(result.poses[:, :3]).cpu().numpy(),
            result.poses[:, 3:6].cpu().numpy())
