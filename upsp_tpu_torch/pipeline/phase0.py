"""Phase 0: one-time setup — model, BVH, camera cals, projections, patches.

Port of ``upsp_tpu/pipeline/phase0.py``.  The visibility rays take the
walk that ``ops/projection.py`` :class:`~upsp_tpu_torch.ops.projection.NodeWalk`
chooses by the JAX package's rule: the native walk when the library
(``upsp_tpu_torch.native``, built from ``cpp/``) loads or builds, its
rays cast by K11 on a CUDA device and by the library on the CPU, its
projections f64 on the host and the finished state moved to ``device``;
else the device walk, the BVH, the projections, the weights and the skip
mask on ``device`` (f32 projection, as the JAX package's device route).
The host builds the grid, the BVH and the patch clusters either way.  The
route taken is logged.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from upsp_tpu_torch.geometry.grids import SurfaceModel, load_model
from upsp_tpu_torch.io.camera_json import read_camera_json
from upsp_tpu_torch.io.tgts import Target, read_tgts, targets_as_arrays
from upsp_tpu_torch.pipeline.config import ProcessingConfig
from upsp_tpu_torch.camera.model import (
    CameraParams,
    cam_center,
    make_camera_params,
    project_points,
)
from upsp_tpu_torch.ops.image import fix_hot_pixels, patch_threshold_from_frame
from upsp_tpu_torch.ops.patching import (
    PatchOperator,
    build_patch_clusters,
    build_patch_operator,
    cluster_targets,
    threshold_bounds,
)
from upsp_tpu_torch.ops.projection import (
    NodeProjection,
    NodeWalk,
    adjust_projection_for_weights,
    identify_skipped_nodes,
    target_walk,
)
from upsp_tpu_torch.ops.raycast import BVHArrays
from upsp_tpu_torch.utils import timing

log = logging.getLogger("upsp_tpu")


@dataclasses.dataclass
class Phase0State:
    """Everything phase 1 needs; per-frame tensors live on ``device``."""

    model: SurfaceModel
    bvh: Any  # upsp_tpu_torch.geometry.bvh.FlatBVH (host arrays)
    cam_params: List[CameraParams]
    projections: List[NodeProjection]  # weight-adjusted
    skipped: torch.Tensor  # (N,) bool
    patch_ops: List[Optional[PatchOperator]]
    ref_frames: torch.Tensor  # (C, H, W) float32 hot-pixel-fixed first frames
    superseded_by: torch.Tensor  # (N,) int64 overlap-adjustment gather
    image_hw: Tuple[int, int]
    config: ProcessingConfig
    patch_diags: Optional[List[Optional[dict]]] = None
    device: torch.device = torch.device("cpu")
    # the derived phase-1 parameters, when handed over from elsewhere
    # (state.from_jax_state); otherwise pipeline.phase1 derives them
    params: Any = None
    # the device BVH of the device walk (None on the native walk)
    bvh_dev: Optional[BVHArrays] = None

    @property
    def n_nodes(self) -> int:
        return self.model.size

    def to(self, device) -> "Phase0State":
        """The same state with its tensors on ``device`` (phase-1
        parameters are derived again there)."""
        device = torch.device(device)
        return dataclasses.replace(
            self,
            projections=[p.to(device) for p in self.projections],
            skipped=self.skipped.to(device),
            patch_ops=[None if op is None else op.to(device)
                       for op in self.patch_ops],
            ref_frames=self.ref_frames.to(device),
            superseded_by=self.superseded_by.to(device),
            device=device,
            params=None,
            bvh_dev=None if self.bvh_dev is None else BVHArrays(
                *(t.to(device) for t in self.bvh_dev)),
        )

    @property
    def n_cameras(self) -> int:
        return len(self.cam_params)


def _build_bvh(model: SurfaceModel, max_leaf: int):
    """The model's flat BVH, native when the library is loaded and numpy
    otherwise (as the JAX package builds it); SAH from 2M triangles."""
    from upsp_tpu_torch.native import build_bvh

    method = os.environ.get(
        "UPSP_BVH_METHOD",
        "sah" if model.triangles.shape[0] >= 2_000_000 else "median",
    )
    return build_bvh(model.vertices, model.triangles, leaf_size=max_leaf,
                     method=method)


def visible_targets(
    targets: Sequence[Target], params: CameraParams,
    bvh_dev: Optional[BVHArrays], model: SurfaceModel,
    oblique_angle_deg: float, image_hw: Tuple[int, int], max_leaf: int = 4,
    flat_bvh=None,
) -> List[Target]:
    """getTargets parity: in-frame, unoccluded, facing within the oblique
    limit; the normal is the nearest node's (psp_process.cpp:92-106).  As
    in the JAX package, the rays take the native walk over ``flat_bvh``
    when it is given and the library loads, else ``bvh_dev``'s device walk
    (``max_leaf`` its leaf size; made from ``flat_bvh`` on the parameters'
    device when None), as ``ops/projection.py`` ``target_walk`` chooses.
    With neither, the flat BVH is built from the model
    with ``max_leaf`` triangles a leaf, as :func:`run_phase0` builds it."""
    if not targets:
        return []
    if flat_bvh is None and bvh_dev is None:
        flat_bvh = _build_bvh(model, max_leaf)
    walk = target_walk(flat_bvh, bvh_dev, params.rvec.device, max_leaf)
    H, W = image_hw
    xyz, _, _ = targets_as_arrays(targets)
    uv = project_points(params, torch.from_numpy(xyz)).numpy()
    in_frame = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    center = cam_center(params).numpy()
    d = xyz - center
    dist = np.linalg.norm(d, axis=1)
    dirs = d / dist[:, None]
    origins = np.broadcast_to(center, xyz.shape).astype(np.float32)
    t, _, hit = walk.intersect(torch.from_numpy(origins),
                               torch.from_numpy(dirs.astype(np.float32)))
    t, hit = t.cpu().numpy(), hit.cpu().numpy()
    occluded = hit & (t < dist - 1e-3)
    hit_pos = np.where(hit[:, None], center + dirs * t[:, None], xyz)
    normals = model.normals[model.nearest_node(hit_pos)]
    ang = np.arccos(np.clip(np.sum(normals * dirs, axis=1), -1, 1))
    forward = ang > np.deg2rad(180.0 - oblique_angle_deg)
    keep = in_frame & hit & (~occluded) & forward
    out = []
    for i, tg in enumerate(targets):
        if keep[i]:
            tg2 = dataclasses.replace(tg)
            tg2.uv = uv[i]
            out.append(tg2)
    return out


def target_image_diameters(targets: Sequence[Target], params: CameraParams,
                           model: SurfaceModel,
                           image_hw: Tuple[int, int]) -> np.ndarray:
    """Projected diameter (px) via a 4-point circle in the surface plane
    (get_target_diameters parity, psp_process.cpp:117-165)."""
    H, W = image_hw
    diams = np.zeros(len(targets))
    for i, tg in enumerate(targets):
        if tg.diameter == 0.0 or tg.uv is None:
            continue
        if not (0 <= tg.uv[0] < W and 0 <= tg.uv[1] < H):
            continue
        n = model.normals[model.nearest_node(tg.xyz[None, :])[0]].astype(np.float64)
        a = np.cross(n, [1.0, 0.0, 0.0])
        if np.linalg.norm(a) < 1e-8:
            a = np.cross(n, [0.0, 1.0, 0.0])
        a /= np.linalg.norm(a)
        b = np.cross(a, n)
        total = 0.0
        for k in range(4):
            theta = 2 * np.pi * k / 4
            pt = tg.xyz + 0.5 * tg.diameter * (np.cos(theta) * a + np.sin(theta) * b)
            proj = project_points(params, torch.from_numpy(pt[None, :])).numpy()[0]
            total += 2.0 * np.linalg.norm(proj - tg.uv)
        diams[i] = total / 4.0
    return diams


def build_patcher_for_camera(
    cfg: ProcessingConfig, params: CameraParams,
    bvh_dev: Optional[BVHArrays], model: SurfaceModel,
    first_frame: np.ndarray, targets_file: str, image_hw: Tuple[int, int],
    bit_depth: int = 12, max_leaf: int = 4, flat_bvh=None,
):
    """InitializeImagePatches parity: visible targets + fiducials ->
    clusters -> boundary threshold -> composed patch operator.  Returns
    (PatchOperator | None, diagnostics | None).  ``bvh_dev``, ``max_leaf``
    and ``flat_bvh``: the rays' walk (:func:`visible_targets`)."""
    all_t = read_tgts(targets_file) + read_tgts(targets_file, section="*Fiducials")
    if not all_t:
        return None, None
    oblique = min(cfg.oblique_angle + 5.0, 90.0)
    vis = visible_targets(all_t, params, bvh_dev, model, oblique, image_hw,
                          max_leaf=max_leaf, flat_bvh=flat_bvh)
    if not vis:
        return None, None
    diams = target_image_diameters(vis, params, model, image_hw) * cfg.target_diam_sf
    keep = diams > 0
    vis_kept = [t for t, k in zip(vis, keep) if k]
    uv = np.stack([t.uv for t in vis])[keep]
    diams = diams[keep]
    if uv.shape[0] == 0:
        return None, None
    groups = cluster_targets(uv, diams, cfg.bound_thickness + cfg.buffer_thickness)
    cluster_of = np.zeros(uv.shape[0], np.int32)
    for gi, g in enumerate(groups):
        cluster_of[g] = gi
    diag = {
        "uv": uv,
        "cluster_of": cluster_of,
        "names": [str(getattr(t, "idx", i)) for i, t in enumerate(vis_kept)],
    }
    clusters = build_patch_clusters(
        uv, diams, image_hw, bound_pts=cfg.bound_thickness,
        buffer=cfg.buffer_thickness,
    )
    thresh = patch_threshold_from_frame(first_frame, bit_depth)
    clusters = threshold_bounds(clusters, first_frame, thresh, offset=2)
    return build_patch_operator(clusters, image_hw), diag


def _apply_normals_file(model: SurfaceModel, path: str) -> None:
    """Normals-override file: 'nidx nx ny nz' rows (set_surface_normals)."""
    data = np.loadtxt(path, ndmin=2)
    if data.size:
        model.set_normals(data[:, 0].astype(np.int64), data[:, 1:4])


def run_phase0(
    cfg: ProcessingConfig, first_frames: Sequence[np.ndarray],
    bit_depths: Optional[Sequence[int]] = None, device="cuda",
    model: Optional[SurfaceModel] = None, max_leaf: int = 4,
    stage_times: Optional[dict] = None,
) -> Phase0State:
    """Build the phase-0 state from the config and per-camera first frames,
    its tensors on ``device`` (the card unless the caller asks for the
    CPU); the visibility rays take :class:`NodeWalk`'s walk (the module
    docstring).  ``stage_times``, when a dict, receives the walk's
    readings over all cameras, as its spans and counters take them:
    ``phase0.walk`` and ``phase0.walk_recheck`` (seconds) and
    ``phase0.walk_rechecked`` (the nodes recast, a float; the device walk
    rechecks none)."""
    device = torch.device(device)
    walker = NodeWalk(device, max_leaf)
    H, W = first_frames[0].shape
    image_hw = (H, W)
    bit_depths = bit_depths or [12] * len(first_frames)
    with timing.span("phase0.model"):
        if model is None:
            model = load_model(cfg.grid, tolerance=cfg.grid_tol)
        if cfg.x_max is not None:
            model.mark_nondata_x_max(cfg.x_max)
        if cfg.active_comps:
            from upsp_tpu_torch.io.comps import apply_active_comps

            n_masked = apply_active_comps(model, cfg.active_comps)
            if n_masked:
                log.info("active_comps: masked %d nodes of inactive components",
                         n_masked)
        if cfg.normals:
            _apply_normals_file(model, cfg.normals)
        bvh = _build_bvh(model, max_leaf)
        walker.load(bvh, model)

    walk_s, recheck_s, rechecked = 0.0, 0.0, 0
    cam_params: List[CameraParams] = []
    raw_projs: List[NodeProjection] = []
    patch_ops: List[Optional[PatchOperator]] = []
    patch_diags: List[Optional[dict]] = []
    for c, cam in enumerate(cfg.cameras):
        cal = read_camera_json(cam.calibration, dims_hw=image_hw)
        params = make_camera_params(cal.rmat, cal.tvec, cal.camera_matrix,
                                    cal.dist_coeffs, dtype=torch.float32)
        cam_params.append(params)
        with timing.timed("phase0.walk") as clock:
            walked = walker.project(params, cfg.oblique_angle, H, W)
        raw_projs.append(walked.projection)
        recheck_s += walked.recheck_s
        rechecked += walked.rechecked
        walk_s += clock.seconds
        if cfg.target_patcher == "polynomial" and cam.targets:
            with timing.span("phase0.patches"):
                op, diag = build_patcher_for_camera(
                    cfg, params, walker.bvh_dev, model, first_frames[c], cam.targets,
                    image_hw, bit_depth=bit_depths[c], max_leaf=max_leaf,
                    flat_bvh=walker.flat_bvh,
                )
        else:
            op, diag = None, None
        patch_ops.append(op)
        patch_diags.append(diag)

    if stage_times is not None:
        stage_times.update({"phase0.walk": walk_s, "phase0.walk_recheck": recheck_s,
                            "phase0.walk_rechecked": float(rechecked)})

    # the weights, the skip mask and the templates where the projections are
    where = walker.where
    with timing.span("phase0.weights"):
        projs = adjust_projection_for_weights(
            raw_projs, [cam_center(p).to(where) for p in cam_params],
            torch.from_numpy(np.asarray(model.vertices)).to(where),
            torch.from_numpy(np.asarray(model.normals)).to(where), overlap=cfg.overlap,
        )
        skipped = identify_skipped_nodes(projs)
        # the ECC template is the hot-pixel-FIXED first frame (phase 1 repairs
        # every input frame, so template and input see the same pixels)
        ref_frames = torch.stack([
            fix_hot_pixels(torch.tensor(np.asarray(f, np.float32), device=where))
            for f in first_frames
        ])
        return Phase0State(
            model=model,
            bvh=bvh,
            cam_params=cam_params,
            projections=[p.to(device) for p in projs],
            skipped=skipped.to(device),
            patch_ops=[None if op is None else op.to(device) for op in patch_ops],
            ref_frames=ref_frames.to(device),
            superseded_by=torch.as_tensor(
                np.asarray(model.superseded_by), dtype=torch.int64, device=device
            ),
            image_hw=image_hw,
            config=cfg,
            patch_diags=patch_diags,
            device=device,
            bvh_dev=walker.bvh_dev,
        )
