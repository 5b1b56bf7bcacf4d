"""VisibilityChecker: oblique-angle cull + BVH occlusion for calibration.

Port of ``upsp_tpu/camera/visibility.py`` (parity with
python/upsp/cam_cal_utils/visibility.py:17-560): back-face cull by the
sign-preserving cos^2 inequality (no arccos), occlusion rays from
epsilon-offset origins toward the camera.  The orientation math is host
numpy in f64, as in the JAX package.  Occlusion keeps the JAX package's
rule (``ops/projection.py`` ``target_walk``): the native host walk
(``upsp_tpu_torch.native``, built from ``cpp/`` by its ``native_library``)
when that library is there, else the device walk of ``ops/raycast.py``, on
f32 rays.  The reference prefers the native walk at scale ("compiles
poorly on TPU", ``upsp_tpu/pipeline/phase0.py:302-303``); which walk a
checker takes is logged once.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from upsp_tpu_torch import native
from upsp_tpu_torch.geometry.bvh import FlatBVH
from upsp_tpu_torch.geometry.grids import SurfaceModel, load_model
from upsp_tpu_torch.ops.projection import target_walk
from upsp_tpu_torch.ops.raycast import BVHArrays, bvh_to_device
from upsp_tpu_torch.parallel.mesh import resolve_device

log = logging.getLogger(__name__)

class VisibilityChecker:
    """Occlusion/orientation visibility oracle over a surface model.

    ``device``: where the device BVH lives and the device walk runs (the
    card by default; raises when CUDA is asked for and absent).  ``walk``
    says which walk the occlusion rays take.
    """

    def __init__(
        self,
        model_or_path,
        oblique_angle: float = 70.0,
        epsilon: float = 1e-4,
        debug_nogrid: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.oblique_angle = float(oblique_angle)
        self.epsilon = float(epsilon)
        self.update_oblique_angle(oblique_angle)
        # the library loaded (or built) first, so that the BVH builds
        # natively; numpy builds it without the library, as the JAX package
        native.native_or_none()
        if debug_nogrid:
            # single far-away micro-triangle: occlusion tests always pass
            verts = np.array(
                [[9e5, 0, 0], [9e5 + 1e-3, 0, 0], [9e5, 1e-3, 0]], np.float32
            )
            tris = np.array([[0, 1, 2]], np.int32)
            self.model = None
            self._bvh = native.build_bvh(verts, tris)
        else:
            if isinstance(model_or_path, SurfaceModel):
                self.model = model_or_path
            else:
                self.model = load_model(str(model_or_path))
            self._bvh = native.build_bvh(self.model.vertices, self.model.triangles)
        self._bvh_dev = bvh_to_device(self._bvh, device=self.device)
        self._walk = target_walk(self._bvh, self._bvh_dev, self.device,
                                        max_leaf=self._bvh.max_leaf_count)
        log.info("visibility occlusion rays take the %s walk%s", self.walk,
                 "" if self.walk == "native" else f" on {self.device}")

    @property
    def walk(self) -> str:
        return self._walk.name

    @property
    def bvh(self) -> FlatBVH:
        return self._bvh

    @property
    def bvh_dev(self) -> BVHArrays:
        return self._bvh_dev

    def update_oblique_angle(self, oblique_angle: float) -> None:
        self.oblique_angle = float(oblique_angle)
        c = np.cos(np.deg2rad(oblique_angle))
        self.squared_cos_angle = c * c

    # -- orientation ---------------------------------------------------------

    def is_back_facing(self, t: np.ndarray, n: np.ndarray) -> np.ndarray:
        """Vectorized back-face test; t = camera - node (toward camera).

        Back-facing iff angle(t, n) > oblique_angle, evaluated as the
        sign-preserving inequality (t.n)|t.n| < cos^2(angle) (t.t)(n.n).
        """
        t = np.atleast_2d(t)
        n = np.atleast_2d(n)
        proj = np.sum(t * n, axis=-1)
        return proj * np.abs(proj) < (
            self.squared_cos_angle * np.sum(t * t, axis=-1) * np.sum(n * n, axis=-1)
        )

    # -- occlusion -----------------------------------------------------------

    def does_intersect(
        self, origins: np.ndarray, directions: np.ndarray
    ) -> np.ndarray:
        """Batched any-hit query; True where the ray strikes the mesh."""
        origins = np.atleast_2d(origins)
        directions = np.atleast_2d(directions)
        _, _, hit = self._walk.intersect(
            torch.as_tensor(origins).to(torch.float32),
            torch.as_tensor(directions).to(torch.float32))
        return hit.cpu().numpy()

    def is_visible(
        self,
        tvec_model_to_camera: np.ndarray,
        nodes: np.ndarray,
        normals: np.ndarray,
        return_angles: bool = False,
    ):
        """Indices of nodes that face the camera and are unoccluded.

        Rays start at node + epsilon*normal and point at the camera; any mesh
        hit means occluded (visibility.py:422-520 semantics).
        """
        cam = np.asarray(tvec_model_to_camera, np.float64).reshape(1, 3)
        nodes = np.asarray(nodes, np.float64)
        normals = np.asarray(normals, np.float64)
        t = cam - nodes
        t_unit = t / np.linalg.norm(t, axis=1, keepdims=True)
        n_unit = normals / np.linalg.norm(normals, axis=1, keepdims=True)
        back = self.is_back_facing(t_unit, n_unit)

        cand = np.nonzero(~back)[0]
        if cand.size == 0:
            return (np.zeros(0, np.int64), np.zeros(0)) if return_angles else np.zeros(0, np.int64)
        origins = nodes[cand] + self.epsilon * n_unit[cand]
        occluded = self.does_intersect(origins, t_unit[cand])
        visible = cand[~occluded]
        if return_angles:
            cosang = np.clip(np.sum(t_unit[visible] * n_unit[visible], axis=1), -1, 1)
            return visible, np.degrees(np.arccos(cosang))
        return visible

    def is_visible_and_inside_incal(
        self,
        tvec_model_to_camera: np.ndarray,
        nodes: np.ndarray,
        normals: np.ndarray,
        project_fn,
        image_hw,
        incal_bounds=None,
    ) -> np.ndarray:
        """Visible nodes whose projections also land in the trusted-distortion
        region (visibility.py:497 role).

        ``project_fn``: (K,3)->(K,2) pixel projection; ``incal_bounds``: an
        AlphaShape from camera/internal.py (None -> image rectangle only).
        """
        from upsp_tpu_torch.camera.internal import points_inside_incal

        vis_idx = self.is_visible(tvec_model_to_camera, nodes, normals)
        if vis_idx.size == 0:
            return vis_idx
        pts = np.asarray(project_fn(np.asarray(nodes)[vis_idx]))
        ok = points_inside_incal(incal_bounds, pts, image_hw)
        return vis_idx[ok]

    def angle_between(self, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
        """Angle in degrees between row-vector batches."""
        v1 = np.atleast_2d(v1)
        v2 = np.atleast_2d(v2)
        u1 = v1 / np.linalg.norm(v1, axis=-1, keepdims=True)
        u2 = v2 / np.linalg.norm(v2, axis=-1, keepdims=True)
        return np.degrees(np.arccos(np.clip(np.sum(u1 * u2, axis=-1), -1, 1)))
