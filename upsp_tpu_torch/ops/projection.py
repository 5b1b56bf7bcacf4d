"""Pixel -> grid-node projection.

Port of ``upsp_tpu/ops/projection.py``.  Each camera carries, per node, a
flat pixel index and a weight; a frame projects by one gather and a
multiply.  :class:`NodeWalk` chooses among the three projection
functions below, and :func:`target_walk` the walk of the target rays,
each by the JAX package's rule (the native walk when the library loads
or builds).
Visibility is built one of two ways, as in the JAX package:
:func:`build_node_projection_host` casts the native walker's rays
(``upsp_tpu_torch.native``, built from ``cpp/``) and projects in f64 on the
host; :func:`build_node_projection` runs on the device of its tensors,
projects in their dtype and walks ``ops/raycast.py``'s device BVH.
:func:`build_node_projection_card` is the native route with its rays on
the card: K11 (``ops/walk_kernels.py``) casts every node's ray, retries
and tests bit for bit with the native walker while the host projects in
f64, and the host rechecks and assembles as
:func:`build_node_projection_host` does (``_settle``), so the two give
the same projection on every node.

The native walk tests triangles with f32 Moller-Trumbore and no
tolerance.  Its rays start at the camera, far from a node's small
triangles, so a ray that lands within about 1e-6 of a triangle edge can
fail the test on both triangles of a shared edge, and on the one
triangle of a boundary edge.  On a flat axis-aligned plate the jittered
retries land on the grid lines through the node, so a boundary node can
lose every ray.  :func:`build_node_projection_host` therefore rechecks
the nodes that every test but the rays passes, and whose native rays hit
nothing or hit a triangle at their targets' distance, with the port's
watertight test over the whole mesh (``ops/raycast.py``
``flat_intersector``; the test's band of a few ulps counts an edge as
inside).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from upsp_tpu_torch import native
from upsp_tpu_torch.camera.model import CameraParams, cam_center, project_points
from upsp_tpu_torch.ops.raycast import (
    BVHArrays, Intersector, bvh_intersect, bvh_to_device, flat_intersector,
    native_intersector, node_visibility, oblique_cos_filter)
from upsp_tpu_torch.ops.walk_kernels import (
    NodeRays, WalkScene, decode, upload_scene, walk_nodes)
from upsp_tpu_torch.utils import timing

log = logging.getLogger("upsp_tpu")

# a native hit farther than this x the distance from the ray's target
# (nearer: an occluder; beyond: the ray passed the node) settles the node,
# and the recheck leaves it
SETTLED_REL = 1e-4


class NodeProjection(NamedTuple):
    """Per-camera node->pixel map (all (N,) tensors)."""

    pixel_index: torch.Tensor  # int64 flat pixel (row * W + col); 0 if invalid
    weight: torch.Tensor  # float32 visibility/overlap weight
    u: torch.Tensor  # float32 normalised image u (0 if invalid)
    v: torch.Tensor  # float32 normalised v
    visible: torch.Tensor  # bool raw visibility before weighting

    def to(self, device) -> "NodeProjection":
        return NodeProjection(*(t.to(device) for t in self))


def build_node_projection(
    params: CameraParams, bvh: BVHArrays, triangles: torch.Tensor,
    vertices: torch.Tensor, normals: torch.Tensor, is_datanode: torch.Tensor,
    oblique_angle_deg: float, height: int, width: int, max_leaf: int = 4,
    n_jitter: int = 6, jitter: float = 1e-4,
) -> NodeProjection:
    """:func:`build_node_projection_host`'s semantics on the device of
    ``vertices`` (``upsp_tpu/ops/projection.py:39-115``): the projection in
    the wider of the camera's and the vertices' dtypes, the in-frame test,
    the oblique cull and the data-node mask, then the owning-triangle test
    (6 jittered retries) on ``bvh``'s device walk.  ``visible`` is the AND
    of the four, so rays are cast only for the nodes that pass the other
    three (the JAX package casts every node's; the result is the same)."""
    dev = vertices.device
    n = vertices.shape[0]
    params = CameraParams(*(t.to(dev) for t in params))
    center = cam_center(params).to(vertices.dtype)
    pix = project_points(params, vertices)
    in_frame = (
        (pix[:, 0] >= 0) & (pix[:, 0] < width)
        & (pix[:, 1] >= 0) & (pix[:, 1] < height)
    )
    d = vertices - center
    dirs = d / torch.linalg.norm(d, dim=1, keepdim=True).clamp_min(1e-30)
    forward = oblique_cos_filter(normals, dirs.to(normals.dtype), oblique_angle_deg)
    (cand,) = torch.nonzero(is_datanode.to(torch.bool) & in_frame & forward,
                            as_tuple=True)
    visible = torch.zeros(n, dtype=torch.bool, device=dev)
    if cand.numel():
        visible[cand], _ = node_visibility(bvh, triangles, vertices, cand, center,
                                           max_leaf=max_leaf, n_jitter=n_jitter,
                                           jitter=jitter)
    col = torch.round(pix[:, 0]).clamp(0, width - 1).to(torch.int64)
    row = torch.round(pix[:, 1]).clamp(0, height - 1).to(torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return NodeProjection(
        pixel_index=torch.where(visible, row * width + col, torch.zeros_like(col)),
        weight=visible.to(torch.float32),
        u=torch.where(visible, (pix[:, 0] / width).to(torch.float32), zero),
        v=torch.where(visible, (pix[:, 1] / height).to(torch.float32), zero),
        visible=visible,
    )


class HostWalk(NamedTuple):
    """:func:`build_node_projection_host`'s result: the projection and the
    recheck's readings, as its span and counters take them."""

    projection: NodeProjection
    recheck_s: float  # seconds of the span ``phase0.walk.recheck``
    rechecked: int  # nodes recast (the counter ``walk.rechecked``)
    recovered: int  # of them, nodes made visible (``walk.recovered``)


def _recast(cand: np.ndarray, flat_bvh, triangles: np.ndarray, vertices: np.ndarray,
            center: torch.Tensor, n_jitter: int, jitter: float) -> np.ndarray:
    """(K,) bool: :func:`~upsp_tpu_torch.ops.raycast.node_visibility` of
    the nodes ``cand`` over the whole mesh, on the CPU, by the watertight
    test (:func:`~upsp_tpu_torch.ops.raycast.flat_intersector`)."""
    verts = torch.from_numpy(np.asarray(vertices))
    seen, _ = node_visibility(None, torch.from_numpy(np.asarray(triangles)), verts,
                              torch.from_numpy(cand), center.to(verts.dtype),
                              n_jitter=n_jitter, jitter=jitter,
                              intersect=flat_intersector(flat_bvh))
    return seen.numpy()


def _project64(params: CameraParams, vertices: np.ndarray) -> torch.Tensor:
    """(N, 2) f64 pixel positions of the nodes (the host's projection)."""
    return project_points(params, torch.from_numpy(np.asarray(vertices, np.float64)))


def _native_rays(flat_bvh, triangles: np.ndarray, vertices: np.ndarray,
                 normals: np.ndarray, center: np.ndarray, thresh: float,
                 n_jitter: int, jitter: float) -> NodeRays:
    """Every node's rays on the native walk from the f64 camera centre
    ``center``: the ray to the node, then, while no ray has landed on one
    of the node's triangles, up to ``n_jitter`` jittered ones (only the
    nodes still missing cast a round's rays), and the oblique test.  K11
    (``ops/walk_kernels.py``) is its twin on the card.  Counts the rays
    cast as ``walk.rays.host``."""
    n = vertices.shape[0]
    d = vertices.astype(np.float64) - center
    dist = np.linalg.norm(d, axis=1, keepdims=True)
    dirs = (d / np.maximum(dist, 1e-30)).astype(np.float32)
    origins = np.broadcast_to(center.astype(np.float32), vertices.shape)

    node_ids = np.arange(n)
    t, prim, hit = native.bvh_intersect(flat_bvh, origins, dirs)
    own = hit & np.any(triangles[np.maximum(prim, 0)] == node_ids[:, None], axis=1)
    settled = hit & (np.abs(t - dist[:, 0]) > SETTLED_REL * dist[:, 0])
    retries = np.zeros(n, np.uint8)
    offsets = np.array(
        [[-jitter, 0, 0], [jitter, 0, 0], [0, -jitter, 0],
         [0, jitter, 0], [0, 0, -jitter], [0, 0, jitter]], np.float64,
    )
    for k in range(n_jitter):
        (missing,) = np.nonzero(~own)
        if not missing.size:
            break
        dk = vertices[missing].astype(np.float64) + offsets[k] - center
        norm = np.linalg.norm(dk, axis=1)
        dk = (dk / norm[:, None]).astype(np.float32)
        t_k, prim_k, hit_k = native.bvh_intersect(flat_bvh, origins[missing], dk)
        trik = triangles[np.maximum(prim_k, 0)]
        own[missing] = hit_k & np.any(trik == missing[:, None], axis=1)
        settled[missing] |= hit_k & (np.abs(t_k - norm) > SETTLED_REL * norm)
        retries[missing] += 1
        t[missing], prim[missing] = t_k, prim_k
    forward = np.sum(normals * dirs, axis=-1) < thresh
    timing.count("walk.rays.host", n + int(retries.sum()))
    return NodeRays(*(torch.from_numpy(a) for a in (own, settled, forward, retries,
                                                     t, prim)))


def _settle(params: CameraParams, flat_bvh, triangles: np.ndarray,
            vertices: np.ndarray, is_datanode: np.ndarray, pix: torch.Tensor,
            own: torch.Tensor, settled: torch.Tensor, forward: torch.Tensor,
            height: int, width: int, n_jitter: int, jitter: float) -> HostWalk:
    """The rays' tests ((N,) bool tensors on the host) to the projection:
    the recheck of the tested nodes no ray owned and none settled, then
    ``visible`` and the pixels of the f64 projection ``pix``."""
    px, py = pix[:, 0], pix[:, 1]
    in_frame = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    tested = torch.from_numpy(np.asarray(is_datanode, bool)) & in_frame & forward
    with timing.timed("phase0.walk.recheck") as clock:
        (cand,) = torch.nonzero(tested & ~own & ~settled, as_tuple=True)
        if cand.numel():
            own[cand] = torch.from_numpy(_recast(cand.numpy(), flat_bvh, triangles,
                                                 vertices, cam_center(params),
                                                 n_jitter, jitter))
        recovered = int(own[cand].sum())
    timing.count("walk.rechecked", int(cand.numel()))
    timing.count("walk.recovered", recovered)
    visible = tested & own
    col = torch.round(px).clamp(0, width - 1).to(torch.int64)
    row = torch.round(py).clamp(0, height - 1).to(torch.int64)
    zero = torch.zeros((), dtype=pix.dtype)
    proj = NodeProjection(
        pixel_index=torch.where(visible, row * width + col, 0),
        weight=visible.to(torch.float32),
        u=torch.where(visible, px / width, zero).to(torch.float32),
        v=torch.where(visible, py / height, zero).to(torch.float32),
        visible=visible,
    )
    return HostWalk(proj, clock.seconds, int(cand.numel()), recovered)


def _oblique_threshold(oblique_angle_deg: float) -> float:
    """The oblique test's bound on cos(normal, ray) (an f64 scalar)."""
    return np.cos(np.deg2rad(180.0 - oblique_angle_deg))


def build_node_projection_host(
    params: CameraParams, flat_bvh, triangles: np.ndarray,
    vertices: np.ndarray, normals: np.ndarray, is_datanode: np.ndarray,
    oblique_angle_deg: float, height: int, width: int, n_jitter: int = 6,
    jitter: float = 1e-4,
) -> HostWalk:
    """Visibility-tested nearest-pixel assignment for every node: in-frame,
    the closest hit of the camera->node ray lands on a triangle of the node
    (6 jittered retries), then the oblique-angle cull
    (psp_process.cpp:167-355 semantics).  The rays take the native walk
    (:func:`_native_rays`); :func:`build_node_projection_card` casts the
    same rays with K11.

    The recheck (the module docstring): a data node in the frame and
    facing the camera that no native ray owned, and whose native rays hit
    nothing or hit within ``SETTLED_REL`` of their targets' distance, is
    recast by :func:`~upsp_tpu_torch.ops.raycast.node_visibility` over
    the whole mesh with the watertight test (:func:`_recast`).  Only its
    ownership can change: its pixel and ``u``, ``v`` are the f64
    projection's.  The recheck is the span ``phase0.walk.recheck``; the
    counters ``walk.rechecked`` and ``walk.recovered`` take the nodes
    recast and those it made visible, and the result carries the same
    readings."""
    center = cam_center(params).numpy().astype(np.float64)
    pix = _project64(params, vertices)
    rays = _native_rays(flat_bvh, triangles, vertices, normals, center,
                        _oblique_threshold(oblique_angle_deg), n_jitter, jitter)
    return _settle(params, flat_bvh, triangles, vertices, is_datanode, pix,
                   rays.own, rays.settled, rays.forward, height, width, n_jitter, jitter)


def build_node_projection_card(
    params: CameraParams, scene: WalkScene, flat_bvh, triangles: np.ndarray,
    vertices: np.ndarray, is_datanode: np.ndarray, oblique_angle_deg: float,
    height: int, width: int, n_jitter: int = 6, jitter: float = 1e-4,
) -> HostWalk:
    """:func:`build_node_projection_host` with the rays on ``scene``'s
    device (``ops/walk_kernels.py`` :func:`~upsp_tpu_torch.ops.walk_kernels.walk_nodes`,
    ``scene`` made by ``upload_scene`` from ``flat_bvh`` and the mesh): K11
    on the card, its plain twin on the CPU.  K11 runs while the host
    projects the nodes in f64; one byte a node comes back, and the recheck
    and the assembly are the host's, so the result is the native route's
    on every node.  Counts the rays K11 cast as ``walk.rays.card``."""
    flags = walk_nodes(scene, cam_center(params), _oblique_threshold(oblique_angle_deg),
                       n_jitter, jitter, SETTLED_REL)
    pix = _project64(params, vertices)
    own, settled, forward, retries = decode(flags.cpu().numpy())
    timing.count("walk.rays.card", scene.n_nodes + int(retries.sum(dtype=np.int64)))
    return _settle(params, flat_bvh, triangles, vertices, is_datanode, pix,
                   *(torch.from_numpy(a) for a in (own, settled, forward)), height, width,
                   n_jitter, jitter)


class NodeWalk:
    """Phase 0's walk of every node's visibility rays, chosen once from
    what the process has (the route logged):

    - the native library and a CUDA ``device``: K11 casts the rays
      (:func:`build_node_projection_card`); the flat BVH and the mesh go
      to the card at the first camera's walk, shared by the cameras;
    - the native library on the CPU: the library casts them
      (:func:`build_node_projection_host`);
    - no library: the device walk over :attr:`bvh_dev` on ``device``
      (:func:`build_node_projection`, an f32 projection), which rechecks
      no node.

    The native routes project in f64 on the host and leave their
    projections there (:attr:`where`).  :meth:`load` takes the flat BVH
    and the model, :meth:`project` walks one camera."""

    def __init__(self, device, max_leaf: int = 4):
        self.device = torch.device(device)
        self.max_leaf = max_leaf
        self.native = native.native_or_none() is not None
        self.card = self.native and self.device.type == "cuda"
        self.flat_bvh = None  # the native walk's (None on the device walk)
        self.bvh_dev: Optional[BVHArrays] = None  # the device walk's
        self._model = self._scene = self._mesh = None
        log.warning("phase 0: visibility rays take the %s walk%s",
                    "native" if self.native else "device",
                    f" (K11 on {self.device})" if self.card else
                    "" if self.native else f" on {self.device}")

    @property
    def where(self) -> torch.device:
        """Where :meth:`project`'s projections are."""
        return torch.device("cpu") if self.native else self.device

    def load(self, flat_bvh, model) -> None:
        """The flat BVH and the model (``geometry.grids.SurfaceModel``)
        to walk; the device walk copies them to ``device``."""
        if self.native:
            self.flat_bvh, self._model = flat_bvh, model
            return
        self.bvh_dev = bvh_to_device(flat_bvh, device=self.device)
        self._mesh = {k: torch.from_numpy(np.asarray(getattr(model, k), dt)).to(self.device)
                      for k, dt in (("triangles", np.int64), ("vertices", None),
                                    ("normals", None), ("is_datanode", bool))}

    def project(self, params: CameraParams, oblique_angle_deg: float, height: int,
                width: int) -> HostWalk:
        """One camera's projection and its recheck's readings."""
        if not self.native:
            return HostWalk(build_node_projection(
                params, self.bvh_dev, oblique_angle_deg=oblique_angle_deg,
                height=height, width=width, max_leaf=self.max_leaf, **self._mesh), 0.0, 0, 0)
        m = self._model
        if not self.card:
            return build_node_projection_host(
                params, self.flat_bvh, m.triangles, m.vertices, m.normals, m.is_datanode,
                oblique_angle_deg=oblique_angle_deg, height=height, width=width)
        if self._scene is None:
            self._scene = upload_scene(self.flat_bvh, m.triangles, m.vertices, m.normals,
                                       self.device)
        return build_node_projection_card(
            params, self._scene, self.flat_bvh, m.triangles, m.vertices, m.is_datanode,
            oblique_angle_deg=oblique_angle_deg, height=height, width=width)


class TargetWalk(NamedTuple):
    """:func:`target_walk`'s walk."""

    name: str  # "native" or "device"
    intersect: Intersector


def target_walk(flat_bvh, bvh_dev: Optional[BVHArrays], device,
                       max_leaf: int = 4) -> TargetWalk:
    """The walk of target and occlusion rays: the native host walk over
    ``flat_bvh`` when it is given and the library loads, else the device
    walk over ``bvh_dev`` (made from ``flat_bvh`` on ``device`` when
    None).  Its ``intersect``: rays in, (t, prim, hit) tensors out, on the
    rays' device for the native walk and on ``bvh_dev``'s for the device
    walk."""
    if flat_bvh is not None and native.native_or_none() is not None:
        return TargetWalk("native", native_intersector(flat_bvh))
    if bvh_dev is None:
        bvh_dev = bvh_to_device(flat_bvh, device=device)

    def walk(origins, directions):
        return bvh_intersect(bvh_dev, origins, directions, max_leaf=max_leaf)

    return TargetWalk("device", walk)


def view_angles_deg(vertices: torch.Tensor, normals: torch.Tensor,
                    center: torch.Tensor) -> torch.Tensor:
    """Angle (deg) between the camera->node direction and the node normal
    (a facing surface scores ~180)."""
    d = vertices - center
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-30)
    cos_t = (d * normals).sum(dim=-1).clamp(-1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos_t))


def adjust_projection_for_weights(
    projections: Sequence[NodeProjection], cam_centers: Sequence[torch.Tensor],
    vertices: torch.Tensor, normals: torch.Tensor, overlap: str = "best_view",
) -> list:
    """Rescale weights where several cameras see one node: best_view gives
    the largest view angle weight 1 (first camera wins ties);
    average_views weights by angle / sum of angles.  Nodes seen by one
    camera keep weight 1."""
    C = len(projections)
    vis = torch.stack([p.visible for p in projections])  # (C, N)
    angles = torch.stack(
        [view_angles_deg(vertices, normals, c) for c in cam_centers]
    )
    angles = torch.where(vis, angles, torch.full_like(angles, -float("inf")))
    multi = vis.sum(dim=0) > 1
    if overlap == "best_view":
        best = torch.argmax(angles, dim=0)
        w = (torch.arange(C, device=best.device)[:, None] == best[None, :]).to(
            torch.float32)
    elif overlap in ("average_views", "average_view"):
        pos = torch.where(vis, angles, torch.zeros_like(angles))
        w = (pos / pos.sum(dim=0).clamp_min(1e-30)).to(torch.float32)
    else:
        raise ValueError(f"unknown overlap type: {overlap}")
    new_w = torch.where(multi[None, :], w * vis, vis.to(torch.float32))
    return [
        NodeProjection(p.pixel_index, new_w[c], p.u, p.v, p.visible)
        for c, p in enumerate(projections)
    ]


def identify_skipped_nodes(projections: Sequence[NodeProjection]) -> torch.Tensor:
    """(N,) bool: nodes no camera covers (NaN downstream)."""
    return ~torch.stack([p.visible for p in projections]).any(dim=0)


def project_frame(frames: torch.Tensor, proj: NodeProjection) -> torch.Tensor:
    """(B, H, W) frames of one camera -> (B, N) weighted node values."""
    b = frames.shape[0]
    return frames.reshape(b, -1)[:, proj.pixel_index] * proj.weight


def project_frames_multicam(frames: torch.Tensor,
                            projections: Sequence[NodeProjection],
                            skipped: torch.Tensor) -> torch.Tensor:
    """Combine cameras: the sum of their weighted gathers, NaN at skipped
    nodes.  ``frames``: (C, H, W) processed images -> (N,), or a batch
    (B, C, H, W) -> (B, N)."""
    x = frames if frames.dim() == 4 else frames[None]
    total = sum(project_frame(x[:, c], p) for c, p in enumerate(projections))
    total = torch.where(skipped, torch.full_like(total, float("nan")), total)
    return total if frames.dim() == 4 else total[0]


def projections_to_arrays(projections: Sequence[NodeProjection]) -> NodeProjection:
    """Stack per-camera projections into one of (C, N) tensors."""
    return NodeProjection(*(torch.stack(f) for f in zip(*projections)))


def coverage(projections: Sequence[NodeProjection], height: int,
             width: int) -> torch.Tensor:
    """Project an all-ones frame through every camera (coverage dataset)."""
    dev = projections[0].weight.device
    ones = torch.ones((1, height, width), dtype=torch.float32, device=dev)
    cov = sum(project_frame(ones, p)[0] for p in projections)
    return torch.where(identify_skipped_nodes(projections),
                       torch.zeros_like(cov), cov)
