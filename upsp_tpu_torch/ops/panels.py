"""Hexahedral panel construction from PLOT3D surface/volume grids.

Reproduces the reference's ``Panels``/``create_integration_matrices`` roles
(cpp/include/integration.h:30-137, cpp/lib/integration.ipp:20-80,466-640 —
studied, not copied), vectorized:

- a SURFACE grid (kmax == 1) extrudes every quad face into a hexahedron:
  side planes through each edge with normal ``edge_dir x avg_face_normal``
  (average with the adjacent face's normal where one exists), top/bottom
  planes at ``+- height_sf * min_edge / 2`` along the face normal;
- a VOLUME grid (l-size == 2) uses each (j, k) cell directly as the hex and
  defines the panel surface at the l-midpoint.

Every panel is 6 half-spaces; assignment of model nodes to panels is one
blocked ``(Q, 3) @ (P*6, 3)^T`` comparison instead of the reference's
per-node Octree walk.  The (P, 6, N) force/moment operator then comes from
:func:`upsp_tpu_torch.ops.integration.integration_matrices` and applies to
a block of frames as one matmul on the device.

A numpy copy of ``upsp_tpu/ops/panels.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_vendored.py`` holds it to the
original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from upsp_tpu_torch.io.plot3d import StructGrid


@dataclasses.dataclass
class PanelSet:
    """P hexahedral panels as stacked half-spaces (outward normals)."""

    normals: np.ndarray  # (P, 6, 3) float64
    offsets: np.ndarray  # (P, 6) float64; inside: n.x <= d
    centers: np.ndarray  # (P, 3) float32 surface-face centroids
    surface: Optional[StructGrid] = None  # panel surface grid (volume input)

    @property
    def size(self) -> int:
        return int(self.normals.shape[0])


def _quad_mesh(grid: StructGrid, zone: int, layer: int = 0):
    """(jmax, imax, 3) position mesh for one zone / k-layer.

    StructGrid zones store i fastest, then j, then k (plot3d.py:51-57); a
    surface zone has kmax == 1 and a volume panel zone kmax == 2 (the
    reference's l direction, integration.ipp:48-49).
    """
    imax, jmax, kmax = (int(v) for v in grid.sz[zone])
    sl = grid.zone_slices()[zone]
    xyz = np.stack([grid.x[sl], grid.y[sl], grid.z[sl]], axis=-1)
    return xyz.reshape(kmax, jmax, imax, 3)[layer].astype(np.float64)


def _face_normals(q: np.ndarray) -> np.ndarray:
    """(k-1, j-1, 3) unit normals of each quad face of a (k, j, 3) mesh."""
    d1 = q[1:, 1:] - q[:-1, :-1]  # diagonal
    d2 = q[1:, :-1] - q[:-1, 1:]  # anti-diagonal
    n = np.cross(d1, d2)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)


def _avg_with_neighbor(n: np.ndarray, axis: int, side: int) -> np.ndarray:
    """Face normal averaged with the neighbor face across one edge.

    ``side`` -1 averages with the previous face along ``axis``, +1 with the
    next; boundary faces keep their own normal (integration.ipp:499-504).
    """
    out = n.copy()
    if side < 0:
        sl_dst = [slice(None)] * 3
        sl_src = [slice(None)] * 3
        sl_dst[axis] = slice(1, None)
        sl_src[axis] = slice(None, -1)
        out[tuple(sl_dst)] = 0.5 * (n[tuple(sl_dst)] + n[tuple(sl_src)])
    else:
        sl_dst = [slice(None)] * 3
        sl_src = [slice(None)] * 3
        sl_dst[axis] = slice(None, -1)
        sl_src[axis] = slice(1, None)
        out[tuple(sl_dst)] = 0.5 * (n[tuple(sl_dst)] + n[tuple(sl_src)])
    return out


def _surface_zone_panels(q: np.ndarray, height_sf: float):
    """All quad faces of one surface zone -> (F, 6, 3) normals, (F, 6) offsets,
    (F, 3) centers."""
    n = _face_normals(q)  # (K, J, 3) with K=k-1 faces
    corners = np.stack(
        [q[:-1, :-1], q[:-1, 1:], q[1:, 1:], q[1:, :-1]], axis=2
    )  # (K, J, 4, 3): j-, j+ along axis 1; ccw ring (j,k)(j+1,k)(j+1,k+1)(j,k+1)
    centers = corners.mean(axis=2)

    # edges of the ccw ring; edge i from corner i to corner i+1
    edges = np.roll(corners, -1, axis=2) - corners  # (K, J, 4, 3)
    # neighbor-averaged normals per edge: edge 0 (k- side), 1 (j+ side),
    # 2 (k+ side), 3 (j- side)
    n_edge = np.stack(
        [
            _avg_with_neighbor(n, 0, -1),  # k-1 neighbor
            _avg_with_neighbor(n, 1, +1),  # j+1 neighbor
            _avg_with_neighbor(n, 0, +1),  # k+1 neighbor
            _avg_with_neighbor(n, 1, -1),  # j-1 neighbor
        ],
        axis=2,
    )  # (K, J, 4, 3)
    # outward side-plane normal: edge_dir x avg_normal for a ccw ring points
    # away from the face interior
    side_n = np.cross(edges, n_edge)
    side_n /= np.maximum(np.linalg.norm(side_n, axis=-1, keepdims=True), 1e-30)
    side_d = np.einsum("kjec,kjec->kje", side_n, corners)

    edge_len = np.linalg.norm(edges, axis=-1)
    half_h = 0.5 * height_sf * edge_len.min(axis=2)  # (K, J)
    top_n = n
    top_d = np.einsum("kjc,kjc->kj", n, centers) + half_h
    bot_n = -n
    bot_d = np.einsum("kjc,kjc->kj", -n, centers) + half_h

    normals = np.concatenate(
        [side_n, top_n[:, :, None], bot_n[:, :, None]], axis=2
    ).reshape(-1, 6, 3)
    offsets = np.concatenate(
        [side_d, top_d[:, :, None], bot_d[:, :, None]], axis=2
    ).reshape(-1, 6)
    return normals, offsets, centers.reshape(-1, 3)


def _volume_zone_panels(q0: np.ndarray, q1: np.ndarray):
    """Hex cells between two l-layers -> half-spaces + midsurface centers."""
    cells = np.stack(
        [
            q0[:-1, :-1], q0[:-1, 1:], q0[1:, 1:], q0[1:, :-1],
            q1[:-1, :-1], q1[:-1, 1:], q1[1:, 1:], q1[1:, :-1],
        ],
        axis=2,
    )  # (K, J, 8, 3)
    centroid = cells.mean(axis=2, keepdims=True)
    # 6 quad faces by corner index into the ring pairs
    faces = np.array(
        [
            [0, 1, 2, 3],  # bottom (l0)
            [4, 5, 6, 7],  # top (l1)
            [0, 1, 5, 4],  # k- side
            [3, 2, 6, 7],  # k+ side
            [0, 3, 7, 4],  # j- side
            [1, 2, 6, 5],  # j+ side
        ]
    )
    fpts = cells[:, :, faces]  # (K, J, 6, 4, 3)
    fc = fpts.mean(axis=3)  # face centers
    n = np.cross(fpts[..., 2, :] - fpts[..., 0, :], fpts[..., 3, :] - fpts[..., 1, :])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    # orient outward: away from the cell centroid
    flip = np.einsum("kjfc,kjfc->kjf", n, fc - centroid) < 0
    n = np.where(flip[..., None], -n, n)
    d = np.einsum("kjfc,kjfc->kjf", n, fc)
    mid = 0.5 * (q0 + q1)
    centers = 0.25 * (
        mid[:-1, :-1] + mid[:-1, 1:] + mid[1:, 1:] + mid[1:, :-1]
    )
    return n.reshape(-1, 6, 3), d.reshape(-1, 6), centers.reshape(-1, 3)


def panels_from_grid(grid: StructGrid, height_sf: float = 1.0) -> PanelSet:
    """Build the panel set (integration.h:30-57 role, both grid flavors)."""
    is_volume = any(int(sz[2]) == 2 for sz in grid.sz)
    norm_l, off_l, cen_l = [], [], []
    surf = StructGrid() if is_volume else None
    for z in range(grid.n_zones):
        lmax = int(grid.sz[z][2])
        if is_volume:
            if lmax != 2:
                raise ValueError(
                    f"volume panel grids need l-size 2, zone {z} has {lmax}"
                )
            q0 = _quad_mesh(grid, z, 0)
            q1 = _quad_mesh(grid, z, 1)
            n, d, c = _volume_zone_panels(q0, q1)
            mid = 0.5 * (q0 + q1)
            surf.sz.append(np.array([mid.shape[1], mid.shape[0], 1], np.int32))
            surf.x = np.concatenate([surf.x, mid[..., 0].ravel()]).astype(np.float32)
            surf.y = np.concatenate([surf.y, mid[..., 1].ravel()]).astype(np.float32)
            surf.z = np.concatenate([surf.z, mid[..., 2].ravel()]).astype(np.float32)
        else:
            if lmax != 1:
                raise ValueError(
                    f"surface panel grids need l-size 1, zone {z} has {lmax}"
                )
            n, d, c = _surface_zone_panels(_quad_mesh(grid, z, 0), height_sf)
        norm_l.append(n)
        off_l.append(d)
        cen_l.append(c)
    if surf is not None:
        surf.zones = np.concatenate(
            [
                np.full(int(np.prod(sz)), zi, np.int32)
                for zi, sz in enumerate(surf.sz)
            ]
        ) if surf.sz else np.zeros(0, np.int32)
    return PanelSet(
        normals=np.concatenate(norm_l),
        offsets=np.concatenate(off_l),
        centers=np.concatenate(cen_l).astype(np.float32),
        surface=surf,
    )


def assign_points_to_panels(
    points: np.ndarray, panels: PanelSet, tol: float = 1e-6,
    block: int = 65536,
) -> np.ndarray:
    """(Q,) int32 panel index per point, -1 when inside none.

    Blocked dense half-space tests: each block is one (B, 3) @ (3, P*6)
    matmul + reduction — the Octree point-location walk (integration.ipp:
    162-210 role) recast as data-parallel compute.  The lowest-index
    containing panel wins (boundary points sit in two).
    """
    pts = np.asarray(points, np.float64)
    P = panels.size
    flat_n = panels.normals.reshape(P * 6, 3)
    flat_d = panels.offsets.reshape(P * 6)
    out = np.full(pts.shape[0], -1, np.int32)
    for s in range(0, pts.shape[0], block):
        blk = pts[s : s + block]
        inside = (
            (blk @ flat_n.T).reshape(blk.shape[0], P, 6)
            <= flat_d.reshape(1, P, 6) + tol
        ).all(axis=2)
        has = inside.any(axis=1)
        out[s : s + block][has] = np.argmax(inside[has], axis=1)
    return out


def panel_node_map(
    model, panels: PanelSet, tol: float = 1e-6
) -> np.ndarray:
    """(N,) panel index per model node (-1 = outside every panel)."""
    return assign_points_to_panels(model.vertices, panels, tol)


def panel_coverage(
    model, panel_of_node: np.ndarray, n_panels: int,
    data_mask: Optional[np.ndarray] = None,
) -> tuple:
    """Per-panel (area, covered-fraction) from the node assignment.

    Triangle area accrues to the panel of its first node (matching the
    operator construction); a triangle counts as covered when all its nodes
    carry data (integration.ipp coverage role).
    """
    from upsp_tpu_torch.geometry.grids import triangle_normals_areas

    _, areas = triangle_normals_areas(model.vertices, model.triangles)
    tri_panel = panel_of_node[model.triangles[:, 0]]
    valid = tri_panel >= 0
    area = np.zeros(n_panels, np.float64)
    np.add.at(area, tri_panel[valid], areas[valid])
    if data_mask is None:
        data_mask = np.ones(model.size, bool)
    tri_cov = data_mask[model.triangles].all(axis=1)
    cov_area = np.zeros(n_panels, np.float64)
    np.add.at(cov_area, tri_panel[valid & tri_cov], areas[valid & tri_cov])
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(area > 0, cov_area / np.maximum(area, 1e-30), 0.0)
    return area.astype(np.float32), frac.astype(np.float32)


def assign_triangles_to_panels(
    model, panels: PanelSet, tol: float = 1e-6
) -> np.ndarray:
    """(T,) panel index per triangle, by centroid containment (-1 outside).

    The component-labeling half of the reference's ``split_model``
    (integration.h:171-178: set TriModel face components to the containing
    panel's index, -1 when in none).  Triangles are kept whole — the
    reference optionally re-meshes by cutting edges at panel boundaries,
    which refines boundary attribution by a sub-triangle sliver; at the
    grid resolutions uPSP integrates over, whole-triangle centroid
    assignment changes panel areas by < one triangle per boundary edge.
    """
    centroids = model.vertices[model.triangles].mean(axis=1)
    return assign_points_to_panels(centroids, panels, tol)


def split_model(model, panels: PanelSet, tol: float = 1e-6):
    """New SurfaceModel whose components are panel indices (split_model role).

    Node components follow first-triangle-wins over the triangle assignment
    (the convention of from_tri_mesh / the reference's TriModel components);
    nodes whose every triangle lies outside all panels get component -1.
    """
    import dataclasses as _dc

    tri_panel = assign_triangles_to_panels(model, panels, tol)
    comp = np.full(model.size, -1, np.int32)
    flat_nodes = model.triangles.reshape(-1)[::-1]
    comp[flat_nodes] = np.repeat(tri_panel.astype(np.int32), 3)[::-1]
    return _dc.replace(model, components=comp)
