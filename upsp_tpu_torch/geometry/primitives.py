"""Geometric primitives: ray/plane/box/polyhedron intersections, node search.

Inventory parity with cpp/include/models.h:82-473 and data_structs.h:155-403
(studied, not copied), vectorized numpy.  The heavy spatial queries of the
reference's Octree are served by the BVH (rays) and scipy cKDTree (nearest /
radius) elsewhere; these primitives cover the direct geometric tests.

A copy of ``upsp_tpu/geometry/primitives.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class Plane(NamedTuple):
    normal: np.ndarray  # (3,) unit
    point: np.ndarray  # (3,)

    @property
    def offset(self) -> float:
        return float(np.dot(self.normal, self.point))


def plane_from_points(a, b, c) -> Plane:
    n = np.cross(np.subtract(b, a), np.subtract(c, a))
    n = n / np.linalg.norm(n)
    return Plane(normal=n, point=np.asarray(a, np.float64))


def ray_plane_intersect(origin, direction, plane: Plane) -> float:
    """Parametric t of the hit (np.inf when parallel/behind)."""
    denom = float(np.dot(plane.normal, direction))
    if abs(denom) < 1e-15:
        return np.inf
    t = (plane.offset - np.dot(plane.normal, origin)) / denom
    return t if t >= 0 else np.inf

def ray_box_intersect(origin, direction, bmin, bmax) -> Tuple[float, float]:
    """Slab test; returns (t_near, t_far), miss when t_near > t_far."""
    origin = np.asarray(origin, np.float64)
    direction = np.asarray(direction, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(np.abs(direction) > 1e-300, 1.0 / direction,
                       np.sign(direction) * 1e300 + (direction == 0) * 1e300)
        t0 = (np.asarray(bmin) - origin) * inv
        t1 = (np.asarray(bmax) - origin) * inv
    t_near = np.max(np.minimum(t0, t1))
    t_far = np.min(np.maximum(t0, t1))
    return float(t_near), float(t_far)


def ray_triangle_intersect(origin, direction, v0, v1, v2,
                           eps: float = 1e-12) -> float:
    """Moller-Trumbore; distance to hit or -1 (projection.h:268 parity)."""
    e1 = np.subtract(v1, v0)
    e2 = np.subtract(v2, v0)
    p = np.cross(direction, e2)
    det = float(np.dot(e1, p))
    if abs(det) < eps:
        return -1.0
    inv = 1.0 / det
    s = np.subtract(origin, v0)
    u = float(np.dot(s, p)) * inv
    if u < 0 or u > 1:
        return -1.0
    q = np.cross(s, e1)
    v = float(np.dot(direction, q)) * inv
    if v < 0 or u + v > 1:
        return -1.0
    t = float(np.dot(e2, q)) * inv
    return t if t > eps else -1.0


class Polyhedron(NamedTuple):
    """Convex polyhedron as intersection of half-spaces (normals outward)."""

    normals: np.ndarray  # (F, 3)
    offsets: np.ndarray  # (F,) n.x <= d inside


def box_polyhedron(bmin, bmax) -> Polyhedron:
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    normals = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float64,
    )
    offsets = np.array(
        [bmax[0], -bmin[0], bmax[1], -bmin[1], bmax[2], -bmin[2]]
    )
    return Polyhedron(normals=normals, offsets=offsets)


def points_in_polyhedron(points: np.ndarray, poly: Polyhedron,
                         tol: float = 0.0) -> np.ndarray:
    """(Q,) bool — inside (or on, within tol) every half-space."""
    d = np.atleast_2d(points) @ poly.normals.T  # (Q, F)
    return np.all(d <= poly.offsets[None, :] + tol, axis=1)


def ray_polyhedron_intersect(origin, direction, poly: Polyhedron) -> float:
    """First hit t with a convex polyhedron (slab-style clip), inf on miss."""
    origin = np.asarray(origin, np.float64)
    direction = np.asarray(direction, np.float64)
    t_near, t_far = 0.0, np.inf
    for n, d in zip(poly.normals, poly.offsets):
        denom = float(np.dot(n, direction))
        dist = d - float(np.dot(n, origin))
        if abs(denom) < 1e-15:
            if dist < 0:
                return np.inf  # parallel and outside
            continue
        t = dist / denom
        if denom > 0:
            t_far = min(t_far, t)
        else:
            t_near = max(t_near, t)
        if t_near > t_far:
            return np.inf
    return t_near


def nodes_in_polyhedron(model, poly: Polyhedron, tol: float = 0.0) -> np.ndarray:
    """Node indices inside a convex polyhedron (models.h:333-362 role)."""
    return np.nonzero(points_in_polyhedron(model.vertices, poly, tol))[0]


def triangle_area_normal(v0, v1, v2) -> Tuple[float, np.ndarray]:
    cr = np.cross(np.subtract(v1, v0), np.subtract(v2, v0))
    n = np.linalg.norm(cr)
    return 0.5 * n, (cr / n if n > 0 else cr)


def get_perpendicular(v: np.ndarray) -> np.ndarray:
    """Any unit vector perpendicular to v (general_utils parity)."""
    v = np.asarray(v, np.float64)
    a = np.array([1.0, 0.0, 0.0]) if abs(v[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    p = np.cross(v, a)
    return p / np.linalg.norm(p)
