"""BVH over a triangle soup: vectorized host build + flat arrays for TPU traversal.

Replaces the pbrt-derived pointer BVH of the reference
(cpp/raycast/pspRT.cpp:499-525 — studied, not copied) with a TPU-friendly
layout: nodes are stored in depth-first order with *escape links*, so traversal
is stackless — a single index walk suitable for ``lax.while_loop`` under
``vmap`` (no per-ray stack, no pointer chasing):

  - hit:  next node is ``i + 1`` (children follow their parent immediately)
  - miss: jump to ``escape[i]``

Leaves reference a contiguous range of reordered triangles.  Build is
median-split on the largest centroid extent (host numpy).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np


@dataclasses.dataclass
class FlatBVH:
    """Flattened BVH arrays (host numpy; shipped to device as-is)."""

    bbox_min: np.ndarray  # (M, 3) float32
    bbox_max: np.ndarray  # (M, 3) float32
    escape: np.ndarray  # (M,) int32 — node index to jump to on miss (M = done)
    leaf_start: np.ndarray  # (M,) int32 — first tri slot, -1 for internal nodes
    leaf_count: np.ndarray  # (M,) int32
    tri_v0: np.ndarray  # (T, 3) float32 — reordered triangle vertices
    tri_e1: np.ndarray  # (T, 3) float32 — v1 - v0
    tri_e2: np.ndarray  # (T, 3) float32 — v2 - v0
    tri_id: np.ndarray  # (T,) int32 — original triangle index per slot

    @property
    def n_nodes(self) -> int:
        return int(self.bbox_min.shape[0])

    @property
    def n_tris(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def max_leaf_count(self) -> int:
        return int(self.leaf_count.max())


def build_bvh(
    vertices: np.ndarray, triangles: np.ndarray, leaf_size: int = 4,
    method: str = "median",
) -> FlatBVH:
    """Build a median-split BVH; returns flattened escape-link arrays.

    ``method="sah"`` is only implemented by the native builder
    (upsp_tpu_torch.native.build_bvh); this numpy fallback always median-splits —
    the tree differs but the traversal contract and hits are identical."""
    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.int64)
    if t.shape[0] == 0:
        raise ValueError("cannot build BVH over empty triangle soup")
    p0, p1, p2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    centroid = (tri_min + tri_max) * 0.5

    T = t.shape[0]
    order = np.arange(T)
    bmin_l, bmax_l, starts, counts = [], [], [], []

    sys.setrecursionlimit(200000)

    def rec(start: int, count: int) -> None:
        """Emit node covering order[start:start+count]; children follow in DFS."""
        idx = len(starts)
        seg = order[start : start + count]
        bmin_l.append(tri_min[seg].min(axis=0))
        bmax_l.append(tri_max[seg].max(axis=0))
        starts.append(start)
        counts.append(count)

        if count <= leaf_size:
            return
        c = centroid[seg]
        extent = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(extent))
        half = count // 2
        if extent[axis] > 0:
            part = np.argpartition(c[:, axis], half)
            order[start : start + count] = seg[part]
        # degenerate cluster (coincident centroids): split by count anyway —
        # identical bboxes, but leaf sizes stay bounded, which keeps the
        # max_leaf-sized traversal blocks small on device
        starts[idx] = -1  # becomes internal
        counts[idx] = 0
        rec(start, half)
        rec(start + half, count - half)

    rec(0, T)

    M = len(starts)
    bbox_min = np.stack(bmin_l).astype(np.float32)
    bbox_max = np.stack(bmax_l).astype(np.float32)
    leaf_start = np.array(starts, np.int32)
    leaf_count = np.array(counts, np.int32)

    # subtree sizes in DFS layout (children of i start at i+1)
    subtree = np.zeros(M, np.int64)

    def sizes(i: int) -> int:
        if leaf_start[i] >= 0:
            subtree[i] = 1
            return 1
        left = i + 1
        ls = sizes(left)
        rs = sizes(left + ls)
        subtree[i] = 1 + ls + rs
        return int(subtree[i])

    sizes(0)

    # escape[i] = first node index past i's subtree (M at the rightmost spine)
    escape = np.full(M, M, np.int32)
    stack = [(0, M)]
    while stack:
        i, esc = stack.pop()
        escape[i] = esc
        if leaf_start[i] < 0:
            left = i + 1
            right = left + int(subtree[left])
            stack.append((left, right))
            stack.append((right, esc))

    q0 = v[t[order, 0]].astype(np.float32)
    q1 = v[t[order, 1]].astype(np.float32)
    q2 = v[t[order, 2]].astype(np.float32)
    return FlatBVH(
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        escape=escape,
        leaf_start=leaf_start,
        leaf_count=leaf_count,
        tri_v0=q0,
        tri_e1=q1 - q0,
        tri_e2=q2 - q0,
        tri_id=order.astype(np.int32),
    )
