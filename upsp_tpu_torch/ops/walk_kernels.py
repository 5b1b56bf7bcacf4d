"""Phase 0's visibility walk on the card (csrc/walk.cu) and its plain twin.

The native route's rays (``ops/projection.py``
``build_node_projection_host``) are numpy around the native library's
walk (``cpp/upsp_native.cpp`` ``upsp_bvh_intersect``): an f64 ray to every
node, up to six jittered retries for the nodes whose ray did not land on
one of their triangles, and the ``own``, ``settled`` and oblique tests.
K11 does all of it per node on the card, bit for bit with the host.

| wrapper | kernel | replaces |
| --- | --- | --- |
| :func:`walk_nodes` | K11 ``walk_kernel`` | the rays, retries and tests of ``build_node_projection_host`` (numpy and ``upsp_bvh_intersect``) |

The native library is built with ``-march=native``, and GCC contracts its
Moller-Trumbore test into fused multiply-adds; the kernel and the twin
round every operation as that build does (csrc/walk.cu says which).  The
oblique test is numpy's: f32 products and sums of the f32 node normals,
compared as numpy compares them with the f64 threshold
(:func:`forward_threshold`).

:func:`upload_scene` puts the flat BVH, the triangles, the vertices and the
normals on a device once; :func:`walk_nodes` walks one camera's rays over
it.  On a CUDA scene it launches K11 (launch count ``walk``) and returns
at once; on a CPU scene it runs the plain twin, which walks the same flat
arrays in the same escape-link order with torch, every ray in lockstep.
The result is one byte a node (:data:`OWN`, :data:`SETTLED`,
:data:`FORWARD`, the retries from bit :data:`RETRY_SHIFT`), and, when
asked, the last ray's ``t`` and ``prim``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from upsp_tpu_torch.ops.cuda_lib import (
    CudaLibrary,
    check_rc,
    count_launch,
    register_kernels,
    stream_of,
)

KERNELS = register_kernels(("walk",))

OWN, SETTLED, FORWARD = 1, 2, 4  # bits of a node's byte
RETRY_SHIFT = 4  # the retries a node took, from this bit
EPS = 1e-9  # cpp/upsp_native.cpp intersect_one's eps
FAR = 3e38  # its distance of a ray that hits nothing
MAX_JITTER = 6


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    lib.upsp_walk.argtypes = ([p] * 9 + [i] + [p] * 3 + [i, f, f, f, d, i, d, d]
                              + [p] * 4)
    lib.upsp_walk.restype = i


LIBRARY = CudaLibrary("walk", _bind)


class WalkScene(NamedTuple):
    """The flat BVH (``geometry/bvh.py`` ``FlatBVH``, as the native library
    takes it) and the mesh, on one device."""

    bbox_min: torch.Tensor  # (M, 3) float32
    bbox_max: torch.Tensor  # (M, 3) float32
    escape: torch.Tensor  # (M,) int32
    leaf_start: torch.Tensor  # (M,) int32, -1 for internal nodes
    leaf_count: torch.Tensor  # (M,) int32
    tri_v0: torch.Tensor  # (T, 3) float32, slot order
    tri_e1: torch.Tensor  # (T, 3) float32
    tri_e2: torch.Tensor  # (T, 3) float32
    tri_id: torch.Tensor  # (T,) int32 original triangle of a slot
    triangles: torch.Tensor  # (T, 3) int32 nodes of an original triangle
    vertices: torch.Tensor  # (N, 3) float32
    normals: torch.Tensor  # (N, 3) float32

    @property
    def n_nodes(self) -> int:
        return int(self.vertices.shape[0])


class NodeRays(NamedTuple):
    """Per node (all (N,) tensors): the tests of its rays and the last
    ray it cast."""

    own: torch.Tensor  # bool: a ray landed on one of its triangles
    settled: torch.Tensor  # bool: a ray hit away from its target
    forward: torch.Tensor  # bool: the oblique test
    retries: torch.Tensor  # uint8: jittered rays cast (0-6)
    t: torch.Tensor  # float32: the last ray's closest hit, FAR if none
    prim: torch.Tensor  # int32: its triangle, -1 if none


def upload_scene(flat, triangles, vertices, normals, device) -> WalkScene:
    """The scene on ``device``: one copy a ``run_phase0``, shared by its
    cameras."""

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return WalkScene(
        bbox_min=put(flat.bbox_min, np.float32), bbox_max=put(flat.bbox_max, np.float32),
        escape=put(flat.escape, np.int32), leaf_start=put(flat.leaf_start, np.int32),
        leaf_count=put(flat.leaf_count, np.int32), tri_v0=put(flat.tri_v0, np.float32),
        tri_e1=put(flat.tri_e1, np.float32), tri_e2=put(flat.tri_e2, np.float32),
        tri_id=put(flat.tri_id, np.int32), triangles=put(triangles, np.int32),
        vertices=put(vertices, np.float32), normals=put(normals, np.float32),
    )


def forward_threshold(thresh) -> float:
    """The oblique threshold ``thresh`` (an f64 cosine) as numpy compares
    ``np.sum(normals * dirs, -1) < thresh`` with f32 normals and ``dirs``,
    widened to f64: rounded to f32 where numpy's promotion compares in f32
    (numpy 1's value-based casting), as it is otherwise."""
    thresh = np.float64(thresh)  # np.cos's scalar, as the host's
    cmp = np.result_type(np.zeros(1, np.float32), thresh)
    return float(thresh.astype(cmp))


def decode(flags) -> Tuple:
    """(own, settled, forward, retries) of the nodes' bytes, a uint8
    tensor or array."""
    return ((flags & OWN) != 0, (flags & SETTLED) != 0, (flags & FORWARD) != 0,
            flags >> RETRY_SHIFT)


def walk_nodes(scene: WalkScene, center: torch.Tensor, thresh: float,
               n_jitter: int = 6, jitter: float = 1e-4, settled_rel: float = 1e-4,
               detail: bool = False):
    """Every node's rays from the camera centre ``center`` ((3,) float32):
    (N,) uint8 bytes, or with ``detail`` the :class:`NodeRays`.  ``thresh``:
    the oblique test's cosine (:func:`forward_threshold`).  K11 on a CUDA
    scene (asynchronous: the bytes are ready when the stream gets there),
    the twin on a CPU one."""
    if not 0 <= n_jitter <= MAX_JITTER:
        raise ValueError(f"n_jitter must be in 0..{MAX_JITTER}, got {n_jitter}")
    thresh = forward_threshold(thresh)
    c = [float(x) for x in torch.as_tensor(center).to(torch.float32).cpu()]
    if not scene.vertices.is_cuda:
        rays = walk_plain(scene, c, thresh, n_jitter, jitter, settled_rel)
        return rays if detail else encode(rays)
    n = scene.n_nodes
    dev = scene.vertices.device
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev) if detail else None
    prim = torch.empty(n, dtype=torch.int32, device=dev) if detail else None
    s = scene
    rc = LIBRARY.lib().upsp_walk(
        s.bbox_min.data_ptr(), s.bbox_max.data_ptr(), s.escape.data_ptr(),
        s.leaf_start.data_ptr(), s.leaf_count.data_ptr(), s.tri_v0.data_ptr(),
        s.tri_e1.data_ptr(), s.tri_e2.data_ptr(), s.tri_id.data_ptr(),
        int(s.bbox_min.shape[0]), s.triangles.data_ptr(), s.vertices.data_ptr(),
        s.normals.data_ptr(), n, *c,
        float(jitter), int(n_jitter), float(settled_rel), float(thresh),
        flags.data_ptr(), None if t is None else t.data_ptr(),
        None if prim is None else prim.data_ptr(), stream_of(flags))
    check_rc(rc, "walk")
    count_launch("walk")
    if not detail:
        return flags
    return NodeRays(*decode(flags), t, prim)


def encode(rays: NodeRays) -> torch.Tensor:
    """The nodes' bytes of :class:`NodeRays` (as K11 writes them)."""
    return (rays.own.to(torch.uint8) * OWN | rays.settled.to(torch.uint8) * SETTLED
            | rays.forward.to(torch.uint8) * FORWARD
            | (rays.retries.to(torch.uint8) << RETRY_SHIFT))


# ---------------------------------------------------------------------------
# the plain twin

def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add, rounded once: the product is exact in f64,
    the sum is rounded to odd in f64 (an even result off by the two-sum's
    error steps to its odd neighbour), and that rounds to f32 as the exact
    sum does (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    r = p + c
    bb = r - p
    err = (p - (r - bb)) + (c - bb)
    even = (r.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, -float("inf")))
    r = torch.where((err != 0) & even, torch.nextafter(r, toward), r)
    return r.float()


def _cross_term(a, b, c, d):
    """a*b - c*d as the native build computes it (csrc/walk.cu)."""
    return _fma32(a, b, -(c * d))


def _dot3(a0, b0, a1, b1, a2, b2):
    """a0*b0 + a1*b1 + a2*b2 as the native build computes it."""
    return _fma32(a2, b2, _fma32(a0, b0, a1 * b1))


def _moller_trumbore(o, d, v0, e1, e2):
    """intersect_one's triangle test, rays (K, 3) against their (K, L, 3)
    triangles: (t, valid) (K, L)."""
    d0, d1, d2 = (x[:, None] for x in d.unbind(-1))
    o0, o1, o2 = (x[:, None] for x in o.unbind(-1))
    a0, a1, a2 = e1.unbind(-1)
    b0, b1, b2 = e2.unbind(-1)
    p0 = _cross_term(d1, b2, d2, b1)
    p1 = _cross_term(d2, b0, d0, b2)
    p2 = _cross_term(d0, b1, d1, b0)
    det = _dot3(a0, p0, a1, p1, a2, p2)
    ok = det.abs() > EPS
    idet = torch.ones_like(det) / torch.where(ok, det, torch.ones_like(det))
    s0, s1, s2 = o0 - v0[..., 0], o1 - v0[..., 1], o2 - v0[..., 2]
    u = _dot3(s0, p0, s1, p1, s2, p2) * idet
    q0 = _cross_term(s1, a2, s2, a1)
    q1 = _cross_term(s2, a0, s0, a2)
    q2 = _cross_term(s0, a1, s1, a0)
    v = _dot3(d0, q0, d1, q1, d2, q2) * idet
    t = _dot3(b0, q0, b1, q1, b2, q2) * idet
    valid = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > EPS)
    return t, valid


def _intersect_plain(s: WalkScene, o: torch.Tensor, d: torch.Tensor):
    """intersect_one for every ray (R, 3) at once: (t, prim), t = FAR and
    prim = -1 where a ray hits nothing.  Each step moves every ray still
    walking one node along the escape links and tests the triangles of
    the leaves whose boxes the rays hit."""
    R, M = d.shape[0], s.bbox_min.shape[0]
    big = torch.tensor(1e30, dtype=torch.float32)
    inv = torch.where(d.abs() > 1e-30, torch.ones_like(d) / d,
                      torch.where(d >= 0, big, -big))
    best_t = torch.full((R,), FAR, dtype=torch.float32)
    best_prim = torch.full((R,), -1, dtype=torch.int32)
    node = torch.zeros(R, dtype=torch.int64)
    ray = torch.arange(R)
    leaves = s.leaf_start >= 0
    width = int(s.leaf_count[leaves].max()) if bool(leaves.any()) else 0
    lane = torch.arange(width)
    while ray.numel():
        nd = node[ray]
        t0 = (s.bbox_min[nd] - o[ray]) * inv[ray]
        t1 = (s.bbox_max[nd] - o[ray]) * inv[ray]
        tnear = torch.minimum(t0, t1).amax(-1).clamp_min(-FAR)
        tfar = torch.maximum(t0, t1).amin(-1).clamp_max(FAR)
        box_hit = (tfar >= tnear.clamp_min(0.0)) & (tnear < best_t[ray])
        start = s.leaf_start[nd]
        leaf = box_hit & (start >= 0)
        if bool(leaf.any()):
            lr, ln = ray[leaf], nd[leaf]
            count = s.leaf_count[ln]
            slot = (start[leaf][:, None] + lane[None, :]).long()
            inside = lane[None, :] < count[:, None]
            slot = torch.where(inside, slot, torch.zeros_like(slot))
            t, ok = _moller_trumbore(o[lr], d[lr], s.tri_v0[slot], s.tri_e1[slot],
                                     s.tri_e2[slot])
            # in slot order, each hit nearer than the best so far replaces it
            for j in range(width):
                take = ok[:, j] & inside[:, j] & (t[:, j] < best_t[lr])
                best_t[lr] = torch.where(take, t[:, j], best_t[lr])
                best_prim[lr] = torch.where(take, s.tri_id[slot[:, j]], best_prim[lr])
        nxt = torch.where(box_hit & (start < 0), nd + 1, s.escape[nd].long())
        node[ray] = nxt
        ray = ray[nxt < M]
    return torch.where(best_prim >= 0, best_t, torch.full_like(best_t, FAR)), best_prim


def _norm(d: torch.Tensor) -> torch.Tensor:
    """np.linalg.norm(d, axis=1) of (K, 3) f64: squares summed in order."""
    sq = d * d
    return torch.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2])


def walk_plain(scene: WalkScene, center, thresh: float, n_jitter: int = 6,
               jitter: float = 1e-4, settled_rel: float = 1e-4) -> NodeRays:
    """K11's twin on a CPU scene, node for node the host's numpy steps
    (``projection.build_node_projection_host``) and the native walk."""
    s = scene
    n = s.n_nodes
    c32 = torch.as_tensor(center, dtype=torch.float32)
    c = c32.double()
    v = s.vertices.double()
    d = v - c
    dist = _norm(d)
    dirs = (d / dist.clamp_min(1e-30)[:, None]).float()
    facing = s.normals * dirs
    forward = ((facing[:, 0] + facing[:, 1]) + facing[:, 2]).double() < thresh
    nodes = torch.arange(n)

    def cast(idx, dk, norm):
        t, prim = _intersect_plain(s, c32.expand(len(idx), 3), dk)
        hit = prim >= 0
        own = hit & (s.triangles[prim.clamp_min(0).long()] == idx[:, None]).any(1)
        settled = hit & ((t.double() - norm).abs() > settled_rel * norm)
        return t, prim, own, settled

    t, prim, own, settled = cast(nodes, dirs, dist)
    retries = torch.zeros(n, dtype=torch.uint8)
    offsets = torch.tensor(
        [[-jitter, 0, 0], [jitter, 0, 0], [0, -jitter, 0], [0, jitter, 0],
         [0, 0, -jitter], [0, 0, jitter]], dtype=torch.float64)
    for k in range(n_jitter):
        (left,) = torch.nonzero(~own, as_tuple=True)
        if not left.numel():
            break
        dk = (v[left] + offsets[k]) - c
        norm = _norm(dk)
        t_k, prim_k, own_k, settled_k = cast(left, (dk / norm[:, None]).float(), norm)
        own[left] = own_k
        settled[left] |= settled_k
        retries[left] += 1
        t[left], prim[left] = t_k, prim_k
    return NodeRays(own, settled, forward, retries, t, prim)
