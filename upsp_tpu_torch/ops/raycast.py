"""Ray-triangle intersection against the flattened BVH, on the device (torch).

Port of ``upsp_tpu/ops/raycast.py``.  The JAX package walks the stackless
escape-link BVH (``geometry/bvh.py``) in a ``lax.while_loop`` vmapped over
rays.  Here all rays walk in lockstep as tensors: each ray's node index,
best t and best triangle are (R,) tensors, a step gathers every ray's node
box (and its leaf triangles, (R, max_leaf, 3)) and moves it to ``node + 1``
on a box hit of an internal node or to ``escape[node]`` otherwise, and a
ray whose node reaches M stops changing.  The host looks at the rays only
every ``check_every`` steps (one sync there, not one a node): it stops when
no ray is left and otherwise keeps only the rays still walking.

f32 by default, as ``bvh_to_device`` is in the JAX package; the
watertight intersector is the default, as there.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from upsp_tpu_torch.geometry.bvh import FlatBVH

CHECK_EVERY = 16  # lockstep steps between the host's looks at the rays


class BVHArrays(NamedTuple):
    """Device-resident flattened BVH, leaf triangles stored per node and
    padded to the largest leaf (as ``upsp_tpu/ops/raycast.py:BVHArrays``)."""

    bbox_min: torch.Tensor  # (M, 3)
    bbox_max: torch.Tensor  # (M, 3)
    escape: torch.Tensor  # (M,) int64
    leaf_count: torch.Tensor  # (M,) int32, 0 for internal nodes
    leaf_v0: torch.Tensor  # (M, L, 3)
    leaf_e1: torch.Tensor  # (M, L, 3)
    leaf_e2: torch.Tensor  # (M, L, 3)
    leaf_tri_id: torch.Tensor  # (M, L) int32 original triangle ids (-1 padding)

    @property
    def max_leaf(self) -> int:
        return int(self.leaf_v0.shape[1])


def bvh_to_device(bvh: FlatBVH, dtype=torch.float32, device="cuda") -> BVHArrays:
    M = bvh.n_nodes
    L = max(bvh.max_leaf_count, 1)
    leaf_v0 = np.zeros((M, L, 3), np.float32)
    leaf_e1 = np.zeros((M, L, 3), np.float32)
    leaf_e2 = np.zeros((M, L, 3), np.float32)
    leaf_tri_id = np.full((M, L), -1, np.int32)
    counts = np.where(bvh.leaf_start >= 0, bvh.leaf_count, 0).astype(np.int64)
    leaves = np.nonzero(bvh.leaf_start >= 0)[0]
    slots = bvh.leaf_start[leaves][:, None] + np.arange(L)[None, :]  # (K, L)
    valid = np.arange(L)[None, :] < counts[leaves][:, None]
    safe = np.where(valid, slots, 0)
    leaf_v0[leaves] = bvh.tri_v0[safe] * valid[..., None]
    leaf_e1[leaves] = bvh.tri_e1[safe] * valid[..., None]
    leaf_e2[leaves] = bvh.tri_e2[safe] * valid[..., None]
    leaf_tri_id[leaves] = np.where(valid, bvh.tri_id[safe], -1)

    def dev(a, dt=None):
        return torch.as_tensor(a).to(device=device, dtype=dt)

    return BVHArrays(
        bbox_min=dev(bvh.bbox_min, dtype),
        bbox_max=dev(bvh.bbox_max, dtype),
        escape=dev(np.asarray(bvh.escape, np.int64)),
        leaf_count=dev(counts.astype(np.int32)),
        leaf_v0=dev(leaf_v0, dtype),
        leaf_e1=dev(leaf_e1, dtype),
        leaf_e2=dev(leaf_e2, dtype),
        leaf_tri_id=dev(leaf_tri_id),
    )


def watertight_intersect(origin, direction, v0, e1, e2, eps=1e-9):
    """Watertight ray-triangle intersection (Woop/Benthin/Wald), batched.

    ``origin``/``direction`` (..., 3) broadcast against the triangle rows
    ``v0``/``e1``/``e2`` (..., L, 3) as ``origin[..., None, :]``; returns
    (t, valid) of shape (..., L).  The ray is permuted so its dominant
    component is z (x and y swapped when that component is negative, to
    keep the winding), the triangle is sheared into that frame and the 2-D
    edge functions decide; a band of a few ulps of the edge functions'
    magnitude counts as inside, so a ray through a shared edge hits at least
    one of its triangles (``upsp_tpu/ops/raycast.py:78-152`` explains the
    band).
    """
    ad = direction.abs()
    kz = ad.argmax(-1, keepdim=True)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    neg = direction.gather(-1, kz) < 0.0
    kx, ky = torch.where(neg, ky, kx), torch.where(neg, kx, ky)
    perm = torch.cat([kx, ky, kz], -1)  # (..., 3)
    d = direction.gather(-1, perm)
    o = origin[..., None, :]
    permL = perm[..., None, :].expand(v0.shape)
    A = (v0 - o).gather(-1, permL)
    B = (v0 + e1 - o).gather(-1, permL)
    C = (v0 + e2 - o).gather(-1, permL)
    sz = (1.0 / d[..., 2])[..., None]
    sx = d[..., 0:1] * sz
    sy = d[..., 1:2] * sz
    ax = A[..., 0] - sx * A[..., 2]
    ay = A[..., 1] - sy * A[..., 2]
    bx = B[..., 0] - sx * B[..., 2]
    by = B[..., 1] - sy * B[..., 2]
    cx = C[..., 0] - sx * C[..., 2]
    cy = C[..., 1] - sy * C[..., 2]
    e0 = cx * by - cy * bx
    e1f = ax * cy - ay * cx
    e2f = bx * ay - by * ax
    tol = 4e-7 * (e0.abs() + e1f.abs() + e2f.abs())
    inside = ((e0 >= -tol) & (e1f >= -tol) & (e2f >= -tol)) | (
        (e0 <= tol) & (e1f <= tol) & (e2f <= tol)
    )
    det = e0 + e1f + e2f
    az = sz * A[..., 2]
    bz = sz * B[..., 2]
    cz = sz * C[..., 2]
    t_scaled = e0 * az + e1f * bz + e2f * cz
    valid = inside & (det != 0.0) & (t_scaled * torch.sign(det) > eps * det.abs())
    t = t_scaled / torch.where(det == 0.0, torch.ones_like(det), det)
    return t, valid


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _dot3(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def moller_trumbore(origin, direction, v0, e1, e2, eps=1e-9):
    """Batched Möller–Trumbore, broadcast as :func:`watertight_intersect`;
    returns (t, valid) per triangle row."""
    o = origin[..., None, :]
    d = direction[..., None, :]
    pvec = _cross(d.expand(e2.shape), e2)
    det = _dot3(e1, pvec)
    ok = det.abs() > eps
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = _dot3(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot3(d, qvec) * inv_det
    t = _dot3(e2, qvec) * inv_det
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return t, valid


def _inv_dir(d):
    inv = torch.where(d.abs() > 1e-30, 1.0 / d, torch.sign(d) * 1e30)
    return torch.where(d == 0.0, torch.full_like(d, 1e30), inv)


def _walk_steps(bvh: BVHArrays, tri_test, o, d, inv, node, best_t, best_prim,
                n_steps: int):
    """``n_steps`` lockstep steps of the escape-link walk for every ray;
    rays whose node is past the last one do not change."""
    M = bvh.bbox_min.shape[0]
    L = bvh.leaf_v0.shape[1]
    lane = torch.arange(L, device=o.device)
    inf = torch.full_like(best_t, float("inf"))[:, None]
    for _ in range(n_steps):
        live = node < M
        nc = node.clamp(max=M - 1)
        t0 = (bvh.bbox_min[nc] - o) * inv
        t1 = (bvh.bbox_max[nc] - o) * inv
        tnear = torch.minimum(t0, t1).amax(-1)
        tfar = torch.maximum(t0, t1).amin(-1)
        box_hit = (tfar >= torch.clamp_min(tnear, 0.0)) & (tnear < best_t) & live
        count = bvh.leaf_count[nc]
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf
        t, valid = tri_test(o, d, bvh.leaf_v0[nc], bvh.leaf_e1[nc], bvh.leaf_e2[nc])
        mask = lane[None, :] < count[:, None]
        t = torch.where(valid & mask & (t < best_t[:, None]), t, inf)
        j = t.argmin(-1, keepdim=True)
        tj = t.gather(-1, j)[:, 0]
        better = do_leaf & (tj < best_t)
        best_t = torch.where(better, tj, best_t)
        best_prim = torch.where(better, bvh.leaf_tri_id[nc].gather(-1, j)[:, 0],
                                best_prim)
        nxt = torch.where(box_hit & ~is_leaf, node + 1, bvh.escape[nc])
        node = torch.where(live, nxt, node)
    return node, best_t, best_prim


def bvh_intersect(bvh: BVHArrays, origins, directions, max_leaf: int = 4,
                  intersector: str = "watertight",
                  check_every: int = CHECK_EVERY):
    """Closest-hit query for a batch of rays.

    origins/directions: (R, 3), cast to the BVH's dtype on its device.
    Returns (t (R,), prim_id (R,) original triangle index or -1, hit (R,)
    bool).  ``intersector``: "watertight" (default, the reference's choice:
    edge-grazing rays cannot leak between shared triangles) or "mt" (plain
    Möller–Trumbore).  ``max_leaf`` is accepted for the JAX signature; the
    leaf width is the BVH's.
    """
    del max_leaf
    tri_test = watertight_intersect if intersector == "watertight" else moller_trumbore
    dt, dev = bvh.leaf_v0.dtype, bvh.leaf_v0.device
    M = bvh.bbox_min.shape[0]
    o = torch.as_tensor(origins).to(device=dev, dtype=dt)
    d = torch.as_tensor(directions).to(device=dev, dtype=dt)
    R = o.shape[0]
    best_t = torch.full((R,), float("inf"), dtype=dt, device=dev)
    best_prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    # the rays still walking: their indices and state, compacted at each look
    idx = torch.arange(R, device=dev)
    a_o, a_d, a_inv = o, d, _inv_dir(d)
    a_node = torch.zeros(R, dtype=torch.int64, device=dev)
    a_t, a_prim = best_t.clone(), best_prim.clone()
    while idx.numel():
        a_node, a_t, a_prim = _walk_steps(bvh, tri_test, a_o, a_d, a_inv, a_node,
                                          a_t, a_prim, check_every)
        keep = a_node < M
        done = ~keep
        best_t[idx[done]] = a_t[done]
        best_prim[idx[done]] = a_prim[done]
        (k,) = torch.nonzero(keep, as_tuple=True)
        idx, a_o, a_d, a_inv = idx[k], a_o[k], a_d[k], a_inv[k]
        a_node, a_t, a_prim = a_node[k], a_t[k], a_prim[k]
    return best_t, best_prim, best_prim >= 0


def brute_force_intersect(tri_v0, tri_e1, tri_e2, origins, directions):
    """O(R*T) oracle for tests; returns (t, prim, hit) with prim in slot
    order."""
    o = torch.as_tensor(origins)
    d = torch.as_tensor(directions)
    T = tri_v0.shape[0]
    shape = (o.shape[0], T, 3)
    t, valid = moller_trumbore(o, d, tri_v0.expand(shape), tri_e1.expand(shape),
                               tri_e2.expand(shape))
    t = torch.where(valid, t, torch.full_like(t, float("inf")))
    j = t.argmin(-1)
    tj = t.gather(-1, j[:, None])[:, 0]
    fin = torch.isfinite(tj)
    return tj, torch.where(fin, j, torch.full_like(j, -1)), fin


def bvh_any_hit_before(bvh: BVHArrays, origins, directions, t_max,
                       max_leaf: int = 4, intersector: str = "watertight"):
    """Occlusion query: does any triangle lie at t in (eps, t_max)?"""
    t, _, hit = bvh_intersect(bvh, origins, directions, max_leaf=max_leaf,
                              intersector=intersector)
    return hit & (t < torch.as_tensor(t_max, device=t.device))


Intersector = Callable[[torch.Tensor, torch.Tensor], tuple]


def native_intersector(flat: FlatBVH) -> Intersector:
    """The native host walk (``upsp_tpu_torch.native.bvh_intersect``, the
    library ``cpp/`` builds) with :func:`bvh_intersect`'s interface: rays
    in, (t, prim, hit) tensors out on the rays' device."""
    from upsp_tpu_torch import native

    def walk(origins, directions):
        dev = origins.device
        t, prim, hit = native.bvh_intersect(
            flat, origins.detach().to("cpu", torch.float32).numpy(),
            directions.detach().to("cpu", torch.float32).numpy())
        return (torch.from_numpy(t).to(dev), torch.from_numpy(prim).to(dev),
                torch.from_numpy(hit).to(dev))

    return walk


def flat_intersector(flat: FlatBVH) -> Intersector:
    """The closest hit over every triangle of ``flat`` by
    :func:`watertight_intersect`, on the host, for a handful of rays (the
    native walk's recheck, ``ops/projection.py``), without the copy of the
    whole tree that :func:`bvh_to_device` makes.  Every ray goes down the
    tree at once (an internal node ``i`` has the children ``i + 1`` and
    ``escape[i + 1]``) through the boxes it crosses, each widened by 1e-5
    of the root box's largest coordinate, so every triangle it can hit is
    in a leaf it reaches; those leaves' triangles are tested in f32 and
    the nearest hit taken (the lowest slot on a tie): the test of every
    triangle's result, which :func:`bvh_intersect`'s walk, pruning its
    boxes in f32, can miss by an ulp.  Rays in, (t, prim, hit) tensors out
    on the rays' device, as :func:`native_intersector`."""
    pad = 1e-5 * float(np.abs(np.concatenate([flat.bbox_min[0], flat.bbox_max[0]])).max())

    def walk(origins, directions):
        dev = origins.device
        o32 = origins.detach().to("cpu", torch.float32)
        d32 = directions.detach().to("cpu", torch.float32)
        o, d = o32.double().numpy(), d32.double().numpy()
        with np.errstate(divide="ignore"):
            inv = np.where(np.abs(d) > 1e-30, 1.0 / d, np.where(d < 0, -1e30, 1e30))
        node, ray = np.zeros(len(o), np.int64), np.arange(len(o))
        found = []
        while node.size:
            t0 = (flat.bbox_min[node] - o[ray] - pad) * inv[ray]
            t1 = (flat.bbox_max[node] - o[ray] + pad) * inv[ray]
            near = np.minimum(t0, t1).max(1)
            cross = np.maximum(t0, t1).min(1) >= np.maximum(near, 0.0)
            node, ray = node[cross], ray[cross]
            leaf = flat.leaf_start[node] >= 0
            found.append(np.stack([node[leaf], ray[leaf]]))
            inner, ray = node[~leaf] + 1, ray[~leaf]
            node = np.concatenate([inner, flat.escape[inner].astype(np.int64)])
            ray = np.concatenate([ray, ray])
        leaves, ray = np.concatenate(found, 1)
        best_t = torch.full((len(o),), float("inf"))
        best_prim = torch.full((len(o),), -1, dtype=torch.int32)
        n = flat.leaf_count[leaves].astype(np.int64)
        slot = np.repeat(flat.leaf_start[leaves] - np.cumsum(n) + n, n) + np.arange(n.sum())
        ray = np.repeat(ray, n)
        t, ok = watertight_intersect(
            o32[ray], d32[ray], *(torch.from_numpy(a[slot])[:, None]
                                  for a in (flat.tri_v0, flat.tri_e1, flat.tri_e2)))
        t = torch.where(ok, t, torch.full_like(t, float("inf")))[:, 0].numpy()
        order = np.lexsort((slot, t, ray))  # a ray's hits, nearest first
        first = order[np.diff(ray[order], prepend=-1) != 0]
        first = first[np.isfinite(t[first])]
        best_t[ray[first]] = torch.from_numpy(t[first])
        best_prim[ray[first]] = torch.from_numpy(flat.tri_id[slot[first]].astype(np.int32))
        return best_t.to(dev), best_prim.to(dev), (best_prim >= 0).to(dev)

    return walk


def node_visibility(
    bvh: Optional[BVHArrays],
    triangles: torch.Tensor,  # (T, 3) node indices per original tri id
    vertices: torch.Tensor,  # (N, 3)
    node_indices: torch.Tensor,  # (K,) nodes to test
    cam_center: torch.Tensor,  # (3,)
    max_leaf: int = 4,
    n_jitter: int = 6,
    jitter: float = 1e-4,
    intersect: Optional[Intersector] = None,
    stats: Optional[dict] = None,
    check_every: int = CHECK_EVERY,
):
    """Per-node visibility by the reference's hit-triangle-contains-node
    test: a node is visible iff the closest hit of the ray camera->node
    lands on a triangle incident to it; 6 axis-jittered retries absorb
    edge/vertex grazing (psp_process.cpp:270-295 semantics).  Returns
    (visible (K,) bool, closest-hit prim of the unjittered ray (K,)).

    A retry only changes nodes that no earlier ray saw, so each retry casts
    only their rays (the JAX package casts all K each time; the result is
    the same).  ``intersect(origins, dirs) -> (t, prim, hit)`` replaces the
    device walk over ``bvh`` (e.g. :func:`native_intersector`); ``stats``,
    when given, receives "primary" ((K,) bool: the nodes the unjittered rays
    saw; the others are the grazing rays the retries handle) and "rays"
    (rays cast).  ``check_every``: the device walk's look interval.
    """
    if intersect is None:
        def intersect(o, d):
            return bvh_intersect(bvh, o, d, max_leaf=max_leaf, check_every=check_every)

    pos = vertices[node_indices]
    d = pos - cam_center[None, :]
    dirs = d / torch.linalg.norm(d, dim=1, keepdim=True)
    origins = cam_center.expand(pos.shape)
    _, prim, hit = intersect(origins, dirs)
    tri_nodes = triangles[prim.clamp_min(0).long()]
    visible = hit & (tri_nodes == node_indices[:, None]).any(1)
    n_rays = int(pos.shape[0])
    if stats is not None:
        stats["primary"] = visible.clone()
    offsets = torch.tensor(
        [[-jitter, 0, 0], [jitter, 0, 0], [0, -jitter, 0], [0, jitter, 0],
         [0, 0, -jitter], [0, 0, jitter]], dtype=pos.dtype, device=pos.device,
    )[:n_jitter]
    for k in range(n_jitter):
        (left,) = torch.nonzero(~visible, as_tuple=True)
        if not left.numel():
            break
        dk = pos[left] + offsets[k] - cam_center[None, :]
        dk = dk / torch.linalg.norm(dk, dim=1, keepdim=True)
        _, prim_k, hit_k = intersect(origins[left], dk)
        trik = triangles[prim_k.clamp_min(0).long()]
        visible[left] = hit_k & (trik == node_indices[left, None]).any(1)
        n_rays += int(left.numel())
    if stats is not None:
        stats["rays"] = n_rays
    return visible, prim


def oblique_cos_filter(normals, dirs, oblique_angle_deg):
    """Keep points whose surface faces the camera within the oblique limit:
    the angle between the normal and the unit camera->point ray exceeds
    ``180 - oblique_angle`` degrees (psp_process.cpp:1606, getTargets)."""
    thresh = np.cos(np.deg2rad(180.0 - oblique_angle_deg))
    cos_theta = (normals * dirs).sum(-1)
    return cos_theta < thresh
