"""Fiducial patching: cover marker dots with a smooth local polynomial fill.

Port of ``upsp_tpu/ops/patching.py``.  Phase 0 builds, per cluster, the
composed operator ``M = A_internal @ pinv(A_boundary)`` on the host (numpy,
as the JAX package); per frame the fill is a gather of boundary pixels,
the operator's products summed along its rows and a scatter of
interiors (:func:`apply_patches`), or, on
the fused warp+filter tail, the node-level correction of
:class:`PatchNodeCorrection` sampled from the kernel's pre-filter warped
image (:func:`patch_correction_values`).  The product runs a frame at a
time, as the JAX package's per-frame ``einsum`` under ``vmap``: one
matmul over the whole batch makes the frames a GEMM's columns, whose
blocking depends on their count, so a frame's fill would change with the
frames beside it.

The products are summed in float64 and rounded to float32 once, and the
node-level correction keeps its composed operator in float64.  A cluster
whose boundary the threshold has cut to a few pixels on one side fits a
cubic that extrapolates: its operator's rows reach 1e5 in absolute sum,
and the fill, tens of thousands of counts below zero, is the difference
of terms a thousand times larger.  Rounded or summed in float32 it moves
by up to tens of counts; in float64 it is the exact product of the
float32 operator and pixels, rounded once, as the deck defines it.  (The
JAX package rounds the correction's operator and sums in float32.)
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from upsp_tpu_torch.ops.ecc_kernels import filter_taps
from upsp_tpu_torch.ops.image import image_dtype

# ---------------------------------------------------------------------------
# host-side cluster construction


@dataclasses.dataclass
class PatchCluster:
    bounds_xy: np.ndarray  # (B, 2) int boundary pixel coords (x, y)
    internal_xy: np.ndarray  # (I, 2) int interior pixel coords


def _target_box(uv: np.ndarray, diameter: float):
    t_min = np.floor(uv - 0.5 * diameter).astype(np.int64)
    t_max = np.ceil(uv + 0.5 * diameter).astype(np.int64)
    return t_min, t_max


def cluster_targets(uv: np.ndarray, diameters: np.ndarray,
                    bound_pts: int = 4) -> List[np.ndarray]:
    """Group targets whose patch regions would touch (BFS, brute force)."""
    unvisited = set(range(uv.shape[0]))
    clusters = []
    while unvisited:
        seed = min(unvisited)
        unvisited.discard(seed)
        members = [seed]
        queue = [seed]
        while queue:
            ref = queue.pop()
            close = [
                j for j in list(unvisited)
                if np.linalg.norm(uv[ref] - uv[j])
                <= bound_pts + 0.5 * (diameters[ref] + diameters[j])
            ]
            for j in close:
                unvisited.discard(j)
                members.append(j)
                queue.append(j)
        clusters.append(np.array(members, np.int64))
    return clusters


def _single_target_boundary(uv, diameter, bound_pts, buffer) -> PatchCluster:
    t_min, t_max = _target_box(uv, diameter)
    gx, gy = np.meshgrid(
        np.arange(t_min[0], t_max[0] + 1), np.arange(t_min[1], t_max[1] + 1),
        indexing="ij",
    )
    internal = np.stack([gx.ravel(), gy.ravel()], axis=1)
    pad = bound_pts + buffer
    gx, gy = np.meshgrid(
        np.arange(t_min[0] - pad, t_max[0] + pad + 1),
        np.arange(t_min[1] - pad, t_max[1] + pad + 1),
        indexing="ij",
    )
    outside = (
        (gx < t_min[0] - buffer) | (gx > t_max[0] + buffer)
        | (gy < t_min[1] - buffer) | (gy > t_max[1] + buffer)
    )
    bounds = np.stack([gx[outside], gy[outside]], axis=1)
    return PatchCluster(bounds_xy=bounds, internal_xy=internal)


def _multi_target_boundary(uvs, diameters, bound_pts, buffer) -> PatchCluster:
    boxes = [_target_box(uvs[k], diameters[k]) for k in range(uvs.shape[0])]
    mins = np.stack([b[0] for b in boxes])
    maxs = np.stack([b[1] for b in boxes])
    t_min = mins.min(axis=0) - (bound_pts + buffer)
    t_max = maxs.max(axis=0) + (bound_pts + buffer)
    dx = int(t_max[0] - t_min[0] + 1)
    dy = int(t_max[1] - t_min[1] + 1)
    mask = np.zeros((dx, dy), np.int8)
    for k in range(uvs.shape[0]):
        lo = mins[k] - t_min
        hi = maxs[k] - t_min
        mask[lo[0] : hi[0] + 1, lo[1] : hi[1] + 1] = 2
    # row/column fill between extreme marked cells
    for x in range(dx):
        idx = np.nonzero(mask[x] == 2)[0]
        if idx.size:
            mask[x, idx[0] : idx[-1] + 1] = 2
    for y in range(dy):
        idx = np.nonzero(mask[:, y] == 2)[0]
        if idx.size:
            mask[idx[0] : idx[-1] + 1, y] = 2
    filled = mask == 2
    from scipy.ndimage import maximum_filter

    reach = maximum_filter(filled, size=2 * (bound_pts + buffer) + 1)
    near = maximum_filter(filled, size=2 * buffer + 1) if buffer > 0 else filled
    bound_mask = reach & (~near) & (~filled)
    return PatchCluster(
        bounds_xy=np.argwhere(bound_mask) + t_min[None, :],
        internal_xy=np.argwhere(filled) + t_min[None, :],
    )


def build_patch_clusters(uv: np.ndarray, diameters: np.ndarray,
                         image_hw: Tuple[int, int], bound_pts: int = 3,
                         buffer: int = 2) -> List[PatchCluster]:
    """Cluster targets and compute in-frame boundary/interior pixel sets."""
    h, w = image_hw
    out = []
    for g in cluster_targets(uv, diameters, bound_pts + buffer):
        if len(g) == 1:
            pc = _single_target_boundary(uv[g[0]], diameters[g[0]], bound_pts,
                                         buffer)
        else:
            pc = _multi_target_boundary(uv[g], diameters[g], bound_pts, buffer)

        def inside(xy):
            return ((xy[:, 0] >= 0) & (xy[:, 0] < w)
                    & (xy[:, 1] >= 0) & (xy[:, 1] < h))

        out.append(PatchCluster(bounds_xy=pc.bounds_xy[inside(pc.bounds_xy)],
                                internal_xy=pc.internal_xy[inside(pc.internal_xy)]))
    return out


def threshold_bounds(clusters: Sequence[PatchCluster], ref_frame: np.ndarray,
                     thresh: float, offset: int = 2) -> List[PatchCluster]:
    """Drop boundary pixels whose (offset-box) neighbourhood dips below
    ``thresh``."""
    from scipy.ndimage import minimum_filter

    local_min = minimum_filter(
        np.asarray(ref_frame, np.float64), size=2 * offset + 1, mode="nearest"
    )
    out = []
    for c in clusters:
        keep = local_min[c.bounds_xy[:, 1], c.bounds_xy[:, 0]] >= thresh
        out.append(PatchCluster(bounds_xy=c.bounds_xy[keep],
                                internal_xy=c.internal_xy))
    return out


def poly2d_basis(x: np.ndarray, y: np.ndarray, degree: int = 3) -> np.ndarray:
    """Columns y^i * x^j for i+j <= degree, (i outer, j inner) ordering."""
    cols = [
        (y.astype(np.float64) ** i) * (x.astype(np.float64) ** j)
        for i in range(degree + 1) for j in range(degree + 1) if i + j <= degree
    ]
    return np.stack(cols, axis=1)


def polyfit2d(x, y, z, degree: int = 3) -> np.ndarray:
    """Least-squares 2D polynomial fit (reference polyfit2D semantics); a
    copy of ``upsp_tpu/ops/patching.py:219-223``."""
    A = poly2d_basis(np.asarray(x), np.asarray(y), degree)
    coeffs, *_ = np.linalg.lstsq(A, np.asarray(z, np.float64), rcond=None)
    return coeffs


def polyval2d(x, y, coeffs, degree: int = 3) -> np.ndarray:
    return poly2d_basis(np.asarray(x), np.asarray(y), degree) @ np.asarray(coeffs)


# ---------------------------------------------------------------------------
# composed operators


class PatchOperator(NamedTuple):
    """Padded, batched patch operator."""

    M: torch.Tensor  # (K, I_max, B_max) float32 composed fill operator
    boundary_idx: torch.Tensor  # (K, B_max) int64 flat pixel (0 where pad)
    internal_idx: torch.Tensor  # (K, I_max) int64 flat pixel (H*W = pad)
    n_clusters: int

    @property
    def empty(self) -> bool:
        return self.n_clusters == 0

    def to(self, device) -> "PatchOperator":
        return PatchOperator(self.M.to(device), self.boundary_idx.to(device),
                             self.internal_idx.to(device), self.n_clusters)


def build_patch_operator(clusters: Sequence[PatchCluster],
                         image_hw: Tuple[int, int],
                         degree: int = 3) -> Optional[PatchOperator]:
    """Compose fit+eval into one matrix per cluster; pad and batch."""
    h, w = image_hw
    n_coef = (degree + 2) * (degree + 1) // 2
    keep = [c for c in clusters
            if c.bounds_xy.shape[0] >= n_coef and c.internal_xy.shape[0] > 0]
    if not keep:
        return None
    b_max = max(c.bounds_xy.shape[0] for c in keep)
    i_max = max(c.internal_xy.shape[0] for c in keep)
    k_n = len(keep)
    M = np.zeros((k_n, i_max, b_max), np.float32)
    b_idx = np.zeros((k_n, b_max), np.int64)
    i_idx = np.full((k_n, i_max), h * w, np.int64)
    for k, c in enumerate(keep):
        bx, by = c.bounds_xy[:, 0], c.bounds_xy[:, 1]
        ix, iy = c.internal_xy[:, 0], c.internal_xy[:, 1]
        mk = poly2d_basis(ix, iy, degree) @ np.linalg.pinv(
            poly2d_basis(bx, by, degree)
        )
        M[k, : mk.shape[0], : mk.shape[1]] = mk
        b_idx[k, : bx.shape[0]] = by * w + bx
        i_idx[k, : ix.shape[0]] = iy * w + ix
    return PatchOperator(torch.from_numpy(M), torch.from_numpy(b_idx),
                         torch.from_numpy(i_idx), k_n)


class PatchNodeCorrection(NamedTuple):
    """Patch+filter effect precomposed to the affected pixels.

    filter(patch(warped)) at every pixel within the filter radius of a
    patch interior is one linear functional of warped values at a small
    static source set, so the fused warp+filter tail can skip patching and
    overlay these values on the few affected nodes.
    """

    src_flat: torch.Tensor  # (S,) int64 flat source pixels
    C: torch.Tensor  # (K, A_max, S_max) float64 affected-value operator
    src_slot: torch.Tensor  # (K, S_max) int64 into the (S,) sampled vector
    pix_idx: torch.Tensor  # (K, A_max) int64 flat affected pixel (H*W = pad)
    n_clusters: int

    def to(self, device) -> "PatchNodeCorrection":
        return PatchNodeCorrection(
            self.src_flat.to(device), self.C.to(device),
            self.src_slot.to(device), self.pix_idx.to(device), self.n_clusters,
        )


def _reflect101(v: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT_101 index (valid while the reach is below n)."""
    return np.where(v < 0, -v, np.where(v >= n, 2 * (n - 1) - v, v))


def _cluster_entries(k, M, b_idx, i_idx, int_k, int_i, taps, image_hw):
    """Affected pixels of cluster ``k`` and their (row, source pixel,
    coefficient) entries, in the order a loop over affected pixels, filter
    taps (dy outer) and nonzero boundary columns meets them; None when
    the filter window reaches another cluster's interior."""
    h, w = image_hw
    r = len(taps) // 2
    d = np.arange(-r, r + 1)
    dy, dx = np.repeat(d, d.size), np.tile(d, d.size)  # dy outer
    wgt = taps[dy + r] * taps[dx + r]  # (T,) f64
    q_int = i_idx[k][i_idx[k] != h * w]
    yy = (q_int // w)[:, None] + dy[None, :]
    xx = (q_int % w)[:, None] + dx[None, :]
    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    aff = np.unique((yy * w + xx)[inside])  # sorted affected pixels
    py, px = aff // w, aff % w
    q = (_reflect101(py[:, None] + dy[None, :], h) * w
         + _reflect101(px[:, None] + dx[None, :], w)).ravel()  # (A*T,)
    kq, iq = int_k[q], int_i[q]
    if ((kq >= 0) & (kq != k)).any():
        return None  # interacting clusters
    a_of = np.repeat(np.arange(aff.size), dy.size)
    v_of = np.tile(wgt, aff.size)
    bcols = np.nonzero((np.abs(M[k]) > 0).any(axis=0))[0]
    mk = M[k][:, bcols]  # (I_max, nb)
    nz_r, nz_c = np.nonzero(mk)  # row-major: columns ascending per row
    nnz = np.bincount(nz_r, minlength=mk.shape[0])
    row_start = np.cumsum(nnz) - nnz
    interior = kq >= 0
    cnt = np.where(interior, nnz[np.where(interior, iq, 0)], 1)
    start = np.cumsum(cnt) - cnt
    n_ent = int(cnt.sum())
    ent_a = np.repeat(a_of, cnt)
    ent_q = np.empty(n_ent, np.int64)
    ent_v = np.empty(n_ent, np.float64)
    ent_q[start[~interior]] = q[~interior]
    ent_v[start[~interior]] = v_of[~interior]
    j = np.nonzero(interior)[0]
    n_j = nnz[iq[j]]
    within = np.arange(int(n_j.sum())) - np.repeat(np.cumsum(n_j) - n_j, n_j)
    src = np.repeat(row_start[iq[j]], n_j) + within
    dst = np.repeat(start[j], n_j) + within
    ent_q[dst] = b_idx[k, bcols[nz_c[src]]]
    ent_v[dst] = np.repeat(v_of[j], n_j) * mk[nz_r[src], nz_c[src]]
    return aff, ent_a, ent_q, ent_v


def build_patch_node_correction(op: Optional[PatchOperator],
                                image_hw: Tuple[int, int], filter_type: str,
                                ksize: int) -> Optional[PatchNodeCorrection]:
    """Precompose filter(patch(warped)) at every affected pixel; None when
    the filter is unsupported or two clusters' windows interact.

    Source pixels take slots in the order the reference's loop meets them,
    and each coefficient sums its contributions in that order in f64 and
    stays f64, so its f32 rounding equals
    ``upsp_tpu.ops.patching.build_patch_node_correction``'s operator
    exactly; the loop itself is vectorised per cluster."""
    if op is None:
        return None
    taps = filter_taps(filter_type, ksize)  # the fused tail's filter
    if taps is None:
        return None
    taps = np.asarray(taps or (1.0,), np.float64)
    h, w = image_hw
    M = op.M.cpu().numpy().astype(np.float64)
    b_idx = op.boundary_idx.cpu().numpy()
    i_idx = op.internal_idx.cpu().numpy()
    k_n = op.n_clusters

    # flat pixel -> (cluster, M row) of every interior pixel; later
    # clusters win, as in the reference's dict
    int_k = np.full(h * w + 1, -1, np.int64)
    int_i = np.full(h * w + 1, -1, np.int64)
    for k in range(k_n):
        rows = np.nonzero(i_idx[k] != h * w)[0]
        int_k[i_idx[k, rows]] = k
        int_i[i_idx[k, rows]] = rows

    per_cluster = []
    for k in range(k_n):
        got = _cluster_entries(k, M, b_idx, i_idx, int_k, int_i, taps, image_hw)
        if got is None:
            return None
        per_cluster.append(got)
    a_max = max((aff.size for aff, _, _, _ in per_cluster), default=0)
    if a_max == 0:
        return None
    # global slots in order of first appearance: per cluster its distinct
    # sources with their first entry, then across clusters in cluster order
    per_q = [np.unique(e[2], return_index=True, return_inverse=True)
             for e in per_cluster]
    cand_q = np.concatenate([u for u, _, _ in per_q])
    cand_order = np.concatenate([
        k * (1 + max(e[2].size for e in per_cluster)) + first
        for k, (_, first, _) in enumerate(per_q)
    ])
    uniq = np.unique(cand_q)
    first = np.full(uniq.size, np.iinfo(np.int64).max)
    np.minimum.at(first, np.searchsorted(uniq, cand_q), cand_order)
    by_first = np.argsort(first)
    slot_of = np.empty(uniq.size, np.int64)
    slot_of[by_first] = np.arange(uniq.size)
    local = []
    for (aff, ent_a, _, ent_v), (uq, _, inv) in zip(per_cluster, per_q):
        s_uq = slot_of[np.searchsorted(uniq, uq)]
        slots = np.unique(s_uq)  # sorted global slots of this cluster
        local.append((aff, ent_a, np.searchsorted(slots, s_uq)[inv.ravel()],
                      ent_v, slots))
    s_max = max(e[4].size for e in local)
    C = np.zeros((k_n, a_max, s_max), np.float64)
    src_slot = np.zeros((k_n, s_max), np.int64)
    pix = np.full((k_n, a_max), h * w, np.int64)
    for k, (aff, ent_a, pos, ent_v, slots) in enumerate(local):
        acc = np.zeros((a_max, s_max), np.float64)
        np.add.at(acc, (ent_a, pos), ent_v)  # in entry order
        C[k] = acc
        src_slot[k, : slots.size] = slots
        pix[k, : aff.size] = aff
    return PatchNodeCorrection(
        src_flat=torch.from_numpy(uniq[by_first].astype(np.int64)),
        C=torch.from_numpy(C), src_slot=torch.from_numpy(src_slot),
        pix_idx=torch.from_numpy(pix), n_clusters=k_n,
    )


# ---------------------------------------------------------------------------
# per-frame application (on a batch of frames, a frame at a time)


def _frame_products(mat: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(B, K, R) float32 products of the (K, R, S) cluster operators with
    each frame's (K, S) gathered pixels in (B, K, S) ``vecs``, a frame at a
    time, each row's products summed along S in float64 and rounded once.
    Every frame takes the same call, so its sums do not depend on the
    frames beside it, and the one intermediate, (K, R, S), is the
    operator's own size."""
    mat = mat.to(torch.float64)
    vecs = vecs.to(torch.float64)
    return torch.stack([(mat * v.unsqueeze(1)).sum(-1) for v in vecs]).to(torch.float32)


def patch_correction_values(warped: torch.Tensor,
                            corr: PatchNodeCorrection) -> torch.Tensor:
    """(B, K, A_max) filtered-patched values from (B, H, W) pre-filter
    warped images: a gather at static source pixels + the cluster product,
    a frame at a time (:func:`_frame_products`)."""
    b = warped.shape[0]
    srcv = warped.reshape(b, -1)[:, corr.src_flat].to(torch.float32)
    return _frame_products(corr.C, srcv[:, corr.src_slot])


def apply_patches(frames: torch.Tensor,
                  op: Optional[PatchOperator]) -> torch.Tensor:
    """Patch all clusters of (B, H, W) frames: gather boundaries, the f32
    operator's product, summed in f64, a frame at a time (:func:`_frame_products`), scatter
    interiors (pad slots are dropped).
    bfloat16 frames stay bfloat16, the fill rounded once; others are f32."""
    frames = frames.to(image_dtype(frames))
    if op is None:
        return frames
    b = frames.shape[0]
    flat = frames.reshape(b, -1)
    z = flat[:, op.boundary_idx].float()  # (B, K, B_max); M's pad columns are 0
    fill = _frame_products(op.M, z).reshape(b, -1)
    idx = op.internal_idx.reshape(-1)
    keep = idx < flat.shape[1]
    out = flat.clone()
    out[:, idx[keep]] = fill[:, keep].to(flat.dtype)
    return out.reshape(frames.shape)
