"""The plain reference of one datapoint: phase 0, the frame program,
the frame statistics and phase 2, in plain PyTorch and numpy.

It imports nothing of the program and takes nothing the program made: it
reads the datapoint's own inputs (the decoded frames the generator wrote,
the targets file, the camera and grid definitions of
``benchmark/datapoint.py``) and works everything out again.  Its steps
are the semantics of the program's stages, written from their plain
twins and the datapoint's definition:

- phase 0 for the flat plate under overhead pinhole cameras: the nodes'
  projection with the camera parameters held in float32 and the points in
  float64 (as the program projects), every node in front of every camera
  and unoccluded (a plane seen from above), the nearest pixel, best view
  by the largest view angle (the first camera on a tie); the ECC and
  phase-correlation templates from the hot-pixel-repaired first frame;
  the polynomial patch operators of the targets (clusters, boundary
  threshold from the first frame's histogram, the degree-3 fill);
- the frame program: hot-pixel repair; in "fft" mode the phase
  correlation (4x4 pooling, Hann window, a Gaussian prior, parabolic
  peak), the integer pre-shift and two Gauss-Newton steps from the
  sub-pixel residual; in identity mode the while loop from identity (50
  steps, |drho| < 1e-3, each frame on its own); then the warp (separable
  resample and its second-order shear term), the patches, the 3-tap
  Gaussian, the node gather and NaN where no camera sees a node.  The
  images are float32 as the program's; the statistics of a step are summed
  and solved in float64;
- the frame statistics (mean, rms) and phase 2 (ratio to the mean, the
  degree-6 detrend over frames, the paint gain) in float64.

Unlike the program it applies the patches to the whole warped image
before the filter (the program overlays precomposed corrections on the
nodes), gathers by a plain index (no tiles), and pools, transforms and
solves in any batch.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.datapoint import CAM_X, CAM_Y, CAM_Z, plate_xy

HOT_THRESH, HOT_MIN_CHANGE, HOT_MAX = 4064, 512, 5
ECC_TAPS = (0.0625, 0.25, 0.375, 0.25, 0.0625)  # the ksize-5 Gaussian pre-blur
FILTER_TAPS = (0.25, 0.5, 0.25)  # the deck's gaussian, filter_size 3
ECC_ITERS = 2  # fixed steps of the fft start
MAX_ITERS, EPSILON = 50, 1e-3  # the while loop's criteria
MAX_INTEGER_SHIFT = 64
BOUND_PTS, BUFFER_PTS, DIAM_SF = 2, 1, 1.2  # the deck's patch defaults
POLY_DEGREE = 3
DETREND_DEGREE = 6


class RefState(NamedTuple):
    pixel_index: torch.Tensor  # (C, N) int64
    weight: torch.Tensor  # (C, N) float32
    skipped: torch.Tensor  # (N,) bool
    patches: List[Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]]
    ref_frames: torch.Tensor  # (C, H, W) float32, hot pixels repaired
    image_hw: Tuple[int, int]


# ---------------------------------------------------------------------------
# phase 0


def _rmat_to_rvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> rotation vector (the axis from R + I near 180 deg)."""
    theta = np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        if axis[0] > 0:
            axis[1] *= np.sign(A[0, 1]) if A[0, 1] != 0 else 1.0
            axis[2] *= np.sign(A[0, 2]) if A[0, 2] != 0 else 1.0
        elif axis[1] > 0:
            axis[2] *= np.sign(A[1, 2]) if A[1, 2] != 0 else 1.0
        return axis / np.linalg.norm(axis) * theta
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return axis / (2.0 * np.sin(theta)) * theta


def _rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(rvec)
    k = rvec / theta
    x, y, z = k.unbind()
    o = torch.zeros_like(x)
    K = torch.stack([torch.stack([o, -z, y]), torch.stack([z, o, -x]),
                     torch.stack([-y, x, o])])
    eye = torch.eye(3, dtype=rvec.dtype)
    return eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)


class _Camera:
    """An overhead pinhole camera of the datapoint, its parameters held in
    float32 as the program holds them."""

    def __init__(self, c: int, focal: float, image_hw):
        h, w = image_hw
        rmat = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
        f32 = torch.float32
        self.rvec = torch.tensor(_rmat_to_rvec(rmat), dtype=f32)
        self.tvec = torch.tensor([-CAM_X[c], CAM_Y, CAM_Z], dtype=torch.float64).to(f32)
        self.fx = torch.tensor(focal, dtype=torch.float64).to(f32)
        self.cx = torch.tensor(w / 2, dtype=f32)
        self.cy = torch.tensor(h / 2, dtype=f32)
        self.R = _rodrigues(self.rvec)  # float32
        self.center = -(self.R.T @ self.tvec)  # float32

    def project(self, pts: torch.Tensor) -> torch.Tensor:
        """(..., 3) float64 points -> (..., 2) float64 pixels."""
        d = torch.float64
        xc = pts.to(d) @ self.R.to(d).T + self.tvec.to(d)
        xy = xc[..., :2] / xc[..., 2:3]
        return torch.stack([self.fx.to(d) * xy[..., 0] + self.cx.to(d),
                            self.fx.to(d) * xy[..., 1] + self.cy.to(d)], -1)


def fix_hot_pixels(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float32: a pixel >= 4064 more than 512 above the median of
    its 4-neighbours (the 2nd smallest of 3 at an edge, 2 at a corner)
    takes that median; a frame with more than 5 such pixels is left as it
    is.  All repairs read the original frame."""
    big = 3.0e38
    xp = F.pad(x[:, None], (1, 1, 1, 1), value=big)[:, 0]
    nb = torch.stack([xp[:, :-2, 1:-1], xp[:, 2:, 1:-1], xp[:, 1:-1, :-2],
                      xp[:, 1:-1, 2:]])
    srt = nb.sort(dim=0).values
    n_valid = (nb < big).sum(0)
    median = torch.where(n_valid == 4, srt[2], srt[1])
    hot = x >= HOT_THRESH
    few = hot.sum(dim=(1, 2)) <= HOT_MAX
    replace = hot & ((x - median) > HOT_MIN_CHANGE) & few[:, None, None]
    return torch.where(replace, median, x)


def _read_targets(path: str) -> np.ndarray:
    """(n, 4) x, y, z, diameter of a .tgts file's *Targets section."""
    rows, section = [], None
    with open(path) as fh:
        for raw in fh:
            words = raw.split()
            if len(words) <= 1:
                section = words[0] if words else None
                continue
            if section == "*Targets":
                rows.append([float(v) for v in words[1:4]] + [float(words[7])])
    return np.array(rows, np.float64)


def _target_box(uv, d):
    return np.floor(uv - 0.5 * d).astype(np.int64), np.ceil(uv + 0.5 * d).astype(np.int64)


def _clusters(uv: np.ndarray, diam: np.ndarray, reach: float) -> List[List[int]]:
    """Targets grouped where their patches would touch (breadth first from
    the lowest index)."""
    left = set(range(len(uv)))
    out = []
    while left:
        seed = min(left)
        left.discard(seed)
        members, queue = [seed], [seed]
        while queue:
            r = queue.pop()
            close = [j for j in list(left)
                     if np.linalg.norm(uv[r] - uv[j]) <= reach + 0.5 * (diam[r] + diam[j])]
            for j in close:
                left.discard(j)
                members.append(j)
                queue.append(j)
        out.append(members)
    return out


def _cluster_pixels(uv, diam, image_hw):
    """(boundary (B, 2), interior (I, 2)) in-frame pixel x, y of one
    cluster: the targets' boxes (filled between their extremes), a ring of
    BOUND_PTS pixels BUFFER_PTS outside them."""
    from scipy.ndimage import maximum_filter

    pad = BOUND_PTS + BUFFER_PTS
    if len(uv) == 1:
        t0, t1 = _target_box(uv[0], diam[0])
        gx, gy = np.meshgrid(np.arange(t0[0], t1[0] + 1), np.arange(t0[1], t1[1] + 1),
                             indexing="ij")
        interior = np.stack([gx.ravel(), gy.ravel()], 1)
        gx, gy = np.meshgrid(np.arange(t0[0] - pad, t1[0] + pad + 1),
                             np.arange(t0[1] - pad, t1[1] + pad + 1), indexing="ij")
        out = ((gx < t0[0] - BUFFER_PTS) | (gx > t1[0] + BUFFER_PTS)
               | (gy < t0[1] - BUFFER_PTS) | (gy > t1[1] + BUFFER_PTS))
        bounds = np.stack([gx[out], gy[out]], 1)
    else:
        boxes = [_target_box(uv[k], diam[k]) for k in range(len(uv))]
        mins = np.stack([b[0] for b in boxes])
        maxs = np.stack([b[1] for b in boxes])
        t0 = mins.min(0) - pad
        t1 = maxs.max(0) + pad
        mask = np.zeros((int(t1[0] - t0[0] + 1), int(t1[1] - t0[1] + 1)), bool)
        for k in range(len(uv)):
            lo, hi = mins[k] - t0, maxs[k] - t0
            mask[lo[0] : hi[0] + 1, lo[1] : hi[1] + 1] = True
        for x in range(mask.shape[0]):
            idx = np.nonzero(mask[x])[0]
            if idx.size:
                mask[x, idx[0] : idx[-1] + 1] = True
        for y in range(mask.shape[1]):
            idx = np.nonzero(mask[:, y])[0]
            if idx.size:
                mask[idx[0] : idx[-1] + 1, y] = True
        reach = maximum_filter(mask, size=2 * pad + 1)
        near = maximum_filter(mask, size=2 * BUFFER_PTS + 1) if BUFFER_PTS > 0 else mask
        bounds = np.argwhere(reach & ~near & ~mask) + t0[None]
        interior = np.argwhere(mask) + t0[None]
    h, w = image_hw

    def inside(xy):
        return (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)

    return bounds[inside(bounds)], interior[inside(interior)]


def _histogram_threshold(img: np.ndarray) -> int:
    """The boundary threshold of a 12-bit first frame: the 256-bin
    histogram's first valley after its first peak (peaks at least 5 bins
    apart, plateaus at their middle), plus 5."""
    bin_sz = 16
    counts = np.zeros(256, np.int64)
    vals = img[img < 4096].astype(np.int64) // bin_sz
    np.add.at(counts, vals, 1)

    def peaks(data):
        data = np.asarray(data, np.float64)
        out, plateau, begin = [], False, 0
        for i in range(len(data) - 1):
            if not plateau:
                if data[i] > data[i + 1] and (i == 0 or data[i] > data[i - 1]):
                    if out and i - out[-1] < 5:
                        if data[out[-1]] < data[i]:
                            out[-1] = i
                        continue
                    out.append(i)
                elif i > 0 and data[i] > data[i - 1] and data[i] == data[i + 1]:
                    plateau, begin = True, i
            elif data[i] < data[i + 1]:
                plateau = False
            elif data[i] > data[i + 1]:
                plateau = False
                p = (i + begin) // 2
                if out and p - out[-1] < 5:
                    if data[out[-1]] < data[p]:
                        out[-1] = p
                    continue
                out.append(p)
        return out

    counts = counts.astype(np.float64)
    maxima = peaks(counts)
    valley = 0
    if maxima:
        with np.errstate(divide="ignore"):
            inv = np.where(counts > 0, 1.0 / counts, np.inf)
        finite = np.isfinite(inv)
        fill = np.nanmax(inv[finite]) if finite.any() else 0.0
        for p in peaks(np.where(finite, inv, fill)):
            if p > maxima[0]:
                valley = p
                break
    return int(valley * bin_sz + 5)


def _poly_basis(x, y):
    return np.stack([(y.astype(np.float64) ** i) * (x.astype(np.float64) ** j)
                     for i in range(POLY_DEGREE + 1) for j in range(POLY_DEGREE + 1)
                     if i + j <= POLY_DEGREE], 1)


def _patches(cam: _Camera, targets: np.ndarray, first: np.ndarray, image_hw):
    """[(M (I, B) float32, boundary flat index (B,), interior flat index
    (I,))] of one camera's clusters, or None."""
    from scipy.ndimage import minimum_filter

    h, w = image_hw
    xyz = torch.from_numpy(targets[:, :3])
    uv = cam.project(xyz).numpy()
    keep = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    uv, tg = uv[keep], targets[keep]
    n = np.array([0.0, 0.0, 1.0])  # the plate's normal
    a = np.cross(n, [1.0, 0.0, 0.0])
    a /= np.linalg.norm(a)
    b = np.cross(a, n)
    diam = np.zeros(len(tg))
    for i in range(len(tg)):
        total = 0.0
        for k in range(4):
            th = 2 * np.pi * k / 4
            pt = tg[i, :3] + 0.5 * tg[i, 3] * (np.cos(th) * a + np.sin(th) * b)
            proj = cam.project(torch.from_numpy(pt[None, :])).numpy()[0]
            total += 2.0 * np.linalg.norm(proj - uv[i])
        diam[i] = total / 4.0
    diam = diam * DIAM_SF
    uv, diam = uv[diam > 0], diam[diam > 0]
    if not len(uv):
        return None
    thresh = _histogram_threshold(first)
    local_min = minimum_filter(first.astype(np.float64), size=5, mode="nearest")
    n_coef = (POLY_DEGREE + 2) * (POLY_DEGREE + 1) // 2
    ops = []
    for g in _clusters(uv, diam, BOUND_PTS + BUFFER_PTS):
        bounds, interior = _cluster_pixels(uv[g], diam[g], image_hw)
        bounds = bounds[local_min[bounds[:, 1], bounds[:, 0]] >= thresh]
        if bounds.shape[0] < n_coef or not interior.shape[0]:
            continue
        M = _poly_basis(interior[:, 0], interior[:, 1]) @ np.linalg.pinv(
            _poly_basis(bounds[:, 0], bounds[:, 1]))
        ops.append((torch.from_numpy(M.astype(np.float32)),
                    torch.from_numpy(bounds[:, 1] * w + bounds[:, 0]),
                    torch.from_numpy(interior[:, 1] * w + interior[:, 0])))
    return ops or None


OPTIONS = {"target_patcher": "polynomial", "registration": "pixel", "filter": "gaussian",
           "filter_size": 3, "overlap": "best_view"}


def phase0(dp: dict, device) -> RefState:
    """The reference's phase-0 state of the datapoint ``dp``
    (:func:`benchmark.datapoint.write_datapoint`'s return)."""
    if dp["options"] != OPTIONS:
        raise ValueError(f"the reference implements the deck options {OPTIONS}, "
                         f"not {dp['options']}")
    h, w = dp["image_hw"]
    x, y = plate_xy(dp["grid_shape"])
    verts32 = torch.from_numpy(np.stack([x, y, np.zeros_like(x)], 1))
    verts = verts32.to(torch.float64)
    n_cams = dp["contents"].shape[1]
    targets = _read_targets(f"{dp['root']}/plate.tgts")
    idx, vis, angle, patches = [], [], [], []
    normal = torch.tensor([0.0, 0.0, 1.0])
    cams = [_Camera(c, dp["focal"], (h, w)) for c in range(n_cams)]
    for c, cam in enumerate(cams):
        pix = cam.project(verts)
        in_frame = (pix[:, 0] >= 0) & (pix[:, 0] < w) & (pix[:, 1] >= 0) & (pix[:, 1] < h)
        col = torch.round(pix[:, 0]).clamp(0, w - 1).long()
        row = torch.round(pix[:, 1]).clamp(0, h - 1).long()
        idx.append(torch.where(in_frame, row * w + col, torch.zeros_like(col)))
        vis.append(in_frame)
        d = verts32 - cam.center
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-30)
        cos_t = (d * normal).sum(-1).clamp(-1.0, 1.0)
        angle.append(torch.rad2deg(torch.arccos(cos_t)))
        first = dp["contents"][0, c]
        patches.append(_patches(cam, targets, first, (h, w)))
    vis = torch.stack(vis)
    ang = torch.where(vis, torch.stack(angle), torch.full((n_cams, len(x)), -math.inf))
    best = torch.argmax(ang, dim=0)
    weight = ((torch.arange(n_cams)[:, None] == best[None]) & vis).float()
    ref = fix_hot_pixels(torch.from_numpy(dp["contents"][0].astype(np.float32)))

    def dev(t):
        return t.to(device)

    return RefState(
        pixel_index=dev(torch.stack(idx)), weight=dev(weight), skipped=dev(~vis.any(0)),
        patches=[None if p is None else [tuple(dev(t) for t in op) for op in p]
                 for p in patches],
        ref_frames=dev(ref), image_hw=(h, w))


# ---------------------------------------------------------------------------
# images


def separable(x: torch.Tensor, taps) -> torch.Tensor:
    """Reflect-101 separable filter of (B, H, W) float32, rows then columns."""
    k = len(taps)
    r = k // 2
    h, w = x.shape[-2:]
    p = F.pad(x[:, None], (r, r, r, r), mode="reflect")[:, 0]
    xh = sum(float(taps[i]) * p[:, :, i : i + w] for i in range(k))
    return sum(float(taps[i]) * xh[:, i : i + h, :] for i in range(k))


def _tent(pos: torch.Tensor, n: int):
    pos = pos.clamp(-2.0, n + 1.0)
    p0 = torch.floor(pos)
    w1 = pos - p0
    w0 = 1.0 - w1
    i0 = p0.long()
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 < n), w0, torch.zeros_like(w0))
    w1 = torch.where((i1 >= 0) & (i1 < n), w1, torch.zeros_like(w1))
    return i0.clamp(0, n - 1), w0, i1.clamp(0, n - 1), w1


def warp(imgs: torch.Tensor, warps: torch.Tensor) -> torch.Tensor:
    """out(x, y) = img(W @ [x, y, 1]), zero outside: the separable
    resample of rows at a11 y + ty + a10 cx and columns at a00 x + tx +
    a01 cy (tent weights), plus the second-order Taylor term of the shear
    displacements (a01 (y - cy), a10 (x - cx)); float32."""
    b, h, w = imgs.shape
    a00, a01, tx, a10, a11, ty = warps.reshape(-1, 6).unbind(1)
    dev = imgs.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    cy, cx = (h - 1) * 0.5, (w - 1) * 0.5
    i0, w0, i1, w1 = _tent(a11[:, None] * ys + ty[:, None] + a10[:, None] * cx, h)
    rows = (w0[:, :, None] * imgs.gather(1, i0[:, :, None].expand(b, h, w))
            + w1[:, :, None] * imgs.gather(1, i1[:, :, None].expand(b, h, w)))
    j0, v0, j1, v1 = _tent(a00[:, None] * xs + tx[:, None] + a01[:, None] * cy, w)
    sep = (v0[:, None, :] * rows.gather(2, j0[:, None, :].expand(b, h, w))
           + v1[:, None, :] * rows.gather(2, j1[:, None, :].expand(b, h, w)))
    dy = a10[:, None, None] * (xs - cx)[None, None, :]
    dx = a01[:, None, None] * (ys - cy)[None, :, None]
    iax, iay = 1.0 / a00[:, None, None], 1.0 / a11[:, None, None]
    z = torch.zeros_like(sep)
    gx, gxx, gy, gyy, gxy = z.clone(), z.clone(), z.clone(), z.clone(), z.clone()
    gx[:, :, 1:-1] = 0.5 * (sep[:, :, 2:] - sep[:, :, :-2]) * iax
    gy[:, 1:-1, :] = 0.5 * (sep[:, 2:, :] - sep[:, :-2, :]) * iay
    gxx[:, :, 1:-1] = (sep[:, :, 2:] - 2 * sep[:, :, 1:-1] + sep[:, :, :-2]) * iax * iax
    gyy[:, 1:-1, :] = (sep[:, 2:, :] - 2 * sep[:, 1:-1, :] + sep[:, :-2, :]) * iay * iay
    gxy[:, 1:-1, 1:-1] = 0.25 * (sep[:, 2:, 2:] - sep[:, 2:, :-2] - sep[:, :-2, 2:]
                                 + sep[:, :-2, :-2]) * iax * iay
    out = sep + dx * gx + dy * gy
    return out + 0.5 * dx * dx * gxx + dx * dy * gxy + 0.5 * dy * dy * gyy


def valid_mask(h: int, w: int, warps: torch.Tensor) -> torch.Tensor:
    """1 where the separable sample positions lie inside the image."""
    dev = warps.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    y = warps[:, 1, 1, None] * ys + warps[:, 1, 2, None] + warps[:, 1, 0, None] * ((w - 1) * 0.5)
    x = warps[:, 0, 0, None] * xs + warps[:, 0, 2, None] + warps[:, 0, 1, None] * ((h - 1) * 0.5)
    my = ((y >= 0.0) & (y <= h - 1.0)).float()
    mx = ((x >= 0.0) & (x <= w - 1.0)).float()
    return my[:, :, None] * mx[:, None, :]


def integer_shift(imgs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out[y, x] = img[y + ty, x + tx], zero outside."""
    b, h, w = imgs.shape
    t = t.long()
    ys = torch.arange(h, device=imgs.device)[None] + t[:, 1:2]
    xs = torch.arange(w, device=imgs.device)[None] + t[:, 0:1]
    rows = imgs.gather(1, ys.clamp(0, h - 1)[:, :, None].expand(b, h, w))
    out = rows.gather(2, xs.clamp(0, w - 1)[:, None, :].expand(b, h, w))
    ok = ((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :]
    return torch.where(ok, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# registration


def decimation(h: int, w: int) -> int:
    """The phase correlation's pooling: the largest power of two that keeps
    the pooled frame at least 256 px."""
    k = 1
    while min(h, w) // (2 * k) >= 256:
        k *= 2
    return k


def _pool(img: torch.Tensor, k: int) -> torch.Tensor:
    h, w = img.shape[-2:]
    x = img[..., : (h // k) * k, : (w // k) * k]
    return x.reshape(x.shape[:-2] + (h // k, k, w // k, k)).mean(dim=(-3, -1))


def _crop_pow2(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2:]
    h2, w2 = 2 ** int(math.log2(h)), 2 ** int(math.log2(w))
    y0, x0 = (h - h2) // 2, (w - w2) // 2
    return img[..., y0 : y0 + h2, x0 : x0 + w2]


class Correlator:
    """Phase correlation against a template: (B, H, W) -> (B, 2) [tx, ty]
    with img(x + tx, y + ty) ~ template(x, y), on the pooled frames'
    centred power-of-two crop, Hann-windowed, with a Gaussian prior of
    12 full-resolution pixels on the displacement and a parabolic peak."""

    def __init__(self, ref: torch.Tensor, prior_px: float = 12.0):
        self.k = decimation(*ref.shape[-2:])
        small = _crop_pow2(_pool(ref, self.k))
        h, w = small.shape
        dev = ref.device
        hann_h = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(h, device=dev) / h)
        hann_w = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(w, device=dev) / w)
        self.win = (hann_h[:, None] * hann_w[None]).float()
        s = prior_px / self.k
        dy = torch.minimum(torch.arange(h, device=dev), h - torch.arange(h, device=dev))
        dx = torch.minimum(torch.arange(w, device=dev), w - torch.arange(w, device=dev))
        self.prior = (torch.exp(-0.5 * (dy / s) ** 2)[:, None]
                      * torch.exp(-0.5 * (dx / s) ** 2)[None]).float()
        self.spec = torch.fft.rfft2(small * self.win)
        self.hw = (h, w)

    def __call__(self, imgs: torch.Tensor) -> torch.Tensor:
        h, w = self.hw
        f = torch.fft.rfft2(_crop_pow2(_pool(imgs, self.k)) * self.win)
        cross = self.spec * torch.conj(f)
        cross = cross / (cross.abs() + 1e-8)
        surf = (torch.fft.irfft2(cross, s=(h, w)) * self.prior).reshape(-1, h * w)
        i = surf.argmax(1)
        py, px = i // w, i % w

        def at(yy, xx):
            return surf.gather(1, ((yy % h) * w + xx % w)[:, None])[:, 0]

        def parabolic(c, lo, hi):
            den = lo - 2.0 * c + hi
            den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
            return (0.5 * (lo - hi) / den).clamp(-0.5, 0.5)

        c = at(py, px)
        fy = py.float() + parabolic(c, at(py - 1, px), at(py + 1, px))
        fx = px.float() + parabolic(c, at(py, px - 1), at(py, px + 1))
        dy = torch.where(fy > h / 2, fy - h, fy)
        dx = torch.where(fx > w / 2, fx - w, fx)
        return torch.stack([-dx, -dy], 1) * self.k


def _gn_step(img_b, tmpl, kshift, warps, valid_shift):
    """One Gauss-Newton step of the ECC maximisation in float64 sums:
    (new warps, rho, |drho| against ``rho_prev`` is the caller's)."""
    b, h, w = img_b.shape
    iw = warp(img_b, warps)
    mask_w = warps if valid_shift is None else torch.cat(
        [warps[:, :, :2], (warps[:, :, 2] + valid_shift)[:, :, None]], 2)
    m = valid_mask(h, w, mask_w).double()
    a00, a01, _, a10, a11, _ = (v[:, None, None].double()
                                for v in warps.reshape(-1, 6).unbind(1))
    iwd = iw.double()
    gix = torch.zeros_like(iwd)
    giy = torch.zeros_like(iwd)
    gix[:, :, 1:-1] = 0.5 * (iwd[:, :, 2:] - iwd[:, :, :-2])
    giy[:, 1:-1, :] = 0.5 * (iwd[:, 2:, :] - iwd[:, :-2, :])
    det = a00 * a11 - a01 * a10
    gx = (a11 * gix - a10 * giy) / det * m
    gy = (-a01 * gix + a00 * giy) / det * m
    dev = img_b.device
    ys = torch.arange(h, dtype=torch.float64, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float64, device=dev)[None, None, :]
    area = m.sum((1, 2)).clamp_min(1.0)
    tv = (tmpl.double() - kshift)[None]
    iv = iwd - kshift
    t_zm = (tv - ((tv * m).sum((1, 2)) / area)[:, None, None]) * m
    i_zm = (iv - ((iv * m).sum((1, 2)) / area)[:, None, None]) * m
    jac = [gx * xs, gy * xs, gx * ys, gy * ys, gx, gy]  # d/d[a00 a10 a01 a11 tx ty]
    J = torch.stack(jac, 1).reshape(b, 6, h * w)
    hmat = J @ J.transpose(1, 2)
    i_proj = (J @ i_zm.reshape(b, h * w, 1))[..., 0]
    t_proj = (J @ t_zm.reshape(b, h * w, 1))[..., 0]
    iw_norm2 = (i_zm * i_zm).sum((1, 2))
    corr = (t_zm * i_zm).sum((1, 2))
    tmpl_norm = torch.sqrt((t_zm * t_zm).sum((1, 2))).clamp_min(1e-12)
    reg = 1e-9 * hmat.diagonal(dim1=1, dim2=2).sum(1) / 6.0 + 1e-12
    hreg = hmat + reg[:, None, None] * torch.eye(6, dtype=hmat.dtype, device=dev)
    hinv_i = torch.linalg.solve(hreg, i_proj)
    hinv_t = torch.linalg.solve(hreg, t_proj)
    num = iw_norm2 - (i_proj * hinv_i).sum(1)
    den = corr - (t_proj * hinv_i).sum(1)
    den = torch.where(den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
    dp = (num / den)[:, None] * hinv_t - hinv_i
    dwarp = torch.stack([dp[:, [0, 2, 4]], dp[:, [1, 3, 5]]], 1)
    new = warps.double() + dwarp
    new = torch.where(torch.isfinite(new), new, warps.double()).float()
    rho = corr / (tmpl_norm * torch.sqrt(iw_norm2.clamp_min(0.0))).clamp_min(1e-12)
    rho = torch.where(torch.isfinite(rho), rho, torch.full_like(rho, -1.0))
    return new, rho


class Registration:
    """ECC templates of one camera: the pre-blurred reference frame, its
    mean (the brightness shift of the statistics) and its correlator."""

    def __init__(self, ref: torch.Tensor):
        self.tmpl = separable(ref[None], ECC_TAPS)[0]
        self.kshift = self.tmpl.double().mean()
        self.corr = Correlator(ref)

    def fft(self, fixed: torch.Tensor):
        """(warps, pre-shifted frames, iterations) of the fft start."""
        t = self.corr(fixed)
        t_int = torch.round(t).clamp(-MAX_INTEGER_SHIFT, MAX_INTEGER_SHIFT)
        shifted = integer_shift(fixed, t_int)
        b = fixed.shape[0]
        w = torch.zeros((b, 2, 3), device=fixed.device)
        w[:, 0, 0] = w[:, 1, 1] = 1.0
        w[:, :, 2] = t - t_int
        img_b = separable(shifted, ECC_TAPS)
        for _ in range(ECC_ITERS):
            w, _ = _gn_step(img_b, self.tmpl, self.kshift, w, t_int)
        return w, shifted, torch.full((b,), ECC_ITERS)

    def identity(self, fixed: torch.Tensor):
        """(warps, frames, iterations) of the while loop from identity, a
        frame at a time."""
        img_b = separable(fixed, ECC_TAPS)
        out, iters = [], []
        for i in range(fixed.shape[0]):
            w = torch.zeros((1, 2, 3), device=fixed.device)
            w[:, 0, 0] = w[:, 1, 1] = 1.0
            rho_prev = torch.full((1,), -1.0, device=fixed.device)
            for it in range(1, MAX_ITERS + 1):
                w, rho = _gn_step(img_b[i : i + 1], self.tmpl, self.kshift, w, None)
                done = bool((rho - rho_prev).abs()[0] < EPSILON)
                rho_prev = rho
                if done:
                    break
            out.append(w)
            iters.append(it)
        return torch.cat(out), fixed, torch.tensor(iters)


def apply_patches(img: torch.Tensor, ops) -> torch.Tensor:
    """Each cluster's interior replaced by the polynomial fill of its
    boundary, every boundary read from the image as it came in."""
    if not ops:
        return img
    b = img.shape[0]
    flat = img.reshape(b, -1)
    fills = [(iidx, (flat[:, bidx].double() @ M.double().T).float())
             for M, bidx, iidx in ops]
    out = flat.clone()
    for iidx, fill in fills:
        out[:, iidx] = fill
    return out.reshape(img.shape)


def frame_program(frames: torch.Tensor, state: RefState, regs: List[Registration],
                  mode: str):
    """(B, C, H, W) float32 decoded frames -> ((B, N) float32 node
    intensities, (B, C) Gauss-Newton steps)."""
    b, n_c = frames.shape[:2]
    total = None
    steps = []
    for c in range(n_c):
        fixed = fix_hot_pixels(frames[:, c])
        w, src, it = (regs[c].fft(fixed) if mode == "fft" else regs[c].identity(fixed))
        steps.append(it)
        img = separable(apply_patches(warp(src, w), state.patches[c]), FILTER_TAPS)
        vals = img.reshape(b, -1)[:, state.pixel_index[c]] * state.weight[c]
        total = vals if total is None else total + vals
    total = torch.where(state.skipped, torch.full_like(total, float("nan")), total)
    return total, torch.stack(steps, 1)


def intensities(dp: dict, state: RefState, mode: str, device, batch: int = 4):
    """((n_distinct + 3, N) float32 intensity of each distinct frame content
    (``dp["contents"]`` rows), (rows, C) Gauss-Newton steps)."""
    regs = [Registration(state.ref_frames[c]) for c in range(state.ref_frames.shape[0])]
    out, steps = [], []
    rows = dp["contents"]
    for s in range(0, len(rows), batch):
        x = torch.from_numpy(rows[s : s + batch].astype(np.float32)).to(device)
        v, it = frame_program(x, state, regs, mode)
        out.append(v)
        steps.append(it)
    return torch.cat(out), torch.cat(steps)


# ---------------------------------------------------------------------------
# statistics and phase 2


def detrend_basis(n_frames: int, device) -> torch.Tensor:
    """(F, D) float64 orthonormal basis of the degree-6 (at most F - 1)
    polynomials in f / F."""
    deg = min(DETREND_DEGREE, n_frames - 1)
    f = torch.arange(n_frames, dtype=torch.float64, device=device) / n_frames
    A = torch.stack([f ** k for k in range(deg + 1)], 1)
    return torch.linalg.qr(A).Q


def phase2_block(it_t: torch.Tensor, avg: torch.Tensor, covered: torch.Tensor,
                 Q: torch.Tensor, dp: dict) -> torch.Tensor:
    """(n, F) float64 delta-Cp of a block of nodes from their (n, F) float64
    intensities and frame means: (avg / I - its polynomial fit) times the
    paint gain a + bT + cT^2 + (d + eT + fT^2) P times 144 / qbar.  The
    datapoint's paint has b = ... = f = 0, so the gain is a."""
    a, b, c, d, e, f = dp["paint"]
    if any((b, c, d, e, f)):
        raise ValueError("the reference's gain takes a constant paint (b..f = 0)")
    ratio = avg[:, None] / it_t
    fit = (ratio @ Q) @ Q.T
    dcp = (ratio - fit) * a * (144.0 / dp["qbar"])
    return torch.where(covered[:, None], dcp, torch.full_like(dcp, float("nan")))
