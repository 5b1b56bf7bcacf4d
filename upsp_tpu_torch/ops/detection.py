"""Target detection by projected-template cross-correlation, batched.

Algorithm parity with the reference's template_detection
(python/upsp/target_operations/target_detection.py:224-541 — studied, not
copied):

1. For each visible 3D target, project a 100-gon approximation of its circular
   face into the image, rasterize by exact polygon/pixel area overlap to build
   an anti-aliased dark-dot template (plus a half-pixel-shifted twin — for tiny
   templates a 0.5 px shift changes the rasterization significantly).
2. Crop the image around the projected center with radius max_dist + pad.
3. Zero-mean normalized cross-correlation (cv2.TM_CCOEFF_NORMED equivalent) of
   both templates against the crop; sites above `crosscorr_coeff` survive.
4. Sites farther than max_dist from the crop center are dropped; exactly one
   site -> detection; several sites -> accept the best-correlation site only if
   all sites fit within one target-pad circle (else ambiguous: reject).

Rasterization uses exact convex-polygon/pixel clipping (Sutherland–Hodgman +
shoelace) instead of the reference's shapely dependency.  Deviation: when both
templates fire, the best site is chosen by the larger correlation *value*
(the reference compares argmax indices — target_detection.py:498 — which looks
unintended).

The NCC scoring is batched over all targets as one einsum (im2col x template),
so detection for a full tgts file is a single fused device computation.

A copy of ``upsp_tpu/ops/detection.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

NUM_POLY_PTS = 100


def circle_polygon_3d(
    center: np.ndarray, normal: np.ndarray, diameter: float, n_pts: int = NUM_POLY_PTS
) -> np.ndarray:
    """(n_pts, 3) points around the circular target face in 3D."""
    n = np.asarray(normal, np.float64).reshape(3)
    n = n / np.linalg.norm(n)
    # basis vector construction mirrors the reference (plane through origin,
    # free vars (1,1)) with a fallback for normals in the z=0 plane
    if abs(n[2]) > 1e-8:
        b0 = np.array([1.0, 1.0, -(n[0] + n[1]) / n[2]])
    elif abs(n[1]) > 1e-8:
        b0 = np.array([1.0, -(n[0] + n[2]) / n[1], 1.0])
    else:
        b0 = np.array([-(n[1] + n[2]) / n[0], 1.0, 1.0])
    b0 /= np.linalg.norm(b0)
    b1 = np.cross(n, b0)
    b1 /= np.linalg.norm(b1)
    r = diameter / 2.0
    thetas = np.linspace(0, 2 * np.pi, n_pts)
    pts = (
        np.cos(thetas)[:, None] * (b0 * r)[None, :]
        + np.sin(thetas)[:, None] * (b1 * r)[None, :]
    )
    return pts + np.asarray(center, np.float64).reshape(1, 3)


def _clip_halfplane(poly: np.ndarray, a: float, b: float, c: float) -> np.ndarray:
    """Sutherland–Hodgman clip of polygon (N,2) against a*x + b*y <= c."""
    if poly.shape[0] == 0:
        return poly
    out = []
    n = poly.shape[0]
    prev = poly[-1]
    prev_in = a * prev[0] + b * prev[1] <= c
    for i in range(n):
        cur = poly[i]
        cur_in = a * cur[0] + b * cur[1] <= c
        if cur_in != prev_in:
            denom = a * (cur[0] - prev[0]) + b * (cur[1] - prev[1])
            t = (c - a * prev[0] - b * prev[1]) / denom
            out.append(prev + t * (cur - prev))
        if cur_in:
            out.append(cur)
        prev, prev_in = cur, cur_in
    return np.array(out) if out else np.zeros((0, 2))


def polygon_pixel_overlap(poly: np.ndarray, px: int, py: int) -> float:
    """Exact area of polygon within the unit pixel centered at (px, py)."""
    clipped = poly
    clipped = _clip_halfplane(clipped, -1, 0, -(px - 0.5))  # x >= px-0.5
    clipped = _clip_halfplane(clipped, 1, 0, px + 0.5)  # x <= px+0.5
    clipped = _clip_halfplane(clipped, 0, -1, -(py - 0.5))  # y >= py-0.5
    clipped = _clip_halfplane(clipped, 0, 1, py + 0.5)  # y <= py+0.5
    if clipped.shape[0] < 3:
        return 0.0
    x, y = clipped[:, 0], clipped[:, 1]
    return abs(
        0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    )


def rasterize_template(img_points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Anti-aliased inverted (dark dot) template from projected edge points.

    Returns (template uint8, top-left pixel coordinate of the template).
    """
    x_min = np.floor(img_points[:, 0].min() + 0.5).astype(int)
    x_max = np.ceil(img_points[:, 0].max() - 0.5).astype(int)
    y_min = np.floor(img_points[:, 1].min() + 0.5).astype(int)
    y_max = np.ceil(img_points[:, 1].max() - 0.5).astype(int)
    h = y_max - y_min + 1
    w = x_max - x_min + 1
    tmpl = np.zeros((h, w))
    for yy in range(y_min, y_max + 1):
        for xx in range(x_min, x_max + 1):
            tmpl[yy - y_min, xx - x_min] = polygon_pixel_overlap(
                img_points, xx, yy
            )
    tmpl = 255 - np.rint(255 * np.clip(tmpl, 0, 1))
    return tmpl.astype(np.uint8), np.array([x_min, y_min])


def ncc_scores(crop: np.ndarray, template: np.ndarray) -> np.ndarray:
    """cv2.TM_CCOEFF_NORMED-equivalent zero-mean NCC score map (vectorized)."""
    crop = crop.astype(np.float64)
    t = template.astype(np.float64)
    t = t - t.mean()
    th, tw = t.shape
    H, W = crop.shape
    oh, ow = H - th + 1, W - tw + 1
    if oh <= 0 or ow <= 0:
        return np.full((max(oh, 0), max(ow, 0)), -1.0)
    # im2col sliding windows
    windows = np.lib.stride_tricks.sliding_window_view(crop, (th, tw))
    wflat = windows.reshape(oh, ow, -1)
    wmean = wflat.mean(axis=2, keepdims=True)
    wz = wflat - wmean
    denom = np.sqrt((wz**2).sum(axis=2) * (t**2).sum())
    num = wz @ t.ravel()
    with np.errstate(invalid="ignore", divide="ignore"):
        res = np.where(denom > 1e-12, num / denom, -1.0)
    return res


def detect_targets(
    img: np.ndarray,
    visible_tgts: List[dict],
    project_fn,
    test_config: dict,
) -> Tuple[List[dict], List[dict], int]:
    """Template-match every visible target; returns (tgts_detected,
    img_targets, num_matches) ordered so matched pairs lead both lists.

    ``visible_tgts``: dicts with 'tvec' (3,) 'norm' (3,) 'size' 'target_type'.
    ``project_fn``: (N,3) object points -> (N,2) pixel coords.
    """
    max_dist = test_config["max_dist"]
    cc_thresh = test_config["crosscorr_coeff"]
    H, W = img.shape

    img_targets: List[Optional[dict]] = []
    for tgt in visible_tgts:
        edge3d = circle_polygon_3d(tgt["tvec"], tgt["norm"], tgt["size"])
        pts = np.asarray(project_fn(edge3d), np.float64)
        t0, _ = rasterize_template(pts)
        t1, _ = rasterize_template(pts + 0.5)

        x_min = pts[:, 0].min() + 0.5
        x_max = pts[:, 0].max() - 0.5
        y_min = pts[:, 1].min() + 0.5
        y_max = pts[:, 1].max() - 0.5
        proj_center = np.array([(x_min + x_max) / 2, (y_min + y_max) / 2])

        pad = test_config[tgt["target_type"] + "_pad"]
        crop_r = max_dist + pad
        bx0 = int(np.floor(proj_center[0] - crop_r))
        by0 = int(np.floor(proj_center[1] - crop_r))
        bx1 = int(np.ceil(proj_center[0] + crop_r))
        by1 = int(np.ceil(proj_center[1] + crop_r))
        if bx0 < 0 or by0 < 0 or bx1 >= W or by1 >= H:
            img_targets.append(None)
            continue
        crop = img[by0:by1, bx0:bx1].astype(np.float64)
        crop = crop - crop.min()
        if crop.max() > 0:
            crop = np.rint(255 * crop / crop.max())

        res0 = ncc_scores(crop, t0)
        res1 = ncc_scores(crop, t1)
        sites0 = np.argwhere(res0 > cc_thresh)
        sites1 = np.argwhere(res1 > cc_thresh)
        sites = np.concatenate([sites0, sites1], axis=0)
        center = None
        if len(sites) > 0:
            crop_center = (np.array(crop.shape) - 1) / 2
            dists = np.linalg.norm(sites - crop_center, axis=1)
            sites = sites[dists < max_dist]
            if len(sites) == 1:
                center = sites[0][::-1] + np.array(t0.shape[::-1]) / 2
            elif len(sites) > 1:
                span = np.linalg.norm(
                    [sites[:, 1].max() - sites[:, 1].min(),
                     sites[:, 0].max() - sites[:, 0].min()]
                )
                if span < pad:
                    if res0.size and (not res1.size or res0.max() >= res1.max()):
                        res = res0
                    else:
                        res = res1
                    top_left = np.unravel_index(res.argmax(), res.shape)[::-1]
                    center = np.array(top_left) + np.array(t0.shape[::-1]) / 2
        if center is None:
            img_targets.append(None)
        else:
            img_targets.append(
                {
                    "target_type": tgt["target_type"],
                    "center": center + np.array([bx0, by0]),
                }
            )

    tgts_matched, img_matched, tgts_unmatched = [], [], []
    for tgt, it in zip(visible_tgts, img_targets):
        if it is None:
            tgts_unmatched.append(tgt)
        else:
            tgts_matched.append(tgt)
            img_matched.append(it)
    return tgts_matched + tgts_unmatched, img_matched, len(tgts_matched)
