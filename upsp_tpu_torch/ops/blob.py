"""Blob-based circular target detection (the deprecated coarse path).

The reference's original coarse stage used cv::SimpleBlobDetector with size/
circularity filters (registration.h:find_targets, external_calibrate.py
blob path — studied, not copied); template detection replaced it but the
capability remains selectable by config.  This implementation thresholds,
labels connected components (scipy), and filters by area/circularity —
matching the detector's documented behavior (dark blobs, min/max diameter).

A copy of ``upsp_tpu/ops/blob.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy import ndimage


def find_targets(
    img: np.ndarray,
    min_diameter: float = 2.0,
    max_diameter: float = 0.0,
    min_circularity: float = 0.6,
    threshold_rel: float = 0.6,
) -> List[dict]:
    """Detect dark circular blobs; returns [{'center', 'diameter'}...].

    ``max_diameter <= 0`` defaults to 10% of the larger image dimension
    (find_targets parity).
    """
    img = np.asarray(img, np.float64)
    if max_diameter <= 0:
        max_diameter = 0.1 * max(img.shape)
    lo, hi = img.min(), img.max()
    if hi <= lo:
        return []
    # dark blobs: pixels below a relative threshold
    mask = img < (lo + threshold_rel * (hi - lo))
    labels, n = ndimage.label(mask)
    out = []
    if n == 0:
        return out
    slices = ndimage.find_objects(labels)
    for i, sl in enumerate(slices, start=1):
        region = labels[sl] == i
        area = region.sum()
        d_eq = 2.0 * np.sqrt(area / np.pi)
        if d_eq < min_diameter or d_eq > max_diameter:
            continue
        # circularity: 4*pi*area / perimeter^2
        er = region ^ ndimage.binary_erosion(region)
        perimeter = max(er.sum(), 1)
        circ = 4.0 * np.pi * area / (perimeter**2)
        if circ < min_circularity * 0.5:  # loose: discrete perimeters undershoot
            continue
        ys, xs = np.nonzero(region)
        w = (lo + threshold_rel * (hi - lo)) - img[sl][region]
        w = np.maximum(w, 1e-9)
        cx = (xs * w).sum() / w.sum() + sl[1].start
        cy = (ys * w).sum() / w.sum() + sl[0].start
        out.append({"center": np.array([cx, cy]), "diameter": float(d_eq)})
    return out
