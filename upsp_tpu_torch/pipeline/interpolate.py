"""Grid-to-grid scalar transfer: k-NN inverse-distance weighting.

Parity: cpp/lib/interpolation.ipp:17-70 (upsp::interpolate — studied, not
copied): k nearest source nodes, weights 1/d^p, exact-hit shortcut.

A copy of ``upsp_tpu/pipeline/interpolate.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def idw_interpolate(
    src_points: np.ndarray,
    src_values: np.ndarray,
    dst_points: np.ndarray,
    k: int = 3,
    p: float = 2.0,
    eps: float = 1e-10,
) -> np.ndarray:
    """Inverse-distance-weighted interpolation from src grid to dst points."""
    tree = cKDTree(np.asarray(src_points))
    k = min(k, len(src_points))
    dist, idx = tree.query(np.asarray(dst_points), k=k)
    if k == 1:
        dist = dist[:, None]
        idx = idx[:, None]
    vals = np.asarray(src_values)[idx]  # (Q, k)
    exact = dist[:, 0] < eps
    with np.errstate(divide="ignore"):
        w = 1.0 / np.power(np.maximum(dist, eps), p)
    out = (w * vals).sum(axis=1) / w.sum(axis=1)
    out[exact] = vals[exact, 0]
    return out
