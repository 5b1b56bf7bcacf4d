"""Point-set registration toolbox: closest-point matching, ICP, CPD.

Inventory parity with cpp/include/registration.h:63-418 (studied, not
copied): closest_point (with and without repeats), iterative_closest_point
(rigid 2D/3D via Procrustes), and coherent_point_drift (rigid + affine EM).
Used for target-pattern alignment when direct projection matching fails.

A copy of ``upsp_tpu/ops/pointset.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree


def closest_point(ref: np.ndarray, pts: np.ndarray,
                  max_dist: float = np.inf) -> np.ndarray:
    """For each ref[i], index of nearest pts (or -1 beyond max_dist)."""
    if len(pts) == 0:
        return np.full(len(ref), -1, np.int64)
    d, idx = cKDTree(pts).query(ref)
    return np.where(d <= max_dist, idx, -1)


def closest_point_unique(ref: np.ndarray, pts: np.ndarray,
                         max_dist: float = np.inf) -> np.ndarray:
    """Greedy one-to-one nearest matching (no repeated pts indices).

    Pairs are assigned globally nearest-first, like the reference's
    closest_point2.
    """
    matches = np.full(len(ref), -1, np.int64)
    if len(pts) == 0 or len(ref) == 0:
        return matches
    d = np.linalg.norm(ref[:, None, :] - pts[None, :, :], axis=2)
    d = np.where(d <= max_dist, d, np.inf)
    used_r, used_p = set(), set()
    order = np.argsort(d, axis=None)
    for flat in order:
        i, j = np.unravel_index(flat, d.shape)
        if not np.isfinite(d[i, j]):
            break
        if i in used_r or j in used_p:
            continue
        matches[i] = j
        used_r.add(i)
        used_p.add(j)
    return matches


def _procrustes(src: np.ndarray, dst: np.ndarray):
    """Best-fit rigid transform dst ~ R src + t (Kabsch)."""
    cs = src.mean(axis=0)
    cd = dst.mean(axis=0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.eye(src.shape[1])
    D[-1, -1] = d
    R = Vt.T @ D @ U.T
    t = cd - R @ cs
    return R, t


def iterative_closest_point(
    ref: np.ndarray,
    pts: np.ndarray,
    max_iters: int = 50,
    tol: float = 1e-8,
    max_dist: float = np.inf,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rigid ICP aligning ``pts`` onto ``ref``; returns (R, t, matches)."""
    R = np.eye(ref.shape[1])
    t = np.zeros(ref.shape[1])
    prev_err = np.inf
    moved = np.asarray(pts, np.float64)
    matches = np.full(len(ref), -1, np.int64)
    for _ in range(max_iters):
        matches = closest_point(ref, moved, max_dist)
        ok = matches >= 0
        if ok.sum() < ref.shape[1]:
            break
        R_step, t_step = _procrustes(moved[matches[ok]], ref[ok])
        moved = moved @ R_step.T + t_step
        R = R_step @ R
        t = R_step @ t + t_step
        err = np.mean(
            np.linalg.norm(ref[ok] - moved[matches[ok]], axis=1) ** 2
        )
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return R, t, matches


def coherent_point_drift(
    ref: np.ndarray,
    pts: np.ndarray,
    mode: str = "rigid",
    max_iters: int = 60,
    w: float = 0.0,
    tol: float = 1e-8,
):
    """CPD EM registration of ``pts`` onto ``ref`` (rigid or affine).

    Returns (transformed pts, B or R, t).  Soft-assignment EM makes it robust
    to missing/extra points where ICP's hard matching fails.
    """
    X = np.asarray(ref, np.float64)  # (N, D)
    Y = np.asarray(pts, np.float64)  # (M, D)
    N, D = X.shape
    M = Y.shape[0]
    TY = Y.copy()
    sigma2 = np.sum((X[None] - Y[:, None]) ** 2) / (D * M * N)
    B = np.eye(D)
    t = np.zeros(D)
    for _ in range(max_iters):
        # E-step: soft correspondence
        d2 = np.sum((X[None, :, :] - TY[:, None, :]) ** 2, axis=2)  # (M, N)
        num = np.exp(-d2 / (2 * sigma2))
        cst = (2 * np.pi * sigma2) ** (D / 2) * w / (1 - w) * M / N if w > 0 else 0.0
        den = num.sum(axis=0, keepdims=True) + cst + 1e-300
        P = num / den
        Np = P.sum()
        if Np < 1e-12:
            break
        # M-step
        mu_x = (P.T.sum(axis=1)[None, :] @ X).ravel() / Np  # weighted X mean
        mu_x = (P.sum(axis=0) @ X) / Np
        mu_y = (P.sum(axis=1) @ Y) / Np
        Xh = X - mu_x
        Yh = Y - mu_y
        A = Xh.T @ P.T @ Yh  # (D, D)
        if mode == "rigid":
            U, S, Vt = np.linalg.svd(A)
            C = np.eye(D)
            C[-1, -1] = np.sign(np.linalg.det(U @ Vt))
            R = U @ C @ Vt
            denom = np.sum(P.sum(axis=1) * np.sum(Yh * Yh, axis=1))
            s = np.trace(A.T @ R) / max(denom, 1e-300)
            B = s * R
        else:  # affine
            YPY = (Yh * P.sum(axis=1)[:, None]).T @ Yh
            B = A @ np.linalg.inv(YPY + 1e-12 * np.eye(D))
        t = mu_x - B @ mu_y
        TY_new = Y @ B.T + t
        x2 = np.sum(P.sum(axis=0) * np.sum((X - mu_x) ** 2, axis=1))
        trAB = np.trace(A.T @ B)
        new_sigma2 = max(
            (x2 - trAB) / (Np * D), 1e-12
        )
        shift = np.mean(np.linalg.norm(TY_new - TY, axis=1))
        TY = TY_new
        sigma2 = new_sigma2
        if shift < tol:
            break
    return TY, B, t


def unmatch_outliers(
    ref: np.ndarray, pts: np.ndarray, matches: np.ndarray, cutoff: float = 3.0
) -> np.ndarray:
    """Drop matches whose distance is > cutoff std devs above the mean."""
    ok = matches >= 0
    if ok.sum() == 0:
        return matches
    d = np.linalg.norm(ref[ok] - pts[matches[ok]], axis=1)
    lim = d.mean() + cutoff * d.std()
    out = matches.copy()
    idx = np.nonzero(ok)[0]
    out[idx[d > lim]] = -1
    return out
