"""Target <-> image-target matching and proximity filters (vectorized).

Parity (studied, not copied): match_obj_and_img_pts
(external_calibrate.py:680-745), filter_dist_filter / filter_matches
(target_detection.py:541-916).  Targets are plain dicts ({'tvec', 'norm',
'size'/'diameter', 'target_type'}) to stay drop-in compatible with reference
data flows; all distance math is batched numpy.

A copy of ``upsp_tpu/camera/matching.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np


def project_targets(project_fn: Callable, tgts: Sequence[dict]) -> np.ndarray:
    """(N, 2) projected centers of targets via the camera's project_fn."""
    if not tgts:
        return np.zeros((0, 2))
    pts = np.stack([np.asarray(t["tvec"]).reshape(3) for t in tgts])
    return np.asarray(project_fn(pts)).reshape(-1, 2)


def match_obj_and_img_pts(
    project_fn: Callable,
    tgts: Sequence[dict],
    img_targets: Sequence[dict],
    max_dist: float,
) -> List[int]:
    """For each target: index of the closest same-type image target within
    max_dist, or -1."""
    projs = project_targets(project_fn, tgts)
    if not img_targets:
        return [-1] * len(tgts)
    centers = np.stack([np.asarray(it["center"], np.float64) for it in img_targets])
    types_img = np.array([it["target_type"] for it in img_targets])
    out = []
    for i, tgt in enumerate(tgts):
        same = types_img == tgt["target_type"]
        if not same.any():
            out.append(-1)
            continue
        d = np.linalg.norm(centers - projs[i], axis=1)
        d = np.where(same, d, np.inf)
        j = int(np.argmin(d))
        out.append(j if d[j] <= max_dist else -1)
    return out


def match_targets(
    project_fn: Callable,
    tgts: Sequence[dict],
    img_targets: Sequence[dict],
    max_dist: float,
) -> Tuple[List[dict], List[dict], int]:
    """Closest-point matching; matched pairs lead both returned lists."""
    idx = match_obj_and_img_pts(project_fn, tgts, img_targets, max_dist)
    matched_t, matched_i, unmatched = [], [], []
    for i, tgt in enumerate(tgts):
        if idx[i] >= 0:
            matched_t.append(tgt)
            matched_i.append(img_targets[idx[i]])
        else:
            unmatched.append(tgt)
    return matched_t + unmatched, matched_i, len(matched_t)


def filter_dist_filter(
    project_fn: Callable,
    tgts: Sequence[dict],
    img_targets: Sequence[dict],
    num_matches: int,
    intra_dist: float,
    inter_dist: float,
) -> Tuple[List[dict], List[dict], int]:
    """Reject ambiguous matches (too-close neighbors), reference semantics:

    inter pass (matched pairs only): drop pair i if any OTHER image target is
    within inter_dist of proj(tgt_i), or any OTHER projected target is within
    intra_dist of img_i.
    intra pass: drop pair i if any other projected target is within intra_dist
    of proj(tgt_i), or any other image target is within intra_dist of img_i.
    """

    def centers_of(its):
        if not its:
            return np.zeros((0, 2))
        return np.stack([np.asarray(it["center"], np.float64).reshape(2) for it in its])

    def pass_once(tgts_l, img_l, n_match, check):
        projs = project_targets(project_fn, tgts_l)
        centers = centers_of(img_l)
        keep = []
        for i in range(n_match):
            if check(i, projs, centers):
                keep.append(i)
        kept_t = [tgts_l[i] for i in keep]
        kept_i = [img_l[i] for i in keep]
        rest_t = [tgts_l[i] for i in range(len(tgts_l)) if i not in keep]
        rest_i = [img_l[i] for i in range(len(img_l)) if i not in keep]
        return kept_t + rest_t, kept_i + rest_i, len(keep)

    def inter_check(i, projs, centers):
        if centers.shape[0]:
            d = np.linalg.norm(centers - projs[i], axis=1)
            d[i] = np.inf
            if np.any(d < inter_dist):
                return False
        d2 = np.linalg.norm(projs - centers[i], axis=1)
        d2[i] = np.inf
        return not np.any(d2 < intra_dist)

    def intra_check(i, projs, centers):
        dp = np.linalg.norm(projs - projs[i], axis=1)
        dp[i] = np.inf
        if np.any(dp < intra_dist):
            return False
        dc = np.linalg.norm(centers - centers[i], axis=1)
        dc[i] = np.inf
        return not np.any(dc < intra_dist)

    tgts1, img1, n1 = pass_once(list(tgts), list(img_targets), num_matches, inter_check)
    return pass_once(tgts1, img1, n1, intra_check)


def filter_matches(
    project_fn: Callable,
    tgts: Sequence[dict],
    img_targets: Sequence[dict],
    num_matches: int,
    test_config: dict,
) -> Tuple[List[dict], List[dict], int]:
    return filter_dist_filter(
        project_fn,
        tgts,
        img_targets,
        num_matches,
        intra_dist=test_config["max_dist"],
        inter_dist=test_config["min_dist"],
    )
