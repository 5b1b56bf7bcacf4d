"""Target bumping: push surveyed targets just proud of the grid surface.

Targets surveyed slightly *under* the model skin break occlusion tests (their
own surface hides them).  The reference nudges such targets outward along
their normal until ~1e-5 inch proud (python/upsp/cam_cal_utils/
target_bumping.py:15-386, known issue docs/md/upsp-user-manual.md:840-848 —
studied, not copied).  Port of ``upsp_tpu/camera/target_bumping.py``: the
rays walk the checker's device BVH (``ops/raycast.py``), as in the JAX
package.

Internal-ness test: cast a ray from just outside the target, toward it, along
the negated normal; if the first surface hit lies beyond the target position,
the target sits under the surface and is bumped out.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from upsp_tpu_torch.camera.visibility import VisibilityChecker
from upsp_tpu_torch.ops.raycast import bvh_intersect


def tgts_internality(
    tgts_xyz: np.ndarray,  # (T, 3)
    tgts_norm: np.ndarray,  # (T, 3)
    vis_checker: VisibilityChecker,
    start_height: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """(is_internal (T,), depth (T,)) — depth is how far under the skin."""
    n = tgts_norm / np.linalg.norm(tgts_norm, axis=1, keepdims=True)
    origins = tgts_xyz + start_height * n
    dirs = -n
    t, prim, hit = bvh_intersect(
        vis_checker.bvh_dev,
        torch.as_tensor(origins).to(torch.float32),
        torch.as_tensor(dirs).to(torch.float32),
        max_leaf=vis_checker.bvh.max_leaf_count,
    )
    t = t.cpu().numpy()
    hit = hit.cpu().numpy()
    # surface crossed before reaching the target -> target is below the skin
    depth = np.where(hit, start_height - t, 0.0)
    internal = hit & (t < start_height - 1e-9)
    return internal, np.maximum(depth, 0.0)


def tgts_bumper(
    targets: Sequence[dict],
    vis_checker: VisibilityChecker,
    bump_eps: float = 1e-5,
    max_bump: float = 0.05,
) -> Tuple[List[dict], np.ndarray, int]:
    """Bump internal targets outward along their normals until just proud.

    Returns (bumped targets, bump distances, number bumped).  Targets already
    proud of the surface are untouched.
    """
    if not targets:
        return [], np.zeros(0), 0
    xyz = np.stack([np.asarray(t["tvec"]).reshape(3) for t in targets])
    nrm = np.stack([np.asarray(t["norm"]).reshape(3) for t in targets])
    internal, depth = tgts_internality(xyz, nrm, vis_checker)
    bump = np.where(internal, np.minimum(depth + bump_eps, max_bump), 0.0)
    out = []
    for i, t in enumerate(targets):
        t2 = dict(t)
        if bump[i] > 0:
            n = nrm[i] / np.linalg.norm(nrm[i])
            t2["tvec"] = (xyz[i] + bump[i] * n).reshape(
                np.asarray(t["tvec"]).shape
            )
        out.append(t2)
    return out, bump, int(internal.sum())


def write_bumped_tgts(
    src_tgts_path: str, dst_tgts_path: str, targets: Sequence[dict]
) -> None:
    """Rewrite a tgts file with bumped *Targets rows (other sections copied)."""
    by_idx = {int(t["idx"]): t for t in targets if "idx" in t}
    out_lines = []
    section = None
    with open(src_tgts_path) as f:
        for raw in f:
            parts = raw.split()
            if len(parts) == 1 and parts[0].startswith("*"):
                section = parts[0]
                out_lines.append(raw)
                continue
            if section == "*Targets" and len(parts) > 10:
                idx = int(parts[0])
                if idx in by_idx:
                    t = by_idx[idx]
                    p = np.asarray(t["tvec"]).reshape(3)
                    n = np.asarray(t["norm"]).reshape(3)
                    out_lines.append(
                        f"{idx:4d} {p[0]:11.4f} {p[1]:9.4f} {p[2]:10.4f} "
                        f"{n[0]:9.5f} {n[1]:10.5f} {n[2]:11.5f} "
                        f"{float(t.get('size', parts[7])):8.3f} "
                        f"{parts[8]:>5s} {parts[9]:>5s} {parts[10]:>5s} "
                        f"{parts[11]}\n"
                    )
                    continue
            out_lines.append(raw)
    with open(dst_tgts_path, "w") as f:
        f.writelines(out_lines)
