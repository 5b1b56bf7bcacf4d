"""Phase-0 diagnostic images and the registration-telemetry sidecar.

Port of ``write_phase0_diagnostics`` (with its drawing helpers) and of
the registration-telemetry sidecar, readers and report
(``write_registration_meta``, ``read_registration_meta``,
``read_registration_telemetry``, ``analyze_registration_telemetry``) from
``upsp_tpu/pipeline/diagnostics.py``, whose module imports the JAX ops at
load time and so cannot be reused.
"""

from __future__ import annotations

import json
import os

import numpy as np

from upsp_tpu_torch.ops.image import convert_to_8u
from upsp_tpu_torch.ops.projection import coverage as _coverage

# nodes-per-pixel colormap (BGR, cv_extras.cpp:277-289): 0 black, 1 green,
# 2 yellow, 3 orange, 4 light orange, >= 5 white
_NODECOUNT_COLORS = np.array(
    [[0, 0, 0], [0, 255, 0], [0, 255, 255], [51, 153, 255], [153, 204, 255]],
    np.uint8,
)


def nodes_per_pixel_counts(pixel_index: np.ndarray, visible: np.ndarray,
                           image_hw) -> np.ndarray:
    H, W = image_hw
    counts = np.zeros(H * W, np.int64)
    np.add.at(counts, np.asarray(pixel_index)[np.asarray(visible)], 1)
    return counts.reshape(H, W)


def nodes_per_pixel_image(counts: np.ndarray) -> np.ndarray:
    """uint8 BGR colormap of node counts per pixel."""
    c = np.clip(np.asarray(counts), 0, 255).astype(np.int64)
    out = np.full(c.shape + (3,), 255, np.uint8)
    for v in range(_NODECOUNT_COLORS.shape[0]):
        out[c == v] = _NODECOUNT_COLORS[v]
    return out


def add_targets_overlay(img8: np.ndarray, centers: np.ndarray,
                        color=(0, 255, 0), labels=None,
                        radius: int = 4) -> np.ndarray:
    """Draw circles (+ optional labels) over a gray or BGR image -> BGR."""
    import cv2

    img8 = np.asarray(img8, np.uint8)
    out = img8.copy() if img8.ndim == 3 else cv2.cvtColor(img8, cv2.COLOR_GRAY2BGR)
    for i, (x, y) in enumerate(np.atleast_2d(centers)):
        cv2.circle(out, (int(round(x)), int(round(y))), radius, color, 1)
        if labels is not None:
            cv2.putText(out, str(labels[i]), (int(x) + 5, int(y) - 5),
                        cv2.FONT_HERSHEY_PLAIN, 0.8, color, 1)
    return out


def write_phase0_diagnostics(state, out_dir: str) -> None:
    """The per-camera diagnostic set (psp_process.cpp:2061-2178):
    8-bit/float first frame, nodes-per-pixel map, per-node (u, v),
    per-camera coverage, fiducial and cluster overlays."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    ref = state.ref_frames.cpu().numpy()
    H, W = state.image_hw
    for c in range(state.n_cameras):
        prefix = os.path.join(out_dir, f"cam{c + 1:02d}-")
        img8 = convert_to_8u(ref[c])
        cv2.imwrite(prefix + "8bit-raw.png", img8)
        try:
            cv2.imwrite(prefix + "raw.exr", ref[c].astype(np.float32))
        except cv2.error:
            # OpenCV built without OpenEXR: keep the float image as raw f32
            ref[c].astype("<f4").tofile(prefix + "raw.f32")
        proj = state.projections[c]
        counts = nodes_per_pixel_counts(proj.pixel_index.cpu().numpy(),
                                        proj.visible.cpu().numpy(), (H, W))
        cv2.imwrite(prefix + "nodecount.png", nodes_per_pixel_image(counts))
        uv = np.stack([proj.u.cpu().numpy(), proj.v.cpu().numpy()], axis=1)
        uv.astype("<f4").ravel().tofile(prefix + "uv")
        _coverage([proj], H, W).cpu().numpy().astype("<f4").tofile(
            prefix + "coverage"
        )
        diag = state.patch_diags[c] if state.patch_diags is not None else None
        if diag is not None:
            fid = add_targets_overlay(img8, diag["uv"], color=(0, 255, 0),
                                      labels=diag["names"])
            cv2.imwrite(prefix + "8bit-projected-fiducials.png", fid)
            cl = np.asarray(diag["cluster_of"])
            n_cl = int(cl.max()) + 1 if cl.size else 0
            cimg = cv2.cvtColor(img8, cv2.COLOR_GRAY2BGR)
            colors = [
                tuple(int(v) for v in col)
                for col in np.random.default_rng(0).integers(
                    64, 255, size=(max(n_cl, 1), 3)
                )
            ]
            for gi in range(n_cl):
                cimg = add_targets_overlay(cimg, diag["uv"][cl == gi],
                                           color=colors[gi])
            cv2.imwrite(prefix + "8bit-fiducial-clusters.png", cimg)
        op = state.patch_ops[c]
        if op is not None:
            bimg = cv2.cvtColor(img8, cv2.COLOR_GRAY2BGR)
            b_idx = op.boundary_idx.cpu().numpy().ravel()
            i_idx = op.internal_idx.cpu().numpy().ravel()
            i_idx = i_idx[i_idx < H * W]
            bimg[i_idx // W, i_idx % W] = (0, 255, 255)
            bimg[b_idx // W, b_idx % W] = (255, 0, 0)
            cv2.imwrite(prefix + "8bit-cluster-boundaries.png", bimg)


def write_registration_meta(out_dir: str, conv_semantics: str = "drho",
                            ecc_iters=None, max_iters: int = 50,
                            epsilon: float = 1e-3) -> None:
    """The ``registration.json`` sidecar: what telemetry column 1 means,
    ``"iters"`` (while-loop ECC: the iteration count) or ``"drho"``
    (fixed-step fft ECC: the final |drho|), and the while loop's
    criteria (psp_process.cpp:1665-1667).  ``band`` is null: the port's
    warp kernel has no band limit, so column 4 (the displacement bound)
    is informational only."""
    meta = {
        "columns": ["rho", conv_semantics, "warp_tx", "warp_ty", "disp_bound"],
        "conv_semantics": conv_semantics,
        "epsilon": epsilon,
        "max_iters": max_iters,
        "band": None,
    }
    if ecc_iters is not None:
        meta["ecc_unroll_iters"] = int(ecc_iters)
    with open(os.path.join(out_dir, "registration.json"), "w") as f:
        json.dump(meta, f, indent=1)


def read_registration_meta(path: str) -> dict:
    """The sidecar of a ``registration`` flat file at ``path`` (absent:
    the while-loop "iters" contract, which predates the sidecar)."""
    mpath = os.path.join(os.path.dirname(path), "registration.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            return json.load(f)
    return {"conv_semantics": "iters", "epsilon": 1e-3, "max_iters": 50}


def read_registration_telemetry(path: str, n_cameras: int) -> np.ndarray:
    """The ``registration`` flat file as (F, C, K) [rho, conv, warp_tx,
    warp_ty, disp_bound]; K from the sidecar's ``columns`` (4 for files
    from before the bound)."""
    k = len(read_registration_meta(path).get("columns", [])) or 4
    return np.fromfile(path, "<f4").reshape(-1, n_cameras, k)


def analyze_registration_telemetry(
    telemetry: np.ndarray,
    max_iters: int = 50,
    epsilon: float = 1e-3,
    conv_semantics: str = "iters",
) -> dict:
    """Per-camera ECC convergence report and tuning advice
    (upsp_tpu/pipeline/diagnostics.py:215-298).

    ``"iters"``: if the iteration budget saturates, relax epsilon; if
    convergence is immediate, tighten it.  ``"drho"``: the fraction of
    frames whose final |drho| is not below epsilon, and one more fixed
    step when it passes 2%.  Frames whose rho falls 4 sigma below the
    sequence's mean are listed in both.  With column 4 present the report
    gives its maximum and 99th percentile, and ``band_violations`` 0: the
    port has no band, so no frame can leave it (the JAX package counts
    bounds above its 3 px band there)."""
    if conv_semantics not in ("iters", "drho"):
        raise ValueError(f"conv_semantics must be iters|drho, got {conv_semantics!r}")
    tele = np.asarray(telemetry, np.float64)
    F, C, _ = tele.shape
    cameras = []
    for c in range(C):
        rho = tele[:, c, 0]
        conv = tele[:, c, 1]
        shift = np.hypot(tele[:, c, 2], tele[:, c, 3])
        mu, sd = float(rho.mean()), float(rho.std())
        suspect = np.nonzero(rho < mu - 4.0 * max(sd, 1e-6))[0]
        rec = {
            "rho_min": float(rho.min()),
            "rho_mean": mu,
            "shift_max_px": float(shift.max()),
            "conv_semantics": conv_semantics,
            "suspect_frames": suspect.tolist(),
        }
        if conv_semantics == "iters":
            p95 = float(np.percentile(conv, 95))
            rec_iters = int(np.clip(np.ceil(p95 * 1.25), 5, max_iters))
            if p95 >= max_iters:
                rec_eps = epsilon * 3.0  # budget-bound: stop earlier
            elif float(conv.mean()) <= 2.0:
                rec_eps = epsilon / 3.0  # converges at once: ask for more
            else:
                rec_eps = epsilon
            rec.update(
                iters_mean=float(conv.mean()),
                iters_p95=p95,
                iters_max=int(conv.max()),
                recommended_max_iters=rec_iters,
                recommended_epsilon=float(rec_eps),
            )
        else:
            unconverged = float((conv >= epsilon).mean())
            rec.update(
                drho_mean=float(conv.mean()),
                drho_p95=float(np.percentile(conv, 95)),
                drho_max=float(conv.max()),
                unconverged_frac=unconverged,
                recommend_extra_unroll_step=bool(unconverged > 0.02),
            )
        if tele.shape[2] >= 5:
            bound = tele[:, c, 4]
            rec.update(
                disp_bound_max=float(bound.max()),
                disp_bound_p99=float(np.percentile(bound, 99)),
                band_violations=0,
            )
        cameras.append(rec)
    return {"n_frames": F, "cameras": cameras}
