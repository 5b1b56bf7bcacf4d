"""External (wind-on) camera calibration: the two-stage solve.

Port of ``upsp_tpu/camera/external.py`` (pipeline parity with
python/upsp/cam_cal_utils/external_calibrate.py:958-2303):

  wind-off pose + tunnel angles  ->  initial guess (>5 px reprojection)
  COARSE:  template detection -> proximity filters -> sub-pixel localization
           -> RANSAC PnP                     (~1 px)
  REFINED: project visible targets as guesses -> filters -> localization
           -> RANSAC PnP at max_dist          (<1 px)

This module is host-side orchestration over target dicts.  Projection,
localization and the pose solve run on the visibility checker's device
(``vis_checker.device``), pose math in float64 and localization in
float32, as in the JAX package; detection (NCC) and matching are numpy.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from upsp_tpu_torch.camera.matching import filter_matches
from upsp_tpu_torch.camera.model import make_camera_params, project_points
from upsp_tpu_torch.camera.pnp import solve_pnp
from upsp_tpu_torch.camera.tunnel import tf_camera_tgts_thru_tunnel
from upsp_tpu_torch.camera.visibility import VisibilityChecker
from upsp_tpu_torch.ops.detection import detect_targets
from upsp_tpu_torch.ops.image import scale_image_max_inlier
from upsp_tpu_torch.ops.localization import localize_targets, type_code


STAGES = ("visibility", "detection", "localization", "pnp")


@contextlib.contextmanager
def stage_time(timings: Optional[dict], name: str):
    """Add the wall seconds of the block to ``timings[name]`` (when
    ``timings`` is a dict).  Every stage ends in a copy to the host, so its
    device work is inside its seconds."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def make_project_fn(rmat, tvec, camera_matrix, dist_coeffs, device="cuda"):
    """(K, 3) numpy points -> (K, 2) numpy pixels, projected in float64 on
    ``device``."""
    params = make_camera_params(rmat, tvec, camera_matrix, dist_coeffs,
                                device=device)

    def fn(pts):
        pts = torch.as_tensor(np.asarray(pts, np.float64), device=device)
        return project_points(params, pts).cpu().numpy()

    return fn


def get_visible_targets(
    rmat, tvec, tgts: Sequence[dict], vis_checker: VisibilityChecker
) -> List[dict]:
    """Targets facing the camera and unoccluded (photogrammetry.py:395)."""
    if not tgts:
        return []
    tvecs = np.stack([np.asarray(t["tvec"]).reshape(3) for t in tgts])
    norms = np.stack([np.asarray(t["norm"]).reshape(3) for t in tgts])
    cam_center = (-np.asarray(rmat).T @ np.asarray(tvec).reshape(3, 1)).reshape(3)
    vis_idx = vis_checker.is_visible(cam_center.reshape(3, 1), tvecs, norms)
    return [tgts[i] for i in vis_idx]


def subpixel_localize(
    img: np.ndarray,
    tgts: Sequence[dict],
    img_targets: Sequence[dict],
    test_config: dict,
    max_localize_delta: Optional[float] = None,
    device="cuda",
) -> Tuple[List[dict], List[dict]]:
    """Batched LM super-Gaussian refinement + reference rejection rules."""
    if not tgts:
        return [], []
    centers = np.stack(
        [np.asarray(it["center"], np.float64).reshape(2) for it in img_targets]
    )
    codes = np.array([type_code(it["target_type"]) for it in img_targets])
    pads = np.array(
        [test_config[it["target_type"] + "_pad"] for it in img_targets]
    )
    crop = 2 * int(pads.max()) + 3
    deltas = (
        None
        if max_localize_delta is None
        else torch.full((len(tgts),), max_localize_delta, dtype=torch.float32,
                        device=device)
    )
    res = localize_targets(
        torch.as_tensor(np.asarray(img)).to(device=device, dtype=torch.float32),
        torch.as_tensor(centers, device=device),
        torch.as_tensor(codes, device=device),
        torch.as_tensor(pads, device=device),
        crop_size=crop,
        max_localize_delta=deltas,
    )
    refined = res.centers.cpu().numpy()
    valid = res.valid.cpu().numpy()
    out_t, out_i = [], []
    for i, (tgt, it) in enumerate(zip(tgts, img_targets)):
        if valid[i]:
            out_t.append(tgt)
            out_i.append(
                {"target_type": it["target_type"], "center": refined[i]}
            )
    return out_t, out_i


def external_calibrate(
    img: np.ndarray,
    rmat,
    tvec,
    camera_matrix,
    dist_coeffs,
    tgts: Sequence[dict],
    img_targets: Sequence[dict],
    test_config: dict,
    max_localize_delta: Optional[float] = None,
    reprojection_error: float = 6.0,
    device="cuda",
    timings: Optional[dict] = None,
):
    """Filter -> localize -> RANSAC PnP; returns (rmat, tvec, inlier pairs);
    ``timings`` as in :func:`external_calibrate_two_stage`."""
    project_fn = make_project_fn(rmat, tvec, camera_matrix, dist_coeffs, device)
    tgts_f, img_f, n_f = filter_matches(
        project_fn, tgts, img_targets, len(img_targets), test_config
    )
    with stage_time(timings, "localization"):
        tgts_s, img_s = subpixel_localize(
            img, tgts_f[:n_f], img_f[:n_f], test_config, max_localize_delta, device
        )
    if len(tgts_s) < 4:
        raise ValueError(
            f"fewer than 4 calibration matches survived ({len(tgts_s)}); bad "
            "initial pose, too few detections, or over-aggressive filtering"
        )
    obj = np.stack([np.asarray(t["tvec"]).reshape(3) for t in tgts_s])
    pix = np.stack([np.asarray(it["center"]).reshape(2) for it in img_s])
    with stage_time(timings, "pnp"):
        rmat_opt, tvec_opt, inlier_idx, rms = solve_pnp(
            rmat, tvec, camera_matrix, dist_coeffs, obj, pix,
            reproj_threshold=reprojection_error, device=device,
        )
    tgt_inl = [tgts_s[i] for i in inlier_idx]
    img_inl = [img_s[i] for i in inlier_idx]
    return rmat_opt, tvec_opt, tgt_inl, img_inl


def external_calibrate_one_step(
    img12bit: np.ndarray,
    rmat_coarse,
    tvec_coarse,
    incal: Tuple[np.ndarray, np.ndarray],
    tgts: Sequence[dict],
    test_config: dict,
    vis_checker: VisibilityChecker,
    timings: Optional[dict] = None,
):
    """Refined stage: projected positions of visible targets are the initial
    image-target guesses (external_calibrate.py:2029-2303)."""
    camera_matrix, dist_coeffs = incal
    device = vis_checker.device
    img8 = scale_image_max_inlier(img12bit)
    with stage_time(timings, "visibility"):
        visible = get_visible_targets(rmat_coarse, tvec_coarse, tgts, vis_checker)
    project_fn = make_project_fn(rmat_coarse, tvec_coarse, camera_matrix,
                                 dist_coeffs, device)
    projs = project_fn(
        np.stack([np.asarray(t["tvec"]).reshape(3) for t in visible])
    ) if visible else np.zeros((0, 2))
    img_targets = [
        {"target_type": t["target_type"], "center": projs[i]}
        for i, t in enumerate(visible)
    ]
    return external_calibrate(
        img8,
        rmat_coarse,
        tvec_coarse,
        camera_matrix,
        dist_coeffs,
        visible,
        img_targets,
        test_config,
        max_localize_delta=None,
        reprojection_error=test_config["max_dist"],
        device=device,
        timings=timings,
    )


def external_calibrate_two_stage(
    img12bit: np.ndarray,
    rmat_init,
    tvec_init,
    incal: Tuple[np.ndarray, np.ndarray],
    tgts: Sequence[dict],
    test_config: dict,
    vis_checker: VisibilityChecker,
    timings: Optional[dict] = None,
):
    """Coarse (template detection) then refined solve; returns (rmat, tvec,
    inlier targets, their image targets).  ``timings``, when a dict,
    accumulates the seconds of each of :data:`STAGES` over both stages."""
    camera_matrix, dist_coeffs = incal
    device = vis_checker.device
    img8 = scale_image_max_inlier(img12bit)

    with stage_time(timings, "visibility"):
        visible = get_visible_targets(rmat_init, tvec_init, tgts, vis_checker)
    # coarse stage uses only dots (sharpie targets) like the reference
    dots = [t for t in visible if t["target_type"] == "dot"]
    project_fn = make_project_fn(rmat_init, tvec_init, camera_matrix, dist_coeffs,
                                 device)
    with stage_time(timings, "detection"):
        tgts_det, img_targets, n_match = detect_targets(
            img8, dots, project_fn, test_config
        )
    rmat_c, tvec_c, _, _ = external_calibrate(
        img8,
        rmat_init,
        tvec_init,
        camera_matrix,
        dist_coeffs,
        tgts_det[:n_match],
        img_targets,
        test_config,
        max_localize_delta=None,
        reprojection_error=6.0,
        device=device,
        timings=timings,
    )
    rmat_r, tvec_r, tgt_inl, img_inl = external_calibrate_one_step(
        img12bit, rmat_c, tvec_c, incal, tgts, test_config, vis_checker,
        timings=timings,
    )
    return rmat_r, tvec_r, tgt_inl, img_inl


def external_calibrate_two_stage_from_wtd(
    img12bit: np.ndarray,
    camera_tunnel_cal,  # (rmat_cam_tunnel, tvec_cam_tunnel, K, dist)
    wtd: dict,
    test_config: dict,
    tgts: Sequence[dict],
    vis_checker: VisibilityChecker,
    timings: Optional[dict] = None,
):
    """Full wind-on solve from the wind-off camera-tunnel calibration + WTD."""
    rmat_ct, tvec_ct, camera_matrix, dist_coeffs = camera_tunnel_cal
    rmat0, tvec0 = tf_camera_tgts_thru_tunnel(rmat_ct, tvec_ct, wtd, test_config)
    return external_calibrate_two_stage(
        img12bit,
        rmat0,
        tvec0,
        (camera_matrix, dist_coeffs),
        tgts,
        test_config,
        vis_checker,
        timings=timings,
    )


def targets_to_dicts(targets) -> List[dict]:
    """upsp_tpu_torch.io.tgts.Target objects -> reference-style dicts."""
    out = []
    for t in targets:
        out.append(
            {
                "target_type": t.target_type,
                "tvec": np.asarray(t.xyz, np.float64).reshape(3, 1),
                "norm": np.asarray(t.norm, np.float64).reshape(3, 1),
                "size": float(t.diameter),
                "name": t.name,
                "idx": t.idx,
            }
        )
    return out
