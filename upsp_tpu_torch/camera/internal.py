"""Internal (intrinsic) calibration: calib.io import + safe-region bounds.

Parity with python/upsp/cam_cal_utils/internal_calibration.py:16-760 (studied,
not copied):

- :func:`incal_from_calibio` parses a calib.io project JSON into the uPSP
  camera-matrix convention.
- The lens-distortion model is only trustworthy where the calibration board
  actually covered the sensor; :func:`incal_calibration_bounds` builds that
  "safe region" as an alpha shape over the detected board corners, and
  :func:`points_inside_incal` filters projected targets to it.  The reference
  uses shapely; this implementation derives the alpha shape from a scipy
  Delaunay triangulation (drop triangles with circumradius > 1/alpha), so it
  has no extra dependency.

A copy of ``upsp_tpu/camera/internal.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial import Delaunay

from upsp_tpu_torch.io.camera_json import standard_to_upsp_camera_matrix


def incal_from_calibio(calibio_path: str):
    """(img_size (h,w), uPSP camera matrix (3,3), dist (1,5)) from calib.io."""
    with open(calibio_path) as f:
        root = json.load(f)
    data = root["calibration"]["cameras"][0]["model"]["ptr_wrapper"]["data"]
    size = data["CameraModelCRT"]["CameraModelBase"]["imageSize"]
    img_size = np.array((size["height"], size["width"]))
    p = data["parameters"]
    cm = np.array(
        [
            [p["f"]["val"], 0.0, p["cx"]["val"]],
            [0.0, p["f"]["val"], p["cy"]["val"]],
            [0.0, 0.0, 1.0],
        ]
    )
    upsp_cm = standard_to_upsp_camera_matrix(cm, img_size)
    dist = np.array(
        [[p["k1"]["val"], p["k2"]["val"], p["p1"]["val"], p["p2"]["val"],
          p["k3"]["val"]]]
    )
    return img_size, upsp_cm, dist


def write_incal_from_calibio(
    calibio_path: str,
    camera_name: str,
    sensor_size,
    save_dir: Optional[str] = None,
) -> str:
    """Convert a calib.io project into a uPSP internal-calibration JSON."""
    img_size, upsp_cm, dist = incal_from_calibio(calibio_path)
    incal = {
        "uPSP_cameraMatrix": upsp_cm.tolist(),
        "distCoeffs": dist.tolist(),
        "sensor_resolution": np.asarray(img_size).tolist(),
        "sensor_size": np.asarray(sensor_size).tolist(),
    }
    if save_dir is None:
        save_dir = os.path.dirname(calibio_path)
    path = os.path.join(save_dir, camera_name + ".json")
    with open(path, "w") as f:
        json.dump(incal, f)
    return path


def calibio_board_points(calibio_path: str) -> np.ndarray:
    """All detected board-corner image points from the calib.io project."""
    with open(calibio_path) as f:
        root = json.load(f)
    pts = []
    detections = root.get("detections", [])
    for det in detections:
        fps = det.get("featurePoints", {})
        # calib.io nests the point list a few ways across versions
        items = fps.get("data", fps) if isinstance(fps, dict) else fps
        if isinstance(items, dict):
            items = items.get("ptr_wrapper", {}).get("data", [])
        for item in items if isinstance(items, list) else []:
            loc = item.get("imagePoint", item)
            if "x" in loc and "y" in loc:
                pts.append((loc["x"], loc["y"]))
    return np.array(pts, np.float64).reshape(-1, 2)


class AlphaShape:
    """Concave hull of 2D points: Delaunay triangles with small circumradius."""

    def __init__(self, points: np.ndarray, alpha: float):
        pts = np.asarray(points, np.float64)
        self.tri = Delaunay(pts)
        self.points = pts
        a, b, c = (pts[self.tri.simplices[:, k]] for k in range(3))
        # circumradius R = abc / (4 * area)
        la = np.linalg.norm(b - c, axis=1)
        lb = np.linalg.norm(a - c, axis=1)
        lc = np.linalg.norm(a - b, axis=1)
        area = 0.5 * np.abs(
            (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
            - (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1])
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            circum = la * lb * lc / np.maximum(4.0 * area, 1e-300)
        self.keep = circum < (1.0 / alpha)

    def contains(self, query: np.ndarray) -> np.ndarray:
        """(Q,) bool — inside any kept triangle."""
        q = np.atleast_2d(query)
        simplex = self.tri.find_simplex(q)
        inside = simplex >= 0
        ok = np.zeros(q.shape[0], bool)
        valid = inside.nonzero()[0]
        ok[valid] = self.keep[simplex[valid]]
        return ok


def incal_calibration_bounds(
    board_points: np.ndarray, alpha: float = 0.01
) -> AlphaShape:
    """Safe-region alpha shape over the calibration-board coverage."""
    return AlphaShape(board_points, alpha)


def points_inside_incal(
    bounds: Optional[AlphaShape], pts: np.ndarray, image_hw: Tuple[int, int]
) -> np.ndarray:
    """Filter projected points to the distortion-trustworthy region.

    Without bounds (no calibration coverage data), falls back to the image
    rectangle — the reference's behavior when no safe region is configured.
    """
    pts = np.atleast_2d(pts)
    H, W = image_hw
    in_img = (
        (pts[:, 0] >= 0) & (pts[:, 0] <= W - 1)
        & (pts[:, 1] >= 0) & (pts[:, 1] <= H - 1)
    )
    if bounds is None:
        return in_img
    return in_img & bounds.contains(pts)
