"""Camera calibration JSON files (uPSP principal-point convention).

uPSP stores the principal point *relative to image center* so that cropped
sensor configurations share one intrinsic file: ``cx = W/2 + dcx``,
``cy = H/2 + dcy``.  ``rmat``/``tvec`` map camera frame -> model(tgts) frame
for wind-on files, camera -> tunnel for camera-tunnel files.

Parity: python/upsp/cam_cal_utils/parsers.py:212-405 (studied, not copied).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np


def upsp_to_standard_camera_matrix(upsp_cm: np.ndarray, dims_hw: Tuple[int, int]):
    """uPSP (center-relative) -> standard (absolute principal point).

    ``dims_hw`` is (height, width).
    """
    cm = np.array(upsp_cm, dtype=np.float64, copy=True)
    cm[0, 2] = dims_hw[1] / 2 + upsp_cm[0][2]
    cm[1, 2] = dims_hw[0] / 2 + upsp_cm[1][2]
    return cm


def standard_to_upsp_camera_matrix(cm: np.ndarray, dims_hw: Tuple[int, int]):
    out = np.array(cm, dtype=np.float64, copy=True)
    out[0, 2] = cm[0][2] - dims_hw[1] / 2
    out[1, 2] = cm[1][2] - dims_hw[0] / 2
    return out


@dataclasses.dataclass
class CameraCalibration:
    """Pinhole + Brown 5-coefficient distortion camera with a rigid pose.

    ``rmat``/``tvec``: x_cam = rmat_inv... — we store the extrinsics exactly as
    the JSON does (camera frame -> target/tunnel frame); helpers in
    :mod:`upsp_tpu_torch.camera.model` interpret them.
    """

    camera_matrix: np.ndarray  # (3,3) absolute principal point
    dist_coeffs: np.ndarray  # (5,) [k1 k2 p1 p2 k3]
    rmat: Optional[np.ndarray] = None  # (3,3)
    tvec: Optional[np.ndarray] = None  # (3,)
    sensor_resolution: Optional[np.ndarray] = None
    sensor_size: Optional[np.ndarray] = None
    image_size_hw: Optional[Tuple[int, int]] = None  # (H, W)

    @property
    def focal_length(self) -> float:
        return float(self.camera_matrix[0, 0])


def read_camera_json(path: str, dims_hw: Tuple[int, int]) -> CameraCalibration:
    """Read either an internal-only or a full camera-pose JSON file."""
    with open(path, "r") as f:
        cal = json.load(f)
    cm = upsp_to_standard_camera_matrix(np.array(cal["uPSP_cameraMatrix"]), dims_hw)
    dist = np.array(cal["distCoeffs"], np.float64).reshape(-1)
    rmat = np.array(cal["rmat"], np.float64) if "rmat" in cal else None
    tvec = (
        np.array(cal["tvec"], np.float64).reshape(3) if "tvec" in cal else None
    )
    return CameraCalibration(
        camera_matrix=cm,
        dist_coeffs=dist,
        rmat=rmat,
        tvec=tvec,
        sensor_resolution=np.array(cal.get("sensor_resolution"))
        if "sensor_resolution" in cal
        else None,
        sensor_size=np.array(cal.get("sensor_size"))
        if "sensor_size" in cal
        else None,
        image_size_hw=tuple(dims_hw),
    )


def write_camera_json(path: str, cal: CameraCalibration) -> None:
    """Write a wind-on camera calibration JSON (uPSP convention)."""
    assert cal.image_size_hw is not None
    out = {
        "uPSP_cameraMatrix": standard_to_upsp_camera_matrix(
            cal.camera_matrix, cal.image_size_hw
        ).tolist(),
        "distCoeffs": [cal.dist_coeffs.tolist()],
    }
    if cal.rmat is not None:
        out["rmat"] = np.asarray(cal.rmat).tolist()
    if cal.tvec is not None:
        out["tvec"] = np.asarray(cal.tvec).reshape(3).tolist()
    if cal.sensor_resolution is not None:
        out["sensor_resolution"] = np.asarray(cal.sensor_resolution).tolist()
    if cal.sensor_size is not None:
        out["sensor_size"] = np.asarray(cal.sensor_size).tolist()
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def read_json(path: str):
    with open(path, "r") as f:
        return json.load(f)


def read_test_config(path: str) -> dict:
    """Read a test-config JSON, promoting 3-vectors/matrices to numpy arrays."""
    with open(path, "r") as f:
        cfg = json.load(f)
    out = {}
    for key, val in cfg.items():
        try:
            if isinstance(val, list) and len(val) == 3:
                if isinstance(val[0], (int, float)):
                    out[key] = np.array(val, np.float64).reshape(3, 1)
                elif isinstance(val[0], list) and len(val[0]) == 3:
                    out[key] = np.array(val, np.float64)
                else:
                    out[key] = val
            else:
                out[key] = val
        except Exception:
            out[key] = val
    return out
