"""Tunnel-coordinate transforms: wind-off pose chained through tunnel angles.

Reproduces the UPWT convention from
python/upsp/cam_cal_utils/camera_tunnel_calibrate.py:246-364 (studied, not
copied): pitch = rot(-ALPHA, y), yaw = rot(-BETA, z), roll = rot(PHI, x),
composed [P][Y][R]; STRUTZ shifts the tunnel center of rotation along z.

A copy of ``upsp_tpu/camera/tunnel.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from upsp_tpu_torch.camera.model import rot


def tunnel_transform(
    alpha: float, beta: float, phi: float, strutz: float, tvec_cor_tgts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Transform from tunnel frame to tgts (model) frame.

    Returns (rmat tgts->tunnel inverse composition, tvec tgts->tunnel), matching
    the reference's ``tunnel_transform`` outputs.
    """
    pitch = rot(-alpha, "y")
    yaw = rot(-beta, "z")
    roll = rot(phi, "x")
    rotation = pitch @ yaw @ roll
    rotation = np.linalg.inv(rotation)
    tvec_cor = np.asarray(tvec_cor_tgts, np.float64).reshape(3, 1)
    tvec_knuckle = rotation @ tvec_cor
    tvec_tunnel_tgts = tvec_knuckle + np.array([[0.0], [0.0], [strutz]])
    return rotation, tvec_tunnel_tgts


def tf_camera_tgts_thru_tunnel(
    rmat_camera_tunnel: np.ndarray,
    tvec_camera_tunnel: np.ndarray,
    wtd: dict,
    test_config: dict,
) -> Tuple[np.ndarray, np.ndarray]:
    """Chain camera->tunnel with tunnel->tgts into the wind-on initial pose.

    ``wtd`` carries ALPHA/BETA/PHI/STRUTZ (degrees / inches); ``test_config``
    carries 'tunnel-cor_to_tgts_tvec'.
    """
    rmat_tunnel_tgts, tvec_tunnel_tgts = tunnel_transform(
        wtd["ALPHA"],
        wtd["BETA"],
        wtd["PHI"],
        wtd["STRUTZ"],
        test_config["tunnel-cor_to_tgts_tvec"],
    )
    rmat_tgts_tunnel = np.linalg.inv(rmat_tunnel_tgts)
    rmat_camera_tgts = rmat_camera_tunnel @ np.linalg.inv(rmat_tgts_tunnel)
    tvec_camera_tgts = (
        np.asarray(tvec_camera_tunnel, np.float64).reshape(3, 1)
        + rmat_camera_tunnel @ tvec_tunnel_tgts
    )
    return rmat_camera_tgts, tvec_camera_tgts
