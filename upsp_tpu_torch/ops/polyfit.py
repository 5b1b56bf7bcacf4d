"""Time-series polynomial detrend, the phase-2 compute core.

Port of ``upsp_tpu/ops/polyfit.py`` (:42-90).  The degree-6 least-squares
fit over normalised frame index is linear, so it is a projector built once
on the host: an orthonormal basis Q of the Vandermonde columns (QR in f64),
then ``fit = (y @ Q) @ Q^T`` as two f32 matmuls per node block.  TF32 is
off package-wide (``upsp_tpu_torch/__init__.py``), so these stay f32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PolyDetrender(NamedTuple):
    basis: torch.Tensor  # (F, C) float32 orthonormal basis Q
    pinv: torch.Tensor  # (C, F) float32 Q^T
    to_monomial: torch.Tensor  # (C, C) float64 R^-1

    @property
    def n_frames(self) -> int:
        return self.basis.shape[0]

    @property
    def n_coeffs(self) -> int:
        return self.basis.shape[1]


def make_detrender(n_frames: int, degree: int = 6, device="cpu") -> PolyDetrender:
    """Degree-``degree`` polynomial projector over (f/F) frame index; the
    order is capped at what the frame count supports."""
    degree = min(degree, max(n_frames - 1, 0))
    f = np.arange(n_frames, dtype=np.float64) / n_frames
    A = np.stack([f**c for c in range(degree + 1)], axis=1)
    Q, R = np.linalg.qr(A)
    return PolyDetrender(
        basis=torch.tensor(Q, dtype=torch.float32, device=device),
        pinv=torch.tensor(Q.T, dtype=torch.float32, device=device),
        to_monomial=torch.tensor(np.linalg.inv(R), device=device),
    )


def fit_coeffs(det: PolyDetrender, series: torch.Tensor) -> torch.Tensor:
    """Least-squares coefficients per row: (..., F) -> (..., C)."""
    return series @ det.pinv.T


def eval_fit(det: PolyDetrender, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate the fitted polynomials at every frame: (..., C) -> (..., F)."""
    return coeffs @ det.basis.T


def detrend(det: PolyDetrender, series: torch.Tensor) -> torch.Tensor:
    """series - polynomial fit, batched over leading dims (nodes)."""
    return series - eval_fit(det, fit_coeffs(det, series))
