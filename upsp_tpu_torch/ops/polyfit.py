"""Time-series polynomial detrend, the phase-2 compute core.

Port of ``upsp_tpu/ops/polyfit.py`` (:42-90).  The degree-6 least-squares
fit over normalised frame index is linear, so it is a projector built once
on the host: an orthonormal basis Q of the Vandermonde columns (QR in f64),
then ``fit = (y @ Q) @ Q^T`` as two f32 matmuls per node block.  TF32 is
off package-wide (``upsp_tpu_torch/__init__.py``), so these stay f32.
The host-side helpers at the end (1-D fits, the coefficient file) are
copies of the JAX package's.
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


def monomial_coeffs(det: PolyDetrender, coeffs: torch.Tensor) -> torch.Tensor:
    """Q-basis coefficients (..., C) -> monomial coefficients (low->high),
    on the coefficients' device and in their dtype."""
    return torch.einsum("dc,...c->...d",
                        det.to_monomial.to(device=coeffs.device, dtype=coeffs.dtype),
                        coeffs)


def fit_coeffs(det: PolyDetrender, series: torch.Tensor) -> torch.Tensor:
    """Least-squares coefficients per row: (..., F) -> (..., C)."""
    return series @ det.pinv.T


def eval_fit(det: PolyDetrender, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate the fitted polynomials at every frame: (..., C) -> (..., F)."""
    return coeffs @ det.basis.T


def detrend(det: PolyDetrender, series: torch.Tensor) -> torch.Tensor:
    """series - polynomial fit, batched over leading dims (nodes)."""
    return series - eval_fit(det, fit_coeffs(det, series))


# host-side parity helpers: copies of upsp_tpu/ops/polyfit.py:91-127


def polyfit_1d(x: np.ndarray, y: np.ndarray, degree: int) -> np.ndarray:
    """Host-side generic polynomial fit (coeffs low->high), parity helper."""
    A = np.stack([np.asarray(x, np.float64) ** c for c in range(degree + 1)], axis=1)
    coeffs, *_ = np.linalg.lstsq(A, np.asarray(y, np.float64), rcond=None)
    return coeffs


def polyval_1d(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    A = np.stack(
        [np.asarray(x, np.float64) ** c for c in range(len(coeffs))], axis=1
    )
    return A @ np.asarray(coeffs)


# coefficient save/restore (TransPolyFitter::write_coeffs format parity:
# int32 check=1, int32 val_size, int32 rows(C), int32 cols(N), then data)


def write_coeffs(filename: str, coeffs: np.ndarray) -> None:
    """coeffs (C, N) float32 -> reference-compatible binary file."""
    c = np.asarray(coeffs, np.float32)
    with open(filename, "wb") as f:
        np.array([1, 4, c.shape[0], c.shape[1]], np.int32).tofile(f)
        c.T.ravel().astype(np.float32).tofile(f)  # column-major like Eigen


def read_coeffs(filename: str) -> np.ndarray:
    with open(filename, "rb") as f:
        hdr = np.fromfile(f, np.int32, 4)
        if hdr[0] != 1:
            raise ValueError("bad coefficients file header")
        if hdr[1] != 4:
            raise ValueError("only float32 coefficient files supported")
        rows, cols = int(hdr[2]), int(hdr[3])
        data = np.fromfile(f, np.float32, rows * cols)
    return data.reshape(cols, rows).T  # back from column-major
