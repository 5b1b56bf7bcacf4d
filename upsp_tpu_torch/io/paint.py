"""Paint calibration file: 'a = ...' .. 'f = ...' coefficient lines.

gain(T, Pss) = a + b*T + c*T^2 + (d + e*T + f*T^2) * Pss
with T the model wall temperature (degF) and Pss the steady-state surface
pressure (psf).  Parity: cpp/lib/non_cv_upsp.cpp (PaintCalibration).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PaintCalibration:
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0
    d: float = 0.0
    e: float = 0.0
    f: float = 0.0

    @classmethod
    def read(cls, filename: str) -> "PaintCalibration":
        pc = cls()
        with open(filename, "r") as fh:
            for line in fh:
                compact = "".join(line.split())
                if "=" not in compact:
                    continue
                key, _, val = compact.partition("=")
                if key in ("a", "b", "c", "d", "e", "f"):
                    setattr(pc, key, float(val))
        return pc

    def get_gain(self, T, Pss):
        """Vectorized paint gain; T and Pss broadcast together."""
        T = np.asarray(T)
        Pss = np.asarray(Pss)
        return self.a + self.b * T + self.c * T * T + (
            self.d + self.e * T + self.f * T * T
        ) * Pss

    def coefficients(self) -> np.ndarray:
        return np.array([self.a, self.b, self.c, self.d, self.e, self.f], np.float32)
