"""Flat binary output files + vv regression dumps.

The reference writes 15 raw float32 little-endian files per datapoint
(psp_process.cpp:524-540): frame-major ``intensity``, node-major
``intensity_transpose``/``pressure_transpose``, per-node diagnostics
(``avg``, ``rms``, ``coverage``, ``steady_state``, ``model_temp``,
``intensity_avg``, ``intensity_rms``, ``intensity_ratio_0``, ``gain``) and node
coordinates ``X``/``Y``/``Z``.  Plus the "vv" 1000-sample regression dumps
checked float-exactly across code versions (psp_process.cpp:1984-2015).

Multi-host writes use per-host pwrite at computed offsets — same pattern as
the reference's write_behind/write_block (psp_process.cpp:915-963).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

FLAT_FILES = (
    "intensity",
    "intensity_transpose",
    "pressure_transpose",
    "intensity_avg",
    "intensity_rms",
    "intensity_ratio_0",
    "avg",
    "rms",
    "coverage",
    "steady_state",
    "model_temp",
    "X",
    "Y",
    "Z",
    "gain",
)


def write_flat(path: str, data: np.ndarray, offset_values: int = 0) -> None:
    """Write float32 data at a value offset (pwrite-at-offset pattern)."""
    arr = np.ascontiguousarray(data, dtype="<f4")
    mode = "r+b" if os.path.exists(path) else "wb"
    with open(path, mode) as f:
        f.seek(offset_values * 4)
        f.write(arr.tobytes())


def read_flat(path: str, count: int = -1, offset_values: int = 0) -> np.ndarray:
    with open(path, "rb") as f:
        f.seek(offset_values * 4)
        return np.fromfile(f, dtype="<f4", count=count)


def read_node_history(
    path: str, node_index: int, n_frames: int
) -> np.ndarray:
    """One node's time history straight out of a *_transpose file.

    Seek-by-offset read identical to scripts/upsp-kulite-comparison:30-47.
    """
    return read_flat(path, count=n_frames, offset_values=node_index * n_frames)


def vv_subsample(values: np.ndarray, max_els: int = 1000) -> np.ndarray:
    """The reference's strided 1000-sample pick (psp_process.cpp:1990-2001)."""
    v = np.asarray(values, np.float32).ravel()
    if v.size == 0:
        return v
    step = 1 if v.size < max_els else v.size // max_els
    idx = np.arange(0, min(max_els, v.size)) * step
    idx = idx[idx < v.size]
    return v[idx]


def write_vv(path: str, values: np.ndarray, max_els: int = 1000) -> None:
    vv_subsample(values, max_els).astype("<f4").tofile(path)


def read_vv(path: str) -> np.ndarray:
    return np.fromfile(path, dtype="<f4")


class FlatFileSet:
    """Manages the standard per-datapoint output directory."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.out_dir, name)

    def write(self, name: str, data: np.ndarray, offset_values: int = 0) -> None:
        write_flat(self.path(name), data, offset_values)

    def write_vv(self, name: str, data: np.ndarray) -> None:
        write_vv(self.path(name), data)

    def write_standard_outputs(
        self,
        model,
        phase1: Optional[Dict[str, np.ndarray]] = None,
        phase2: Optional[Dict[str, np.ndarray]] = None,
    ) -> None:
        """Write node coordinates + whatever phase outputs are provided.

        phase1 keys: intensity (F,N), intensity_avg, intensity_rms,
        intensity_ratio_0, coverage.  phase2 keys: pressure_transpose (N,F),
        avg, rms, gain, steady_state, model_temp.
        """
        self.write("X", model.vertices[:, 0])
        self.write("Y", model.vertices[:, 1])
        self.write("Z", model.vertices[:, 2])
        if phase1:
            for key in ("intensity", "intensity_avg", "intensity_rms",
                        "intensity_ratio_0", "coverage"):
                if key in phase1:
                    self.write(key, np.asarray(phase1[key]))
            if "intensity" in phase1:
                self.write(
                    "intensity_transpose", np.asarray(phase1["intensity"]).T
                )
            for key, src in (
                ("vv-int-avg.dat", "intensity_avg"),
                ("vv-int-rms.dat", "intensity_rms"),
                ("vv-int-coverage.dat", "coverage"),
                ("vv-int-sample1.dat", "intensity_ratio_0"),
            ):
                if src in phase1:
                    self.write_vv(key, np.asarray(phase1[src]))
        if phase2:
            for key in ("pressure_transpose", "avg", "rms", "gain",
                        "steady_state", "model_temp"):
                if key in phase2:
                    self.write(key, np.asarray(phase2[key]))
            for key, src in (
                ("vv-cp-avg.dat", "avg"),
                ("vv-cp-rms.dat", "rms"),
            ):
                if src in phase2:
                    self.write_vv(key, np.asarray(phase2[src]))
