"""PSP HDF5 output: grid + tunnel conditions + camera settings + datasets.

Layout parity with the reference writer (cpp/include/PSPHDF5.h:314-343,
cpp/lib/PSPHDF5.ipp — studied, not copied), via h5py:

  /                  attrs: psph5_version, nodal, transpose, structured
  /Grid/x,y,z        node coordinates (+ units attr on the group)
  /Grid/grid_sizes   (structured) zone dims, or /Grid/triangles,/Grid/components
  /Condition/*       test_id, run, sequence, alpha..ttot, frame_rate, fstop,
                     exposure, focal_length (each with a units attr)
  /frames            (nodes, n_frames) chunked float32 when transposed
  /<name>            extra per-node datasets (rms, average, coverage, ...)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

try:
    import h5py

    HAS_H5PY = True
except ImportError:  # pragma: no cover - h5py is present in this image
    HAS_H5PY = False

PSPH5_VERSION = 1
STRING_LEN = 64


class PSPWriter:
    """Chunked HDF5 writer for surface-pressure time histories."""

    def __init__(
        self,
        filename: str,
        model,
        n_frames: int = 1,
        transposed: bool = False,
        chunk_nodes: int = 4096,
    ):
        if not HAS_H5PY:
            raise ImportError("h5py is required for HDF5 output")
        self.file = h5py.File(filename, "w")
        self.model = model
        self.n_frames = n_frames
        self.transposed = transposed
        self.chunk_nodes = chunk_nodes
        self.file.attrs["psph5_version"] = np.uint16(PSPH5_VERSION)
        self.file.attrs["nodal"] = np.uint16(1)
        self.file.attrs["transpose"] = np.uint16(1 if transposed else 0)

    def write_grid(self, units: str = "") -> None:
        m = self.model
        g = self.file.create_group("Grid")
        g.create_dataset("x", data=m.vertices[:, 0].astype(np.float32))
        g.create_dataset("y", data=m.vertices[:, 1].astype(np.float32))
        g.create_dataset("z", data=m.vertices[:, 2].astype(np.float32))
        if units:
            g.attrs["units"] = units
        structured = getattr(m, "grid", None) is not None
        self.file.attrs["structured"] = np.uint16(1 if structured else 0)
        if structured:
            sizes = np.stack([np.asarray(s, np.int32) for s in m.grid.sz])
            g.create_dataset("grid_sizes", data=sizes)
        else:
            g.create_dataset("triangles", data=m.triangles.astype(np.int32))
            g.create_dataset("components", data=m.components.astype(np.int32))

    def write_tunnel_conditions(self, cond) -> None:
        c = self.file.require_group("Condition")

        def scalar(name, value, units="-", dtype=np.float32):
            d = c.create_dataset(name, data=np.asarray(value, dtype))
            d.attrs["units"] = units

        tid = np.bytes_(str(cond.test_id)[:STRING_LEN])
        c.create_dataset("test_id", data=tid)
        scalar("run", cond.run, "-", np.int32)
        scalar("sequence", cond.seq, "-", np.int32)
        scalar("alpha", cond.alpha, "deg")
        scalar("beta", cond.beta, "deg")
        scalar("phi", cond.phi, "deg")
        scalar("mach", cond.mach, "-")
        scalar("reynolds_number", cond.rey, "million/ft")
        scalar("total_pressure", cond.ptot, "psf")
        scalar("dynamic_pressure", cond.qbar, "psf")
        scalar("total_temperature", cond.ttot, "F")
        scalar("static_pressure", cond.ps, "psf")
        scalar("thermocouple_average", cond.tcavg, "F")

    def write_camera_settings(
        self,
        framerate: int = 0,
        fstop: float = 0.0,
        exposure: float = 0.0,
        focal_lengths: Optional[Sequence[float]] = None,
        cam_nums: Optional[Sequence[int]] = None,
    ) -> None:
        c = self.file.require_group("Condition")
        d = c.create_dataset("frame_rate", data=np.int32(framerate))
        d.attrs["units"] = "Hz"
        d = c.create_dataset("fstop", data=np.float32(fstop))
        d.attrs["units"] = "-"
        d = c.create_dataset("exposure", data=np.float32(exposure))
        d.attrs["units"] = "microseconds"
        if focal_lengths is not None:
            d = c.create_dataset(
                "focal_length", data=np.asarray(focal_lengths, np.float32)
            )
            d.attrs["units"] = "pix"
        if cam_nums is not None:
            c.create_dataset("camera_numbers", data=np.asarray(cam_nums, np.int32))

    def write_string_attribute(self, name: str, value: str) -> None:
        self.file.attrs[name] = value

    def create_frames_dataset(self) -> "h5py.Dataset":
        """Chunked pressure-time-history dataset.

        ``transposed=True``: (nodes, frames) — fast per-node history reads
        (kulite comparison).  ``transposed=False``: (frames, nodes) frame-
        major, the reference's non-transposed layout (PSPHDF5.h:314-343,
        ``transpose`` attr 0) — fast per-frame surface reads (plotting).
        """
        n = self.model.size
        if self.transposed:
            shape = (n, self.n_frames)
            chunk = (min(self.chunk_nodes, n), min(self.n_frames, 4096))
        else:
            shape = (self.n_frames, n)
            chunk = (min(self.n_frames, 4096), min(self.chunk_nodes, n))
        return self.file.create_dataset(
            "frames", shape=shape, dtype=np.float32, chunks=chunk
        )

    def write_frames_block(
        self, data: np.ndarray, node_start: int = 0
    ) -> None:
        """Write a node-major block (nodes_block, frames) at a node offset.

        The block is transposed on the fly for the frame-major layout.
        """
        if "frames" not in self.file:
            self.create_frames_dataset()
        ds = self.file["frames"]
        data = np.asarray(data, np.float32)
        sl = slice(node_start, node_start + data.shape[0])
        if self.transposed:
            ds[sl, :] = data
        else:
            ds[:, sl] = np.ascontiguousarray(data.T)

    def write_new_dataset(
        self, name: str, values: np.ndarray, units: str = ""
    ) -> None:
        d = self.file.create_dataset(
            name, data=np.asarray(values, np.float32)
        )
        if units:
            d.attrs["units"] = units

    def close(self) -> None:
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- interrogation helpers (hdf5_* API parity, PSPHDF5.h:35-118) -------------


def hdf5_num_frames(filename: str) -> int:
    with h5py.File(filename, "r") as f:
        if "frames" not in f:
            return 0
        axis = 1 if f.attrs.get("transpose", 0) else 0
        return int(f["frames"].shape[axis])


def hdf5_is_transposed(filename: str) -> bool:
    with h5py.File(filename, "r") as f:
        return bool(f.attrs.get("transpose", 0))


def hdf5_is_structured(filename: str) -> bool:
    with h5py.File(filename, "r") as f:
        return bool(f.attrs.get("structured", 0))


def hdf5_num_nodes(filename: str) -> int:
    with h5py.File(filename, "r") as f:
        return int(f["Grid/x"].shape[0])


def hdf5_read_dataset(filename: str, name: str) -> np.ndarray:
    with h5py.File(filename, "r") as f:
        return np.array(f[name])


def hdf5_read_node_history(filename: str, node_index: int) -> np.ndarray:
    with h5py.File(filename, "r") as f:
        if f.attrs.get("transpose", 0):
            return np.array(f["frames"][node_index, :])
        return np.array(f["frames"][:, node_index])
