"""PLOT3D multi-zone structured grid and function-file I/O.

File format (FORTRAN unformatted, little-endian, 4-byte record markers):

  record 1: int32 n_zones
  record 2: int32 dims[n_zones * 3]            (imax, jmax, kmax per zone)
  records 3..: per zone, float32 xyz[3 * imax*jmax*kmax]
               laid out as all-x, then all-y, then all-z (Fortran order)

Function files have the same shape with an extra "number of variables" slot in
the dims record and float32 scalar data per zone.

Behavior-parity reference: /root/reference/cpp/lib/plot3d.cpp:28-340 and
/root/reference/python/upsp/processing/plot3d.py:7-68 (studied, not copied).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, List, Sequence

import numpy as np


def _read_record(f: BinaryIO, dtype, count: int) -> np.ndarray:
    """Read one FORTRAN unformatted record, validating its length markers."""
    head = np.fromfile(f, dtype=np.int32, count=1)
    if head.size != 1:
        raise EOFError("unexpected EOF reading record marker")
    data = np.fromfile(f, dtype=dtype, count=count)
    if data.size != count:
        raise EOFError("unexpected EOF reading record body")
    tail = np.fromfile(f, dtype=np.int32, count=1)
    expected = count * np.dtype(dtype).itemsize
    if head[0] != expected or tail.size != 1 or tail[0] != expected:
        raise ValueError(
            f"bad FORTRAN record markers: head={head[0]}, tail="
            f"{tail[0] if tail.size else '?'}, expected {expected}"
        )
    return data


def _write_record(f: BinaryIO, arr: np.ndarray) -> None:
    marker = np.array([arr.nbytes], dtype=np.int32)
    marker.tofile(f)
    arr.tofile(f)
    marker.tofile(f)


@dataclasses.dataclass
class StructGrid:
    """A PLOT3D multi-zone structured (surface) grid, flattened.

    Nodes are stored zone-after-zone in Fortran order within each zone (the i
    index varies fastest).  ``sz[z] = (imax, jmax, kmax)``; surface grids have
    ``kmax == 1``.
    """

    sz: List[np.ndarray] = dataclasses.field(default_factory=list)
    x: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.float32))
    y: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.float32))
    z: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.float32))
    zones: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32)
    )

    @property
    def n_zones(self) -> int:
        return len(self.sz)

    @property
    def size(self) -> int:
        return int(self.x.shape[0])

    def xyz(self) -> np.ndarray:
        """(N, 3) float32 node positions."""
        return np.stack([self.x, self.y, self.z], axis=1).astype(np.float32)

    def zone_slices(self) -> List[slice]:
        out, start = [], 0
        for dims in self.sz:
            n = int(np.prod(dims))
            out.append(slice(start, start + n))
            start += n
        return out

    def triangles(self) -> np.ndarray:
        """Triangulate every zone's quad faces -> (T, 3) int32 node indices.

        Each quad (ii, jj)x(ii+1, jj+1) becomes tris (p0, p1, p2), (p0, p2, p3)
        with p0=(jj,ii), p1=(jj,ii+1), p2=(jj+1,ii+1), p3=(jj+1,ii) — the same
        winding the reference exporter uses
        (python/upsp/processing/p3d_conversions.py:201-222), so normals and
        occlusion tests line up bit-for-bit with its BVH inputs.
        """
        tris = []
        idx0 = 0
        for dims in self.sz:
            imax, jmax = int(dims[0]), int(dims[1])
            kmax = int(dims[2]) if len(dims) > 2 else 1
            if imax >= 2 and jmax >= 2:
                ii = np.arange(imax - 1)
                jj = np.arange(jmax - 1)
                jjg, iig = np.meshgrid(jj, ii, indexing="ij")
                p0 = idx0 + jjg * imax + iig
                p1 = p0 + 1
                p2 = idx0 + (jjg + 1) * imax + iig + 1
                p3 = p2 - 1
                t0 = np.stack([p0, p1, p2], axis=-1).reshape(-1, 3)
                t1 = np.stack([p0, p2, p3], axis=-1).reshape(-1, 3)
                # interleave t0, t1 to match per-quad emission order
                zt = np.empty((t0.shape[0] * 2, 3), dtype=np.int64)
                zt[0::2] = t0
                zt[1::2] = t1
                tris.append(zt)
            idx0 += imax * jmax * max(kmax, 1)
        if not tris:
            return np.zeros((0, 3), np.int32)
        return np.concatenate(tris).astype(np.int32)

    def num_faces(self) -> int:
        n = 0
        for dims in self.sz:
            n += 2 * max(int(dims[0]) - 1, 0) * max(int(dims[1]) - 1, 0)
        return n


def read_p3d_grid(filename: str) -> StructGrid:
    """Read an unformatted PLOT3D multi-zone grid file."""
    grid = StructGrid()
    with open(filename, "rb") as f:
        n_zones = int(_read_record(f, np.int32, 1)[0])
        dims = _read_record(f, np.int32, n_zones * 3)
        sizes = []
        for i in range(n_zones):
            zdims = dims[3 * i : 3 * i + 3]
            grid.sz.append(zdims.copy())
            sizes.append(int(np.prod(zdims)))
        total = sum(sizes)
        grid.x = np.zeros(total, np.float32)
        grid.y = np.zeros(total, np.float32)
        grid.z = np.zeros(total, np.float32)
        zones = np.zeros(total, np.int32)
        cur = 0
        for i, n in enumerate(sizes):
            xyz = _read_record(f, np.float32, 3 * n)
            grid.x[cur : cur + n] = xyz[:n]
            grid.y[cur : cur + n] = xyz[n : 2 * n]
            grid.z[cur : cur + n] = xyz[2 * n :]
            zones[cur : cur + n] = i
            cur += n
        grid.zones = zones
    return grid


def write_p3d_grid(filename: str, grid: StructGrid) -> None:
    """Write an unformatted PLOT3D multi-zone grid file."""
    with open(filename, "wb") as f:
        _write_record(f, np.array([grid.n_zones], np.int32))
        _write_record(f, np.concatenate([np.asarray(s, np.int32) for s in grid.sz]))
        cur = 0
        for dims in grid.sz:
            n = int(np.prod(dims))
            xyz = np.concatenate(
                [
                    grid.x[cur : cur + n],
                    grid.y[cur : cur + n],
                    grid.z[cur : cur + n],
                ]
            ).astype(np.float32)
            _write_record(f, xyz)
            cur += n


def read_p3d_function(filename: str, function_index: int = 0) -> np.ndarray:
    """Read one scalar from an unformatted PLOT3D function file.

    Function files carry dims of (imax, jmax, kmax, nvars) per zone; scalars are
    stored var-major within each zone record.  Mirrors the behavior of
    cpp/lib/plot3d.cpp:read_plot3d_scalar_function_file.
    """
    with open(filename, "rb") as f:
        n_zones = int(_read_record(f, np.int32, 1)[0])
        dims = _read_record(f, np.int32, n_zones * 4)
        out = []
        for i in range(n_zones):
            imax, jmax, kmax, nvar = (int(v) for v in dims[4 * i : 4 * i + 4])
            n = imax * jmax * kmax
            data = _read_record(f, np.float32, n * nvar)
            out.append(data[function_index * n : (function_index + 1) * n])
        return np.concatenate(out)


def write_p3d_function(
    filename: str, zone_dims: Sequence[Sequence[int]], values: np.ndarray
) -> None:
    """Write a single-variable unformatted PLOT3D function file."""
    with open(filename, "wb") as f:
        _write_record(f, np.array([len(zone_dims)], np.int32))
        dims4 = []
        for d in zone_dims:
            dims4.extend([int(d[0]), int(d[1]), int(d[2]) if len(d) > 2 else 1, 1])
        _write_record(f, np.array(dims4, np.int32))
        cur = 0
        for d in zone_dims:
            n = int(d[0]) * int(d[1]) * (int(d[2]) if len(d) > 2 else 1)
            _write_record(f, np.asarray(values[cur : cur + n], np.float32))
            cur += n
