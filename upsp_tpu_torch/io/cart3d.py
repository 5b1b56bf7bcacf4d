"""Cart3D ASCII ``.tri`` / ``.triq`` unstructured surface mesh I/O.

``.tri``:   ``n_verts n_tris`` / vertex xyz lines / 1-based connectivity lines /
optional per-tri component ids.
``.triq``:  ``n_verts n_tris n_scalars`` / vertices / connectivity / components /
per-vertex scalars.

Parity: cpp/lib/cart3d.cpp:read_tri/read_triq (studied, not copied).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray  # (N, 3) float32
    triangles: np.ndarray  # (T, 3) int32, 0-based
    components: Optional[np.ndarray] = None  # (T,) int32
    scalars: Optional[np.ndarray] = None  # (N, S) float32

    @property
    def size(self) -> int:
        return int(self.vertices.shape[0])


def read_tri(filename: str) -> TriMesh:
    with open(filename, "r") as f:
        tokens = f.read().split()
    it = iter(tokens)
    n_verts = int(next(it))
    n_tris = int(next(it))
    # .triq has a third header int (number of scalars)
    rest = list(it)
    n_scalars = 0
    body = rest
    expected_tri = 3 * n_verts + 3 * n_tris
    if len(rest) >= 1:
        # detect triq: header has one extra int before vertex data
        cand = int(float(rest[0]))
        triq_len = 3 * n_verts + 3 * n_tris + n_tris + cand * n_verts + 0
        if float(rest[0]).is_integer() and (len(rest) - 1) >= triq_len and cand > 0:
            # assume .triq when the extra-header interpretation fits exactly
            if (len(rest) - 1) in (triq_len, triq_len):
                n_scalars = cand
                body = rest[1:]
    vals = np.array(body, dtype=np.float64)
    verts = vals[: 3 * n_verts].reshape(n_verts, 3).astype(np.float32)
    off = 3 * n_verts
    tris = vals[off : off + 3 * n_tris].reshape(n_tris, 3).astype(np.int64) - 1
    off += 3 * n_tris
    comps = None
    scalars = None
    remaining = vals[off:]
    if n_scalars:
        comps = remaining[:n_tris].astype(np.int32)
        remaining = remaining[n_tris:]
        scalars = (
            remaining[: n_scalars * n_verts]
            .reshape(n_verts, n_scalars)
            .astype(np.float32)
        )
    elif remaining.size >= n_tris:
        comps = remaining[:n_tris].astype(np.int32)
    return TriMesh(
        vertices=verts,
        triangles=tris.astype(np.int32),
        components=comps,
        scalars=scalars,
    )


def read_triq(filename: str) -> TriMesh:
    """Read a FORTRAN-unformatted binary ``.triq`` (reference layout).

    Records: [n_node n_tri n_scalar] / interleaved xyz f32 / 1-based
    connectivity i32 / per-tri components i32 / node-major scalars f32
    (cart3d.cpp:read_triq record structure).
    """
    from upsp_tpu_torch.io.plot3d import _read_record

    with open(filename, "rb") as f:
        hdr = _read_record(f, np.int32, 3)
        n_node, n_tri, n_scalar = (int(v) for v in hdr)
        xyz = _read_record(f, np.float32, 3 * n_node).reshape(n_node, 3)
        tris = _read_record(f, np.int32, 3 * n_tri).reshape(n_tri, 3) - 1
        comps = _read_record(f, np.int32, n_tri)
        scalars = None
        if n_scalar > 0:
            data = _read_record(f, np.float32, n_scalar * n_node)
            scalars = data.reshape(n_scalar, n_node).T.copy()
    return TriMesh(
        vertices=xyz.astype(np.float32),
        triangles=tris.astype(np.int32),
        components=comps.astype(np.int32),
        scalars=scalars,
    )


def write_triq(filename: str, mesh: TriMesh, scalars: Optional[np.ndarray] = None):
    """Write the reference-format binary .triq."""
    from upsp_tpu_torch.io.plot3d import _write_record

    s = scalars if scalars is not None else mesh.scalars
    if s is None:
        s = np.zeros((mesh.size, 1), np.float32)
    s = np.atleast_2d(np.asarray(s, np.float32))
    if s.shape[0] == mesh.size:
        s = s.T  # -> (n_scalar, n_node)
    with open(filename, "wb") as f:
        _write_record(
            f, np.array([mesh.size, mesh.triangles.shape[0], s.shape[0]], np.int32)
        )
        _write_record(f, np.ascontiguousarray(mesh.vertices, np.float32).reshape(-1))
        _write_record(
            f, (np.asarray(mesh.triangles, np.int32) + 1).reshape(-1)
        )
        comps = (
            mesh.components
            if mesh.components is not None
            else np.zeros(mesh.triangles.shape[0], np.int32)
        )
        _write_record(f, np.asarray(comps, np.int32))
        _write_record(f, s.reshape(-1))


def write_tri(filename: str, mesh: TriMesh) -> None:
    with open(filename, "w") as f:
        f.write(f"{mesh.size} {mesh.triangles.shape[0]}\n")
        for v in mesh.vertices:
            f.write(f"{v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for t in mesh.triangles:
            f.write(f"{t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
        if mesh.components is not None:
            for c in mesh.components:
                f.write(f"{int(c)}\n")
