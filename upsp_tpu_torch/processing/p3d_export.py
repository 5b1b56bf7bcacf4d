"""PLOT3D surface export: OBJ / glTF triangle soups + zone mapping.

Parity: python/upsp/processing/p3d_conversions.py:12-222 (studied, not
copied) — same triangulation winding as SurfaceModel/StructGrid.triangles().

A copy of ``upsp_tpu/processing/p3d_export.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import json
import struct
from typing import Optional

import numpy as np

from upsp_tpu_torch.io.plot3d import StructGrid


def p3d_to_obj(grid: StructGrid, path: str) -> None:
    """Write the triangulated surface as a Wavefront OBJ."""
    tris = grid.triangles()
    with open(path, "w") as f:
        for i in range(grid.size):
            f.write(f"v {grid.x[i]} {grid.y[i]} {grid.z[i]}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def p3d_to_gltf(grid: StructGrid, path: str) -> None:
    """Write a minimal valid glTF 2.0 file with embedded buffers."""
    verts = grid.xyz().astype("<f4")
    tris = grid.triangles().astype("<u4").ravel()
    vbin = verts.tobytes()
    ibin = tris.tobytes()
    buf = vbin + ibin
    gltf = {
        "asset": {"version": "2.0", "generator": "upsp_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [
            {
                "primitives": [
                    {"attributes": {"POSITION": 0}, "indices": 1, "mode": 4}
                ]
            }
        ],
        "buffers": [
            {
                "uri": "data:application/octet-stream;base64,"
                + base64.b64encode(buf).decode(),
                "byteLength": len(buf),
            }
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(vbin),
             "target": 34962},
            {"buffer": 0, "byteOffset": len(vbin), "byteLength": len(ibin),
             "target": 34963},
        ],
        "accessors": [
            {
                "bufferView": 0,
                "componentType": 5126,
                "count": int(verts.shape[0]),
                "type": "VEC3",
                "min": verts.min(axis=0).tolist(),
                "max": verts.max(axis=0).tolist(),
            },
            {
                "bufferView": 1,
                "componentType": 5125,
                "count": int(tris.size),
                "type": "SCALAR",
            },
        ],
    }
    with open(path, "w") as f:
        json.dump(gltf, f)


def write_zones_mapping(grid: StructGrid, path: str) -> None:
    """Per-vertex zone index JSON (VisibilityChecker caching aid)."""
    with open(path, "w") as f:
        json.dump({"zones": grid.zones.tolist()}, f)
