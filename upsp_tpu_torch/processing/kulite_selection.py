"""Kulite-comparison selection areas + selection-pixel debug images.

Parity with python/upsp/kulite_comparison/{selection,spatial_queries,
plotting}.py (studied, not copied): pick surface vertices in a small area
displaced from each kulite (so the virtual sensor is not contaminated by the
kulite's own footprint in the paint), de-duplicate near-coincident grid
vertices, and render the chosen pixels onto the raw camera images using the
``camNN-uv`` projection diagnostics.

Geometry convention (selection.py:91-113 semantics): the model +X axis is
aligned with the freestream, so "up"/"down" move the area forward/aft along
X, and "port"/"starboard" rotate the kulite position around the X axis by
``displacement / distance_from_centerline`` radians.

A copy of ``upsp_tpu/processing/kulite_selection.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger("upsp_tpu")

# distinct highlight palette (BGR); kulite marker drawn darker than its area
_PALETTE = [
    (180, 119, 31),
    (14, 127, 255),
    (44, 160, 44),
    (40, 39, 214),
    (189, 103, 148),
    (75, 86, 140),
    (194, 119, 227),
    (127, 127, 127),
    (34, 189, 188),
    (207, 190, 23),
]


def _rotate_about_x(p: np.ndarray, radians: float) -> np.ndarray:
    c, s = np.cos(radians), np.sin(radians)
    x, y, z = p
    return np.array([x, c * y - s * z, s * y + c * z])


def selection_area_center(
    p0: np.ndarray, direction: str, surface_displacement: float
) -> np.ndarray:
    """Center of the selection area displaced from a kulite at ``p0``.

    "up" = forward (-X), "down" = aft (+X); "port"/"starboard" slide along
    the circumference by ``surface_displacement`` of arc length.
    """
    p0 = np.asarray(p0, np.float64)
    distance_from_centerline = float(np.hypot(p0[1], p0[2]))
    if direction.lower() in ("port", "starboard") and distance_from_centerline == 0:
        raise ValueError("kulite on the X axis has no port/starboard direction")
    arc = surface_displacement / max(distance_from_centerline, 1e-30)
    centers = {
        "up": p0 + surface_displacement * np.array([-1.0, 0.0, 0.0]),
        "down": p0 + surface_displacement * np.array([+1.0, 0.0, 0.0]),
        # +rotation around -X (forward) is port; implemented about +X below
        "starboard": _rotate_about_x(p0, arc),
        "port": _rotate_about_x(p0, -arc),
    }
    try:
        return centers[direction.lower()]
    except KeyError:
        raise ValueError(
            f"direction must be one of {sorted(centers)}, got {direction!r}"
        ) from None


class KuliteNeighborhoodSearch:
    """Select grid vertices near (but displaced from) each kulite.

    ``model``: a SurfaceModel (geometry/grids.py) — its cKDTree serves both
    the k-NN and ball queries.  ``kulite_positions``: name -> (3,) model-frame
    position, e.g. from processing.kulites.read_kulite_positions.
    """

    def __init__(self, model, kulite_positions: Dict[str, np.ndarray]):
        self.model = model
        self.tree = model.kdtree
        self.positions = {k: np.asarray(v, np.float64) for k, v in kulite_positions.items()}

    def query(
        self,
        kulite_name: str,
        direction: str,
        displacement: float,
        number_vertices: int,
        duplicate_vertex_tol: Optional[float] = 2e-2,
    ) -> Dict[str, object]:
        """Nearest vertex to the kulite + ``number_vertices`` unique selection
        vertices around the displaced area center.

        The k-NN query size grows geometrically until enough vertices survive
        duplicate filtering (selection.py:40-63 strategy — k must be fixed per
        cKDTree query, so over-ask and retry).
        """
        p0 = self.positions[kulite_name]
        center = selection_area_center(p0, direction, displacement)
        _, kulite_nn = self.tree.query(p0, k=1)

        n_model = self.model.size
        k = int(number_vertices * 1.5)
        selected: List[int] = []
        while k < n_model:
            k = min(int(k * 1.5), n_model)
            _, idx = self.tree.query(center, k=k)
            idx = [int(v) for v in np.atleast_1d(idx)]
            if duplicate_vertex_tol is not None:
                idx = self.filter_duplicates(idx, duplicate_vertex_tol)
            if len(idx) >= number_vertices:
                selected = idx[:number_vertices]
                break
        else:
            selected = idx  # whole model queried; take what survived
        return {
            "Kulite Nearest Vertex": int(kulite_nn),
            "Selection Vertices": selected,
        }

    def filter_duplicates(
        self, vertices: Sequence[int], duplicate_vertex_tol: float = 2e-2
    ) -> List[int]:
        """Greedy pass keeping the first vertex of each near-coincident
        cluster (distance < tol), in the given (distance-sorted) order."""
        pts = self.model.vertices[np.asarray(vertices, int)]
        neighbor_lists = self.tree.query_ball_point(pts, duplicate_vertex_tol)
        kept: List[int] = []
        kept_set = set()
        for idx, neighbors in zip(vertices, neighbor_lists):
            if any(n in kept_set for n in neighbors):
                continue
            kept.append(idx)
            kept_set.add(idx)
        return kept


def highlight_pixels(image: np.ndarray, pixels_yx, bgr) -> np.ndarray:
    """Paint (y, x) pixels of a BGR image with a color, in place."""
    h, w = image.shape[:2]
    for y, x in pixels_yx:
        if 0 <= y < h and 0 <= x < w:
            image[y, x] = bgr
    return image


def make_selection_area_images(
    records: Sequence[Dict[str, object]],
    diag_dir: str,
    out_dir: str,
    n_cameras: Optional[int] = None,
) -> List[str]:
    """Render each kulite's selection vertices onto the raw camera images.

    ``records``: dicts with 'Kulite Name', 'Kulite Nearest Vertex',
    'Selection Vertices' (a list, or its string repr as the reference CSVs
    store it).  ``diag_dir`` holds the phase-0 diagnostics
    (``camNN-8bit-raw.png`` + ``camNN-uv`` normalized projections from
    pipeline/diagnostics.py).  One output image per camera accumulates every
    kulite, each in its own palette color (plotting.py:41-130 behavior).
    Returns the written paths.
    """
    import ast

    import cv2

    if hasattr(records, "to_dict"):  # pandas DataFrame
        records = records.to_dict("records")
    os.makedirs(out_dir, exist_ok=True)

    if n_cameras is None:
        n_cameras = 0
        while os.path.exists(
            os.path.join(diag_dir, f"cam{n_cameras + 1:02d}-8bit-raw.png")
        ):
            n_cameras += 1

    written = []
    color_of: Dict[str, tuple] = {}
    for c in range(1, n_cameras + 1):
        img = cv2.imread(os.path.join(diag_dir, f"cam{c:02d}-8bit-raw.png"))
        if img is None:
            continue
        h, w = img.shape[:2]
        uv = np.fromfile(os.path.join(diag_dir, f"cam{c:02d}-uv"), "<f4").reshape(
            -1, 2
        )

        def yx_of(vertex_indices):
            out = []
            for ii in vertex_indices:
                u, v = uv[ii]
                if u > 0 and v > 0:
                    out.append((round(h * v), round(w * u)))
            return out

        for rec in records:
            name = str(rec["Kulite Name"])
            verts = rec["Selection Vertices"]
            if isinstance(verts, str):
                verts = ast.literal_eval(verts)
            if name not in color_of:
                color_of[name] = _PALETTE[len(color_of) % len(_PALETTE)]
            bgr = color_of[name]
            highlight_pixels(img, yx_of(verts), bgr)
            dark = tuple(max(ch - 70, 0) for ch in bgr)
            highlight_pixels(img, yx_of([int(rec["Kulite Nearest Vertex"])]), dark)

        path = os.path.join(out_dir, f"cam{c:02d}-selected-pixels.png")
        cv2.imwrite(path, img)
        written.append(path)
        log.info("wrote %s", path)
    return written
