"""Panel force & moment integration of surface pressure.

Port of ``upsp_tpu/ops/integration.py``, which recasts the reference's Eigen
sparse panel-integration matrices (cpp/include/integration.h:30-171) in
segment-sum form: every triangle contributes

    dF = -Cp_face * area * n_hat          (pressure acts inward on the surface)
    dM = r x dF                           (about a reference point)

to its panel.  The map from nodal Cp to (fx, fy, fz, mx, my, mz) is
linear, so :func:`integration_matrices` (numpy, the JAX package's arrays)
returns the dense (panels, 6, nodes) operator, and
:func:`integrate_panels` / :func:`integrate_time_history` apply it: NaN to
0, then one f32 product over the node axis on the operator's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from upsp_tpu_torch.geometry.grids import SurfaceModel, triangle_normals_areas


class FoMo(NamedTuple):
    """Integrated forces and moments per panel."""

    fx: torch.Tensor
    fy: torch.Tensor
    fz: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    mz: torch.Tensor

    def stack(self) -> torch.Tensor:
        return torch.stack([self.fx, self.fy, self.fz, self.mx, self.my, self.mz])


def integration_matrices(
    model: SurfaceModel,
    panel_of_node: Optional[np.ndarray] = None,
    moment_center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    n_panels: Optional[int] = None,
) -> np.ndarray:
    """Dense (P, 6, N) operator: panel F&M from nodal Cp.

    Each triangle's pressure load (-Cp_face * A * n) is attributed equally to
    its 3 nodes' Cp values (Cp_face = mean of corners), and the triangle
    belongs to the panel of its first node.  ``panel_of_node`` defaults to the
    model's component ids.

    ``n_panels``: when given, row i of the operator is EXACTLY panel id i
    (0..n_panels-1) — the alignment contract for PanelSet-derived maps from
    :func:`upsp_tpu_torch.ops.panels.panel_node_map`, whose unassigned nodes carry
    id -1; triangles on unassigned nodes are dropped.  Without it, rows
    follow np.unique of the (non-negative) ids — the component-id case.
    """
    if panel_of_node is None:
        panel_of_node = model.components
    panel_of_node = np.asarray(panel_of_node)
    if n_panels is None:
        panels = np.unique(panel_of_node)
        panels = panels[panels >= 0]
        panel_index = {p: i for i, p in enumerate(panels)}
        P = len(panels)
    else:
        P = int(n_panels)
        panel_index = {p: p for p in range(P)}
    N = model.size

    normals, areas = triangle_normals_areas(model.vertices, model.triangles)
    tris = model.triangles
    centroids = model.vertices[tris].mean(axis=1)  # (T, 3)
    r = centroids - np.asarray(moment_center, np.float32)

    op = np.zeros((P, 6, N), np.float32)
    tri_panel = np.array(
        [panel_index.get(p, -1) for p in panel_of_node[tris[:, 0]]]
    )
    keep = tri_panel >= 0  # drop triangles on unassigned (-1) nodes
    tri_panel = tri_panel[keep]
    tris = tris[keep]
    # force contribution of each corner node: -(A/3) * n per unit Cp
    f_per_cp = (-(areas[:, None] / 3.0) * normals)[keep]  # (T, 3)
    m_per_cp = np.cross(r[keep], f_per_cp)  # (T, 3)
    for k in range(3):
        nodes = tris[:, k]
        for d in range(3):
            np.add.at(op[:, d, :], (tri_panel, nodes), f_per_cp[:, d])
            np.add.at(op[:, 3 + d, :], (tri_panel, nodes), m_per_cp[:, d])
    return op


def _operator(op, device=None) -> torch.Tensor:
    """The (P, 6, N) operator as an f32 tensor (on ``device`` if given)."""
    op = torch.as_tensor(op)
    return op.to(device=device if device is not None else op.device,
                 dtype=torch.float32)


def integrate_panels(op, cp) -> FoMo:
    """Apply the operator: cp (..., N) -> per-panel forces and moments, six
    (..., P) tensors, on the operator's device."""
    op = _operator(op)
    cp = torch.as_tensor(cp).to(op.device, torch.float32)
    out = torch.einsum("pdn,...n->...pd", op, torch.nan_to_num(cp, nan=0.0))
    return FoMo(fx=out[..., 0], fy=out[..., 1], fz=out[..., 2],
                mx=out[..., 3], my=out[..., 4], mz=out[..., 5])


def coverage_mask_from_pressure(frame0: np.ndarray) -> np.ndarray:
    """(N,) bool data mask: finite pressure == node has data (NaN = skipped,
    matching the NaN-fill convention of phase 1/2)."""
    return np.isfinite(np.asarray(frame0))


def integrate_time_history(op, pressure_transpose) -> torch.Tensor:
    """(N, F) delta-Cp -> (P, 6, F) unsteady panel force/moment histories,
    on the operator's device."""
    op = _operator(op)
    pt = torch.as_tensor(pressure_transpose).to(op.device, torch.float32)
    return torch.einsum("pdn,nf->pdf", op, torch.nan_to_num(pt, nan=0.0))
