"""Phase 2: intensity ratio -> detrend -> paint gain -> delta-Cp.

Port of ``upsp_tpu/pipeline/phase2.py`` (:35-173) on node-major tensors:

    ratio  = Iref_avg / I
    fit    = polynomial fit of ratio over frames (degree 6, f32 matmuls)
    gain   = a + bT + cT^2 + (d + eT + fT^2) * (qbar * Cp_steady + ps)
    dCp    = (ratio - fit) * gain * 144 / qbar

Nodes with zero coverage carry NaN throughout.  :func:`run_phase2_sharded`
runs it over the ranks of a mesh, each on its own block of nodes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from upsp_tpu_torch.io.paint import PaintCalibration
from upsp_tpu_torch.io.wtd import TunnelConditions, model_temperature
from upsp_tpu_torch.ops.polyfit import PolyDetrender, detrend, make_detrender

class Phase2Constants(NamedTuple):
    paint: torch.Tensor  # (6,) a..f
    qbar: torch.Tensor  # ()
    ps: torch.Tensor  # ()


class Phase2Outputs(NamedTuple):
    pressure_transpose: torch.Tensor  # (nodes, frames) delta-Cp
    rms: torch.Tensor  # (nodes,)
    avg: torch.Tensor  # (nodes,)
    gain: torch.Tensor  # (nodes,)
    steady_state: Optional[torch.Tensor] = None  # (nodes,) steady Cp
    model_temp: Optional[torch.Tensor] = None  # (nodes,) degF


def make_phase2_constants(pcal: PaintCalibration, cond: TunnelConditions,
                          device="cpu") -> Phase2Constants:
    return Phase2Constants(
        paint=torch.as_tensor(np.asarray(pcal.coefficients(), np.float32),
                              device=device),
        qbar=torch.tensor(float(cond.qbar), dtype=torch.float32, device=device),
        ps=torch.tensor(float(cond.ps), dtype=torch.float32, device=device),
    )


def paint_gain(paint: torch.Tensor, T: torch.Tensor, Pss: torch.Tensor):
    a, b, c, d, e, f = paint.unbind()
    return a + b * T + c * T * T + (d + e * T + f * T * T) * Pss


def phase2_convert(
    intensity_transpose: torch.Tensor,  # (nodes, F)
    sol_avg: torch.Tensor,  # (nodes,) frame-mean intensity (Iref)
    coverage: torch.Tensor,  # (nodes,)
    steady_cp: torch.Tensor,  # (nodes,)
    model_temp: torch.Tensor,  # (nodes,) degF
    const: Phase2Constants,
    det: PolyDetrender,
) -> Phase2Outputs:
    """The node-block conversion."""
    covered = coverage > 0
    nan = torch.tensor(float("nan"), device=coverage.device)
    Pss = const.qbar * steady_cp + const.ps
    gain = torch.where(covered, paint_gain(const.paint, model_temp, Pss), nan)
    ratio = sol_avg[:, None] / intensity_transpose
    dCp = detrend(det, ratio) * gain[:, None] * (144.0 / const.qbar)
    dCp = torch.where(covered[:, None], dCp, nan)
    avg = torch.where(covered, dCp.mean(dim=1), nan)
    rms = torch.where(covered, torch.sqrt((dCp * dCp).mean(dim=1)), nan)
    return Phase2Outputs(pressure_transpose=dCp, rms=rms, avg=avg, gain=gain)


def compute_model_temperature(cfg, cond: TunnelConditions, n_nodes: int,
                              model=None) -> np.ndarray:
    """Per-node model temperature: a PLOT3D function file if configured,
    else the recovery-factor estimate (psp_process.cpp:2315-2345)."""
    if getattr(cfg, "model_temp_p3d", ""):
        from upsp_tpu_torch.io.plot3d import read_p3d_function

        temps = read_p3d_function(cfg.model_temp_p3d)
        if temps.shape[0] == n_nodes:
            return temps.astype(np.float32)
        if model is not None and getattr(cfg, "steady_grid", ""):
            return _interpolate_from_steady_grid(cfg, temps, model)
        raise ValueError(
            f"model_temp file has {temps.shape[0]} values, expected {n_nodes}"
        )
    t = model_temperature(cond, recovery_factor=cfg.recovery_factor,
                          gamma=cfg.gamma, f_to_r=cfg.f_to_r)
    return np.full(n_nodes, t, np.float32)


def load_steady_cp(cfg, n_nodes: int, model=None) -> np.ndarray:
    """Steady-state Cp per node (zeros for wind-off runs)."""
    if cfg.wind_off or not cfg.steady_psp:
        return np.zeros(n_nodes, np.float32)
    from upsp_tpu_torch.io.plot3d import read_p3d_function

    steady = read_p3d_function(cfg.steady_psp)
    if steady.shape[0] == n_nodes:
        return steady.astype(np.float32)
    if model is not None and cfg.steady_grid:
        return _interpolate_from_steady_grid(cfg, steady, model)
    raise ValueError(f"steady file has {steady.shape[0]} values, expected {n_nodes}")


def _interpolate_from_steady_grid(cfg, values: np.ndarray, model) -> np.ndarray:
    from upsp_tpu_torch.geometry.grids import load_model
    from upsp_tpu_torch.pipeline.interpolate import idw_interpolate

    steady_model = load_model(cfg.steady_grid, tolerance=cfg.grid_tol)
    return idw_interpolate(steady_model.vertices, values,
                           model.vertices).astype(np.float32)


def run_phase2(cfg, intensity_transpose: torch.Tensor, sol_avg: torch.Tensor,
               coverage: torch.Tensor, cond: TunnelConditions,
               pcal: PaintCalibration, model=None) -> Phase2Outputs:
    """Phase 2 over a (nodes, frames) tensor on its device."""
    dev = intensity_transpose.device
    n_nodes, n_frames = intensity_transpose.shape
    const = make_phase2_constants(pcal, cond, dev)
    det = make_detrender(n_frames, cfg.degree, dev)
    steady = torch.as_tensor(load_steady_cp(cfg, n_nodes, model), device=dev)
    mtemp = torch.as_tensor(compute_model_temperature(cfg, cond, n_nodes, model),
                            device=dev)
    out = phase2_convert(intensity_transpose, sol_avg, coverage, steady, mtemp,
                         const, det)
    return out._replace(steady_state=steady, model_temp=mtemp)


def run_phase2_sharded(cfg, it_local: torch.Tensor, sol_avg: torch.Tensor,
                       coverage: np.ndarray, cond: TunnelConditions,
                       pcal: PaintCalibration, mesh, model=None
                       ) -> Optional[Phase2Outputs]:
    """Phase 2 over the ranks of ``mesh`` (upsp_tpu/pipeline/phase2.py:
    175-257): each rank converts its (N_pad/D, F) node block ``it_local``
    (the frames->nodes exchange's result, frame pads already cut) with its
    nodes' ``sol_avg`` on its device, and rank 0 gathers every node's
    outputs; the other ranks return None.  ``coverage`` is over every
    node.  Node pads carry coverage 0, so they convert to NaN, and are cut
    from the gathered arrays.
    """
    from upsp_tpu_torch.parallel.mesh import gather, node_sharding

    dev = mesh.device
    N, F = coverage.shape[0], it_local.shape[1]
    n0, n1 = node_sharding(mesh, N)

    def local_nodes(a):
        out = torch.zeros(n1 - n0, dtype=torch.float32, device=dev)
        a = np.asarray(a, np.float32)[n0:n1]
        out[: a.shape[0]] = torch.as_tensor(a, device=dev)
        return out

    const = make_phase2_constants(pcal, cond, dev)
    det = make_detrender(F, cfg.degree, dev)
    steady = load_steady_cp(cfg, N, model)
    mtemp = compute_model_temperature(cfg, cond, N, model)
    out = phase2_convert(it_local, sol_avg, local_nodes(coverage),
                         local_nodes(steady), local_nodes(mtemp), const, det)
    whole = {k: gather(mesh, getattr(out, k), "cpu")
             for k in ("pressure_transpose", "rms", "avg", "gain")}
    if mesh.rank != 0:
        return None
    return Phase2Outputs(**{k: v[:N] for k, v in whole.items()},
                         steady_state=torch.as_tensor(steady),
                         model_temp=torch.as_tensor(mtemp))
