"""Phase 1 -> frames->nodes exchange -> phase 2 over the ranks of a mesh.

Port of ``upsp_tpu/parallel/sharded_run.py`` (:31-136) on in-memory
frames:

  frames (F, C, H, W)        each rank runs its contiguous frame block
    -> avg/rms               f64 partial sums, summed over the ranks
                             (the reference's MPI_Reduce)
    -> (N, F) node blocks    one all_to_all (the reference's
                             global_transpose)
    -> phase-2 conversion    each rank its node block

Each rank returns its own blocks; the frame statistics are whole on
every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from upsp_tpu_torch.ops.polyfit import PolyDetrender
from upsp_tpu_torch.ops.projection import coverage as proj_coverage
from upsp_tpu_torch.parallel.mesh import (
    Mesh, all_reduce, global_transpose, make_mesh, node_sharding, padded)
from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
from upsp_tpu_torch.pipeline.phase2 import Phase2Constants, phase2_convert


class ShardedOutputs(NamedTuple):
    intensity: torch.Tensor  # (F_pad/D, N): this rank's frame block
    sol_avg: torch.Tensor  # (N,)
    sol_rms: torch.Tensor  # (N,)
    pressure_transpose: torch.Tensor  # (N_pad/D, F_pad): this rank's node block
    rms: torch.Tensor  # (N_pad/D,)
    avg: torch.Tensor
    gain: torch.Tensor


def make_sharded_pipeline(state, mesh: Mesh, const: Phase2Constants,
                          det: PolyDetrender, steady, model_temp, coverage):
    """The pipeline of this rank: (F_pad, C, H, W) frames, F_pad a
    multiple of the world size -> :class:`ShardedOutputs`.  ``steady``,
    ``model_temp`` and ``coverage`` are (N,) arrays over every node.
    Phase 1 starts each frame's ECC solve from identity, as the JAX
    package's frame program does."""
    step = make_chunk_processor(state, warm_start=False, frame_batch=8, mesh=mesh)
    n = state.n_nodes
    n_pad = padded(n, mesh.world)
    n0, n1 = node_sharding(mesh, n)

    def local_nodes(a):
        out = torch.zeros(n_pad, dtype=torch.float32, device=mesh.device)
        out[:n] = torch.as_tensor(a, dtype=torch.float32, device=mesh.device)
        return out[n0:n1]

    st, mt, cov = local_nodes(steady), local_nodes(model_temp), local_nodes(coverage)

    def pipeline(frames) -> ShardedOutputs:
        intensity = step(frames)  # (F_pad/D, N)
        i64 = intensity.double()
        seen = ~torch.isnan(i64)
        sums = all_reduce(mesh, torch.stack([
            torch.where(seen, i64, 0.0).sum(0),
            torch.where(seen, i64 * i64, 0.0).sum(0),
            seen.sum(0, dtype=torch.float64),
        ]))
        # nanmean over the frames, as the JAX pipeline's
        avg = (sums[0] / sums[2]).float()
        rms = torch.sqrt(sums[1] / sums[2]).float()
        block = torch.zeros((intensity.shape[0], n_pad), dtype=torch.float32,
                            device=mesh.device)
        block[:, :n] = intensity
        it = global_transpose(mesh, block)  # (N_pad/D, F_pad)
        out = phase2_convert(it, local_nodes(avg), cov, st, mt, const, det)
        return ShardedOutputs(intensity=intensity, sol_avg=avg, sol_rms=rms,
                              pressure_transpose=out.pressure_transpose,
                              rms=out.rms, avg=out.avg, gain=out.gain)

    return pipeline


def run_sharded(state, frames: np.ndarray, cond, pcal, mesh: Optional[Mesh] = None,
                degree: int = 6, steady: Optional[np.ndarray] = None,
                model_temp: Optional[np.ndarray] = None) -> ShardedOutputs:
    """Pad the (F, C, H, W) frames to a multiple of the world size with
    copies of the last frame, and run this rank's pipeline on them
    (``mesh``: by default :func:`make_mesh` on the state's device).  As
    in the JAX package, the frame statistics and the detrender take the
    padded frame count (upsp_tpu/parallel/sharded_run.py:119)."""
    from upsp_tpu_torch.io.wtd import model_temperature
    from upsp_tpu_torch.ops.polyfit import make_detrender
    from upsp_tpu_torch.pipeline.phase2 import make_phase2_constants

    if mesh is None:
        mesh = make_mesh(state.device)
    frames = np.asarray(frames)
    pad = (-frames.shape[0]) % mesh.world
    if pad:
        frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)])
    n = state.n_nodes
    const = make_phase2_constants(pcal, cond, mesh.device)
    det = make_detrender(frames.shape[0], degree, mesh.device)
    cov = proj_coverage(state.projections, *state.image_hw)[state.superseded_by]
    if steady is None:
        steady = np.zeros(n, np.float32)
    if model_temp is None:
        model_temp = np.full(n, model_temperature(cond), np.float32)
    fn = make_sharded_pipeline(state, mesh, const, det, steady, model_temp, cov)
    return fn(frames)
