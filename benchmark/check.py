"""The comparison that decides ``correct``: what the window's datapoints
produced against the plain reference (``benchmark/reference/plain.py``)
on the same inputs.

Three numbers, each the worst over every datapoint the run completed,
every frame and every node (a NaN on one side only counts as infinite):

- ``intensity_gap``: the largest |program - reference| of the phase-1
  node intensities (12-bit counts), which carries phase 0's projections,
  patches and templates, the ingest, the registration, the patches and
  filter, and the gather;
- ``stats_gap``: the largest relative gap of the frame statistics (the
  per-node mean and rms over frames);
- ``dcp_gap``: the largest |program - reference| of phase 2's delta-Cp.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from benchmark.datapoint import content_index
from benchmark.reference import plain as R

NUMBERS = ("intensity_gap", "stats_gap", "dcp_gap")
NODE_BLOCK = 1 << 17


def _gap(a: torch.Tensor, b: torch.Tensor, rel: bool = False) -> float:
    """The largest |a - b| (relative to |b| with ``rel``), infinite where
    exactly one is NaN."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if bool((nan_a != nan_b).any()):
        return math.inf
    d = (a.double() - b.double()).abs()
    if rel:
        d = d / b.double().abs().clamp_min(1e-30)
    d = torch.where(nan_b, torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


class Reference:
    """The reference's results on one datapoint, on ``device``: the
    intensity of each distinct frame content, the node statistics, the
    coverage and, per node block, phase 2."""

    def __init__(self, dp: dict, mode: str, device):
        self.dp = dp
        self.device = torch.device(device)
        self.state = R.phase0(dp, self.device)
        self.rows, self.steps = R.intensities(dp, self.state, mode, self.device)
        n_f = dp["n_frames"]
        self.index = torch.tensor([content_index(f, dp["n_distinct"]) for f in range(n_f)],
                                  device=self.device)
        counts = torch.bincount(self.index, minlength=self.rows.shape[0]).double()
        rows64 = self.rows.double()
        self.avg = (counts[:, None] * rows64).sum(0) / n_f
        self.rms = torch.sqrt((counts[:, None] * rows64 * rows64).sum(0) / n_f)
        self.covered = ~self.state.skipped
        self.Q = R.detrend_basis(n_f, self.device)

    def gn_steps(self) -> int:
        """Gauss-Newton steps of one datapoint, over its frames and cameras."""
        return int(self.steps[self.index.cpu()].sum())

    def compare(self, outputs: List[dict]) -> dict:
        """{number: worst value} over ``outputs`` (each {"intensity" (F, N),
        "avg", "rms" (N,), "dcp" (N, F)} as numpy arrays)."""
        worst = dict.fromkeys(NUMBERS, 0.0)
        n_nodes = self.rows.shape[1]
        for out in outputs:
            got = torch.from_numpy(np.ascontiguousarray(out["intensity"]))
            for f0 in range(0, got.shape[0], 16):
                want = self.rows[self.index[f0 : f0 + 16]]
                worst["intensity_gap"] = max(worst["intensity_gap"], _gap(
                    got[f0 : f0 + 16].to(self.device), want))
            for key, ref in (("avg", self.avg), ("rms", self.rms)):
                g = torch.from_numpy(out[key]).to(self.device)
                worst["stats_gap"] = max(worst["stats_gap"], _gap(g, ref, rel=True))
            for n0 in range(0, n_nodes, NODE_BLOCK):
                n1 = min(n0 + NODE_BLOCK, n_nodes)
                it_t = self.rows[:, n0:n1].double()[self.index].T
                want = R.phase2_block(it_t, self.avg[n0:n1], self.covered[n0:n1],
                                      self.Q, self.dp)
                got = torch.from_numpy(np.ascontiguousarray(out["dcp"][n0:n1])).to(self.device)
                worst["dcp_gap"] = max(worst["dcp_gap"], _gap(got, want))
        return worst
