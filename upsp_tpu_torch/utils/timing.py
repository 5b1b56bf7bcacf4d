"""Scope timers, pipeline stage checkpoints and device traces.

Port of ``upsp_tpu/utils/timing.py``.  ``StageClock`` is the reference's
timedBarrierPoint (psp_process.cpp:583-606): every stage records its
total elapsed and since-previous seconds, and on multi-rank runs the
wait at the barrier separately (the load-imbalance signal).
``BlockTimer`` (a copy) is the reference's psp::BlockTimer
(cpp/include/utils/pspTimer.h); :func:`trace` records device work with
``torch.profiler`` where the JAX package uses ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, List, Optional, Tuple

log = logging.getLogger("upsp_tpu.timing")


class BlockTimer:
    """RAII-style scope timer: logs elapsed wall time on exit."""

    def __init__(self, label: str, enabled: bool = True):
        self.label = label
        self.enabled = enabled
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        if self.enabled:
            log.info("%s: %.3f s", self.label, self.elapsed)


class StageClock:
    """Labelled stage checkpoints.

    Each :meth:`point` first calls ``sync`` (waits for this rank's device
    work), then ``barrier`` (waits for every rank; e.g.
    :func:`upsp_tpu_torch.parallel.mesh.barrier`), appends (label, total
    elapsed, seconds since the previous point, barrier wait) to
    ``records`` and, when ``enabled``, logs them (info).  ``times``, when
    a dict, receives each stage's seconds since the previous point under
    its label, and the barrier waits under ``"barrier"`` (label ->
    seconds) when there is a barrier.  On multi-rank runs every rank must
    make the same points in the same order.
    """

    def __init__(self, barrier: Optional[Callable[[], None]] = None,
                 enabled: bool = True,
                 sync: Optional[Callable[[], None]] = None,
                 times: Optional[dict] = None):
        self.t_start = time.perf_counter()
        self.t_prev = self.t_start
        self.barrier = barrier
        self.enabled = enabled
        self.sync = sync
        self.times = times
        self.records: List[Tuple[str, float, float, float]] = []

    def point(self, label: str) -> None:
        if self.sync is not None:
            self.sync()
        t_before = time.perf_counter()
        if self.barrier is not None:
            self.barrier()
        t_after = time.perf_counter()
        rec = (label, t_after - self.t_start, t_after - self.t_prev,
               t_after - t_before)
        self.records.append(rec)
        self.t_prev = t_after
        if self.times is not None:
            self.times[label] = rec[2]
            if self.barrier is not None:
                self.times.setdefault("barrier", {})[label] = rec[3]
        if self.enabled:
            log.info("[stage] %-40s total %8.3f s  step %8.3f s  barrier %6.3f s",
                     *rec)

    def summary(self) -> str:
        """The records as a table, one stage a line."""
        lines = [f"{'stage':40s} {'total':>10s} {'step':>10s} {'barrier':>8s}"]
        for label, total, step, wait in self.records:
            lines.append(f"{label:40s} {total:10.3f} {step:10.3f} {wait:8.3f}")
        return "\n".join(lines)

    def split(self, label: str) -> None:
        """Record the seconds since the previous point under ``label`` in
        ``times`` (after ``sync``), without ending the stage: a part of
        the stage that the next point ends."""
        if self.sync is not None:
            self.sync()
        if self.times is not None:
            self.times[label] = time.perf_counter() - self.t_prev


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the CPU and, where CUDA is available,
    the card, written as a Chrome trace (``trace.json``) under ``log_dir``;
    yields the ``torch.profiler.profile`` (its events are read after the
    block); a no-op yielding None when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_barrier():
    """Wait for this process's device work and then, on a run of two or
    more ranks, for every rank (a :class:`StageClock` barrier)."""
    import torch
    import torch.distributed as dist

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        from upsp_tpu_torch.parallel.mesh import Mesh, barrier

        backend = dist.get_backend()
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
        barrier(Mesh(dist.get_rank(), dist.get_world_size(), device,
                     dist.group.WORLD, backend))
