"""Pipeline stage checkpoints with the barrier wait kept apart.

Port of ``upsp_tpu/utils/timing.py``'s ``StageClock``: the reference's
timedBarrierPoint (psp_process.cpp:583-606).  Every stage records its
total elapsed and since-previous seconds, and on multi-rank runs the
wait at the barrier separately (the load-imbalance signal).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

log = logging.getLogger("upsp_tpu.timing")


class StageClock:
    """Labelled stage checkpoints.

    Each :meth:`point` first calls ``sync`` (waits for this rank's device
    work), then ``barrier`` (waits for every rank; e.g.
    :func:`upsp_tpu_torch.parallel.mesh.barrier`), and logs (debug) the
    total elapsed, the seconds since the previous point and the barrier
    wait.  ``times``, when a dict, receives each stage's seconds since the
    previous point under its label, and the barrier waits under
    ``"barrier"`` (label -> seconds) when there is a barrier.  On
    multi-rank runs every rank must make the same points in the same
    order.
    """

    def __init__(self, barrier: Optional[Callable[[], None]] = None,
                 sync: Optional[Callable[[], None]] = None,
                 times: Optional[dict] = None):
        self.t_start = time.perf_counter()
        self.t_prev = self.t_start
        self.barrier = barrier
        self.sync = sync
        self.times = times

    def point(self, label: str) -> None:
        if self.sync is not None:
            self.sync()
        t_before = time.perf_counter()
        if self.barrier is not None:
            self.barrier()
        t_after = time.perf_counter()
        step, wait = t_after - self.t_prev, t_after - t_before
        self.t_prev = t_after
        if self.times is not None:
            self.times[label] = step
            if self.barrier is not None:
                self.times.setdefault("barrier", {})[label] = wait
        log.debug("[stage] %-40s total %8.3f s  step %8.3f s  barrier %6.3f s",
                  label, t_after - self.t_start, step, wait)

    def split(self, label: str) -> None:
        """Record the seconds since the previous point under ``label`` in
        ``times`` (after ``sync``), without ending the stage: a part of
        the stage that the next point ends."""
        if self.sync is not None:
            self.sync()
        if self.times is not None:
            self.times[label] = time.perf_counter() - self.t_prev
