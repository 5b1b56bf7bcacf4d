"""Reduction of a ``torch.profiler`` trace of whole datapoints.

The traced segment runs datapoints inside ``record_function`` ranges
named :data:`DATAPOINT`; each datapoint's stages are rebuilt from its
``stage_times`` durations in their order (phase 0, phase 1 with its
set-up first, phase 2, outputs), starting at its range's start.  The
device's activity is the union of the kernels', copies' and sets'
intervals on the card; a ``record_function`` range mirrored on the
card's timeline (a user annotation, the profiler's ``gpu_user_annotation``)
is no activity and is left out.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

DATAPOINT = "benchmark.datapoint"
STAGES = ("phase0", "phase1", "phase2", "outputs")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _covered(union: List[Tuple[float, float]], lo: float, hi: float) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union)


def stage_intervals(start_us: float, times: dict) -> List[Tuple[str, float, float]]:
    """(label, start, end) in microseconds of one datapoint's stages, with
    phase 1's set-up apart from its frames."""
    out, t = [], start_us
    for label in STAGES:
        d = 1e6 * times.get(label, 0.0)
        if label == "phase1" and "phase1_setup" in times:
            s = 1e6 * times["phase1_setup"]
            out.append(("phase1_setup", t, t + s))
            out.append(("phase1", t + s, t + d))
        else:
            out.append((label, t, t + d))
        t += d
    return out


class TraceSummary:
    """What the per-layer readers take from a trace: ``window_s``,
    ``busy_s``, ``phase1_busy_s``, ``kernel_s`` (summed device seconds by
    kernel name), ``device_ops`` and ``idle_gaps`` (the ten largest)."""

    def __init__(self, events, stage_times: List[dict], window_s: float):
        """``events``: (name, on the card, start us, end us, user annotation)."""
        dev, ranges = [], []
        for name, on_card, start, end, annotation in events:
            if on_card:
                if not (annotation or name == DATAPOINT):
                    dev.append((name, start, end))
            elif name == DATAPOINT:
                ranges.append((start, end))
        ranges.sort()
        if len(ranges) != len(stage_times):
            raise RuntimeError(f"the trace holds {len(ranges)} datapoint ranges for "
                               f"{len(stage_times)} traced datapoints")
        self.window_s = window_s
        union = _union([(s, e) for _, s, e in dev])
        self.busy_s = sum(e - s for s, e in union) / 1e6
        stages = [iv for (s, _), t in zip(ranges, stage_times)
                  for iv in stage_intervals(s, t)]
        self.phase1_busy_s = sum(_covered(union, s, e) for lab, s, e in stages
                                 if lab == "phase1") / 1e6
        self.kernel_s: Dict[str, float] = {}
        for name, s, e in dev:
            self.kernel_s[name] = self.kernel_s.get(name, 0.0) + (e - s) / 1e6
        self.device_ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        lo = ranges[0][0] if ranges else 0.0
        hi = ranges[-1][1] if ranges else 0.0
        edges = [lo] + [x for iv in union for x in iv] + [hi]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                mid = 0.5 * (a + b)
                label = next((lab for lab, s, e in stages if s <= mid < e),
                             "between datapoints")
                gaps.append((label, (b - a) / 1e6))
        self.idle_gaps = sorted(gaps, key=lambda g: -g[1])[:10]

    def seconds_of(self, pattern: str) -> float:
        """Device seconds of the kernels whose name holds ``pattern`` as a
        whole word."""
        rx = re.compile(r"\b" + re.escape(pattern) + r"\b")
        return sum(s for n, s in self.kernel_s.items() if rx.search(n))


def summarize(prof, stage_times: List[dict], window_s: float) -> TraceSummary:
    """The :class:`TraceSummary` of a finished ``torch.profiler.profile``,
    read from its raw events (building ``prof.events()``'s tree takes
    tens of seconds for one datapoint)."""
    events = []
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        start = e.start_ns() / 1e3
        events.append((e.name(), e.device_type().name == "CUDA", start,
                       start + e.duration_ns() / 1e3,
                       bool(annotation()) if callable(annotation) else False))
    return TraceSummary(events, stage_times, window_s)
