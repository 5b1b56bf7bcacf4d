"""The program's spans and counters over whole datapoints of a cell, and
the idle gaps of a traced datapoint named by the span the host was in.

    python3 -m benchmark.spans --workload <name> --seed <n> [--seconds <s>]

From the root of a checkout, on a card (exits 2 without CUDA).  The
cell's datapoint is written and warmed as the harness does it; then
``--seconds`` of datapoints with recording off (the program's
``stage_times`` only), two datapoints inside one
``upsp_tpu_torch.utils.timing.recording()``, and one more under
``torch.profiler`` with recording on.  Prints one JSON line:

- ``metrics``: :func:`span_metrics` over the two recorded datapoints;
- ``coverage``: :func:`coverage`, the worst of the two;
- ``stage_gap_ms``: the largest |stage span - ``stage_times`` entry|;
- ``stages_on_off``: each stage's mean seconds with recording on and off;
- ``cost``: ns a span and a count with recording off and on, the spans
  and counts a datapoint, and their products in ms a datapoint;
- ``anchor``: the error of mapping a span onto the profiler's timeline
  (probes before and after the traced datapoint), and how far the
  harness's rebuilt stage boundaries lie from the stage spans;
- ``breakdown``: the traced datapoint's ``device_ops``, its ``idle_gaps``
  labelled by :func:`label_gaps`, and ``idle_by_span``;
- ``spans``, ``counters``: per-name means a datapoint, and
  ``outputs_equal``: whether the recorded datapoints' intensities equal
  an unrecorded one's.

The functions are the reductions a later harness reads the same
recordings with; this entry is not one of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

STAGES = ("phase0", "phase1_setup", "phase1", "phase2", "outputs")
PROBE = "upsp.probe"


def _per_frame_us(ns: float, frames: int) -> Optional[float]:
    return ns / 1e3 / frames if frames else None


def span_metrics(rec) -> Dict[str, Optional[float]]:
    """The six per-layer numbers of a recording's datapoints: phase 1's
    ingest wait (``phase1.ingest_wait`` + ``phase1.stage``), dispatch (the
    self time of ``phase1.program``), sync wait (``phase1.gn_sync`` +
    ``phase1.fetch``) in us a frame and its host syncs a frame, over
    ``frames.phase1``; ``phase0.walk`` and ``phase2.host_stats`` in
    seconds, the mean a datapoint."""
    dps = rec.datapoints()
    frames = sum(rec.counter("frames.phase1", d) for d in dps)

    def total(*names):
        return sum(rec.total_ns(n, d) for n in names for d in dps)

    dispatch = sum(rec.self_ns(s) for d in dps for s in rec.of(d, "phase1.program"))
    syncs = sum(v for d in dps for k, v in rec.counters.get(d, {}).items()
                if k.startswith("host_syncs."))
    n = len(dps)
    return {
        "phase1.ingest_wait_us_per_frame": _per_frame_us(
            total("phase1.ingest_wait", "phase1.stage"), frames),
        "phase1.dispatch_us_per_frame": _per_frame_us(dispatch, frames),
        "phase1.sync_wait_us_per_frame": _per_frame_us(
            total("phase1.gn_sync", "phase1.fetch"), frames),
        "phase1.host_syncs_per_frame": syncs / frames if frames else None,
        "phase0.walk_s": total("phase0.walk") / 1e9 / n if n else None,
        "phase2.host_stats_s": total("phase2.host_stats") / 1e9 / n if n else None,
    }


def coverage(rec) -> Dict[str, float]:
    """The share of each stage that the spans below it cover, the worst
    over the datapoints: ``phase1`` is its frames (the stage less its
    ``phase1_setup``, whose own children do not count), ``phase0`` and
    ``phase2`` the whole stage."""
    from upsp_tpu_torch.utils.timing import covered_ns

    worst: Dict[str, float] = {}
    for d in rec.datapoints():
        stage = {s.name: s for s in rec.of(d) if s.name in STAGES}
        for name in ("phase0", "phase1", "phase2"):
            st = stage.get(name)
            if st is None or st.end_ns <= st.start_ns:
                continue
            kids = [k for k in rec.children(st) if k.name != "phase1_setup"]
            lo = stage["phase1_setup"].end_ns if name == "phase1" else st.start_ns
            share = covered_ns(kids, lo, st.end_ns) / (st.end_ns - lo)
            worst[name] = min(worst.get(name, 1.0), share)
    return worst


def stage_gap_ms(rec, stage_times: List[dict]) -> float:
    """The largest |stage span - its ``stage_times`` entry| in ms, the
    datapoints and their ``stage_times`` in the same order."""
    gap = 0.0
    for d, st in zip(rec.datapoints(), stage_times):
        for s in rec.of(d):
            if s.name in STAGES and s.name in st:
                gap = max(gap, abs((s.end_ns - s.start_ns) / 1e9 - st[s.name]) * 1e3)
    return gap


def events_of(prof) -> list:
    """(name, on the card, start us, end us, user annotation) of a finished
    ``torch.profiler.profile``'s raw events, as ``benchmark.trace``
    reads them."""
    events = []
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        start = e.start_ns() / 1e3
        events.append((e.name(), e.device_type().name == "CUDA", start,
                       start + e.duration_ns() / 1e3,
                       bool(annotation()) if callable(annotation) else False))
    return events


def clock_of(events) -> Optional[Tuple[float, float]]:
    """(start, end) us of the recording's ``upsp.clock`` range on the
    profiler's timeline: the longest (an empty one comes first)."""
    from upsp_tpu_torch.utils.timing import CLOCK

    ranges = [(e - s, s, e) for name, on_card, s, e, _ in events
              if name == CLOCK and not on_card]
    return max(ranges)[1:] if ranges else None


def to_profiler_us(rec, clock: Tuple[float, Optional[float]], ns: int) -> float:
    """A ``perf_counter_ns`` reading on the profiler's timeline: linear
    between the clock range's start and end (its start alone when
    ``clock``'s end is None)."""
    s, e = clock
    if e is None or not rec.anchor_end_ns or rec.anchor_end_ns == rec.anchor_ns:
        return s + (ns - rec.anchor_ns) / 1e3
    return s + (ns - rec.anchor_ns) * (e - s) / (rec.anchor_end_ns - rec.anchor_ns)


def to_recorder_ns(rec, clock: Tuple[float, float], us: float) -> int:
    """A time on the profiler's timeline as a ``perf_counter_ns`` reading
    (the inverse of :func:`to_profiler_us`)."""
    s, e = clock
    if not rec.anchor_end_ns or e <= s:
        return rec.anchor_ns + round((us - s) * 1e3)
    return rec.anchor_ns + round((us - s) * (rec.anchor_end_ns - rec.anchor_ns) / (e - s))


def _gaps(events, stage_times: List[dict]) -> List[Tuple[str, float, float, float]]:
    """Every idle gap of the traced datapoints, (stage label, seconds,
    start us, end us), by ``benchmark.trace.TraceSummary``'s rule."""
    from benchmark.trace import DATAPOINT, _union, stage_intervals

    dev, ranges = [], []
    for name, on_card, start, end, annotation in events:
        if on_card:
            if not (annotation or name == DATAPOINT):
                dev.append((start, end))
        elif name == DATAPOINT:
            ranges.append((start, end))
    ranges.sort()
    stages = [iv for (s, _), t in zip(ranges, stage_times) for iv in stage_intervals(s, t)]
    union = _union(dev)
    lo = ranges[0][0] if ranges else 0.0
    hi = ranges[-1][1] if ranges else 0.0
    edges = [lo] + [x for iv in union for x in iv] + [hi]
    out = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            label = next((lab for lab, s, e in stages if s <= mid < e),
                         "between datapoints")
            out.append((label, (b - a) / 1e6, a, b))
    return out


def innermost(spans: list, starts: list, t_ns: int):
    """The innermost of nested ``spans`` (sorted by start, the longer
    first; ``starts`` their starts) open at ``t_ns``: the latest started
    that holds it, or None."""
    for i in range(bisect.bisect_right(starts, t_ns) - 1, -1, -1):
        if spans[i].end_ns > t_ns:
            return spans[i]
    return None


def label_gaps(events, stage_times: List[dict], rec, top: int = 10):
    """(idle_gaps, idle_by_span) of a traced datapoint recorded with its
    profiler anchor: each gap of ``benchmark.trace.TraceSummary``, the
    same seconds in the same order, its stage label followed by
    ``/<span>``, the innermost span open on the datapoint's thread at the
    gap's middle, where that span lies below the stage; and the idle
    seconds summed by label, the ``top`` largest."""
    clock = clock_of(events)
    roots = [s for s in rec.spans if s.name == "datapoint"]
    main = sorted((s for s in rec.spans if roots and s.thread == roots[0].thread),
                  key=lambda s: (s.start_ns, -s.end_ns))
    starts = [s.start_ns for s in main]
    labelled = []
    for label, secs, a, b in _gaps(events, stage_times):
        if clock is not None and rec.anchor_ns is not None:
            s = innermost(main, starts, to_recorder_ns(rec, clock, 0.5 * (a + b)))
            if s is not None and s.name not in STAGES and s.name != "datapoint":
                label = f"{label}/{s.name}"
        labelled.append((label, secs))
    by: Dict[str, float] = {}
    for label, secs in labelled:
        by[label] = by.get(label, 0.0) + secs
    gaps = sorted(labelled, key=lambda g: -g[1])[:top]
    return gaps, sorted(by.items(), key=lambda kv: -kv[1])[:top]


def rebuilt_stage_gap_us(events, stage_times: dict, rec) -> Optional[float]:
    """The largest distance between a stage boundary as the harness
    rebuilds it (the ``stage_times`` durations laid end to end from the
    datapoint range's start) and the recorded stage span's, on the
    profiler's timeline, for one traced datapoint."""
    from benchmark.trace import DATAPOINT, stage_intervals

    clock = clock_of(events)
    ranges = sorted(s for n, on_card, s, _, _ in events if n == DATAPOINT and not on_card)
    if clock is None or rec.anchor_ns is None or not ranges:
        return None
    spans = {s.name: (s.start_ns, s.end_ns) for s in rec.spans if s.name in STAGES}
    if "phase1_setup" in spans:  # the rebuilt phase 1 is its frames alone
        spans["phase1"] = (spans["phase1_setup"][1], spans["phase1"][1])
    gap = 0.0
    for label, s, e in stage_intervals(ranges[0], stage_times):
        if label in spans:
            a, b = (to_profiler_us(rec, clock, t) for t in spans[label])
            gap = max(gap, abs(s - a), abs(e - b))
    return gap


def probe_errors_us(events, rec, probes: List[Tuple[int, int]], two_ends: bool = True
                    ) -> Optional[List[Tuple[float, float]]]:
    """For each of ``probes``, the ``perf_counter_ns`` readings just
    before and just after an ``upsp.probe`` range was entered, in order:
    (the reading before, mapped, less the range's profiler start; the
    entry's own us), mapped through both ends of the clock range or
    through its start alone.  The profiler stamps a range during its
    entry, so an entry slower than the recording's shows as an error up
    to its length."""
    clock = clock_of(events)
    starts = sorted(s for n, on_card, s, _, _ in events if n == PROBE and not on_card)
    if clock is None or len(starts) != len(probes):
        return None
    if not two_ends:
        clock = (clock[0], None)
    return [(to_profiler_us(rec, clock, a) - s, (b - a) / 1e3)
            for (a, b), s in zip(probes, starts)]


def _probe(record_function) -> Tuple[int, int]:
    t = time.perf_counter_ns()
    with record_function(PROBE):
        return t, time.perf_counter_ns()


def _unit_costs(timing, n: int = 50_000) -> Dict[str, float]:
    """ns a ``span`` and a ``count`` cost with recording off and on, less
    an empty loop's; the best of three loops of ``n``."""
    span, count = timing.span, timing.count

    def empty():
        for _ in range(n):
            pass

    def spans():
        for _ in range(n):
            with span("x"):
                pass

    def counts():
        for _ in range(n):
            count("x", 1)

    def best(body, on: bool = False) -> float:
        times = []
        for _ in range(3):
            with timing.recording() if on else contextlib.nullcontext():
                t = time.perf_counter_ns()
                body()
                times.append(time.perf_counter_ns() - t)
        return min(times) / n

    base = best(empty)
    return {"span_off": best(spans) - base, "count_off": best(counts) - base,
            "span_on": best(spans, True) - base, "count_on": best(counts, True) - base}


def measure(cell: dict, seed: int, seconds: float, device="cuda") -> dict:
    """The JSON line's dict (the module docstring) for one run of ``cell``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.datapoint import write_datapoint
    from benchmark.trace import DATAPOINT, TraceSummary
    from upsp_tpu_torch.pipeline.config import read_input_deck
    from upsp_tpu_torch.pipeline.run import run_datapoint
    from upsp_tpu_torch.utils import timing

    device = torch.device(device)
    conf, traffic = cell["config"], cell["traffic"]
    if device.type == "cuda":
        from upsp_tpu_torch.ops import cuda_lib

        cuda_lib.build_all()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    root = tempfile.mkdtemp(prefix="upsp_spans_")
    try:
        dp = write_datapoint(
            root, seed=seed, n_cameras=conf["n_cameras"], image_hw=tuple(conf["image_hw"]),
            grid_shape=tuple(conf["grid_shape"]), n_frames=traffic["n_frames"],
            n_distinct=traffic["n_distinct"], n_targets=conf["n_targets"],
            max_shift_px=traffic["max_shift_px"], video_format=conf["video_format"],
            device=device, options=conf["deck_options"])
        cfg = read_input_deck(dp["deck"])
        start = traffic["warm_start"] if traffic["warm_start"] == "fft" else False

        def datapoint(st):
            out = run_datapoint(cfg, device=device, write_outputs=False, stage_times=st,
                                warm_start=start, compute_dtype=conf["compute_dtype"])
            sync()
            return out.intensity

        reference = datapoint({})  # the warm datapoint
        window, t_end = [], time.perf_counter() + seconds
        while not window or time.perf_counter() < t_end:
            window.append({})
            datapoint(window[-1])

        recorded, diffs = [{}, {}], []
        calls = {"count": 0}
        count = timing.count

        def tally(name, n=1):
            calls["count"] += 1
            count(name, n)

        timing.count = tally
        try:
            with timing.recording() as rec:
                for st in recorded:
                    x = datapoint(st)
                    diffs.append((np.array_equal(x, reference, equal_nan=True),
                                  float(np.nanmax(np.abs(x - reference)))))
        finally:
            timing.count = count

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        traced, probes = [{}], []
        with profile(activities=acts) as prof:
            with timing.recording() as trec:
                probes += [_probe(record_function) for _ in range(3)]
                t_tr = time.perf_counter()
                with record_function(DATAPOINT):
                    datapoint(traced[0])
                traced_s = time.perf_counter() - t_tr
                probes += [_probe(record_function) for _ in range(3)]
        events = events_of(prof)
        del prof
    finally:
        shutil.rmtree(root, ignore_errors=True)

    summary = TraceSummary(events, traced, traced_s)
    errors = probe_errors_us(events, trec, probes)
    idle_gaps, idle_by_span = label_gaps(events, traced, trec)
    dps = rec.datapoints()
    n_spans, n_counts = len(rec.spans) / len(dps), calls["count"] / len(dps)
    unit = _unit_costs(timing)
    names = sorted({s.name for s in rec.spans})
    counters = sorted({k for d in dps for k in rec.counters.get(d, {})})
    mean = statistics.fmean
    return {
        "workload": cell["name"], "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "window_datapoints": len(window),
        "metrics": span_metrics(rec),
        "coverage": coverage(rec),
        "stage_gap_ms": stage_gap_ms(rec, recorded),
        "stages_on_off": {k: {"on": mean(st[k] for st in recorded),
                              "off": mean(st[k] for st in window)} for k in STAGES},
        "cost": {"ns": unit, "spans_per_datapoint": n_spans,
                 "counts_per_datapoint": n_counts,
                 **{f"{w}_ms_per_datapoint": (unit[f"span_{w}"] * n_spans
                                              + unit[f"count_{w}"] * n_counts) / 1e6
                    for w in ("off", "on")}},
        "anchor": {"error_us": max(abs(e) for e, _ in errors) if errors else None,
                   "probe_errors_us": errors,
                   "probe_errors_us_start_only": probe_errors_us(events, trec, probes, False),
                   "rebuilt_stage_gap_us": rebuilt_stage_gap_us(events, traced[0], trec)},
        "breakdown": {"device_ops": [list(x) for x in summary.device_ops],
                      "idle_gaps": [list(x) for x in idle_gaps],
                      "idle_by_span": [list(x) for x in idle_by_span]},
        "traced": {"coverage": coverage(trec), "metrics": span_metrics(trec),
                   "stage_gap_ms": stage_gap_ms(trec, traced)},
        "spans": {n: sum(rec.total_ns(n, d) for d in dps) / 1e9 / len(dps) for n in names},
        "counters": {k: mean(rec.counter(k, d) for d in dps) for k in counters},
        "outputs_equal": all(eq for eq, _ in diffs),
        "outputs_max_abs_diff": max(d for _, d in diffs),
        "stage_times": {"recorded": recorded, "traced": traced},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import cells

    if not torch.cuda.is_available():
        print("the spans are read on a CUDA device", file=sys.stderr)
        return 2
    cell = cells.cell(args.workload, cells.load_benchmark())
    print(json.dumps(measure(cell, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
