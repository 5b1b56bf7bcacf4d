"""``benchmark/spans.py``: the span readings of a recording, and the idle
gaps of a trace labelled with the span the host was in, on synthetic
recordings and events; and one run of a cut cell on the CPU.

The labelled gaps keep ``benchmark.trace.TraceSummary``'s seconds, order
and stage labels on the same events, and its ``device_ops`` are what the
harness reads.
"""

import math
import random

import pytest

from benchmark import spans as S
from benchmark.tests.tiny import tiny_cell
from benchmark.trace import DATAPOINT, TraceSummary
from upsp_tpu_torch.utils.timing import CLOCK, Recording, Span

ANCHOR_NS = 5_000_000  # perf_counter_ns at the clock range's start (0 us)
MAIN, PREFETCH = 1, 2
STAGE_TIMES = {"phase0": 2e-4, "phase1_setup": 1e-4, "phase1": 5e-4, "phase2": 2e-4,
               "outputs": 1e-4}


def _recording(spans, counters=None):
    rec = Recording()
    rec.anchor_ns = ANCHOR_NS
    rec.spans = [Span(i, name, ANCHOR_NS + a, ANCHOR_NS + b, parent, thread, 0)
                 for i, (name, a, b, parent, thread) in enumerate(spans)]
    rec.counters = {0: dict(counters or {})}
    return rec


# one datapoint on the profiler's clock (us) and the recorder's (ns from the
# anchor): phase 0 [0, 200) with its walk, phase 1 [200, 700) with its set-up
# [200, 300) and one chunk, phase 2 [700, 900), outputs [900, 1000)
SPANS = [
    ("datapoint", 0, 1_000_000, None, MAIN),                 # 0
    ("phase0", 0, 200_000, 0, MAIN),                          # 1
    ("phase0.walk", 10_000, 150_000, 1, MAIN),                # 2
    ("phase1", 200_000, 700_000, 0, MAIN),                    # 3
    ("phase1_setup", 200_000, 300_000, 3, MAIN),              # 4
    ("phase1.ingest_wait", 300_000, 320_000, 3, MAIN),        # 5
    ("phase1.stage", 320_000, 340_000, 3, MAIN),              # 6
    ("phase1.program", 340_000, 400_000, 3, MAIN),            # 7
    ("phase1.gn_sync", 350_000, 370_000, 7, MAIN),            # 8
    ("phase1.fetch", 400_000, 500_000, 3, MAIN),              # 9
    ("phase1.store", 500_000, 690_000, 3, MAIN),              # 10
    ("phase2", 700_000, 900_000, 0, MAIN),                    # 11
    ("phase2.host_stats", 700_000, 850_000, 11, MAIN),        # 12
    ("outputs", 900_000, 1_000_000, 0, MAIN),                 # 13
    ("ingest.read", 100_000, 600_000, None, PREFETCH),        # 14
]
COUNTERS = {"frames.phase1": 4, "host_syncs.gn": 3, "host_syncs.fetch": 2,
            "host_syncs.staging": 1, "bytes.d2h.pageable": 10**6}
EVENTS = [
    (DATAPOINT, False, 0.0, 1000.0, False),
    (CLOCK, False, 0.0, 1000.0, False),
    ("k1", True, 100.0, 150.0, False),
    ("k2", True, 300.0, 320.0, False),
    ("k3", True, 600.0, 900.0, False),
    (DATAPOINT, True, 0.0, 1000.0, True),  # the range mirrored on the card
]


def test_span_metrics():
    m = S.span_metrics(_recording(SPANS, COUNTERS))
    assert m["phase1.ingest_wait_us_per_frame"] == pytest.approx((20 + 20) / 4)
    assert m["phase1.dispatch_us_per_frame"] == pytest.approx((60 - 20) / 4)
    assert m["phase1.sync_wait_us_per_frame"] == pytest.approx((20 + 100) / 4)
    assert m["phase1.host_syncs_per_frame"] == pytest.approx(6 / 4)
    assert m["phase0.walk_s"] == pytest.approx(140e-6)
    assert m["phase2.host_stats_s"] == pytest.approx(150e-6)


def test_span_metrics_without_spans():
    m = S.span_metrics(Recording())
    assert set(m) == {"phase1.ingest_wait_us_per_frame", "phase1.dispatch_us_per_frame",
                      "phase1.sync_wait_us_per_frame", "phase1.host_syncs_per_frame",
                      "phase0.walk_s", "phase2.host_stats_s"}
    assert all(v is None for v in m.values())


def test_coverage_and_stage_gap():
    rec = _recording(SPANS, COUNTERS)
    cov = S.coverage(rec)
    assert cov["phase0"] == pytest.approx(140 / 200)
    assert cov["phase1"] == pytest.approx(390 / 400)  # frames: 300-700 less 690-700
    assert cov["phase2"] == pytest.approx(150 / 200)
    assert S.stage_gap_ms(rec, [STAGE_TIMES]) == pytest.approx(0.0, abs=1e-9)
    off = dict(STAGE_TIMES, phase2=STAGE_TIMES["phase2"] + 0.002)
    assert S.stage_gap_ms(rec, [off]) == pytest.approx(2.0)


def test_gaps_labelled_by_span():
    rec = _recording(SPANS, COUNTERS)
    summary = TraceSummary(EVENTS, [STAGE_TIMES], 1e-3)
    gaps, by_span = S.label_gaps(EVENTS, [STAGE_TIMES], rec)
    assert [s for _, s in gaps] == [s for _, s in summary.idle_gaps]
    assert [lab.split("/")[0] for lab, _ in gaps] == [lab for lab, _ in summary.idle_gaps]
    assert dict(gaps) == pytest.approx({
        "phase1/phase1.fetch": 280e-6,       # 320-600 us, middle 460
        "phase1_setup": 150e-6,              # 150-300, middle 225: no span below it
        "phase0/phase0.walk": 100e-6,        # 0-100, middle 50
        "outputs": 100e-6})                  # 900-1000
    assert dict(by_span) == pytest.approx(dict(gaps))
    assert S.rebuilt_stage_gap_us(EVENTS, STAGE_TIMES, rec) == pytest.approx(0.0)


def test_gaps_without_anchor_keep_stage_labels():
    rec = _recording(SPANS, COUNTERS)
    events = [e for e in EVENTS if e[0] != CLOCK]
    gaps, _ = S.label_gaps(events, [STAGE_TIMES], rec)
    assert gaps == TraceSummary(events, [STAGE_TIMES], 1e-3).idle_gaps
    assert S.rebuilt_stage_gap_us(events, STAGE_TIMES, rec) is None


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_gaps_equal_the_harness_reduction(seed):
    """Random kernels and copies (overlapping, mirrored annotations left
    out) over two datapoints: the same gaps, seconds, order and stage
    labels as ``TraceSummary`` gives."""
    rnd = random.Random(seed)
    events = [(DATAPOINT, False, 0.0, 1000.0, False), (DATAPOINT, False, 1100.0, 2100.0, False),
              (CLOCK, False, 0.0, 2100.0, False)]
    for _ in range(60):
        s = rnd.uniform(0, 2100)
        events.append((rnd.choice(["k1", "k2", "Memcpy"]), True, s, s + rnd.uniform(1, 40),
                       False))
        events.append(("ann", True, s, s + 5, True))
    times = [STAGE_TIMES, STAGE_TIMES]
    rec = _recording(SPANS, COUNTERS)
    summary = TraceSummary(events, times, 2.1e-3)
    gaps, _ = S.label_gaps(events, times, rec)
    assert [s for _, s in gaps] == [s for _, s in summary.idle_gaps]
    assert [lab.split("/")[0] for lab, _ in gaps] == [lab for lab, _ in summary.idle_gaps]
    assert len(S._gaps(events, times)) > len(gaps)  # the ten largest of more


def test_innermost_and_anchor_error():
    rec = _recording(SPANS)
    main = sorted((s for s in rec.spans if s.thread == MAIN),
                  key=lambda s: (s.start_ns, -s.end_ns))
    starts = [s.start_ns for s in main]
    assert S.innermost(main, starts, ANCHOR_NS + 360_000).name == "phase1.gn_sync"
    assert S.innermost(main, starts, ANCHOR_NS + 395_000).name == "phase1.program"
    assert S.innermost(main, starts, ANCHOR_NS + 695_000).name == "phase1"
    assert S.innermost(main, starts, ANCHOR_NS - 1) is None
    probes = [(ANCHOR_NS + 10_000, ANCHOR_NS + 12_000), (ANCHOR_NS + 900_000, ANCHOR_NS + 901_000)]
    events = EVENTS + [(S.PROBE, False, 10.5, 11.0, False), (S.PROBE, False, 899.0, 900.0, False)]
    got = S.probe_errors_us(events, rec, probes)
    assert got == [pytest.approx((-0.5, 2.0)), pytest.approx((1.0, 1.0))]
    assert S.probe_errors_us(EVENTS, rec, probes) is None


def test_clock_maps_through_both_ends():
    """The profiler's clock ran 0.1% fast over the recording: the start and
    end of its range map the recorder's readings in between."""
    rec = _recording(SPANS)
    rec.anchor_end_ns = ANCHOR_NS + 1_000_000
    events = [(CLOCK, False, 7.0, 8.0, False),  # the empty range first
              (CLOCK, False, 10.0, 1011.0, False)]
    clock = S.clock_of(events)
    assert clock == (10.0, 1011.0)
    assert S.to_profiler_us(rec, clock, ANCHOR_NS + 500_000) == pytest.approx(510.5)
    assert S.to_profiler_us(rec, (10.0, None), ANCHOR_NS + 500_000) == pytest.approx(510.0)
    assert S.to_recorder_ns(rec, clock, 510.5) == ANCHOR_NS + 500_000


def test_measure_on_the_cpu():
    """A cut cell end to end on the CPU: every reading present; the times
    are the CPU's, for the checks alone."""
    out = S.measure(tiny_cell("cine2cam.identity.dp512"), 2**31 + 11, 0.0, device="cpu")
    m = out["metrics"]
    assert all(v is not None and math.isfinite(v) for v in m.values()), m
    assert m["phase1.host_syncs_per_frame"] == 0.0  # no card: no host sync
    assert out["coverage"]["phase1"] >= 0.9
    assert out["stage_gap_ms"] < 1.0
    assert out["outputs_equal"] is True
    assert out["anchor"]["error_us"] is not None
    assert out["breakdown"]["idle_gaps"] and out["breakdown"]["idle_by_span"]
    assert out["counters"]["frames.phase1"] == 12 and out["counters"]["gn.steps"] > 0
    cost = out["cost"]
    assert cost["spans_per_datapoint"] > 0 and cost["counts_per_datapoint"] > 0
    assert cost["on_ms_per_datapoint"] > cost["off_ms_per_datapoint"] > 0
