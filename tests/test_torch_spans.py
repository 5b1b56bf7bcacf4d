"""The port's span and counter recorder (``upsp_tpu_torch.utils.timing``)
and the spans the pipeline records, on the CPU.

- The recorder: nesting and parents, a parent stack a thread, the
  datapoint's identifier carried to another thread, a clock's stage spans
  adopting what ran inside them, self time, counters a datapoint, one
  recording at a time, and a stress of threads on one recording.
- Off: ``span`` is one shared no-op, nothing is recorded and neither
  ``span`` nor ``count`` allocates.
- ``run_datapoint`` through the video files (2 cameras, 96x128 12-bit
  ``.mraw``, 12 frames in chunks of 5), fft and identity starts: the span
  tree under one datapoint identifier, the prefetch threads' reads, the
  children of phase 1 covering at least 90% of its frames' time, each
  stage span equal to its ``stage_times`` entry within 1 ms, the walk's
  ``stage_times`` readings equal to its spans and counters, the counts,
  and the same intensities as without a recording.
- Under ``torch.profiler`` (CPU), a span around a torch op holds the op's
  event once mapped through the ``upsp.clock`` anchor.
- The mesh path on two gloo ranks records phase 1's names on each rank.
"""

import json
import os
import subprocess
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from upsp_tpu_torch.parallel.launcher import run_local_ranks
from upsp_tpu_torch.pipeline.config import read_input_deck
from upsp_tpu_torch.pipeline.run import run_datapoint
from upsp_tpu_torch.pipeline.synthetic import write_datapoint
from upsp_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES, CHUNK = 12, 5
STAGES = ("phase0", "phase1_setup", "phase1", "phase2", "outputs")
WALK = ("phase0.walk", "phase0.walk_recheck", "phase0.walk_rechecked")  # run_phase0's
PHASE1 = ("phase1.ingest_wait", "phase1.stage", "phase1.program", "phase1.fetch",
          "phase1.store")


# -- the recorder ------------------------------------------------------------------


def test_nesting_parents_and_self_time():
    with timing.recording() as rec:
        with timing.span("a"):
            with timing.span("b"):
                time.sleep(0.002)
            with timing.span("c"):
                with timing.span("d"):
                    pass
        with timing.span("e"):
            pass
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["b", "d", "c", "a", "e"]  # as they end
    assert by["a"].parent is None and by["e"].parent is None
    assert by["b"].parent == by["c"].parent == by["a"].id
    assert by["d"].parent == by["c"].id
    assert {s.thread for s in rec.spans} == {threading.get_ident()}
    assert {s.datapoint for s in rec.spans} == {None}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    a = by["a"]
    assert rec.children(a) == [by["b"], by["c"]]
    kids = (by["b"].end_ns - by["b"].start_ns) + (by["c"].end_ns - by["c"].start_ns)
    assert rec.self_ns(a) == a.end_ns - a.start_ns - kids
    assert rec.self_ns(by["b"]) == by["b"].end_ns - by["b"].start_ns
    assert rec.total_ns("b", None) >= 2_000_000


def test_threads_and_datapoints():
    """Each thread nests on its own stack; ``carry`` gives a thread the
    caller's datapoint, whose spans have no parent there."""

    @timing.datapoint
    def work(tag):
        with timing.span("outer"):
            timing.count("things", 2)
            t = threading.Thread(target=timing.carry(read))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        return tag

    def read():
        with timing.span("read"):
            with timing.span("inner"):
                timing.count("things")

    with timing.recording() as rec:
        assert work("x") == "x" and work("y") == "y"
    assert rec.datapoints() == [0, 1]
    for d in (0, 1):
        spans = {s.name: s for s in rec.of(d)}
        assert set(spans) == {"datapoint", "outer", "read", "inner"}
        assert spans["outer"].parent == spans["datapoint"].id
        assert spans["read"].parent is None and spans["read"].thread != spans["outer"].thread
        assert spans["inner"].parent == spans["read"].id
        assert rec.counter("things", d) == 3
    assert work("z") == "z"  # no recording: the plain call


def test_clock_stages_adopt_their_spans():
    """A clock with ``spans`` records its stages under the datapoint, each
    over what ran since the previous point; a split is a part of the stage
    the next point ends; ``times`` holds the same readings."""
    times = {}

    @timing.datapoint
    def run():
        clock = timing.StageClock(enabled=False, times=times, spans=True)
        with timing.span("p0.part"):
            pass
        clock.point("phase0")
        with timing.span("p1.setup"):
            pass
        clock.split("phase1_setup")
        with timing.span("p1.loop"):
            pass
        clock.point("phase1")
        timing.StageClock(enabled=False).point("other")  # no spans: not recorded

    with timing.recording() as rec:
        run()
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"datapoint", "p0.part", "phase0", "p1.setup", "phase1_setup",
                       "p1.loop", "phase1"}
    root = by["datapoint"].id
    assert by["phase0"].parent == root and by["phase1"].parent == root
    assert by["p0.part"].parent == by["phase0"].id
    assert by["phase1_setup"].parent == by["phase1"].id
    assert by["p1.setup"].parent == by["phase1_setup"].id
    assert by["p1.loop"].parent == by["phase1"].id
    assert by["phase0"].end_ns == by["phase1"].start_ns == by["phase1_setup"].start_ns
    for name in ("phase0", "phase1_setup", "phase1"):
        s = by[name]
        assert abs((s.end_ns - s.start_ns) / 1e9 - times[name]) < 1e-6


def test_one_recording_at_a_time():
    with timing.recording():
        assert timing.span("a") is not timing.span("a")
        with pytest.raises(RuntimeError):
            with timing.recording():
                pass
    assert timing.span("a") is timing.span("b")


def test_threads_stress():
    """More threads than cores on one recording with a short switch
    interval: no span or count is lost and each thread's spans nest."""
    n_threads, n_each = 4 * (os.cpu_count() or 2), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                with timing.span("outer"):
                    with timing.span("inner"):
                        timing.count("n")

        with timing.recording() as rec:
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(rec.spans) == 2 * n_threads * n_each
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer" and by_id[s.parent].thread == s.thread
        else:
            assert s.parent is None
    assert rec.counter("n", None) == n_threads * n_each


def test_off_records_and_allocates_nothing():
    assert timing.span("a") is timing.span("b")
    assert timing.count("a", 3) is None
    assert timing.carry(test_off_records_and_allocates_nothing) is (
        test_off_records_and_allocates_nothing)
    span, count = timing.span, timing.count
    for _ in range(10):  # warm
        with span("x"):
            count("y", 1)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(5000):
            with span("x"):
                count("y", 1)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, timing.__file__)]
    grown = after.filter_traces(only).compare_to(before.filter_traces(only), "lineno")
    assert sum(d.count_diff for d in grown) == 0 and sum(d.size_diff for d in grown) == 0


# -- the pipeline's spans ----------------------------------------------------------


@pytest.fixture(scope="module")
def datapoints(tmp_path_factory):
    """Per start: (recording, stage_times, intensity, intensity without a
    recording)."""
    root = str(tmp_path_factory.mktemp("spans"))
    dp = write_datapoint(root, n_frames=N_FRAMES, n_distinct=N_FRAMES, seed=4,
                         max_shift_px=1.0)
    out = {}
    for mode, start in (("fft", "fft"), ("identity", False)):
        def run(st):
            return run_datapoint(read_input_deck(dp["deck"]), device="cpu",
                                 write_outputs=False, stage_times=st,
                                 frames_per_chunk=CHUNK, warm_start=start).intensity

        plain = run({})
        st = {}
        with timing.recording() as rec:
            got = run(st)
        out[mode] = (rec, st, got, plain)
    return out


@pytest.mark.parametrize("mode", ["fft", "identity"])
def test_datapoint_span_tree(datapoints, mode):
    rec, st, got, plain = datapoints[mode]
    assert rec.datapoints() == [0]
    assert {s.datapoint for s in rec.spans} == {0}
    by_id = {s.id: s for s in rec.spans}
    root, = rec.of(0, "datapoint")
    stage = {s.name: s for s in rec.spans if s.name in STAGES}
    assert set(stage) == set(STAGES) and set(st) == set(STAGES) | set(WALK)
    for name in ("phase0", "phase1", "phase2", "outputs"):
        assert stage[name].parent == root.id
    assert stage["phase1_setup"].parent == stage["phase1"].id

    def parent(s):
        return by_id[s.parent].name if s.parent is not None else None

    want = {"phase0.inputs": "phase0", "phase0.model": "phase0", "phase0.walk": "phase0",
            "phase0.patches": "phase0", "phase0.weights": "phase0",
            "phase0.walk.recheck": "phase0.walk",
            "phase1.processor": "phase1_setup", "phase1.params": "phase1.processor",
            "phase2.host_stats": "phase2", "phase2.coverage": "phase2",
            "phase2.upload": "phase2", "phase2.device": "phase2",
            "phase2.download": "phase2"}
    want.update({n: "phase1" for n in PHASE1})
    if mode == "identity":
        want["phase1.gn_sync"] = "phase1.program"
    names = {s.name for s in rec.spans}
    assert names == set(want) | set(STAGES) | {"datapoint", "ingest.read"}
    for s in rec.spans:
        if s.name in want:
            assert parent(s) == want[s.name], s
        if s.name == "ingest.read":
            assert s.parent is None and s.thread != root.thread
    assert len(rec.of(0, "phase0.walk")) == 2  # a camera each
    assert len(rec.of(0, "phase0.walk.recheck")) == 2
    chunks = -(-N_FRAMES // CHUNK)
    for n in PHASE1:
        assert len(rec.of(0, n)) == chunks, n
    assert len(rec.of(0, "ingest.read")) == 2 * chunks


@pytest.mark.parametrize("mode", ["fft", "identity"])
def test_datapoint_stage_spans_and_coverage(datapoints, mode):
    rec, st, got, plain = datapoints[mode]
    stage = {s.name: s for s in rec.spans if s.name in STAGES}
    for name in STAGES:
        s = stage[name]
        assert abs((s.end_ns - s.start_ns) / 1e9 - st[name]) < 1e-3, name
    p1, lo = stage["phase1"], stage["phase1_setup"].end_ns
    kids = [k for k in rec.children(p1) if k.name != "phase1_setup"]
    assert timing.covered_ns(kids, lo, p1.end_ns) >= 0.9 * (p1.end_ns - lo)


@pytest.mark.parametrize("mode", ["fft", "identity"])
def test_datapoint_walk_readings(datapoints, mode):
    """``stage_times``' walk readings are the walk's spans and counters,
    read off the same clock."""
    rec, st, got, plain = datapoints[mode]

    def seconds(name):
        total = 0.0
        for s in rec.of(0, name):
            total += (s.end_ns - s.start_ns) / 1e9
        return total

    assert st["phase0.walk"] == seconds("phase0.walk") > 0
    assert st["phase0.walk_recheck"] == seconds("phase0.walk.recheck")
    c = rec.counters[0]
    assert st["phase0.walk_rechecked"] == float(c["walk.rechecked"])
    assert 0 <= c["walk.recovered"] <= c["walk.rechecked"]


@pytest.mark.parametrize("mode", ["fft", "identity"])
def test_datapoint_counts_and_outputs(datapoints, mode):
    rec, st, got, plain = datapoints[mode]
    c = rec.counters[0]
    assert c["frames.phase1"] == N_FRAMES
    assert c["frames.decoded"] == 2 * N_FRAMES
    if mode == "identity":
        assert c["gn.steps"] == len(rec.of(0, "phase1.gn_sync")) > 0
        assert c["gn.lane_steps"] >= c["gn.steps"]
    else:
        assert "gn.steps" not in c
    # no card: every Gauss-Newton update is the host's twin
    assert c["gn.update.host"] > 0 and "gn.update.kernel" not in c
    # no card: nothing crosses a bus and no host waits on a device
    assert not [k for k in c if k.startswith(("host_syncs.", "bytes."))]
    np.testing.assert_array_equal(got, plain)


# -- the profiler's clock ----------------------------------------------------------


def test_span_holds_its_op_on_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile

    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.recording() as rec:
            time.sleep(0.01)
            with timing.span("around"):
                time.sleep(0.005)
                torch.mm(a, b)
                time.sleep(0.005)
    assert rec.anchor_ns < rec.anchor_end_ns
    events = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
              for e in prof.profiler.kineto_results.events()]
    clock = [(s, e) for n, s, e in events if n == timing.CLOCK]
    mm = [(s, e) for n, s, e in events if n == "aten::mm"]
    assert len(clock) == 2 and len(mm) == 1  # an empty range, then the recording's
    (s0, e0), sp = max(clock, key=lambda c: c[1] - c[0]), rec.spans[0]

    def mapped(ns):
        return s0 + (ns - rec.anchor_ns) * (e0 - s0) / (rec.anchor_end_ns - rec.anchor_ns)

    assert mapped(sp.start_ns) <= mm[0][0] and mm[0][1] <= mapped(sp.end_ns)


# -- the mesh path -----------------------------------------------------------------

_RANK = r"""
import json, sys
from upsp_tpu_torch.parallel.launcher import initialize_distributed
from upsp_tpu_torch.pipeline.config import read_input_deck
from upsp_tpu_torch.pipeline.run import run_datapoint
from upsp_tpu_torch.utils import timing
import torch.distributed as dist

deck, out = sys.argv[1], sys.argv[2]
initialize_distributed(timeout_s=120)
with timing.recording() as rec:
    run_datapoint(read_input_deck(deck), device="cpu", write_outputs=False,
                  frames_per_chunk=4, mesh="auto")
with open(out % dist.get_rank(), "w") as fh:
    json.dump({"names": sorted({s.name for s in rec.spans}),
               "frames": rec.counter("frames.phase1", 0)}, fh)
dist.destroy_process_group()
"""


def test_mesh_records_phase1_spans(tmp_path):
    dp = write_datapoint(str(tmp_path), n_frames=8, n_distinct=8, seed=5,
                         max_shift_px=0.4)
    out = str(tmp_path / "rank%d.json")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    with open(tmp_path / "ranks.log", "w") as fh:
        rcs = run_local_ranks([sys.executable, "-c", _RANK, dp["deck"], out], 2,
                              timeout_s=240, env=env, stdout=fh,
                              stderr=subprocess.STDOUT)
    assert rcs == [0, 0], (tmp_path / "ranks.log").read_text()
    ranks = [json.loads(open(out % r).read()) for r in (0, 1)]
    for r, got in enumerate(ranks):
        assert set(PHASE1) - {"phase1.store"} | {"phase1.exchange"} <= set(got["names"])
        assert ("phase1.store" in got["names"]) == (r == 0)  # rank 0 keeps the rows
        assert {"phase2.stats", "phase2.coverage", "phase2.download",
                "phase2.device"} <= set(got["names"])
    assert sum(g["frames"] for g in ranks) == 8
