"""Scope timers, pipeline stage checkpoints, spans and counters, and
device traces.

Port of ``upsp_tpu/utils/timing.py``.  ``StageClock`` is the reference's
timedBarrierPoint (psp_process.cpp:583-606): every stage records its
total elapsed and since-previous seconds, and on multi-rank runs the
wait at the barrier separately (the load-imbalance signal).
``BlockTimer`` (a copy) is the reference's psp::BlockTimer
(cpp/include/utils/pspTimer.h); :func:`trace` records device work with
``torch.profiler`` where the JAX package uses ``jax.profiler``.

Spans and counters (the port's own; the JAX package has none): the
pipeline marks its parts with ``with span(name):`` and counts its host
syncs, copies and frames with ``count(name, n)``.  Both do nothing unless
a :func:`recording` is open, which keeps them in memory, each span with
its parent, its thread and the datapoint it belongs to (each call of a
function decorated with :func:`datapoint` is one).  Off, ``span``
returns one shared no-op context manager and ``count`` returns at once.
:func:`timed` is a span whose seconds the caller reads after the block,
recording or not, from the span's own clock readings.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import sys
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

log = logging.getLogger("upsp_tpu.timing")

CLOCK = "upsp.clock"  # the profiler range that anchors a recording's clock


class Span(NamedTuple):
    """One recorded span: ``time.perf_counter_ns()`` at its start and end;
    ``parent`` is the id of the span it ran inside (None at the top of its
    thread), ``datapoint`` the identifier of its datapoint (None outside
    one)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int
    datapoint: Optional[int]


class Recording:
    """The spans (in the order they ended) and the counters
    (datapoint -> name -> count) of one :func:`recording`.
    ``anchor_ns``, ``anchor_end_ns``: ``perf_counter_ns()`` as the
    recording's ``upsp.clock`` profiler range began and ended (None
    without a profiler); the range's start and end on the profiler's
    timeline map a span onto it."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[Optional[int], Dict[str, int]] = {}
        self.anchor_ns: Optional[int] = None
        self.anchor_end_ns: Optional[int] = None
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._datapoints = itertools.count()

    def _next_id(self) -> int:
        with self._lock:
            return next(self._ids)

    def _add(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def _count(self, datapoint: Optional[int], name: str, n: int) -> None:
        with self._lock:
            c = self.counters.setdefault(datapoint, {})
            c[name] = c.get(name, 0) + n

    def enclose(self, name: str, start_ns: int, end_ns: int, since: int = 0) -> Span:
        """Record a span that began before its end was known (a stage ended
        by a clock point): its parent is the span open on this thread, and
        it adopts the spans of this thread under that parent that ended
        after index ``since`` and began at or after ``start_ns``."""
        stack = _stack()
        parent = stack[-1] if stack else None
        tid = threading.get_ident()
        with self._lock:
            span = Span(next(self._ids), name, start_ns, end_ns, parent, tid,
                        getattr(_local, "datapoint", None))
            for i in range(since, len(self.spans)):
                s = self.spans[i]
                if s.parent == parent and s.thread == tid and s.start_ns >= start_ns:
                    self.spans[i] = s._replace(parent=span.id)
            self.spans.append(span)
        return span

    def datapoints(self) -> List[int]:
        """The datapoints' identifiers, in the order they began."""
        return sorted({s.datapoint for s in self.spans if s.name == "datapoint"})

    def of(self, datapoint: Optional[int], name: Optional[str] = None) -> List[Span]:
        """The spans of ``datapoint`` (named ``name``, when given)."""
        return [s for s in self.spans if s.datapoint == datapoint
                and (name is None or s.name == name)]

    def total_ns(self, name: str, datapoint: Optional[int]) -> int:
        """The summed durations of the spans ``name`` of ``datapoint``."""
        return sum(s.end_ns - s.start_ns for s in self.of(datapoint, name))

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id]

    def self_ns(self, span: Span) -> int:
        """``span``'s duration less the part its children cover."""
        return (span.end_ns - span.start_ns
                - covered_ns(self.children(span), span.start_ns, span.end_ns))

    def counter(self, name: str, datapoint: Optional[int]) -> int:
        return self.counters.get(datapoint, {}).get(name, 0)


def covered_ns(spans, lo: int, hi: int) -> int:
    """The nanoseconds of [``lo``, ``hi``) that the union of ``spans``
    covers."""
    covered, reach = 0, lo
    for s, e in sorted((max(x.start_ns, lo), min(x.end_ns, hi)) for x in spans):
        s = max(s, reach)
        if e > s:
            covered += e - s
            reach = e
    return covered


_local = threading.local()  # per thread: the open spans' ids, the datapoint
_recording: Optional[Recording] = None


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


_OFF = contextlib.nullcontext()  # the span of a process that is not recording


class _On:
    __slots__ = ("rec", "name", "id", "parent", "start", "end")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = self.rec._next_id()
        stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        _stack().pop()
        self.rec._add(Span(self.id, self.name, self.start, self.end, self.parent,
                           threading.get_ident(), getattr(_local, "datapoint", None)))
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class _Clock:
    """:class:`_On`'s readings without a recording."""

    __slots__ = ("start", "end")

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        return False

    seconds = _On.seconds


def span(name: str):
    """A context manager that records ``name`` from its entry to its exit
    while a recording is open; the shared no-op otherwise."""
    rec = _recording
    if rec is None:
        return _OFF
    return _On(rec, name)


def timed(name: str):
    """:func:`span` ``name`` whose ``seconds`` the caller reads after the
    block, recorded or not: the span and the reading are the same two
    clock readings."""
    rec = _recording
    return _Clock() if rec is None else _On(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the current datapoint while a
    recording is open."""
    rec = _recording
    if rec is not None:
        rec._count(getattr(_local, "datapoint", None), name, n)


@contextlib.contextmanager
def recording():
    """Record spans and counters in memory until the block ends; yields
    the :class:`Recording`.  Under an active ``torch.profiler`` the block
    runs inside one ``record_function("upsp.clock")`` range whose start
    and end are ``anchor_ns`` and ``anchor_end_ns``, each read just
    before the profiler stamps it (after an empty ``upsp.clock`` range:
    the first range of a process is stamped late).  One recording at a
    time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    anchor = None
    torch = sys.modules.get("torch")
    if torch is not None and torch.autograd.profiler._is_profiler_enabled:
        with torch.autograd.profiler.record_function(CLOCK):
            pass
        anchor = torch.autograd.profiler.record_function(CLOCK)
        rec.anchor_ns = time.perf_counter_ns()
        anchor.__enter__()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
        if anchor is not None:
            rec.anchor_end_ns = time.perf_counter_ns()
            anchor.__exit__(None, None, None)


def datapoint(fn: Callable) -> Callable:
    """Decorator: while a recording is open, each call of ``fn`` is one
    datapoint, with an identifier of its own and a root span
    ``"datapoint"`` over the call."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        rec = _recording
        if rec is None:
            return fn(*args, **kwargs)
        outer = getattr(_local, "datapoint", None)
        with rec._lock:
            _local.datapoint = next(rec._datapoints)
        try:
            with _On(rec, "datapoint"):
                return fn(*args, **kwargs)
        finally:
            _local.datapoint = outer

    return call


def carry(fn: Callable) -> Callable:
    """``fn`` to run on another thread as part of this thread's datapoint
    (its spans and counts carry the datapoint's identifier); ``fn`` itself
    when not recording."""
    if _recording is None:
        return fn
    dp = getattr(_local, "datapoint", None)

    def run(*args, **kwargs):
        _local.datapoint = dp
        return fn(*args, **kwargs)

    return run


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

    With ``spans``, while a recording is open, each point and split also
    records its stage as a span from the previous point to its own
    reading, adopting the spans that ran inside it
    (:meth:`Recording.enclose`): stage spans and ``times`` are the same
    readings.
    """

    def __init__(self, barrier: Optional[Callable[[], None]] = None,
                 enabled: bool = True,
                 sync: Optional[Callable[[], None]] = None,
                 times: Optional[dict] = None, spans: bool = False):
        self.t_start = time.perf_counter()
        self.t_prev = self.t_start
        self.barrier = barrier
        self.enabled = enabled
        self.sync = sync
        self.times = times
        self.records: List[Tuple[str, float, float, float]] = []
        self.spans = spans
        self._since = len(_recording.spans) if spans and _recording is not None else 0

    def _enclose(self, label: str, t_end: float, stage_ends: bool) -> None:
        rec = _recording
        if self.spans and rec is not None:
            rec.enclose(label, round(self.t_prev * 1e9), round(t_end * 1e9), self._since)
            if stage_ends:
                self._since = len(rec.spans)

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
        self._enclose(label, t_after, stage_ends=True)
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
        t = time.perf_counter()
        if self.times is not None:
            self.times[label] = t - self.t_prev
        self._enclose(label, t, stage_ends=False)


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
