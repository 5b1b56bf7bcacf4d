"""Timing on one NVIDIA GPU (port of ``tools/benchlib.py``).

PyTorch enqueues device work and returns before the card has done it, so a
host clock around a call measures the enqueue.  Every stream of calls here
ends in ``torch.cuda.synchronize()`` before the clock stops.

:func:`per_call_seconds` keeps the JAX tool's two-rep-count difference:
R independent calls are enqueued round-robin over distinct input buffers
and the stream is synchronized once at its end; two rep counts are timed
and differenced,

    per_call = (t(R2) - t(R1)) / (R2 - R1)

which cancels the warm-up, the final synchronize and the host's lag
behind the card at the stream's start.  It is also the number a run
that keeps several chunks in flight sees.  Every tool takes ``--device`` (default ``cuda``) and
raises without CUDA unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, List, Sequence

import torch


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu, which "
                         "runs the kernels' plain twins")


def resolve_device(name: str) -> torch.device:
    """The device a tool runs on; ``cuda`` raises without CUDA (no silent
    fall-back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run the "
                           "kernels' plain twins on the CPU")
    return device


def card() -> str:
    """The card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    reports them (its first line), or why there is none."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "nvidia-smi unavailable"


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def sync(out=None) -> None:
    """Wait for the card where ``out`` (or, with None, any tensor) may live."""
    t = _first_tensor(out)
    if t is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def force_fetch(out) -> float:
    """One element of (the first tensor of) ``out`` on the host, after the
    card has finished."""
    sync(out)
    return float(_first_tensor(out).reshape(-1)[0].item())


def run_stream(fn: Callable, inputs: Sequence, reps: int) -> None:
    """Enqueue ``reps`` calls round-robin over ``inputs``, then wait for
    the card."""
    out = None
    for i in range(reps):
        out = fn(inputs[i % len(inputs)])
    sync(out)


def trial_seconds(fn: Callable, inputs: Sequence, r1: int = 2, r2: int = 8,
                  trials: int = 3) -> List[float]:
    """Per-call seconds of ``fn`` by the two-rep-count difference, one per
    trial (after one warm-up stream of ``r1`` calls)."""
    run_stream(fn, inputs, r1)
    out = []
    for _ in range(trials):
        t0 = time.perf_counter()
        run_stream(fn, inputs, r1)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_stream(fn, inputs, r2)
        t2 = time.perf_counter() - t0
        out.append((t2 - t1) / (r2 - r1))
    return out


def per_call_seconds(fn: Callable, inputs: Sequence, r1: int = 2, r2: int = 8,
                     trials: int = 3) -> float:
    """Amortized per-call wall time of ``fn`` (min over trials)."""
    return min(trial_seconds(fn, inputs, r1, r2, trials))


def chained_cost(make_fn: Callable[[int], Callable], inputs: Sequence, k1: int,
                 k2: int, reps: int = 4, trials: int = 3) -> float:
    """Marginal cost of one application of an op in a chain.

    ``make_fn(K)`` returns a callable that applies the op K times, each
    application reading the previous one's output from device memory.
    Cost = (t(K2) - t(K1)) / (K2 - K1), each t amortized over ``reps``
    calls with one synchronize at the end (min over trials)."""
    f1, f2 = make_fn(k1), make_fn(k2)
    run_stream(f1, inputs, reps)
    run_stream(f2, inputs, reps)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        run_stream(f1, inputs, reps)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_stream(f2, inputs, reps)
        t2 = time.perf_counter() - t0
        best = min(best, (t2 - t1) / (k2 - k1) / reps)
    return best

