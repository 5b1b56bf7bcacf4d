"""Device-memory rate probes: what one pass over the frames costs on the
card (port of ``tools/bench_hbm.py``).

    python -m upsp_tpu_torch.tools.bench_hbm [--reps 5] [--hw 1024,1024]
        [--batch 8] [--device cuda|cpu]

Each probe applies one pass K times, each pass reading the last one's
output from device memory, and :func:`benchlib.chained_cost` differences
two loop lengths K1 < K2 (each stream ended by
``torch.cuda.synchronize()``, the best of ``--reps`` trials):

    per pass = (t(K2) - t(K1)) / (K2 - K1)

which cancels the launch floor and the final wait, as the JAX tool's two
``fori_loop`` lengths do.  GB/s is the bytes a pass must move (each input
read once, the output written once) over that time.  The probes, with the
JAX tool's shapes and loop lengths at the default ``--hw``/``--batch``:

- ``copy r+w``: ``v * 1.000001``, one read and one write;
- ``axpy 2r+1w``: ``torch.add(y, v, alpha=1.000001)``, one kernel;

on a flat frame (4 MB), on the batch (8 x 1 MP, 34 MB) and on 8 batches
(268 MB), then at the working shape

- ``gaussian3 separable``: K1 (``ecc_kernels.blur``, 3 taps), one pass:
  it reads and writes the frames once (the JAX tool assumed two passes of
  XLA's separable form);
- ``warp order2``: K2 (``ecc_kernels.warp_affine_banded``), the frame
  program's warp (``warp_affine_mxu``, its TPU form, is not ported).

Ends with one JSON line: each probe's us a pass and GB/s, the best GB/s,
and the rate the kernels' bounds assume (``chip_smoke.HBM_BYTES_PER_S``,
3.35 TB/s, the H100 SXM data sheet) beside it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from upsp_tpu_torch.tools import benchlib
from upsp_tpu_torch.tools.bench import parse_pair

ASSUMED_GBS = 3350.0  # the H100 SXM data sheet's 3.35 TB/s
WARP = ((1.0, 1e-4, 0.3), (-1e-4, 1.0, -0.2))
BLUR_LABEL = "gaussian3 separable ({} x {}, K1: one pass)"
WARP_LABEL = "warp order2 ({} x {}, K2)"
BLUR_LOOPS, WARP_LOOPS = (16, 128), (8, 64)  # tools/bench_hbm.py:131, 147


def _mp(hw) -> str:
    n = hw[0] * hw[1]
    return "1 MP" if n == 1 << 20 else f"{hw[0]}x{hw[1]}"


def plan(hw, batch: int):
    """(shape, label, K1, K2) of the elementwise probes
    (tools/bench_hbm.py:73-77 at 1024x1024 and a batch of 8)."""
    n = hw[0] * hw[1]
    shapes = [(n,), (batch,) + tuple(hw), (8 * batch,) + tuple(hw)]
    loops = [(64, 1024), (32, 512), (16, 128)]
    labels = [f"flat {n * 4 // 2**20} MB",
              f"batched {batch} x {_mp(hw)} ({round(batch * n * 4 / 1e6)} MB)",
              f"batched {8 * batch} x {_mp(hw)} ({round(8 * batch * n * 4 / 1e6)} MB)"]
    return [(s, lab, k1, k2) for s, lab, (k1, k2) in zip(shapes, labels, loops)]


def make_inputs(hw, batch: int):
    """The JAX tool's arrays in its draw order from ``default_rng(0)``
    (tools/bench_hbm.py:70-100, 118-120): x then y of each elementwise
    shape, then the working frames N(2000, 200), on the host."""
    rng = np.random.default_rng(0)
    pairs = []
    for shape, _, _, _ in plan(hw, batch):
        x = rng.normal(size=shape).astype(np.float32)
        y = rng.normal(size=shape).astype(np.float32)
        pairs.append((x, y))
    frames = rng.normal(2000, 200, (batch,) + tuple(hw)).astype(np.float32)
    return pairs, frames


def looped(step, k: int):
    def fn(args):
        v, rest = args[0], args[1:]
        for _ in range(k):
            v = step(v, *rest)
        return v

    return fn


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--hw", default="1024,1024")
    ap.add_argument("--batch", type=int, default=8)
    benchlib.add_device_arg(ap)
    return ap


def run(argv=None) -> dict:
    from upsp_tpu_torch.ops import ecc_kernels as K

    args = parser().parse_args(argv)
    device = benchlib.resolve_device(args.device)
    hw, b = parse_pair(args.hw), args.batch
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"backend=torch {torch.__version__} device={name}", flush=True)
    probes = {}

    def report(label, make_step, args_, k1, k2, nbytes):
        cost = benchlib.chained_cost(lambda k: looped(make_step, k), [args_], k1, k2,
                                     reps=1, trials=args.reps)
        gbs = nbytes / cost / 1e9
        probes[label] = {"us_per_pass": round(cost * 1e6, 3), "gb_per_s": round(gbs, 2)}
        print(f"{label:42s} {cost * 1e6:9.1f} us/pass  {gbs:7.1f} GB/s", flush=True)

    pairs, frames = make_inputs(hw, b)
    for (shape, label, k1, k2), (x, y) in zip(plan(hw, b), pairs):
        x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        nbytes = x.numel() * 4
        report(f"copy r+w ({label})", lambda v: v * 1.000001, (x,), k1, k2, 2 * nbytes)
        report(f"axpy 2r+1w ({label})", lambda v, y: torch.add(y, v, alpha=1.000001),
               (x, y), k1, k2, 3 * nbytes)
        del x, y
    x = torch.from_numpy(frames).to(device)
    nbytes = x.numel() * 4
    warp = torch.tensor(WARP, dtype=torch.float32, device=device).expand(b, 2, 3).contiguous()
    taps3 = K.filter_taps("gaussian", 3)
    report(BLUR_LABEL.format(b, _mp(hw)), lambda v: K.blur(v, taps3), (x,), *BLUR_LOOPS,
           2 * nbytes)
    report(WARP_LABEL.format(b, _mp(hw)), K.warp_affine_banded, (x, warp), *WARP_LOOPS,
           2 * nbytes)
    best = max(p["gb_per_s"] for p in probes.values())
    print(f"best {best:.1f} GB/s against the {ASSUMED_GBS:.0f} GB/s the kernels' "
          f"bounds assume ({best / ASSUMED_GBS:.3f})", flush=True)
    return {
        "config": {"hw": list(hw), "batch": b, "reps": args.reps},
        "probes": probes,
        "best_gb_per_s": best,
        "assumed_gb_per_s": ASSUMED_GBS,
        "best_over_assumed": round(best / ASSUMED_GBS, 4),
        "device": name,
        "card": benchlib.card(),
    }


def main(argv=None) -> None:
    print(json.dumps(run(argv)), flush=True)


if __name__ == "__main__":
    main()
