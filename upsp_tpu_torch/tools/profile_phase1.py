"""Device time by kernel of the production chunk program on one card (port
of ``tools/profile_phase1.py``).

    python -m upsp_tpu_torch.tools.profile_phase1 [--dtype float32]
        [--frames 32] [--mode fft] [--hw 1024,1024] [--cams 1]
        [--grid 160,128] [--reps 8] [--top 40] [--logdir DIR]
        [--device cuda|cpu]

Inputs as ``bench``: ``--frames`` frames tiled from 8 distinct jittered
ones, 3 device buffers offset by ``i * 1e-3``.  Two chunks run outside the
window (warm-up), then ``--reps`` chunks run inside a
``torch.profiler.profile(activities=[CPU, CUDA])`` window
(``utils.timing.trace``, which writes the Chrome trace ``trace.json``
into ``--logdir``; without it, into a temporary directory removed at
the end), after one small kernel that opens the profiler's
device tracing (CUPTI can miss the first kernels after it starts).
From the profiler's events it prints the total device time a frame and
the window's wall time a frame -- their quotient
is the card's busy share (the profiler's own host cost is inside the
window, so the share is a lower bound) -- then the kernels by self device
time: us a frame, % of device time, launches a chunk, and the K-number
where the name is one of ``csrc/*.cu``'s kernels, and the device time and
launches of the matrix products (cuBLAS, CUTLASS).  It holds the profiler's
launches of each of those kernels against the wrappers' launch counts
(``ops.cuda_lib.launch_counts``) over the same window, and ends with one
JSON line.

If the profiler records no device time it raises: no other clock's
number is printed under this tool's name.  With ``--device cpu`` it
prints the host ops by self CPU time instead (no device number).
"""

from __future__ import annotations

import argparse
import json
import re
import tempfile
import time
from typing import Dict, List, Tuple

import torch

from upsp_tpu_torch.tools import benchlib
from upsp_tpu_torch.tools.bench import WARM, bench_inputs, parse_pair

# csrc/*.cu's kernels -> (the TPU kernel they replace, the launch counts of
# ops.cuda_lib that launch them once each)
KERNELS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "blur_kernel": ("K1", ("blur", "blur_bf16")),
    "warp_kernel": ("K2", ("warp", "warp_bf16")),
    "moments_kernel": ("K3", ("moments", "moments_bf16", "moments_update",
                              "moments_update_bf16")),
    "moments_reduce_kernel": ("K3", ("moments", "moments_bf16", "moments_update",
                                     "moments_update_bf16", "gn_fused",
                                     "gn_fused_bf16")),
    "warp_filter_kernel": ("K4", ("warp_filter", "warp_filter_bf16")),
    "gather_kernel": ("K5", ("gather", "gather_bf16")),
    "hot_scan_kernel": ("K6", ("hot",)),
    "hot_repair_kernel": ("K6", ("hot",)),
    "unpack12_kernel": ("K7", ("unpack12",)),
    "unpack10_kernel": ("K8", ("unpack10",)),
    "gn_fused_kernel": ("K9", ("gn_fused", "gn_fused_bf16")),
    "pool_kernel": ("K10", ("pool", "pool_bf16")),
}
# a cuBLAS or CUTLASS matrix product's kernel
GEMM_RE = re.compile(r"gemm|xmma|cutlass", re.IGNORECASE)
# a kernel's name in a demangled ("ns::blur_kernel<float, 2>(...)") or
# mangled ("...11blur_kernelIfLi2EE...") symbol
_KERNEL_RE = re.compile(r"(?<![A-Za-z_])(" + "|".join(KERNELS) + r")(?![a-z0-9_])")
N_BUFFERS = 3


def kernel_of(name: str):
    """The ``csrc/*.cu`` kernel a profiler row names, or None."""
    m = _KERNEL_RE.search(name)
    return m.group(1) if m else None


def op_table(events, device: bool = True) -> List[Tuple[str, float, int]]:
    """[(name, self us, count)] of a profile's ``key_averages()``,
    descending by self time: the device rows (kernels, copies, sets) with
    ``device``, else the host ops.  Raises when device rows are asked for
    and the profiler recorded no device time."""
    rows = []
    for e in events:
        on_host = e.device_type == torch.autograd.DeviceType.CPU
        if device and not on_host:
            rows.append((e.key, float(e.self_device_time_total), int(e.count)))
        elif not device and on_host:
            rows.append((e.key, float(e.self_cpu_time_total), int(e.count)))
    rows.sort(key=lambda r: -r[1])
    if device and sum(r[1] for r in rows) <= 0:
        raise RuntimeError("the profiler recorded no device time in the window "
                           "(CUPTI saw no kernel); no device profile to report")
    return rows


def kernel_launches(rows) -> Dict[str, int]:
    """Launches of each ``csrc/*.cu`` kernel in the table's rows."""
    out = {k: 0 for k in KERNELS}
    for name, _, count in rows:
        k = kernel_of(name)
        if k is not None:
            out[k] += count
    return out


def expected_launches(counts: dict) -> Dict[str, int]:
    """The launches of each ``csrc/*.cu`` kernel that the wrappers' counts
    imply (one wrapper call launches each of its kernels once)."""
    return {k: sum(counts.get(c, 0) for c in names)
            for k, (_, names) in KERNELS.items()}


def capture(fn, inputs, reps: int, logdir: str):
    """Warm up outside the window, then ``reps`` chunks inside it:
    (key_averages, window wall seconds, wrapper launch counts in it)."""
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.utils.timing import trace

    benchlib.run_stream(fn, inputs, 2)
    before = cuda_lib.launch_counts()
    with trace(logdir) as prof:
        if inputs[0].is_cuda:
            # CUPTI can miss the first kernels after the profiler starts:
            # one small kernel, waited for, before the window opens
            torch.ones(1, device=inputs[0].device).add_(1)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        benchlib.run_stream(fn, inputs, reps)
        wall = time.perf_counter() - t0
    after = cuda_lib.launch_counts()
    counts = {k: after[k] - before.get(k, 0) for k in after}
    return prof.key_averages(), wall, counts


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", default="1024,1024")
    ap.add_argument("--grid", default="160,128")
    ap.add_argument("--cams", type=int, default=1)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--frame-batch", type=int, default=8)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--mode", default="fft", choices=list(WARM))
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--logdir", default=None)
    benchlib.add_device_arg(ap)
    return ap


def run(argv=None, state=None) -> dict:
    """Print the table and return the summary; ``state``: a phase-0 state
    to use instead of the synthetic one of ``--cams``/``--hw``/``--grid``."""
    args = parser().parse_args(argv)
    device = benchlib.resolve_device(args.device)
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor

    if state is None:
        from upsp_tpu_torch.pipeline.synthetic import make_synthetic_state

        state = make_synthetic_state(n_cameras=args.cams, image_hw=parse_pair(args.hw),
                                     grid_shape=parse_pair(args.grid), device=device)
    inputs = bench_inputs(state, args.frames, N_BUFFERS)
    fn = make_chunk_processor(
        state, warm_start=WARM[args.mode],
        frame_batch=args.frame_batch if args.mode == "fft" else 1,
        compute_dtype=args.dtype,
    )
    with tempfile.TemporaryDirectory(prefix="upsp_prof_") as tmp:
        events, wall, counts = capture(fn, inputs, args.reps, args.logdir or tmp)
    on_card = device.type == "cuda"
    rows = op_table(events, device=on_card)
    total = sum(r[1] for r in rows)
    n = args.reps * args.frames
    per_frame_us = total / n
    wall_us = wall * 1e6 / n
    what = "device" if on_card else "host (CPU run: no device time)"
    print(f"total {what} self-time {total / 1e3:.2f} ms over {args.reps} chunks x "
          f"{args.frames} frames => {per_frame_us:.1f} us/frame "
          f"({1e6 / per_frame_us:.0f} fps); window wall {wall_us:.1f} us/frame", flush=True)
    if on_card:
        print(f"device busy share {per_frame_us / wall_us:.4f}", flush=True)
    print(f"{'op':70s} {'us/frame':>9s} {'%':>6s} {'/chunk':>7s}  K")
    table = []
    for name, us, count in rows[: args.top]:
        k = kernel_of(name)
        knum = KERNELS[k][0] if k else ""
        print(f"{name[:70]:70s} {us / n:9.2f} {100 * us / total:6.2f} "
              f"{count / args.reps:7.2f}  {knum}")
        table.append({"name": name[:200], "k": knum or None,
                      "us_per_frame": round(us / n, 3),
                      "pct": round(100 * us / total, 3),
                      "launches_per_chunk": count / args.reps})
    if args.logdir:
        print(f"\ntrace dir: {args.logdir}", flush=True)
    rec = {"frames": args.frames, "reps": args.reps, "cams": len(state.projections),
           "hw": list(state.image_hw), "nodes": int(state.model.size),
           "dtype": args.dtype, "mode": args.mode, "top": table, "trace": args.logdir,
           "window_wall_us_per_frame": round(wall_us, 3)}
    if on_card:
        prof = kernel_launches(rows)
        want = expected_launches(counts)
        k_us = sum(us for name, us, _ in rows if kernel_of(name))
        gemms = [(name, us, count) for name, us, count in rows if GEMM_RE.search(name)]
        rec.update({
            "device_us_per_frame": round(per_frame_us, 3),
            "busy_share": round(per_frame_us / wall_us, 5),
            "k_share_of_device": round(k_us / total, 5),
            "gemm_us_per_frame": round(sum(us for _, us, _ in gemms) / n, 3),
            "gemm_launches_per_chunk": sum(c for _, _, c in gemms) / args.reps,
            "gemm_kernels": [{"name": name[:200], "us_per_frame": round(us / n, 3),
                              "launches_per_chunk": c / args.reps}
                             for name, us, c in gemms],
            "kernel_launches": prof,
            "wrapper_launches": want,
            "launches_match": prof == want,
        })
        print(f"csrc kernels: {100 * k_us / total:.2f}% of device time; launches "
              f"profiler {prof} / wrappers {want}", flush=True)
    else:
        rec["host_us_per_frame"] = round(per_frame_us, 3)
    rec["device"] = torch.cuda.get_device_name(device) if on_card else "cpu"
    rec["card"] = benchlib.card()
    return rec


def main(argv=None) -> None:
    print(json.dumps(run(argv)), flush=True)


if __name__ == "__main__":
    main()
