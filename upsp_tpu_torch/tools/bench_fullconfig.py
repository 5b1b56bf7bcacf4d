"""The production configuration on one card: 4 cameras x 1200x1800 x
1,048,576 nodes, phase 1 and phase 2 from frames already on the device
(port of ``tools/bench_fullconfig.py``).

    python -m upsp_tpu_torch.tools.bench_fullconfig [--mode fft|scan|cold]
        [--frames 32] [--compute-dtype float32|bfloat16] [--json-out FILE]
        [--device cuda|cpu]

Phase 1 is the production chunk program (``make_chunk_processor``,
warm start ``--mode``, ``--frame-batch`` frames a batch); phase 2 is
``phase2_like``: the frame statistics, the ratio to the mean, the
frames->nodes transpose, the order-6 detrend and the paint scaling.  Both
are timed with :func:`benchlib.per_call_seconds` (1 and 4 calls) on two
distinct device buffers.  Host ingest is not in these numbers: the gap to
a run from files (``scripts/upsp-process-torch``) is ingest.

Frames are integer rolls (-2..2 px, seed 0) of an analytic base with a
sinusoidal gain (bench_fullconfig.py:99-112), so ECC does full solves.

Prints the record as one JSON line and, with ``--json-out``, writes it to
that file (nothing by default): ``config``, ``t_frame_ms_phase1``,
``fps_phase1``, ``command``, and without ``--phase1-only``
``t_phase2_ms_per_chunk``, ``t_frame_ms_end2end``, ``fps_end2end`` --
the keys ``tools/bench_scaling_model.py --from-bench`` reads -- plus
``card``, ``device`` and ``state_build_s``.  The JAX tool's
``host_finalize_ms_per_frame`` is left out: it times the host unpermute
of the TPU gather's slot order, and K5 writes model order, so there is no
such step; ``config.slab_gather`` is False for the same reason, and
``--no-slab`` (the switch for that gather) is refused.
``--no-vmap-cameras`` is accepted so that the JAX tool's command lines
run, and changes nothing: the per-camera loop is the default.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from upsp_tpu_torch.tools import benchlib
from upsp_tpu_torch.tools.bench import WARM, parse_pair

PAINT_SCALE = 1.7 * 144.0 / 350.0  # bench_fullconfig.py:158's delta-Cp scaling
DETREND_ORDER = 6


def make_frames(n_frames: int, n_cams: int, H: int, W: int) -> np.ndarray:
    """(F, C, H, W) f32: integer rolls of an analytic base, modulated per
    frame (bench_fullconfig.py:99-112)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = (
        2000
        + 0.5 * xx
        + 0.3 * yy
        + 400 * np.sin(xx / 37.0) * np.cos(yy / 29.0)
    ).astype(np.float32)
    frames = np.empty((n_frames, n_cams, H, W), np.float32)
    for f in range(n_frames):
        sh = rng.integers(-2, 3, 2)
        img = np.roll(base, tuple(sh), axis=(0, 1))
        frames[f] = img[None] * (1 + 0.01 * np.sin(2 * np.pi * f / 7))
    return frames


def phase2_like(sols: torch.Tensor, det):
    """Statistics, ratio, transpose, detrend and scaling of an (F, N)
    chunk (bench_fullconfig.py:150-156): (delta-Cp (N, F), avg, rms)."""
    from upsp_tpu_torch.ops.polyfit import detrend
    from upsp_tpu_torch.pipeline.phase1 import phase1_statistics

    avg, rms = phase1_statistics(sols)
    ratio = avg[None, :] / torch.where(sols == 0, torch.ones_like(sols), sols) - 1.0
    node_major = ratio.T.contiguous()
    return detrend(det, node_major) * PAINT_SCALE, avg, rms


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="fft", choices=["fft", "scan", "cold"])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--cams", type=int, default=4)
    ap.add_argument("--hw", default="1200,1800")  # 2.16 MP
    ap.add_argument("--grid", default="1024,1024")  # ~1.05M nodes
    ap.add_argument("--frame-batch", type=int, default=8)
    ap.add_argument("--ecc-iters", type=int, default=None,
                    help="fine GN steps (default: production 2 full-res, 0 coarse)")
    ap.add_argument("--ecc-coarse-iters", type=int, default=None)
    ap.add_argument("--phase1-only", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--no-slab", action="store_true",
                    help="refused: the TPU's slot-order gather; K5 has no slot order")
    ap.add_argument("--no-vmap-cameras", action="store_true",
                    help="accepted for the JAX tool's command lines; changes "
                         "nothing (the per-camera loop is the default)")
    ap.add_argument("--json-out", default=None,
                    help="write the record to this JSON file (none by default)")
    benchlib.add_device_arg(ap)
    return ap


def run(argv=None, state=None) -> dict:
    """The record; ``state``: a phase-0 state of the configuration's
    cameras, frame size and nodes to use instead of the synthetic one."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.no_slab:
        ap.error("--no-slab switches off the TPU's slot-order slab gather and "
                 "its host unpermute; K5 gathers in model order, so there is "
                 "nothing to switch off")
    device = benchlib.resolve_device(args.device)
    H, W = parse_pair(args.hw)
    grid = parse_pair(args.grid)
    F, C = args.frames, args.cams

    from upsp_tpu_torch.ops.polyfit import make_detrender
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
    from upsp_tpu_torch.pipeline.synthetic import make_synthetic_state

    t0 = time.perf_counter()
    if state is None:
        state = make_synthetic_state(n_cameras=C, image_hw=(H, W), grid_shape=grid,
                                     device=device)
    t_state = time.perf_counter() - t0
    n_nodes = state.model.size
    print(f"state: {C} cams x {H}x{W} ({H * W / 1e6:.2f} MP), {n_nodes / 1e6:.2f}M "
          f"nodes [{t_state:.1f}s]", flush=True)

    fft = args.mode == "fft"
    fn = make_chunk_processor(
        state,
        warm_start=WARM[args.mode],
        frame_batch=args.frame_batch if fft else 1,
        ecc_iters=args.ecc_iters if fft else None,
        ecc_coarse_iters=args.ecc_coarse_iters if fft else None,
        compute_dtype=args.compute_dtype,
    )
    frames = make_frames(F, C, H, W)
    inputs = [torch.from_numpy(frames).to(device),
              torch.from_numpy(frames + 0.25).to(device)]
    del frames

    t0 = time.perf_counter()
    sols = fn(inputs[0])
    benchlib.sync(sols)
    print(f"phase1 first call: {time.perf_counter() - t0:.1f}s", flush=True)
    t1 = benchlib.per_call_seconds(fn, inputs, r1=1, r2=4, trials=args.reps)
    print(f"phase1: {t1 * 1e3:.0f} ms / {F} frames = {F / t1:.1f} frames/s", flush=True)

    t2 = None
    if not args.phase1_only:
        det = make_detrender(F, DETREND_ORDER, device=device)
        t0 = time.perf_counter()
        benchlib.force_fetch(phase2_like(sols, det))
        print(f"phase2 first call: {time.perf_counter() - t0:.1f}s", flush=True)
        sols2 = fn(inputs[1])
        t2 = benchlib.per_call_seconds(lambda s: phase2_like(s, det), [sols, sols2],
                                       r1=1, r2=4, trials=args.reps)
        del sols2
        print(f"phase2: {t2 * 1e3:.0f} ms", flush=True)
        total = t1 + t2
        print(f"END2END: {F / total:.1f} frames/s ({total * 1e3:.0f} ms / {F} frames)",
              flush=True)
    del sols, inputs

    rec = {
        "config": {
            "cams": C, "hw": [H, W], "mp": round(H * W / 1e6, 3),
            "nodes": int(n_nodes), "frames": F, "mode": args.mode,
            "frame_batch": args.frame_batch,
            "compute_dtype": args.compute_dtype,
            "slab_gather": False,
        },
        "t_frame_ms_phase1": round(t1 * 1e3 / F, 4),
        "fps_phase1": round(F / t1, 2),
        "command": " ".join(["python -m upsp_tpu_torch.tools.bench_fullconfig"]
                            + list(sys.argv[1:] if argv is None else argv)),
    }
    if t2 is not None:
        rec["t_phase2_ms_per_chunk"] = round(t2 * 1e3, 2)
        rec["t_frame_ms_end2end"] = round((t1 + t2) * 1e3 / F, 4)
        rec["fps_end2end"] = round(F / (t1 + t2), 2)
    rec["state_build_s"] = round(t_state, 3)
    rec["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu")
    rec["card"] = benchlib.card()
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(f"wrote {args.json_out}", flush=True)
    return rec


def main(argv=None) -> None:
    print(json.dumps(run(argv)), flush=True)


if __name__ == "__main__":
    main()
