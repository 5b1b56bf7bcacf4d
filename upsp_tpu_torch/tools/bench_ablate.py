"""Where the phase-1 time a frame goes, by ablation (port of
``tools/bench_ablate.py``).

    python -m upsp_tpu_torch.tools.bench_ablate [--hw 1024,1024] [--cams 1]
        [--frames 32] [--device cuda|cpu]

Times the production chunk program (fft start, ``--frame-batch`` frames a
batch) with 2, 4 and 0 Gauss-Newton steps and with registration off
(``dataclasses.replace(state.config, registration="none")``), each by
:func:`benchlib.per_call_seconds` (2 and 6 chunks) over three device
buffers, and reads off as differences: the marginal GN step, the fixed
ECC cost (phase correlation, pre-shift, blur, final warp) and the
non-registration remainder (hot pixels, patches, filter, gather), in ms a
frame.  Ends with one JSON line of the variants' ms and the three
differences.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from upsp_tpu_torch.tools import benchlib
from upsp_tpu_torch.tools.bench import parse_pair

VARIANTS = (
    ("production (fft + 2 GN)", dict(ecc_iters=2)),
    ("fft + 4 GN", dict(ecc_iters=4)),
    ("fft + 0 GN (init+final warp only)", dict(ecc_iters=0)),
)
NO_REG = "no registration"


def time_fn(fn, arg, reps: int = 3) -> float:
    inputs = [arg, arg + 1e-3, arg + 2e-3]
    return benchlib.per_call_seconds(fn, inputs, r1=2, r2=6, trials=reps)


def without_registration(state):
    """The state with ``registration="none"`` (bench_ablate.py:75-77)."""
    cfg = dataclasses.replace(state.config, registration="none")
    return dataclasses.replace(state, config=cfg)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", default="1024,1024")
    ap.add_argument("--grid", default="160,128")
    ap.add_argument("--cams", type=int, default=1)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--frame-batch", type=int, default=8)
    benchlib.add_device_arg(ap)
    return ap


def run(argv=None, state=None) -> dict:
    args = parser().parse_args(argv)
    device = benchlib.resolve_device(args.device)
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
    from upsp_tpu_torch.pipeline.synthetic import make_frame_batch, make_synthetic_state

    if state is None:
        state = make_synthetic_state(n_cameras=args.cams, image_hw=parse_pair(args.hw),
                                     grid_shape=parse_pair(args.grid), device=device)
    F = args.frames
    H, W = state.image_hw
    fr_dev = torch.from_numpy(make_frame_batch(state, F)).to(device)
    print(f"{len(state.projections)} cams x {H}x{W}, {state.model.size} nodes, "
          f"{F} frames", flush=True)

    results = {}
    for name, kw in VARIANTS:
        t = time_fn(make_chunk_processor(state, warm_start="fft",
                                         frame_batch=args.frame_batch, **kw), fr_dev)
        results[name] = t
        print(f"{name:40s} {t * 1e3:7.1f} ms  {F / t:8.1f} fps", flush=True)
    # the same batch as the ECC variants, so the differences compare like
    # with like
    t = time_fn(make_chunk_processor(without_registration(state), warm_start=False,
                                     frame_batch=args.frame_batch), fr_dev)
    results[NO_REG] = t
    print(f"{'no registration (patch+filter+proj)':40s} {t * 1e3:7.1f} ms  "
          f"{F / t:8.1f} fps", flush=True)

    t2, t4 = results["production (fft + 2 GN)"], results["fft + 4 GN"]
    t0gn = results["fft + 0 GN (init+final warp only)"]
    step = (t4 - t2) / 2 / F * 1e3
    fixed = (t0gn - results[NO_REG]) / F * 1e3
    rest = results[NO_REG] / F * 1e3
    print(f"\nper-frame marginal GN step : {step:.3f} ms")
    print(f"per-frame ECC fixed (fft init + final warp + blur): {fixed:.3f} ms")
    print(f"per-frame non-registration remainder: {rest:.3f} ms", flush=True)
    return {
        "config": {"cams": len(state.projections), "hw": [H, W],
                   "nodes": int(state.model.size), "frames": F,
                   "frame_batch": args.frame_batch},
        "variants_ms": {k: round(v * 1e3, 4) for k, v in results.items()},
        "variants_fps": {k: round(F / v, 3) for k, v in results.items()},
        "gn_step_ms_per_frame": round(step, 5),
        "ecc_fixed_ms_per_frame": round(fixed, 5),
        "non_registration_ms_per_frame": round(rest, 5),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": benchlib.card(),
    }


def main(argv=None) -> None:
    print(json.dumps(run(argv)), flush=True)


if __name__ == "__main__":
    main()
