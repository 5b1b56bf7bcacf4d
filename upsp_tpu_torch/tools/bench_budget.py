"""Component budget of the 1 MP chunk program (port of
``tools/bench_budget.py``).

    python -m upsp_tpu_torch.tools.bench_budget [--mp 1|2] [--frames 32]
        [--device cuda|cpu]

Variants of the production chunk program (fft start, ``--frame-batch``
frames a batch) are timed whole by :func:`benchlib.per_call_seconds` (2
and 6 chunks over ``bench``'s four buffers): 2, 3, 1 and 0 Gauss-Newton
steps and registration off.  The marginal GN step and the registration's
total (final warp included) are differences between them, so each is an
end-to-end delta.  The JAX tool's banded-warp variant (``ecc_band=8``)
is not ported, by design: the port's warps have no band limit and
``ecc_band`` raises (``pipeline/phase1.make_chunk_processor``); its line
says so.  ``--hw``/``--grid`` override the frame size and grid (tests).
Ends with one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from upsp_tpu_torch.tools import benchlib
from upsp_tpu_torch.tools.bench import bench_inputs, parse_pair
from upsp_tpu_torch.tools.bench_ablate import without_registration

BANDED = "production, banded warps (band=8)"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mp", type=int, default=1, choices=(1, 2))
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--frame-batch", type=int, default=8)
    ap.add_argument("--hw", default=None, help="frame size (default from --mp)")
    ap.add_argument("--grid", default="160,128")
    benchlib.add_device_arg(ap)
    return ap


def run(argv=None, state=None) -> dict:
    args = parser().parse_args(argv)
    device = benchlib.resolve_device(args.device)
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor

    if state is None:
        from upsp_tpu_torch.pipeline.synthetic import make_synthetic_state

        hw = (parse_pair(args.hw) if args.hw
              else (1024, 1024) if args.mp == 1 else (1200, 1800))
        state = make_synthetic_state(n_cameras=1, image_hw=hw,
                                     grid_shape=parse_pair(args.grid), device=device)
    inputs = bench_inputs(state, args.frames)
    F = args.frames
    ms = {}

    def t(label, st=state, **kw):
        fn = make_chunk_processor(st, frame_batch=args.frame_batch, **kw)
        per = benchlib.per_call_seconds(fn, inputs, r1=2, r2=6)
        print(f"{label:44s} {per / F * 1e3:7.3f} ms/frame   {F / per:8.1f} fps",
              flush=True)
        ms[label] = per / F * 1e3
        return per / F

    t_full = t("production (fft + 2 GN)", warm_start="fft", ecc_iters=2)
    t_gn3 = t("fft + 3 GN", warm_start="fft", ecc_iters=3)
    t_gn1 = t("fft + 1 GN", warm_start="fft", ecc_iters=1)
    t("fft + 0 GN (init only + final warp)", warm_start="fft", ecc_iters=0)
    step = (t_gn3 - t_gn1) / 2 * 1e3
    print(f"{'-> marginal GN step':44s} {step:7.3f} ms/frame")
    t_noreg = t("no registration (hot+patch+filter+gather)", without_registration(state))
    reg = (t_full - t_noreg) * 1e3
    print(f"{'-> registration total (incl final warp)':44s} {reg:7.3f} ms/frame")
    print(f"{BANDED:44s} not ported by design (ecc_band)", flush=True)
    return {
        "config": {"cams": 1, "hw": list(state.image_hw), "nodes": int(state.model.size),
                   "frames": F, "frame_batch": args.frame_batch},
        "variants_ms_per_frame": {k: round(v, 5) for k, v in ms.items()},
        "gn_step_ms_per_frame": round(step, 5),
        "registration_ms_per_frame": round(reg, 5),
        "banded": "not ported by design (ecc_band)",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": benchlib.card(),
    }


def main(argv=None) -> None:
    print(json.dumps(run(argv)), flush=True)


if __name__ == "__main__":
    main()
