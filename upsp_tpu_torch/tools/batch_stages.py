"""Which stage of the chunk program first depends on the frame batch.

    python -m upsp_tpu_torch.tools.batch_stages [--frames 16] [--batches 8,16]
        [--cams 4] [--hw 1200,1800] [--grid 1024,1024] [--device cuda|cpu]

The same frames go through the production chunk program (fft start) built
with ``frame_batch`` b1, in calls of b1 frames, and with b2, in one call of
b2 frames.  While they run, the outputs of each stage of the frame
program (the functions ``pipeline/phase1.py`` calls, wrapped for the
run) are kept, and the two runs are compared stage by stage in program
order: hot pixels (K6), phase correlation, integer shift, the
Gauss-Newton steps (``ecc_affine``: K1-K3 and the 6x6 solves), the final
warp and filter (K4), the patch matmuls, the gather (K5) and its
overlays.  The first stage whose outputs differ while every earlier one
is equal computes a result that depends on the batch.

From the command line the state is the synthetic one of
``bench_fullconfig``'s configuration and the frames
``make_frame_batch``'s; :func:`stage_diffs` takes any state and frames.
Ends with one JSON line: each stage's largest difference and the first
that differs (``null`` when none does).
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, List

import torch

from upsp_tpu_torch.tools import benchlib
from upsp_tpu_torch.tools.bench import parse_pair

# (stage, the phase1 module names whose outputs it is), in program order
STAGES = (
    ("hot pixels", ("fix_hot_pixels_kernel",)),
    ("phase correlation", ("correlate",)),
    ("integer shift", ("integer_shift",)),
    ("GN steps", ("ecc_affine",)),
    ("final warp + filter", ("warp_filter", "warp_affine_banded")),
    ("patch matmuls", ("patch_correction_values", "apply_patches")),
    ("gather", ("project_gather",)),
    ("overlays", ("apply_overlays",)),
)


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out.detach().clone()]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _tensors(x)]
    return []


@contextlib.contextmanager
def recording(log: Dict[str, list]):
    """Wrap the stage functions of ``pipeline.phase1``: each call appends
    copies of its output tensors to ``log[name]``."""
    from upsp_tpu_torch.pipeline import phase1

    names = [n for _, ns in STAGES for n in ns]
    saved = {n: getattr(phase1, n) for n in names}

    def wrap(name, fn):
        def recorded(*args, **kw):
            out = fn(*args, **kw)
            log.setdefault(name, []).append(_tensors(out))
            return out
        return recorded

    try:
        for n in names:
            setattr(phase1, n, wrap(n, saved[n]))
        yield log
    finally:
        for n in names:
            setattr(phase1, n, saved[n])


def _run(state, frames, batch: int, **kw) -> List[Dict[str, list]]:
    """One log a call of ``batch`` frames."""
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor

    fn = make_chunk_processor(state, warm_start="fft", frame_batch=batch, **kw)
    logs = []
    for s in range(0, frames.shape[0], batch):
        with recording({}) as log:
            benchlib.sync(fn(frames[s : s + batch]))
        logs.append(log)
    return logs


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return float("inf")
    if a.dtype == torch.bool or not a.is_floating_point():
        return float((a != b).any())
    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0


def stage_diffs(state, frames: torch.Tensor, batches=(8, 16), **kw) -> dict:
    """Each stage's largest difference between ``frame_batch`` b1 and b2
    on ``frames`` (F, C, H, W) on the state's device (F a multiple of both),
    and the first stage that differs."""
    b1, b2 = batches
    runs = [_run(state, frames, b, **kw) for b in (b1, b2)]
    out, first = {}, None
    for stage, names in STAGES:
        worst = None
        for name in names:
            calls = [[log.get(name, []) for log in logs] for logs in runs]
            if not any(c for logs in calls for c in logs):
                continue
            for k in range(len(calls[0][0])):
                for leaf in range(len(calls[0][0][k])):
                    # the k-th call of a chunk call, joined along the frames
                    got = [torch.cat([c[k][leaf] for c in logs]) for logs in calls]
                    d = _max_diff(*got)
                    worst = d if worst is None else max(worst, d)
        if worst is None:
            continue
        out[stage] = worst
        if first is None and worst > 0:
            first = stage
    return {"batches": [b1, b2], "frames": int(frames.shape[0]),
            "max_abs_diff": out, "first_differs": first}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--batches", default="8,16")
    ap.add_argument("--cams", type=int, default=4)
    ap.add_argument("--hw", default="1200,1800")
    ap.add_argument("--grid", default="1024,1024")
    benchlib.add_device_arg(ap)
    return ap


def run(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = benchlib.resolve_device(args.device)
    from upsp_tpu_torch.pipeline.synthetic import make_frame_batch, make_synthetic_state

    state = make_synthetic_state(n_cameras=args.cams, image_hw=parse_pair(args.hw),
                                 grid_shape=parse_pair(args.grid), device=device)
    frames = torch.from_numpy(make_frame_batch(state, args.frames)).to(device)
    rec = stage_diffs(state, frames, parse_pair(args.batches))
    rec["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu")
    rec["card"] = benchlib.card()
    return rec


def main(argv=None) -> None:
    print(json.dumps(run(argv)), flush=True)


if __name__ == "__main__":
    main()
