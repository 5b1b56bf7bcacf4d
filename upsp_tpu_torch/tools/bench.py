"""Frames/s of the fused register+patch+filter+project chunk program on one
card (port of ``bench.py``).

    python -m upsp_tpu_torch.tools.bench [--trials 3] [--device cuda|cpu]

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N or null, ...}

Configuration and inputs as the JAX bench: 1 camera of 1024x1024, a
160x128 grid, 32 frames (``BENCH_FRAMES``), 8 distinct sub-pixel-jittered
frames tiled to the chunk, 4 buffers each offset by ``i * 1e-3``, all on
the device before the clock starts.  The timed program is
``make_chunk_processor(state, warm_start="fft", frame_batch=8,
compute_dtype=...)``; ``BENCH_MODE`` (fft | scan | cold),
``BENCH_FRAME_BATCH`` and ``BENCH_DTYPE`` (one dtype only) as there.
The headline is f32, the median of ``--trials`` trials of
:func:`benchlib.trial_seconds` (2 and 8 chunks), with the trials' band;
bf16 is measured alongside under the ``bf16_*`` keys.

``vs_baseline``: against a single-core OpenCV pipeline of the same
per-frame work (``cv2.findTransformECC``, warp, blur, sparse projection)
measured here when ``cv2`` imports; without it ``null`` with
``"baseline": "cv2 absent"``.  ``"card"`` is the card's name and power
limit, ``"device"`` the device the numbers come from.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from upsp_tpu_torch.tools import benchlib

IMAGE_HW = (1024, 1024)  # 1 MP
GRID_SHAPE = (160, 128)  # ~20k nodes
N_DISTINCT = 8
N_BUFFERS = 4
WARM = {"fft": "fft", "scan": True, "cold": False}


def parse_pair(text: str):
    return tuple(int(v) for v in text.split(","))


def distinct_tiled(state, n_frames: int) -> np.ndarray:
    """``min(8, n_frames)`` jittered frames (``make_frame_batch``) tiled to
    ``n_frames`` (bench.py:44-48): the per-frame device work is that of
    distinct sub-pixel shifts, without the host's cost of synthesizing
    every frame."""
    from upsp_tpu_torch.pipeline.synthetic import make_frame_batch

    n_distinct = min(N_DISTINCT, n_frames)
    distinct = make_frame_batch(state, n_distinct)
    reps_tile = -(-n_frames // n_distinct)
    return np.tile(distinct, (reps_tile, 1, 1, 1))[:n_frames]


def bench_inputs(state, n_frames: int, n_buffers: int = N_BUFFERS):
    """Distinct device buffers, ``base + i * 1e-3`` (bench.py:49-52)."""
    base = distinct_tiled(state, n_frames)
    return [torch.from_numpy(base + i * 1e-3).to(state.device)
            for i in range(n_buffers)]


def chunk_program(state, compute_dtype: str = "float32", mode: str = "fft",
                  frame_batch: int = 8):
    """The timed program (bench.py:56-70)."""
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor

    return make_chunk_processor(
        state, warm_start=WARM[mode],
        frame_batch=frame_batch if mode == "fft" else 1,
        compute_dtype=compute_dtype,
    )


def bench_gpu(state, inputs, compute_dtype: str = "float32", trials: int = 3):
    """Per-trial frames/s of the chunk program, ascending."""
    mode = os.environ.get("BENCH_MODE", "fft")
    fn = chunk_program(state, compute_dtype, mode,
                       int(os.environ.get("BENCH_FRAME_BATCH", "8")))
    n_frames = int(inputs[0].shape[0])
    return sorted(n_frames / t
                  for t in benchlib.trial_seconds(fn, inputs, 2, 8, trials))


def bench_reference_cpu(state, n_frames: int = 2):
    """Frames/s of a single-core OpenCV pipeline of the same per-frame work
    (bench.py:101-136), or None without ``cv2``."""
    try:
        import cv2
    except ImportError:
        return None
    from upsp_tpu_torch.pipeline.synthetic import make_frame_batch

    cv2.setNumThreads(1)
    ref = state.ref_frames[0].cpu().numpy()
    frames = make_frame_batch(state, n_frames)[:, 0]
    pix = state.projections[0].pixel_index.cpu().numpy()
    w = state.projections[0].weight.cpu().numpy()
    t0 = time.perf_counter()
    for f in range(n_frames):
        img = frames[f]
        warp = np.eye(2, 3, dtype=np.float32)
        try:
            cv2.findTransformECC(
                ref, img, warp, cv2.MOTION_AFFINE,
                (cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 50, 1e-3),
            )
        except cv2.error:
            pass
        img = cv2.warpAffine(
            img, warp, (img.shape[1], img.shape[0]),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )
        img = cv2.GaussianBlur(img, (3, 3), 0)
        _ = img.ravel()[pix] * w
    return n_frames / (time.perf_counter() - t0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int,
                    default=int(os.environ.get("BENCH_FRAMES", "32")))
    ap.add_argument("--hw", default="%d,%d" % IMAGE_HW)
    ap.add_argument("--grid", default="%d,%d" % GRID_SHAPE)
    ap.add_argument("--trials", type=int, default=3)
    benchlib.add_device_arg(ap)
    return ap


def run(argv=None, state=None) -> dict:
    """The JSON record; ``state``: a phase-0 state to use instead of
    building the synthetic one."""
    args = parser().parse_args(argv)
    device = benchlib.resolve_device(args.device)
    if state is None:
        from upsp_tpu_torch.pipeline.synthetic import make_synthetic_state

        state = make_synthetic_state(n_cameras=1, image_hw=parse_pair(args.hw),
                                     grid_shape=parse_pair(args.grid), device=device)
    inputs = bench_inputs(state, args.frames)
    pinned = os.environ.get("BENCH_DTYPE")
    band = bench_gpu(state, inputs, pinned or "float32", args.trials)
    fps = band[len(band) // 2]  # the median trial
    band_bf16 = None if pinned else bench_gpu(state, inputs, "bfloat16", args.trials)
    ref_fps = bench_reference_cpu(state)
    rec = {
        "metric": "frames_per_sec_per_chip_register_project_1MP",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": None if ref_fps is None else round(fps / max(ref_fps, 1e-9), 3),
        "baseline": ("cv2 absent" if ref_fps is None else
                     f"single-core OpenCV {ref_fps:.4f} frames/s, measured here"),
        "trial_fps_min": round(band[0], 3),
        "trial_fps_max": round(band[-1], 3),
    }
    if band_bf16 is not None:
        rec["bf16_optin_fps"] = round(band_bf16[len(band_bf16) // 2], 3)
        rec["bf16_trial_fps_min"] = round(band_bf16[0], 3)
        rec["bf16_trial_fps_max"] = round(band_bf16[-1], 3)
    rec["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu")
    rec["card"] = benchlib.card()
    return rec


def main(argv=None) -> None:
    print(json.dumps(run(argv)), flush=True)


if __name__ == "__main__":
    main()
