"""One run of one cell: set-up, the measured window, the traced segment,
the correctness check and the result line.

The window drives the program's own entry, ``run_datapoint`` (what
``scripts/upsp-process-torch`` calls), on whole datapoints back to back:
phase 0, the phase-1 chunk loop with packed ingest from the video files,
the frame program, phase 2.  Each call passes ``write_outputs=False``,
a fresh ``stage_times`` dict, the cell's ECC start and compute dtype, and
the program's defaults otherwise.  The window ends with the datapoint
running when ``seconds`` have passed.  With ``trace``, one more datapoint
runs under ``torch.profiler`` after the window.
"""

from __future__ import annotations

import math
import shutil
import sys
import tempfile
import time
from typing import Optional

import torch

from benchmark import cells
from benchmark.check import NUMBERS, Reference
from benchmark.datapoint import write_datapoint
from benchmark.reference.plain import decimation

FORBIDDEN = ("jax", "jaxlib", "flax", "upsp_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``upsp_tpu_torch`` is neither)."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


def _assert_no_jax() -> None:
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the benchmark may not load: {found}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def work_of(cell: dict, ref: Reference, n_nodes: int) -> dict:
    """The quantities the kernel files count work from, for one datapoint."""
    conf, traffic = cell["config"], cell["traffic"]
    h, w = conf["image_hw"]
    return {
        "frames": traffic["n_frames"], "cameras": conf["n_cameras"], "height": h,
        "width": w, "px": h * w, "nodes": n_nodes,
        "elem": 2 if conf["compute_dtype"] == "bfloat16" else 4,
        "gn_steps": ref.gn_steps(), "frame_batch": 8, "frames_per_chunk": 64,
        "video_bits": 12 if conf["video_format"] == "mraw12" else 10,
        "warm_start": traffic["warm_start"], "decimate": decimation(h, w),
    }


def kernel_times(trace, work: dict, n_datapoints: int) -> dict:
    """{kernel file: (least seconds, device seconds)} of the kernels the
    trace shows."""
    from benchmark.kernels._peaks import least_s

    out = {}
    for name, mod in cells.kernel_bounds().items():
        spent = sum(trace.seconds_of(n) for n in mod.NAMES)
        if spent > 0:
            flops, nbytes = mod.work(work)
            out[name] = (n_datapoints * least_s(flops, nbytes), spent)
    return out


def _keep(out) -> dict:
    return {"intensity": out.intensity, "avg": out.intensity_avg,
            "rms": out.intensity_rms, "dcp": out.phase2.pressure_transpose,
            "n_nodes": out.state.n_nodes}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
             t0: Optional[float] = None, compute_dtype: Optional[str] = None,
             warm: bool = True) -> dict:
    """Run ``cell`` (:func:`benchmark.cells.cell`) once; returns the result
    line's dict, with the compared numbers under ``checks`` last.
    ``compute_dtype`` overrides the configuration's (the control);
    ``warm=False`` leaves out the warm datapoint (a run for its checks
    alone, whose times mean nothing)."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    conf, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    dtype = compute_dtype or conf["compute_dtype"]

    from upsp_tpu_torch.pipeline.config import read_input_deck
    from upsp_tpu_torch.pipeline.run import run_datapoint

    if device.type == "cuda":
        from upsp_tpu_torch.ops import cuda_lib

        cuda_lib.build_all()
    t_built = time.perf_counter()
    root = tempfile.mkdtemp(prefix="upsp_bench_")
    try:
        dp = write_datapoint(
            root, seed=seed, n_cameras=conf["n_cameras"], image_hw=tuple(conf["image_hw"]),
            grid_shape=tuple(conf["grid_shape"]), n_frames=traffic["n_frames"],
            n_distinct=traffic["n_distinct"], n_targets=conf["n_targets"],
            max_shift_px=traffic["max_shift_px"], video_format=conf["video_format"],
            device=device, options=conf["deck_options"])
        cfg = read_input_deck(dp["deck"])
        start_mode = traffic["warm_start"] if traffic["warm_start"] == "fft" else False
        t_written = time.perf_counter()

        def datapoint(stage_times):
            return run_datapoint(cfg, device=device, write_outputs=False,
                                 stage_times=stage_times, warm_start=start_mode,
                                 compute_dtype=dtype)

        if warm:
            datapoint({})  # cuFFT plans, first touch, the page cache
        _sync(device)
        _assert_no_jax()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0
        print(f"setup: imports and kernels {t_built - t0:.3f} s, datapoint written "
            f"{t_written - t_built:.3f} s, warm datapoint {t0 + setup_s - t_written:.3f} s",
            file=sys.stderr)

        outputs, stages = [], []
        start = time.perf_counter()
        while True:
            st = {}
            outputs.append(_keep(datapoint(st)))
            stages.append(st)
            if time.perf_counter() - start >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

        summary, traced_stages = None, []
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            from benchmark.trace import DATAPOINT, summarize

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                t_tr = time.perf_counter()
                st = {}
                with record_function(DATAPOINT):
                    outputs.append(_keep(datapoint(st)))
                traced_stages.append(st)
                _sync(device)
                traced_s = time.perf_counter() - t_tr
            t_red = time.perf_counter()
            summary = summarize(prof, traced_stages, traced_s)
            del prof
            print(f"trace: {traced_s:.3f} s traced, reduced in "
                f"{time.perf_counter() - t_red:.3f} s", file=sys.stderr)

        for st in stages + traced_stages:
            print("stages " + " ".join(f"{k} {v:.4f}" for k, v in st.items()
                                     if isinstance(v, float)), file=sys.stderr)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref = Reference(dp, traffic["warm_start"], device)
        checks = ref.compare(outputs)
        print(f"setup {setup_s:.3f} s, window {window_s:.3f} s for {len(stages)} "
            f"datapoints, reference and comparison {time.perf_counter() - t_ref:.3f} s",
            file=sys.stderr)
        ok = all(checks[k] <= limits[k] for k in NUMBERS)
        failed = sum(1 for o in outputs if not all(
            v <= limits[k] for k, v in ref.compare([o]).items())) if not ok else 0

        if trace:
            ctx = {"stages": stages, "frames": traffic["n_frames"], "trace": summary,
                   "traced_frames": traffic["n_frames"] * len(traced_stages)}
            ctx["kernels"] = kernel_times(summary, work_of(cell, ref, outputs[0]["n_nodes"]),
                                          len(traced_stages))
            metrics = {}
            for m in cell["per_layer"]:
                v = cells.metric_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            e2e = {"datapoint_s": window_s / len(stages), "setup_s": setup_s}
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in cell["end_to_end"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    _assert_no_jax()
    for k in NUMBERS:
        print(f"check {k}: {checks[k]!r} limit {limits[k]!r}", file=sys.stderr)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": bool(ok), "attempted": len(outputs), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
    result["checks"] = {k: {"value": checks[k] if math.isfinite(checks[k]) else "inf",
                            "limit": limits[k]} for k in NUMBERS}
    return result
