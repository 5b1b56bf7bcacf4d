#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device:

1. prints torch's version and the card's name and power limit;
2. builds the ECC kernels (upsp_tpu_torch/csrc/ecc.cu) and prints the time;
3. holds each kernel against its plain PyTorch twin on the card at the
   slice's shapes (8 frames of 1024x1024 f32) and times both with CUDA
   events;
4. writes a synthetic datapoint (2 cameras, 1024x1024 12-bit .mraw, 128
   frames tiled from 16 sub-pixel-jittered frames, a 320x256 plate grid,
   12 fiducial targets, polynomial patches, gaussian 3, best view) under
   build/chip_smoke/ and runs scripts/upsp-process-torch on it, with the
   kernel launch counts reset just before and read just after;
5. checks the outputs (all flat files, the registration sidecar,
   output.h5 where h5py is installed, finite values on visible nodes,
   every kernel launched) and
   one 8-frame batch against the port's CPU twin path on the same frames.

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
CUDA is unavailable, the repository is missing, or any phase fails.
"""

import importlib.util
import json
import os
import runpy
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
SCRIPT = os.path.join(REPO, "scripts", "upsp-process-torch")
TPU_KERNELS = {
    "blur": "upsp_tpu/ops/pallas_ecc.py:829",
    "warp": "upsp_tpu/ops/pallas_ecc.py:285",
    "moments": "upsp_tpu/ops/pallas_ecc.py:587",
    "warp_filter": "upsp_tpu/ops/pallas_ecc.py:444",
}
B, H, W = 8, 1024, 1024  # frame batch and frame size of the slice
N_FRAMES, N_DISTINCT, GRID, N_TARGETS = 128, 16, (320, 256), 12
DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def cuda_time(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase():
    """Each kernel against its twin on the card; returns per-kernel rows."""
    import numpy as np
    import torch

    from upsp_tpu_torch.ops import ecc_kernels as K

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 2000 + 300 * np.sin(xx / 7.3) * np.cos(yy / 5.1)
    imgs = torch.tensor(base[None] + rng.normal(0, 40, (B, H, W)).astype(np.float32),
                        device=DEVICE)
    tmpl = torch.tensor(base.astype(np.float32), device=DEVICE)
    w = np.zeros((B, 2, 3), np.float32)
    w[:, 0, 0] = 1 + rng.uniform(-1e-3, 1e-3, B)
    w[:, 1, 1] = 1 + rng.uniform(-1e-3, 1e-3, B)
    w[:, 0, 1] = rng.uniform(-1e-3, 1e-3, B)
    w[:, 1, 0] = rng.uniform(-1e-3, 1e-3, B)
    w[:, :, 2] = rng.uniform(-0.7, 0.7, (B, 2))
    warps = torch.tensor(w, device=DEVICE)
    mask = warps.clone()
    mask[:, :, 2] += torch.tensor([1.0, -1.0], device=DEVICE)
    taps5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)
    taps3 = (0.25, 0.5, 0.25)

    def edge_mask(w):
        """Pixels within 2 px of a border-straddling sample: there the value
        moves by the full pixel value per pixel of position, so the bound
        is position rounding (4 ulps of 1024) times the pixel value."""
        ys = w[:, 1, 1, None] * np.arange(H) + w[:, 1, 2, None] + w[:, 1, 0, None] * (W - 1) / 2
        xs = w[:, 0, 0, None] * np.arange(W) + w[:, 0, 2, None] + w[:, 0, 1, None] * (H - 1) / 2
        ry = (ys < 3) | (ys > H - 4)
        rx = (xs < 3) | (xs > W - 4)
        return ry[:, :, None] | rx[:, None, :]

    edge = edge_mask(w)
    edge_bound = 4 * float(np.spacing(np.float32(1024))) * 4096

    def image_err(got, want, bound=2e-3):
        d = (got - want).abs().cpu().numpy()
        inner = float(d[~edge].max())
        outer = float(d[edge].max()) if edge.any() else 0.0
        ok = inner <= bound and outer <= edge_bound + bound
        return max(inner, outer), ok, f"interior {inner:.3g} <= {bound}, edge {outer:.3g} <= {edge_bound + bound:.3g}"

    rows = []

    def row(name, err, ok, detail, fn, plain_fn):
        ms = cuda_time(fn)
        plain_ms = cuda_time(plain_fn, iters=5, warmup=1)
        print(f"  {name}: max_abs_err {err:.4g} ({detail}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)
        check(ok, f"{name} kernel within bound of its twin")
        rows.append(dict(name=name, route="cuda",
                         source="upsp_tpu_torch/csrc/ecc.cu",
                         replaces=TPU_KERNELS[name], launches=0,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms))

    got = K.blur(imgs, taps5)
    want = K.blur_plain(imgs, taps5)
    d = float((got - want).abs().max())
    row("blur", d, d <= 2e-3, "bound 2e-3", lambda: K.blur(imgs, taps5),
        lambda: K.blur_plain(imgs, taps5))

    err, ok, det = image_err(K.warp_affine_banded(imgs, warps), K.warp_plain(imgs, warps))
    row("warp", err, ok, det, lambda: K.warp_affine_banded(imgs, warps),
        lambda: K.warp_plain(imgs, warps))

    got = K.ecc_gn_moments(imgs, tmpl, warps, mask).cpu().numpy()[:, :42]
    want = K.moments_plain(imgs, tmpl, warps, mask).cpu().numpy()[:, :42]
    diff = np.abs(got - want)
    rel = 0.0  # per statistic group, relative to its own largest member
    for lo, hi in [(0, 18), (18, 24), (24, 30), (30, 36), (36, 37), (37, 39),
                   (39, 42)]:
        scale = np.abs(want[:, lo:hi]).max(axis=1, keepdims=True)
        rel = max(rel, float((diff[:, lo:hi] / (np.abs(want[:, lo:hi]) + scale)).max()))
    row("moments", float(diff.max()), rel <= 2e-4,
        f"max rel {rel:.3g} <= 2e-4 (f32 reduction order)",
        lambda: K.ecc_gn_moments(imgs, tmpl, warps, mask),
        lambda: K.moments_plain(imgs, tmpl, warps, mask))

    o1 = K.warp_filter(imgs, warps, taps3)
    o2, iw = K.warp_filter(imgs, warps, taps3, with_warped=True)
    p_out, p_iw = K.warp_filter_plain(imgs, warps, taps3, True)
    e1, k1, d1 = image_err(o1, p_out)
    e2, k2, d2 = image_err(o2, p_out)
    e3, k3, d3 = image_err(iw, p_iw)
    row("warp_filter", max(e1, e2, e3), k1 and k2 and k3,
        f"filtered {d1}; with_warped {d2}; warped {d3}",
        lambda: K.warp_filter(imgs, warps, taps3, with_warped=True),
        lambda: K.warp_filter_plain(imgs, warps, taps3, True))
    torch.cuda.synchronize()
    return rows


def datapoint_phase(rows):
    """The main path: synthetic datapoint -> upsp-process-torch -> checks."""
    import numpy as np
    import torch

    from upsp_tpu_torch.ops import ecc_kernels as K
    from upsp_tpu_torch.pipeline.phase0 import run_phase0
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
    from upsp_tpu_torch.pipeline.run import FLAT_FILES, read_flat, read_input_deck
    from upsp_tpu_torch.pipeline.synthetic import write_datapoint

    rng = np.random.default_rng(1)
    # jitter <= 2 px whose fractional parts stay clear of +-0.5, so the
    # integer pre-shift cannot round differently on the card and the CPU
    shifts = rng.integers(-1, 2, (16, 2)) + rng.uniform(-0.3, 0.3, (16, 2))
    shifts[0] = 0.0
    t0 = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    shifts = shifts[:N_DISTINCT]
    dp = write_datapoint(WORK, n_cameras=2, image_hw=(H, W), n_frames=N_FRAMES,
                         grid_shape=GRID, n_targets=N_TARGETS, seed=1,
                         shifts=shifts)
    n_nodes = GRID[0] * GRID[1]
    print(f"  datapoint written in {time.perf_counter() - t0:.2f} s "
          f"(2 cameras x {N_FRAMES} frames x {H}x{W}, {n_nodes} nodes)", flush=True)

    timings = os.path.join(WORK, "timings.json")
    argv = [SCRIPT, "-input_deck", dp["deck"], "--registration-telemetry",
            "--timings", timings, "--device", DEVICE]
    K.reset_launch_counts()
    saved = sys.argv
    sys.argv = argv
    try:
        runpy.run_path(SCRIPT, run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise SmokeFailure(f"upsp-process-torch exited with {e.code}")
    finally:
        sys.argv = saved
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for r in rows:
        r["launches"] = counts[r["name"]]
    print(f"  launches on the main path: {counts}", flush=True)
    for name in K.KERNELS:
        check(counts[name] > 0, f"kernel {name} launched on the main path")

    with open(timings) as fh:
        t = json.load(fh)
    print(f"  phase 0 {t['phase0']:.3f} s; phase 1 {t['n_frames'] / t['phase1']:.1f} "
          f"frames/s ({t['phase1']:.3f} s for {t['n_frames']} frames x 2 cameras, "
          f"host decode included); phase 2 {t['phase2']:.3f} s; outputs "
          f"{t['outputs']:.3f} s", flush=True)

    out = dp["out_dir"]
    for name in FLAT_FILES:
        check(os.path.exists(os.path.join(out, name)), f"flat file {name}")
    for name in ("registration", "registration.json"):
        check(os.path.exists(os.path.join(out, name)), f"output {name}")
    if importlib.util.find_spec("h5py") is None:
        # as in the JAX package, the HDF5 file needs h5py; without it the
        # run logs that it skipped output.h5
        print("  h5py is not installed here: output.h5 not written (skipped "
              "with a warning, as the JAX package does)", flush=True)
    else:
        check(os.path.exists(os.path.join(out, "output.h5")), "output output.h5")
    intensity = read_flat(os.path.join(out, "intensity")).reshape(N_FRAMES, n_nodes)
    cov = read_flat(os.path.join(out, "coverage"))
    visible = cov > 0
    check(visible.mean() > 0.9, f"coverage: {visible.mean():.3f} of nodes visible")
    check(np.isfinite(intensity[:, visible]).all(), "intensity finite on visible nodes")
    press = read_flat(os.path.join(out, "pressure_transpose")).reshape(n_nodes, N_FRAMES)
    check(np.isfinite(press[visible]).all(), "delta-Cp finite on visible nodes")
    tele = read_flat(os.path.join(out, "registration")).reshape(N_FRAMES, 2, 5)
    print(f"  registration: rho min {tele[..., 0].min():.4f}, |t| max "
          f"{np.abs(tele[..., 2:4]).max():.3f} px, bound max "
          f"{tele[..., 4].max():.3f} px", flush=True)
    check(np.isfinite(tele).all() and tele[..., 0].min() > 0.9, "registration telemetry")

    # one 8-frame batch through the card and through the CPU twins
    cfg = read_input_deck(dp["deck"])
    frames = dp["frames"][:8]
    state = run_phase0(cfg, [frames[0, c] for c in range(2)], [12, 12], device=DEVICE)
    gpu, gtele = make_chunk_processor(state, with_telemetry=True)(frames)
    cpu, ctele = make_chunk_processor(state.to("cpu"), with_telemetry=True)(frames)
    gpu, cpu = gpu.cpu().numpy(), cpu.numpy()
    np.testing.assert_array_equal(np.isnan(gpu), np.isnan(cpu))
    v = np.isfinite(cpu)
    d = np.abs(gpu[v] - cpu[v])
    viol = int((d > 0.2 + 1e-4 * np.abs(cpu[v])).sum())
    print(f"  8-frame batch, card vs CPU twins: max abs {d.max():.4g} counts, "
          f"{viol} beyond rtol 1e-4 + atol 0.2; telemetry max abs "
          f"{np.abs(gtele.cpu().numpy() - ctele.numpy()).max():.3g}", flush=True)
    check(viol == 0, "card path matches the CPU twin path (rtol 1e-4, atol 0.2)")
    # and the batch equals what the CLI wrote for those frames
    check(np.allclose(intensity[:8][:, visible], gpu[:, visible], rtol=1e-5, atol=1e-3),
          "the batch equals the CLI's first 8 intensity rows")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "upsp_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(upsp_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi unavailable", flush=True)
    try:
        import upsp_tpu_torch  # noqa: F401  (sets the TF32 policy)
        from upsp_tpu_torch.ops import ecc_kernels as K

        print("[1/3] build", flush=True)
        t0 = time.perf_counter()
        K.build()
        K._lib()
        print(f"  kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
        print("[2/3] kernels against their twins (8 x 1024 x 1024 f32)", flush=True)
        rows = kernel_phase()
        print("[3/3] datapoint through scripts/upsp-process-torch", flush=True)
        datapoint_phase(rows)
    except (SmokeFailure, AssertionError, RuntimeError, ImportError,
            NotImplementedError, OSError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 3
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
