#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device:

1. prints torch's version and the card's name and power limit;
2. builds every CUDA source of the port (upsp_tpu_torch/csrc/*.cu, one
   nvcc each, all started together) and prints the time;
3. holds each kernel against its plain PyTorch twin on the card and times
   both with CUDA events: K1-K4 on 8 frames of 1024x1024 and of 1200x1800
   f32, K5-K8 at the full configuration's shapes (8 frames x 4 cameras x
   1200x1800, a 1,048,576-node gather plan);
4. drives three synthetic datapoints through scripts/upsp-process-torch,
   each with the kernel launch counts reset just before and read just
   after, packed ingest on and hot pixels injected:
   (a) 2 cameras x 1024x1024 12-bit .mraw, 64 frames, 81,920 nodes;
   (b) the full configuration: 4 cameras x 1200x1800 12-bit .mraw, 64
       frames, a 1024x1024 grid (1,048,576 nodes);
   (c) 2 cameras x 1024x1024 10-bit packed .cine, 32 frames;
   every path uses polynomial patches, gaussian 3, best view and the fft
   warm start;
5. checks each path's outputs (all flat files, the registration sidecar,
   output.h5 where h5py is installed, finite values on visible nodes, the
   kernels the path must launch) and one batch of its frames — packed
   bytes unpacked on the card — against the port's CPU twin path.

Prints the kernel table as one JSON line (per kernel: ``launches`` over
the three paths and ``launches_by_path``; ``ms``/``plain_ms`` at the full
configuration's shape, every measured shape under ``shapes``), then as
the last line {"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
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
ECC_CU = "upsp_tpu_torch/csrc/ecc.cu"
KERNEL_INFO = {  # name -> (source, the TPU kernel it replaces)
    "blur": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:829"),
    "warp": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:285"),
    "moments": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:587"),
    "warp_filter": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:444"),
    "gather": ("upsp_tpu_torch/csrc/gather.cu", "upsp_tpu/ops/pallas_gather.py:251"),
    "hot": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:739"),
    "unpack12": ("upsp_tpu_torch/csrc/unpack.cu", "upsp_tpu/ops/pallas_unpack.py:37"),
    "unpack10": ("upsp_tpu_torch/csrc/unpack.cu", "upsp_tpu/ops/pallas_unpack.py:76"),
}
B = 8  # the frame batch of the frame program
FULL_C, FULL_H, FULL_W = 4, 1200, 1800
# K1-K4 are checked at the frame sizes of paths (a)/(c) and of (b), whose
# 1800-px rows end in partial tiles
ECC_SHAPES = ((1024, 1024), (FULL_H, FULL_W))
N_DISTINCT, N_TARGETS = 16, 12
# (name, write_datapoint arguments, frames of the card-vs-CPU batch,
#  kernels the path must launch)
FRAME_KERNELS = ("blur", "warp", "moments", "warp_filter", "gather", "hot")
PATHS = [
    ("a: 2 x 1024x1024 mraw12, 64 frames, 81,920 nodes",
     dict(n_cameras=2, image_hw=(1024, 1024), n_frames=64, grid_shape=(320, 256)),
     slice(0, 8), FRAME_KERNELS + ("unpack12",)),
    ("b: full config, 4 x 1200x1800 mraw12, 64 frames, 1,048,576 nodes",
     dict(n_cameras=FULL_C, image_hw=(FULL_H, FULL_W), n_frames=64,
          grid_shape=(1024, 1024)),
     slice(1, 3), FRAME_KERNELS + ("unpack12",)),
    ("c: 2 x 1024x1024 cine10, 32 frames, 81,920 nodes",
     dict(n_cameras=2, image_hw=(1024, 1024), n_frames=32, grid_shape=(320, 256),
          video_format="cine10"),
     slice(0, 8), FRAME_KERNELS + ("unpack10",)),
]
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


def add_row(rows, name, shape, err, ok, detail, fn, plain_fn, nbytes):
    """Time a kernel and its twin (kernel, plain) at ``shape`` and record
    them in the kernel's row; the achieved HBM rate is ``nbytes`` (what the
    call must move) over the kernel time.  A kernel checked at several
    shapes keeps each under ``shapes``; its top-level ``ms``/``plain_ms``
    are the last shape's (the full configuration's), its ``max_abs_err``
    the largest."""
    ms = cuda_time(fn)
    plain_ms = cuda_time(plain_fn, iters=5, warmup=1)
    print(f"  {name} at {shape}: max_abs_err {err:.4g} ({detail}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {nbytes / 1e6:.1f} MB per "
          f"call, {nbytes / ms / 1e6:.0f} GB/s", flush=True)
    check(ok, f"{name} kernel within bound of its twin at {shape}")
    row = next((r for r in rows if r["name"] == name), None)
    if row is None:
        source, replaces = KERNEL_INFO[name]
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=0, launches_by_path={}, max_abs_err=0.0, shapes=[])
        rows.append(row)
    row["shapes"].append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms))
    row.update(max_abs_err=max(row["max_abs_err"], err), ms=ms, plain_ms=plain_ms)


def kernel_phase_ecc(rows, H, W):
    """K1-K4 against their twins on B frames of H x W."""
    import numpy as np
    import torch

    from upsp_tpu_torch.ops import ecc_kernels as K

    shape = f"{B}x{H}x{W}"
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
    px = B * H * W

    def edge_mask(w):
        """Pixels within 2 px of a border-straddling sample: there the value
        moves by the full pixel value per pixel of position, so the bound
        is position rounding (4 ulps of the larger frame side) times the
        pixel value."""
        ys = w[:, 1, 1, None] * np.arange(H) + w[:, 1, 2, None] + w[:, 1, 0, None] * (W - 1) / 2
        xs = w[:, 0, 0, None] * np.arange(W) + w[:, 0, 2, None] + w[:, 0, 1, None] * (H - 1) / 2
        ry = (ys < 3) | (ys > H - 4)
        rx = (xs < 3) | (xs > W - 4)
        return ry[:, :, None] | rx[:, None, :]

    edge = edge_mask(w)
    edge_bound = 4 * float(np.spacing(np.float32(max(H, W)))) * 4096

    def image_err(got, want, bound=2e-3):
        d = (got - want).abs().cpu().numpy()
        inner = float(d[~edge].max())
        outer = float(d[edge].max()) if edge.any() else 0.0
        ok = inner <= bound and outer <= edge_bound + bound
        return max(inner, outer), ok, f"interior {inner:.3g} <= {bound}, edge {outer:.3g} <= {edge_bound + bound:.3g}"

    got = K.blur(imgs, taps5)
    want = K.blur_plain(imgs, taps5)
    d = float((got - want).abs().max())
    add_row(rows, "blur", shape, d, d <= 2e-3, "bound 2e-3",
            lambda: K.blur(imgs, taps5), lambda: K.blur_plain(imgs, taps5), 8 * px)

    err, ok, det = image_err(K.warp_affine_banded(imgs, warps), K.warp_plain(imgs, warps))
    add_row(rows, "warp", shape, err, ok, det, lambda: K.warp_affine_banded(imgs, warps),
            lambda: K.warp_plain(imgs, warps), 8 * px)

    got = K.ecc_gn_moments(imgs, tmpl, warps, mask).cpu().numpy()[:, :42]
    want = K.moments_plain(imgs, tmpl, warps, mask).cpu().numpy()[:, :42]
    diff = np.abs(got - want)
    rel = 0.0  # per statistic group, relative to its own largest member
    for lo, hi in [(0, 18), (18, 24), (24, 30), (30, 36), (36, 37), (37, 39),
                   (39, 42)]:
        scale = np.abs(want[:, lo:hi]).max(axis=1, keepdims=True)
        rel = max(rel, float((diff[:, lo:hi] / (np.abs(want[:, lo:hi]) + scale)).max()))
    add_row(rows, "moments", shape, float(diff.max()), rel <= 2e-4,
            f"max rel {rel:.3g} <= 2e-4 (f32 reduction order)",
            lambda: K.ecc_gn_moments(imgs, tmpl, warps, mask),
            lambda: K.moments_plain(imgs, tmpl, warps, mask), 4 * px + 4 * H * W)

    o1 = K.warp_filter(imgs, warps, taps3)
    o2, iw = K.warp_filter(imgs, warps, taps3, with_warped=True)
    p_out, p_iw = K.warp_filter_plain(imgs, warps, taps3, True)
    e1, k1, d1 = image_err(o1, p_out)
    e2, k2, d2 = image_err(o2, p_out)
    e3, k3, d3 = image_err(iw, p_iw)
    add_row(rows, "warp_filter", shape, max(e1, e2, e3), k1 and k2 and k3,
            f"filtered {d1}; with_warped {d2}; warped {d3}",
            lambda: K.warp_filter(imgs, warps, taps3, with_warped=True),
            lambda: K.warp_filter_plain(imgs, warps, taps3, True), 12 * px)
    torch.cuda.synchronize()


def synthetic_plan(rng):
    """A full-config gather plan: a 1024x1024 grid seen by 4 cameras in
    strips (row-major image positions, as a plate grid projects), ~10%
    invisible (weight 0), 1% skipped, every 97th node a superseded copy of
    its neighbour."""
    import numpy as np

    from upsp_tpu_torch.ops.gather_kernels import build_gather_plan

    gi = gj = 1024
    i, j = np.meshgrid(np.arange(gi), np.arange(gj), indexing="ij")
    cam = (i * FULL_C) // gi
    row = 40 + (j * (FULL_H - 80)) // gj
    col = 60 + ((i % (gi // FULL_C)) * (FULL_W - 120)) // (gi // FULL_C)
    idx = (cam * FULL_H * FULL_W + row * FULL_W + col).ravel()
    n = idx.size
    w = rng.uniform(0.5, 1.0, n).astype(np.float32)
    invisible = rng.random(n) < 0.1
    w[invisible] = 0.0
    idx[invisible] = 0
    skipped = invisible & (rng.random(n) < 0.1)
    sup = np.arange(n)
    sup[::97] = np.minimum(sup[::97] + 1, n - 1)
    return build_gather_plan(idx, w, skipped, sup, (), FULL_C * FULL_H * FULL_W,
                             device=DEVICE)


def kernel_phase_ingest(rows):
    """K5-K8 against their twins at the full configuration's shapes: all
    four do selects, integer operations and one multiply, so they must
    match exactly."""
    import numpy as np
    import torch

    from upsp_tpu_torch.ops import ecc_kernels as K
    from upsp_tpu_torch.ops import gather_kernels as G
    from upsp_tpu_torch.ops import unpack_kernels as U
    from upsp_tpu_torch.pipeline.run import LUT_10_TO_12

    rng = np.random.default_rng(2)
    n_img, px = B * FULL_C, FULL_H * FULL_W
    frames = f"{B}x{FULL_C}x{FULL_H}x{FULL_W}"

    # K5: (8, 4*1200*1800) frames through a 1,048,576-node plan
    plan = synthetic_plan(rng)
    stacked = (2000 + 300 * torch.randn((B, plan.n_pixels), device=DEVICE,
                                        generator=torch.Generator(DEVICE).manual_seed(5)))
    got, want = G.project_gather(stacked, plan), G.gather_plain(stacked, plan)
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    fin = ~torch.isnan(want)
    err = float((got[fin] - want[fin]).abs().max())
    nodes = plan.n_nodes
    add_row(rows, "gather", f"{frames} -> {nodes} nodes", err, same_nan and err == 0.0,
            f"exact; NaN at the same {int((~fin).sum())} entries",
            lambda: G.project_gather(stacked, plan),
            lambda: G.gather_plain(stacked, plan), B * nodes * 8 + nodes * 12)

    # K6: 32 images of 1200x1800 with 0, 3, 5 and 6 hot pixels (6 > 5:
    # left as it is); corners and edges included
    imgs = torch.tensor(rng.normal(2000, 150, (n_img, FULL_H, FULL_W)).astype(np.float32),
                        device=DEVICE)
    spots = [(0, 0), (0, FULL_W - 1), (FULL_H - 1, 0), (FULL_H - 1, FULL_W - 1),
             (0, FULL_W // 2), (FULL_H // 2, 0), (FULL_H // 2, FULL_W // 2)]
    for k in range(n_img):
        for y, x in spots[: (0, 3, 5, 6)[k % 4]]:
            imgs[k, y, x] = 4095.0
    got, want = K.fix_hot_pixels_kernel(imgs), K.fix_hot_pixels(imgs)
    err = float((got - want).abs().max())
    changed = int((want != imgs).sum())
    add_row(rows, "hot", f"{n_img}x{FULL_H}x{FULL_W}", err,
            bool(torch.equal(got, want)) and changed > 0,
            f"exact; the twin repaired {changed} pixels",
            lambda: K.fix_hot_pixels_kernel(imgs), lambda: K.fix_hot_pixels(imgs),
            12 * n_img * px)

    # K7/K8: random packed bytes of 8 frames x 4 cameras x 1200x1800
    gen = torch.Generator(DEVICE).manual_seed(7)
    b12 = torch.randint(0, 256, (n_img * px * 3 // 2,), dtype=torch.uint8,
                        device=DEVICE, generator=gen)
    got, want = U.unpack_12bpp(b12), U.unpack_12bpp_plain(b12)
    err = float((got - want).abs().max())
    add_row(rows, "unpack12", f"{frames} packed", err, bool(torch.equal(got, want)), "exact",
            lambda: U.unpack_12bpp(b12), lambda: U.unpack_12bpp_plain(b12),
            n_img * px * 11 // 2)
    b10 = torch.randint(0, 256, (n_img * px * 5 // 4,), dtype=torch.uint8,
                        device=DEVICE, generator=gen)
    lut = torch.tensor(LUT_10_TO_12.astype(np.float32), device=DEVICE)
    got, want = U.unpack_10bpp(b10, lut), U.unpack_10bpp_plain(b10, lut)
    err = float((got - want).abs().max())
    raw_ok = torch.equal(U.unpack_10bpp(b10), U.unpack_10bpp_plain(b10))
    add_row(rows, "unpack10", f"{frames} packed", err,
            bool(torch.equal(got, want)) and raw_ok,
            "exact, with the cine 10->12 LUT and without",
            lambda: U.unpack_10bpp(b10, lut), lambda: U.unpack_10bpp_plain(b10, lut),
            n_img * px * 21 // 4)
    torch.cuda.synchronize()


def run_cli(argv):
    saved = sys.argv
    sys.argv = argv
    try:
        runpy.run_path(SCRIPT, run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise SmokeFailure(f"upsp-process-torch exited with {e.code}")
    finally:
        sys.argv = saved


def datapoint_path(label, spec, batch, expect):
    """One datapoint through the CLI, its outputs, and one batch of its
    packed frames on the card against the CPU twins; returns the kernel
    launch counts of the CLI run."""
    import numpy as np
    import torch

    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.pipeline.phase0 import run_phase0
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
    from upsp_tpu_torch.pipeline.run import (
        FLAT_FILES,
        open_videos,
        packed_ingest_config,
        read_flat,
        read_input_deck,
    )
    from upsp_tpu_torch.pipeline.synthetic import write_datapoint

    print(f"  -- path {label}", flush=True)
    rng = np.random.default_rng(1)
    # jitter <= 2 px whose fractional parts stay clear of +-0.5, so the
    # integer pre-shift cannot round differently on the card and the CPU
    shifts = rng.integers(-1, 2, (N_DISTINCT, 2)) + rng.uniform(-0.3, 0.3, (N_DISTINCT, 2))
    shifts[0] = 0.0
    root = os.path.join(WORK, "dp")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    dp = write_datapoint(root, n_targets=N_TARGETS, seed=1, shifts=shifts,
                         hot_pixels=True, **spec)
    n_frames = spec["n_frames"]
    n_cams = spec["n_cameras"]
    n_nodes = spec["grid_shape"][0] * spec["grid_shape"][1]
    print(f"  datapoint written in {time.perf_counter() - t0:.2f} s", flush=True)

    timings = os.path.join(root, "timings.json")
    cuda_lib.reset_launch_counts()
    run_cli([SCRIPT, "-input_deck", dp["deck"], "--registration-telemetry",
             "--timings", timings, "--device", DEVICE])
    torch.cuda.synchronize()
    counts = cuda_lib.launch_counts()
    print(f"  launches on this path: {counts}", flush=True)
    for name in expect:
        check(counts[name] > 0, f"kernel {name} launched on this path")

    with open(timings) as fh:
        t = json.load(fh)
    frames_s = t["phase1"] - t["phase1_setup"]
    print(f"  phase 0 {t['phase0']:.3f} s; phase 1 {t['phase1']:.3f} s for "
          f"{t['n_frames']} frames x {n_cams} cameras = "
          f"{t['n_frames'] / t['phase1']:.1f} frames/s, of which set-up "
          f"{t['phase1_setup']:.3f} s and frames {frames_s:.3f} s = "
          f"{t['n_frames'] / frames_s:.1f} frames/s, packed ingest included; "
          f"phase 2 {t['phase2']:.3f} s; outputs {t['outputs']:.3f} s", flush=True)

    out = dp["out_dir"]
    for name in FLAT_FILES + ("registration", "registration.json"):
        check(os.path.exists(os.path.join(out, name)), f"output {name}")
    if importlib.util.find_spec("h5py") is None:
        # as in the JAX package, the HDF5 file needs h5py; without it the
        # run logs that it skipped output.h5
        print("  h5py is not installed here: output.h5 not written (skipped "
              "with a warning, as the JAX package does)", flush=True)
    else:
        check(os.path.exists(os.path.join(out, "output.h5")), "output output.h5")
    intensity = read_flat(os.path.join(out, "intensity")).reshape(n_frames, n_nodes)
    cov = read_flat(os.path.join(out, "coverage"))
    visible = cov > 0
    check(visible.mean() > 0.9, f"coverage: {visible.mean():.3f} of nodes visible")
    check(np.isfinite(intensity[:, visible]).all(), "intensity finite on visible nodes")
    press = read_flat(os.path.join(out, "pressure_transpose")).reshape(n_nodes, n_frames)
    check(np.isfinite(press[visible]).all(), "delta-Cp finite on visible nodes")
    tele = read_flat(os.path.join(out, "registration")).reshape(n_frames, n_cams, 5)
    print(f"  registration: rho min {tele[..., 0].min():.4f}, |t| max "
          f"{np.abs(tele[..., 2:4]).max():.3f} px, bound max "
          f"{tele[..., 4].max():.3f} px", flush=True)
    check(np.isfinite(tele).all() and tele[..., 0].min() > 0.9, "registration telemetry")

    # one batch: the videos' packed bytes unpacked on the card, against the
    # CPU twins on the decoded frames
    cfg = read_input_deck(dp["deck"])
    readers, _, _ = open_videos(cfg)
    try:
        state = run_phase0(cfg, [r.read_frame(0) for r in readers],
                           [r.bit_depth for r in readers], device=DEVICE)
        use_packed, kw = packed_ingest_config(readers, None, "auto")
        check(use_packed, "the videos support packed ingest")
        k0, k1 = batch.start, batch.stop
        packed = np.stack([r.read_packed_frames(k1 - k0, start=k0) for r in readers], 1)
    finally:
        for r in readers:
            r.close()
    gpu, gtele = make_chunk_processor(state, with_telemetry=True, packed=True, **kw)(
        torch.from_numpy(packed).to(DEVICE))
    cpu, ctele = make_chunk_processor(state.to("cpu"), with_telemetry=True)(
        dp["frames"][batch])
    gpu, cpu = gpu.cpu().numpy(), cpu.numpy()
    check(np.array_equal(np.isnan(gpu), np.isnan(cpu)), "NaN at the same nodes")
    v = np.isfinite(cpu)
    d = np.abs(gpu[v] - cpu[v])
    viol = int((d > 0.2 + 1e-4 * np.abs(cpu[v])).sum())
    print(f"  frames {k0}-{k1 - 1}, card (packed) vs CPU twins: max abs "
          f"{d.max():.4g} counts, {viol} beyond rtol 1e-4 + atol 0.2; telemetry "
          f"max abs {np.abs(gtele.cpu().numpy() - ctele.numpy()).max():.3g}",
          flush=True)
    check(viol == 0, "card path matches the CPU twin path (rtol 1e-4, atol 0.2)")
    check(np.allclose(intensity[batch][:, visible], gpu[:, visible], rtol=1e-5, atol=1e-3),
          "the batch equals the CLI's intensity rows")
    shutil.rmtree(root, ignore_errors=True)
    return counts


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
    card = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else "nvidia-smi unavailable")
    print(card, flush=True)
    t_start = time.perf_counter()
    try:
        import upsp_tpu_torch  # noqa: F401  (sets the TF32 policy)
        from upsp_tpu_torch.ops import cuda_lib

        print("[1/3] build", flush=True)
        t0 = time.perf_counter()
        cuda_lib.build_all()
        print(f"  kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
        print("[2/3] kernels against their twins", flush=True)
        rows = []
        for h, w in ECC_SHAPES:
            kernel_phase_ecc(rows, h, w)
        kernel_phase_ingest(rows)
        print("[3/3] datapoints through scripts/upsp-process-torch", flush=True)
        by_path = {}  # "a", "b", "c" -> that path's launch counts
        for label, spec, batch, expect in PATHS:
            by_path[label.split(":")[0]] = datapoint_path(label, spec, batch, expect)
        for r in rows:
            r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
            r["launches"] = sum(r["launches_by_path"].values())
            check(r["launches"] > 0, f"kernel {r['name']} launched on the main paths")
        check({r["name"] for r in rows} == set(KERNEL_INFO), "every kernel has a row")
    except (SmokeFailure, AssertionError, RuntimeError, ImportError,
            NotImplementedError, OSError, ValueError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 3
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
