#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device:

1. prints torch's version and the card's name and power limit;
2. builds every CUDA source of the port (upsp_tpu_torch/csrc/*.cu, one
   nvcc each, all started together) and prints the time;
3. holds each kernel against its plain PyTorch twin on the card and times
   both with CUDA events, and the one PyTorch call that computes the same
   function where there is one (K1: conv2d over a reflect pad, in full
   f32): K1-K4 on 8 frames of 1024x1024 and of 1200x1800, in float32 and
   in bfloat16, K1 bit for bit, with K1-K3 called twice for bit-identical
   output and K2 and K4 also on a 1.6x scale warp (their global-memory
   route) and on a shear that moves the frame's corners by 2.9 px, K2 and
   K3 on a 40 px, -25 px translation with the mask warp the warp; K3 with
   the Gauss-Newton update in its reduce stage (the step's launch) on the
   same frames, its new warps, rho and drho bit for bit with the twin's
   update of its own statistics, also on lanes that take the update's
   guards; K9
   (the fused GN step) on 8 frames of each in both, also against K2 then
   K3 and on the 2.9 px shear, bit-identical from call to call, with its
   registers; K5-K8 at the full configuration's shapes (8 frames x 4
   cameras x 1200x1800, a 1,048,576-node gather plan; K5 with f32 and with
   bf16 frames, from the camera images and from a stack, also on a plan
   with a partial last tile and an all-NaN tile and in plain model order,
   with its sector floor; K6 also on an all-saturated frame and adjacent
   hot pixels; both bit-identical from call to call); K10 (the phase
   correlation's k x k pooling) at 8 x 4 x 1200x1800, k = 4, f32 and
   bf16, bit for bit, also on a camera's strided slice, with
   ``F.avg_pool2d`` as its yardstick and the parent's two pooling GEMMs
   timed beside it; K11 (phase 0's visibility walk) over the full
   configuration's 1,048,576 nodes from its 4 camera centres, bit for bit
   with the native library's rays, with the native rays' time, the rays a
   second and the scene's upload;
4. drives four synthetic datapoints through scripts/upsp-process-torch,
   each run (and (e), (f) below) with the kernel launch counts reset just
   before and read just after, packed ingest on and hot pixels injected, in this order:
   (a) 2 cameras x 1024x1024 12-bit .mraw, 64 frames, 81,920 nodes;
   (r) right after (a), on its files: the processing tree.  A data/user/
       proc JSON names (a)'s inputs and options,
       scripts/upsp-make-processing-tree-torch builds the tree, and its
       03_launchers/step+psp_process runs the datapoint (scripts/ on PATH,
       behind a wrapper that adds --timings to upsp-process-torch so the
       run's launch counts can be read): K1-K7 launched, every flat file
       bit for bit against a direct upsp-process-torch on the tree's deck
       (as (a)'s deck sets number_frames, which the tree cannot render)
       and compared with (a)'s; the tree's build time and the datapoint's
       wall time;
   (c) 2 cameras x 1024x1024 10-bit packed .cine, 32 frames;
   (h) (c)'s configuration with the deck option pixel_interpolation =
       nearest, through --ecc-init scan (the while loop from the previous
       frame's warp, nearest final warps: no K4);
   (b) the full configuration: 4 cameras x 1200x1800 12-bit .mraw, 64
       frames, a 1024x1024 grid (1,048,576 nodes);
   (d) path (b)'s files again with --compute-dtype bfloat16;
   then (b)'s files once more in f32 and in bf16, for a bf16-against-f32
   frames/s that (b)'s first run at 1200x1800 does not bias; every path
   uses polynomial patches, gaussian 3, best view and, but (g) and (h),
   the fft warm start;
   right after (b), on its files and outputs, in this process:
   (m) ``run_phase0`` on the device walk (the library's loader made to
       report it missing, as the tests do; the flat BVH still builds
       natively) against the native walk (its rays on K11, once a camera),
       each timed, then the native walk on the CPU (the host's rays):
       every field of K11's route equal to the
       host's on every node, both walks' seconds and nodes rechecked;
       visible masks and best-view weights equal on every node
       (the native route's recheck recovers the plate-edge nodes its rays
       miss), pixel_index, u and v equal up to the f32 projection's
       rounding, equal patch operators and skip masks, and the native
       walk's recheck against the walk (their ``stage_times`` seconds);
       then
       ``keyframe_mapping`` of all 1,048,576 nodes of each camera on the
       card against a float64 CPU evaluation on 4,096 of them, and
       ``remap_error_bound`` at a pose step of 1e-3;
   (n) one 64-frame chunk on the card through
       ``make_chunk_processor(vmap_cameras=True)`` against the per-camera
       loop on the dense step without the pre-shift (rtol 1e-4 / atol
       1e-2, translations within 1e-3 px), the batched run launching K1,
       K2, K5, K6 and not K3, K4, K9; the frames/s of both and of the
       default loop printed;
   (o) ``scripts/upsp-integrate-forces-torch`` on (b)'s
       pressure_transpose with 8 x 8 panels over the plate (a PLOT3D grid
       this script writes): fomo against a float64 numpy product of the
       same operator, panels.csv with 64 rows;
   (p) ``surface_psd`` of the same block (nperseg 32, 10 nodes set to
       NaN) against scipy.signal.welch in float64 on 1,000 nodes, NaN
       nodes NaN, its seconds and peak device memory;
   (s) right after (n), the JAX package's calls that the port now takes
       as it does (``drop_in_path``): (s1) ``run_datapoint(frame_batch=16)``,
       every flat file against (b)'s within the f32 bounds, bit for bit or
       not printed; (s2) ``process_frame(adjust_overlap=False)`` and
       ``=True`` on one frame on the card, with supersession equal to
       without it indexed by ``superseded_by`` bit for bit, on (b)'s plan
       and on one with 10,000 nodes superseded; (s3)
       ``make_chunk_processor(state)`` at its defaults (scan starts, a
       frame at a time) on 8 frames on the card, K1-K6 launched, its
       frames/s beside (b)'s and (n)'s default loop;
       (s1) then prints which stage of the frame program first depends on
       the frame batch (``upsp_tpu_torch.tools.batch_stages``: each
       stage's outputs at batches of 8 and of 16 on (b)'s first 16 frames;
       the hot pixels and the phase correlation must not), and checks each
       camera's pooled frames (K10) and phase correlation, and its patch
       products alone: a frame's values the same bit for bit in batches
       of 16, 8 and 1 on the card;
   (t) right after (s), the port's measurement tools
       (``upsp_tpu_torch/tools/``) on the card, each record printed:
       ``bench`` (1 MP, f32 and bf16, 5 trials), ``bench_fullconfig``
       (fft, f32, phase 2), ``profile_phase1`` at 1 MP and at (b)'s shapes
       on (b)'s state (the profiler's K1-K6 launches equal to the wrappers'
       counts over the same chunks, busy share in (0, 1]),
       ``bench_ablate``, ``bench_components`` (1 MP), ``bench_hbm`` (its
       best rate beside the 3.35 TB/s the bounds assume),
       ``correlate`` at (b)'s shapes under the profiler (K10, no matrix
       product), and ``bench_endurance`` at 512 frames of
       1,048,576 nodes (15 flat files, finite statistics); no K7, K8;
   between (b) and (d), two out-of-core runs (``run_datapoint_streaming``):
   (e) (b)'s files through ``upsp-process-torch --streaming`` in f32,
       with its disk transpose (numpy, fewer rows than a native block)
       timed against the native one on the same file;
   (f) 256 frames at 1,048,576 nodes in this process, from a callable
       source that tiles (b)'s 64 frames from one tensor on the card,
       with its peak device memory and phase 2's memory per node block,
       after a sweep of phase 2's memory against the frame count; then
       the native and the numpy transpose of a 4096 x 32768 file, and
       the column transposes that (j)'s two ranks make, on the same file;
   between (e) and (f), two runs of (b)'s files as two ranks of
   ``upsp-process-torch --distributed``, two processes on the one card
   (gloo by the transport rule), each rank's launch counts and stage
   seconds from its --timings file:
   (i) in memory, its files against (b)'s;
   (j) out of core (--streaming), its intensity_transpose against (e)'s
       bit for bit and its other files against (b)'s;
   and between (f) and (d):
   (g) (b)'s files through --no-warm-start (reference parity: identity
       starts, the while loop), into an output directory of its own, with
       its frames/s, the histogram of its iteration counts and its
       largest translation difference from (b);
   then (k): a one-rank NCCL group in this process, the exchange, the
   gathers, the f64 reduction and the barrier on a 64 x 1,048,576 block
   against torch, the exchange timed (the only NCCL code a one-card
   machine runs);
   then (l): external calibration on the card, in this process:
   scripts/upsp-external-calibration-torch --joint_ba on (b)'s rig (4 x
   1200x1800 first frames of a faint-texture datapoint, the plate grid of
   1,048,576 nodes, 24 targets) from camera-tunnel poses perturbed as
   tests/test_external_calibrate.py perturbs them: every pose recovered
   (rmat within 5e-3, tvec within 3e-2), reprojection rms < 1 px, device
   memory allocated and, by an audit of every op, no float tensor made
   on the CPU but copies and views; its stage seconds; then
   ``ops.raycast.node_visibility`` of every node from each camera centre
   on the device walk and on the native walk, timed, their disagreements
   bounded by the grazing rays the jittered retries recovered, and the
   device walk at each look interval of L_CHECK_EVERY;
   last, (q): bundle_adjust(mesh=) in f64 on (b)'s rig (4 cameras, (l)'s
   24 targets) and on 4 cameras x 1,000 points, perturbed as
   tests/test_torch_ba.py perturbs its rig: mesh=None, a one-rank NCCL
   group in this process (bit for bit against mesh=None), then two gloo
   ranks on the one card, each with half of the observations (poses and
   points within 1e-8, rms within 1e-9 of mesh=None; the ranks equal),
   each form timed and every solve repeated bit for bit; no K1-K9 kernel;
5. checks each path's outputs (all flat files, the registration sidecar,
   output.h5 where h5py is installed, finite values on visible nodes, the
   kernels the path must launch, and for (d) that no f32 ECC kernel ran)
   and one batch of its frames — packed bytes unpacked on the card —
   against the port's CPU twin path with the same ECC start ((g) and (h):
   the sidecar says "iters", column 1 holds integers in [1, 50], iteration
   counts within one of the twins'); (d)'s batch also against (b)'s; (e)'s
   outputs against (b)'s, (f)'s first 64 intensity rows and frame
   statistics against (b)'s; every rank of (i) and (j) on the card,
   launching K1-K7.

Prints the seconds of each phase, then the kernel table as one JSON line
(per kernel: ``launches`` over the paths and ``launches_by_path``;
``ms``/``device_ms``/``plain_ms``/``library_ms`` and
``bound_ms``/``bound_by`` at the full configuration's shape, every
measured shape under ``shapes``; ``bound_share``, the bound over
``device_ms``; the redesigned K1-K6 and K9 also ``redesigned``, with
their time before the redesign printed on a line of its own; K5 also
``sector_floor_ms``, ``stacked_device_ms`` and
``model_order_device_ms``; K11 also ``rays``, ``rays_per_s`` and
``upload_s``; K10 also ``gemm_ms``, the parent's two
pooling GEMMs, and its bf16 instantiation ``kernel_phase_only`` (the
phase correlation pools f32 frames in both compute dtypes); K9 also ``split_ms``/``split_device_ms``, the
time of K2 then K3, ``registers`` and ``local_bytes`` a thread, and
``kernel_phase_only``: no datapoint path runs it; K3 as the Gauss-Newton
step launches it, with the update in its reduce stage, is
``moments_update``, and K3 alone ``kernel_phase_only``), the card's name and
power limit, then as the last line {"ok": true, "device": {...}}.
Exits non-zero, printing no result, when CUDA is unavailable, the
repository is missing, or any phase fails.
"""

import importlib.util
import json
import math
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
GATHER_CU = "upsp_tpu_torch/csrc/gather.cu"
KERNEL_INFO = {  # name -> (source, the TPU kernel it replaces)
    "blur": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:829"),
    "warp": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:285"),
    "moments": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:587"),
    # K3 with the Gauss-Newton update in its reduce stage: the kernel and
    # the XLA update after it (body_pallas)
    "moments_update": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:587 + "
                       "upsp_tpu/ops/registration.py:298-343"),
    "warp_filter": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:444"),
    "gn_fused": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:1044"),
    "gather": (GATHER_CU, "upsp_tpu/ops/pallas_gather.py:251"),
    "hot": (ECC_CU, "upsp_tpu/ops/pallas_ecc.py:739"),
    "unpack12": ("upsp_tpu_torch/csrc/unpack.cu", "upsp_tpu/ops/pallas_unpack.py:37"),
    "unpack10": ("upsp_tpu_torch/csrc/unpack.cu", "upsp_tpu/ops/pallas_unpack.py:76"),
    # K10 replaces no Pallas kernel: the XLA dot of decimate_image
    "pool": ("upsp_tpu_torch/csrc/fftreg.cu", "upsp_tpu/ops/fftreg.py:74"),
    # K11 replaces no Pallas kernel: the native walk's rays, retries and tests
    # in numpy around cpp/'s upsp_bvh_intersect
    "walk": ("upsp_tpu_torch/csrc/walk.cu", "upsp_tpu/ops/projection.py:118"),
}
# the bfloat16 instantiations replace the same TPU kernels (out_dtype=imgs.dtype)
for _k in ("blur", "warp", "moments", "moments_update", "warp_filter", "gn_fused",
           "gather", "pool"):
    KERNEL_INFO[f"{_k}_bf16"] = KERNEL_INFO[_k]
# no datapoint path runs K9, nor K10 on bf16 frames (the phase correlation
# takes the f32 frames in both compute dtypes), nor K3 without the update
# (the Gauss-Newton step launches ``moments_update``; ``moments`` is the
# statistics alone, for the tools and the statistics' own check)
KERNEL_PHASE_ONLY = ("gn_fused", "gn_fused_bf16", "pool_bf16", "moments",
                     "moments_bf16")
# the least time of a call: bytes over the HBM rate, operations over the
# f32 (CUDA-core) rate -- every kernel computes in f32 -- whichever is
# larger (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# floating-point operations per output pixel (per node for K5) that the
# function needs, an FMA as two.  Work that is constant along a row or a
# column is done once per row or column and left out: sample positions and
# tent weights, the Taylor displacements, and the y factors of the
# statistics (sum f*x*y = y * sum_row f*x).  K1: a 5-tap pass (9), twice.
# K2: four tent taps (9) and the order-2 Taylor term (27: five derivatives
# 16, the cross displacement 1, five FMAs 10).  K4: K2 and a 3-tap pass
# (5), twice.  K3: central differences 4, the rotated gradient 6, the
# brightness shifts 2, the three Hessian products 3 and their x-moments 15
# (f*x, then sums of f*x*x, f*x, f), the gradient-times-z products 4 and
# their sums 18 (g*z*x and g*z for two g and three z), the masked sums 9.
# K9: K2 + K3.  K5: one multiply.  K6: two compares.  K7/K8: integer work.
# K10 (per pooled pixel, k x k block): k column sums of k products (2k^2 -
# k), then k products and k - 1 sums: 2k^2 + k - 1 (:func:`pool_flops`).
FLOPS = {"blur": 2 * 9, "warp": 9 + 27, "warp_filter": 36 + 2 * 5, "moments": 61,
         "gn_fused": 36 + 61, "gather": 1, "hot": 2, "unpack12": 0, "unpack10": 0}
# K3's update epilogue, per lane (every rounded op, clamp, compare and
# select of ``gn_update_lane``): the statistics 39 (two means 2, the
# projections 24, the two variances and the correlation 9, the area's and
# the norm's clamps 4), the regularisation 8, the 6x6 Cholesky 139 (21
# entries of 2, their 70 products and differences, 6 square roots with
# their clamps, 15 quotients), two triangular solves of 72, the two dot
# products, num, den, its floor and lam 26, the increments with their
# finiteness selects 24, rho and |drho| 8
UPDATE_FLOPS = 39 + 8 + 139 + 2 * 72 + 26 + 24 + 8


def pool_flops(k):
    return 2 * k * k + k - 1
B = 8  # the frame batch of the frame program
FULL_C, FULL_H, FULL_W = 4, 1200, 1800
# K1-K4 are checked at the frame sizes of paths (a)/(c) and of (b), whose
# 1800-px rows end in partial tiles
ECC_SHAPES = ((1024, 1024), (FULL_H, FULL_W))
N_DISTINCT, N_TARGETS = 16, 12
# the datapoint paths' K3 is the Gauss-Newton step's, with the update
F32_ECC = ("blur", "warp", "moments_update", "warp_filter")
FRAME_KERNELS = F32_ECC + ("gather", "hot")
# phase 0 on the card casts its visibility rays with K11, once a camera
PHASE0_KERNELS = ("walk",)
BF16_KERNELS = tuple(f"{k}_bf16" for k in F32_ECC + ("gather",)) + ("hot",)
# (label, write_datapoint arguments, frames of the card-vs-CPU batch,
#  kernels the path must launch), f32
PATHS = [
    ("a: 2 x 1024x1024 mraw12, 64 frames, 81,920 nodes",
     dict(n_cameras=2, image_hw=(1024, 1024), n_frames=64, grid_shape=(320, 256)),
     slice(0, 8), FRAME_KERNELS + ("pool", "unpack12") + PHASE0_KERNELS),
    ("c: 2 x 1024x1024 cine10, 32 frames, 81,920 nodes",
     dict(n_cameras=2, image_hw=(1024, 1024), n_frames=32, grid_shape=(320, 256),
          video_format="cine10"),
     slice(0, 8), FRAME_KERNELS + ("pool", "unpack10") + PHASE0_KERNELS),
]
# the full configuration, written once and run as (b) in f32 and (d) in
# bf16: (label, compute dtype, kernels the path must launch)
FULL = dict(n_cameras=FULL_C, image_hw=(FULL_H, FULL_W), n_frames=64,
            grid_shape=(1024, 1024))
FULL_BATCH = slice(1, 3)
# path (f): (b)'s 64 frames tiled to this many, streamed at 1,048,576 nodes
LONG_FRAMES = 256
# frame counts of the phase-2 memory sweep, at 65,536 nodes a block
P2_SWEEP_FRAMES = (256, 1024, 4096, 8192)
P2_NODE_BLOCK = 65536
# the flat-file transpose timed with more frames than a native block
TALL = (4096, 32768)
FULL_PATHS = (
    ("b: full config, 4 x 1200x1800 mraw12, 64 frames, 1,048,576 nodes",
     "float32", FRAME_KERNELS + ("pool", "unpack12") + PHASE0_KERNELS),
    # the phase correlation pools the f32 frames in both dtypes: K10 in f32
    ("d: full config in bfloat16 (--compute-dtype bfloat16), path (b)'s files",
     "bfloat16", BF16_KERNELS + ("pool", "unpack12") + PHASE0_KERNELS),
)
# path (g): (b)'s files again, reference parity (identity starts, the while
# loop), into an output directory of its own
G_LABEL = ("g: full config with --no-warm-start (identity starts, the while loop), "
           "path (b)'s files")
# path (h): (c)'s configuration with nearest final warps, scan starts; no K4
H_PATH = ("h: 2 x 1024x1024 cine10, 32 frames, 81,920 nodes, pixel_interpolation = "
          "nearest, --ecc-init scan",
          dict(n_cameras=2, image_hw=(1024, 1024), n_frames=32, grid_shape=(320, 256),
               video_format="cine10", options=["pixel_interpolation = nearest"]),
          slice(0, 8), ("blur", "warp", "moments_update", "gather", "hot", "unpack10")
          + PHASE0_KERNELS)
# (e)'s outputs against (b)'s: what phase 1 writes exactly, the frame
# statistics (summed in f64 in another order) within rtol 1e-5, carried to
# ratio_0 as atol 1e-5 since avg / I0 is near 1, phase 2 within
# tests/test_outputs.py's bounds; (j) is held to the same
E_FILES = ("intensity", "intensity_avg", "intensity_rms", "intensity_ratio_0",
           "coverage", "gain", "steady_state", "model_temp", "pressure_transpose",
           "avg", "rms")
E_TOL = {"intensity_avg": dict(rtol=1e-5), "intensity_rms": dict(rtol=1e-5),
         "intensity_ratio_0": dict(atol=1e-5),
         "pressure_transpose": dict(rtol=1e-4, atol=1e-6),
         "avg": dict(rtol=1e-4, atol=1e-6), "rms": dict(rtol=1e-4, atol=1e-6)}
# path (s): the JAX package's calls on (b)'s files.  (s1)'s files against
# (b)'s: intensities and their statistics within the f32 bound (rtol 1e-4,
# atol 0.2 counts), what is derived from their ratios within atol 5e-4 (0.2
# counts of ~2000), the rest exactly (tests/test_torch_slice.py's table)
S_FRAME_BATCH = 16
S_INTENSITY = ("intensity", "intensity_transpose", "intensity_avg", "intensity_rms")
S_RATIO = ("intensity_ratio_0", "pressure_transpose", "avg", "rms")
S_SUPERSEDED = 10_000  # live nodes (s2) gives another node's value
S_FRAMES = 8  # (s3)'s frames, scan starts a frame at a time
# path (t): the measurement tools (upsp_tpu_torch/tools/), each through its
# run(argv) as ``python -m upsp_tpu_torch.tools.<name>`` runs it
T_TRIALS = 5  # bench's timing trials
T_TOP = 12  # rows of each profile's table
T_CORRELATE_CALLS = 4  # correlate calls in its profiler window
# 2 GiB a flat file at 1,048,576 nodes; the disk probe 1 GiB (a chip
# machine's disk takes ~45 GiB of writes a call, this script's included)
T_ENDURANCE_FRAMES = 512
# (b)'s configuration for the profile at its shapes, with (b)'s state
T_FULL_ARGS = ["--cams", str(FULL_C), "--hw", f"{FULL_H},{FULL_W}",
               "--grid", "1024,1024", "--reps", "4"]
# the launches of csrc/*.cu's K1-K6 and K10 kernels that each profile must
# count
T_PROFILED = ("blur_kernel", "warp_kernel", "moments_kernel", "moments_reduce_kernel",
              "warp_filter_kernel", "gather_kernel", "hot_scan_kernel",
              "hot_repair_kernel", "pool_kernel")
# paths (i) and (j): (b)'s files through two CLI ranks on the one card
RANKS = 2
RANK_TIMEOUT_S = 300
# path (k): the NCCL exchange of one rank, on a (frames, nodes) f32 block
K_SHAPE = (64, 1 << 20)
# path (l): external calibration of (b)'s rig (4 x 1200x1800, the plate grid
# of 1,048,576 nodes) from one first frame a camera, faint texture
# (``write_datapoint(texture_scale=)``: at full contrast the texture moves
# the dots' fitted centres by ~1 px)
CAL_SCRIPT = os.path.join(REPO, "scripts", "upsp-external-calibration-torch")
L_TARGETS = 24
L_CHECK_EVERY = (1, 4, 16, 64)  # the device walk's look intervals, timed again
L_SPEC = dict(n_cameras=FULL_C, image_hw=(FULL_H, FULL_W), n_frames=1, n_distinct=1,
              grid_shape=(1024, 1024), n_targets=L_TARGETS, seed=0,
              texture_scale=0.1)
L_RMAT_TOL, L_TVEC_TOL, L_RMS_PX = 5e-3, 3e-2, 1.0  # tests/test_external_calibrate.py
# ops whose CPU outputs are host data on its way to or from the card (copies,
# tensors made from numpy, views of them): the calibration may make float
# tensors of one or more dimensions on the CPU with these and no other op.
# (0-d tensors on the CPU are Python constants and their zero tangents in
# torch.func's forward mode; integer ones its shape bookkeeping, e.g.
# jacfwd's basis offsets.)
# path (m): phase 0 on the device walk against the native walk, (b)'s files.
# The device walk projects in f32 (as the JAX package's device route), the
# native one in f64: at 1800 px an f32 position is good to a few 1e-4 px
M_HALF_PX = 2e-3  # a pixel_index may move only this close to a half pixel
M_UV_PX = 2e-3  # u, v agree within this (px)
M_SAMPLE = 4096  # nodes of the f64 CPU keyframe evaluation
M_KEY_TOL = 1e-4  # relative, plus 1e-2 of it times the largest magnitude
M_POSE_STEP = 1e-3  # remap_error_bound's step on each pose component
# path (o): forces on an O_PANELS x O_PANELS panel grid over the plate
FORCES_SCRIPT = os.path.join(REPO, "scripts", "upsp-integrate-forces-torch")
O_PANELS = 8
# path (p): surface PSD
P_NPERSEG, P_NAN_ROWS, P_SAMPLE = 32, 10, 1000
# path (q): bundle adjustment across ranks, f64, on (b)'s rig with (l)'s
# targets and on a wider rig, LM steps as the calibration CLI takes them
Q_ITERS = 30
Q_WIDE_POINTS = 1000
Q_POSE_TOL, Q_RMS_TOL = 1e-8, 1e-9
Q_OBS = ("cam_idx", "pt_idx", "uv", "weight")  # each rank's block of these
# path (r): (a)'s files through the processing tree's psp_process launcher
TREE_SCRIPT = os.path.join(REPO, "scripts", "upsp-make-processing-tree-torch")
R_DP = "a"  # the datapoint's name in the tree
HOST_OPS = ("aten._to_copy", "aten.copy_", "aten.lift_fresh", "aten.lift_fresh_copy",
            "aten.detach", "aten.alias", "aten.to", "aten.clone")
DEVICE = "cuda"
# the redesigned kernels' ``ms`` before their redesign (PERF.md section 6:
# this script on an NVIDIA H100 80GB HBM3 at 700.00 W; K3/K4 as first
# written, K1/K2 before their own redesign, on 8 frames of each of
# ECC_SHAPES; K5/K6 before their redesign, at the full configuration's shapes;
# K9 as first written, on 8 frames of each of ECC_SHAPES, 1024x1024 from
# a sweep of that commit's K9 by a tool since removed, the mean of two
# runs), printed beside this run's ``ms`` and kept out of the kernels
# line
PREV_MS = {"moments": (0.1356, 0.2357), "moments_bf16": (0.1224, 0.2481),
           "warp_filter": (0.1645, 0.3355), "warp_filter_bf16": (0.1642, 0.3349),
           "blur": (0.0892, 0.1744), "blur_bf16": (0.0880, 0.1751),
           "warp": (0.0783, 0.1498), "warp_bf16": (0.0771, 0.1525),
           "hot": 0.3831, "gather": 0.2273, "gather_bf16": 0.1971,
           "gn_fused": (0.2008, 0.4047), "gn_fused_bf16": (0.1903, 0.4174)}


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def cuda_time(fn, iters=20, warmup=3, graph=False):
    """ms per call of ``fn``: CUDA events around ``iters`` calls after
    ``warmup``.  With ``graph`` the calls are captured once into a CUDA
    graph and the replay is timed, so the host's share of a call (Python,
    ctypes, allocation), which the card would otherwise wait for when a
    call is short, is left out: the device's time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        run = g.replay
    else:
        def run():
            for _ in range(iters):
                fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def add_row(rows, name, shape, err, ok, detail, fn, plain_fn, nbytes, flops,
            library_fn=None, prev_ms=None, **extra):
    """Time a kernel, its twin and (where there is one) the one PyTorch
    call that computes the same function, in turns, at ``shape``, and
    record them in the kernel's row with the least time the card could
    take: ``nbytes`` (each input read once, each output written once) over
    the HBM rate or ``flops`` over the f32 rate, whichever is larger.
    ``ms``, ``plain_ms`` and ``library_ms`` time calls made from Python,
    host included, as this script always has; ``device_ms`` replays the kernel's
    calls from a CUDA graph, the device's time alone, and the share of the
    bound is taken of it.  ``prev_ms``, an earlier version's ``ms``, is printed
    beside ``ms`` and not recorded.  A kernel checked at several shapes
    keeps each under ``shapes``; its top-level numbers are the last
    shape's (the full configuration's), its ``max_abs_err`` the largest."""
    ms = cuda_time(fn)
    device_ms = cuda_time(fn, graph=True)
    plain_ms = cuda_time(plain_fn, iters=5, warmup=1)
    library_ms = cuda_time(library_fn) if library_fn is not None else None
    by_bytes, by_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(by_bytes, by_flops)
    bound_by = "bytes" if by_bytes >= by_flops else "operations"
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"  {name} at {shape}: max_abs_err {err:.4g} ({detail}); kernel "
          f"{ms:.4f} ms (device {device_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"library {lib}; bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
          f"{100 * bound_ms / device_ms:.0f}% of it on the device; "
          f"{nbytes / device_ms / 1e6:.0f} GB/s", flush=True)
    if prev_ms is not None:
        print(f"  {name} at {shape}, before its redesign: {prev_ms:.4f} ms "
              f"(PERF.md section 6), {prev_ms / ms:.2f}x this run's ms", flush=True)
    check(ok, f"{name} kernel within bound of its twin at {shape}")
    row = next((r for r in rows if r["name"] == name), None)
    if row is None:
        source, replaces = KERNEL_INFO[name]
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=0, launches_by_path={}, max_abs_err=0.0, shapes=[])
        rows.append(row)
    timing = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by=bound_by,
                  bound_share=bound_ms / device_ms, **extra)
    row["shapes"].append(dict(shape=shape, max_abs_err=err, **timing))
    row.update(max_abs_err=max(row["max_abs_err"], err), **timing)


def bf16_ulp(want):
    """The spacing of bfloat16 (8 significant bits) at |want|."""
    import torch

    a = want.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def ecc_inputs(H, W, dtype):
    """B frames of H x W (a smooth field plus noise), a template, sub-pixel
    warps with a shear, and mask warps with an integer pre-shift."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 2000 + 300 * np.sin(xx / 7.3) * np.cos(yy / 5.1)
    imgs = torch.tensor(base[None] + rng.normal(0, 40, (B, H, W)).astype(np.float32),
                        device=DEVICE).to(dtype)
    tmpl = torch.tensor(base.astype(np.float32), device=DEVICE).to(dtype)
    w = np.zeros((B, 2, 3), np.float32)
    w[:, 0, 0] = 1 + rng.uniform(-1e-3, 1e-3, B)
    w[:, 1, 1] = 1 + rng.uniform(-1e-3, 1e-3, B)
    w[:, 0, 1] = rng.uniform(-1e-3, 1e-3, B)
    w[:, 1, 0] = rng.uniform(-1e-3, 1e-3, B)
    w[:, :, 2] = rng.uniform(-0.7, 0.7, (B, 2))
    warps = torch.tensor(w, device=DEVICE)
    mask = warps.clone()
    mask[:, :, 2] += torch.tensor([1.0, -1.0], device=DEVICE)
    return imgs, tmpl, warps, mask, w


def stats_err(got, want):
    """Largest error of the 42 statistics relative to |value| plus its
    group's largest member (f32 reduction order)."""
    import numpy as np

    got, want = got.cpu().numpy()[:, :42], want.cpu().numpy()[:, :42]
    diff = np.abs(got - want)
    rel = 0.0
    for lo, hi in [(0, 18), (18, 24), (24, 30), (30, 36), (36, 37), (37, 39),
                   (39, 42)]:
        scale = np.abs(want[:, lo:hi]).max(axis=1, keepdims=True)
        rel = max(rel, float((diff[:, lo:hi] / (np.abs(want[:, lo:hi]) + scale)).max()))
    return float(diff.max()), rel


def kernel_phase_ecc(rows, H, W, dtype_name):
    """K1-K4 against their twins on B frames of H x W, float32 or bfloat16:
    f32 within 2e-3 counts, bf16 within 1 bf16 ulp of the twin (both
    compute in f32 and round once), K3 within 2e-4 relative; K1-K3
    bit-identical from call to call; K2 and K4 also on a 1.6x scale warp,
    whose taps they read from global memory instead of their staged
    window, and on a shear that moves the frame's corners by 2.9 px; K2
    and K3 also on a 40 px, -25 px translation with the mask warp the warp
    (what the while loop gives them from identity).  K3 also as the
    Gauss-Newton step launches it (``moments_update``): its update bit for
    bit with the twin's of its own statistics, guard lanes included.  K1's
    yardstick, conv2d over a reflect pad, runs with cuDNN's TF32 off (its
    default for f32 convolutions is TF32)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from upsp_tpu_torch.ops import ecc_kernels as K
    from upsp_tpu_torch.ops import registration as R

    dtype = getattr(torch, dtype_name)
    sfx = "" if dtype == torch.float32 else "_bf16"
    e = 4 if dtype == torch.float32 else 2  # bytes per pixel
    shape = f"{B}x{H}x{W} {dtype_name}"
    imgs, tmpl, warps, mask, w = ecc_inputs(H, W, dtype)
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
        return torch.tensor(ry[:, :, None] | rx[:, None, :], device=DEVICE)

    edge = edge_mask(w)
    edge_bound = 4 * float(np.spacing(np.float32(max(H, W)))) * 4096

    def image_err(got, want, edge=edge):
        d = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            bound = torch.full_like(d, 2e-3)
        else:
            bound = bf16_ulp(want)
        bound = torch.where(edge, bound + edge_bound, bound)
        worst = float((d / bound).max())
        return float(d.max()), worst <= 1.0, f"max |d| / bound {worst:.3g} <= 1"

    k2d = torch.outer(*(torch.tensor(taps5, device=DEVICE),) * 2).to(dtype)[None, None]

    def conv2d_blur():
        return F.conv2d(F.pad(imgs[:, None], (2, 2, 2, 2), mode="reflect"), k2d)

    def redesign(name):
        return dict(prev_ms=PREV_MS[name][ECC_SHAPES.index((H, W))],
                    redesigned=True)

    got = K.blur(imgs, taps5)
    check(torch.equal(got, K.blur(imgs, taps5)),
          f"blur{sfx} bit-identical from call to call at {shape}")
    # K1 rounds each product and sum as its twin does: bit for bit
    err = float((got.float() - K.blur_plain(imgs, taps5).float()).abs().max())
    ok, det = err == 0.0, "exact"
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        add_row(rows, "blur" + sfx, shape, err, ok, det,
                lambda: K.blur(imgs, taps5), lambda: K.blur_plain(imgs, taps5),
                2 * e * px, FLOPS["blur"] * px, library_fn=conv2d_blur,
                **redesign("blur" + sfx))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    # a 1.6x scale: the source window outgrows K2's and K4's shared-memory
    # budget
    w_far = w.copy()
    w_far[:, 0, 0] = w_far[:, 1, 1] = 1.6
    w_far[:, :, 2] -= 0.3 * np.array([W, H], np.float32)
    far = torch.tensor(w_far, device=DEVICE)
    # a shear that displaces the frame's corners by 2.9 px in x and in y,
    # inside the TPU kernel's +-3 px band: there the Taylor terms reach
    # thousands of counts and cancel, so their rounding order shows
    w_shear = w.copy()
    w_shear[:, 0, 1] = np.sign(w[:, 0, 1]) * 2.9 / ((H - 1) / 2)
    w_shear[:, 1, 0] = np.sign(w[:, 1, 0]) * 2.9 / ((W - 1) / 2)
    shear = torch.tensor(w_shear, device=DEVICE)

    got = K.warp_affine_banded(imgs, warps)
    check(torch.equal(got, K.warp_affine_banded(imgs, warps)),
          f"warp{sfx} bit-identical from call to call at {shape}")
    err, ok, det = image_err(got, K.warp_plain(imgs, warps))
    e_far, k_far, d_far = image_err(K.warp_affine_banded(imgs, far),
                                    K.warp_plain(imgs, far), edge=edge_mask(w_far))
    check(k_far, f"warp{sfx} global-memory route (1.6x scale) matches its twin at "
          f"{shape}: {d_far}")
    e_sh, k_sh, d_sh = image_err(K.warp_affine_banded(imgs, shear),
                                 K.warp_plain(imgs, shear), edge=edge_mask(w_shear))
    check(k_sh, f"warp{sfx} on a 2.9 px shear matches its twin at {shape}: {d_sh}")
    # what the while loop gives K2 and K3 from identity: a whole-pixel
    # translation (40 px in x, -25 px in y) with the small rotation, no
    # pre-shift, so the mask warp is the warp and strips tens of pixels
    # wide leave the statistics
    w_40 = w.copy()
    w_40[:, :, 2] = np.array([40.0, -25.0], np.float32)
    t40 = torch.tensor(w_40, device=DEVICE)
    iw40 = K.warp_affine_banded(imgs, t40)
    e_40, k_40, d_40 = image_err(iw40, K.warp_plain(imgs, t40), edge=edge_mask(w_40))
    check(k_40, f"warp{sfx} on a 40 px, -25 px translation matches its twin at "
          f"{shape}: {d_40}")
    add_row(rows, "warp" + sfx, shape, max(err, e_far, e_sh, e_40), ok, det,
            lambda: K.warp_affine_banded(imgs, warps),
            lambda: K.warp_plain(imgs, warps), 2 * e * px, FLOPS["warp"] * px,
            **redesign("warp" + sfx))

    got = K.ecc_gn_moments(imgs, tmpl, warps, mask)
    check(torch.equal(got, K.ecc_gn_moments(imgs, tmpl, warps, mask)),
          f"moments{sfx} bit-identical from call to call at {shape}")
    err, rel = stats_err(got, K.moments_plain(imgs, tmpl, warps, mask))
    e_40, rel_40 = stats_err(K.ecc_gn_moments(iw40, tmpl, t40, t40),
                             K.moments_plain(iw40, tmpl, t40, t40))
    check(rel_40 <= 2e-4, f"moments{sfx} on the 40 px, -25 px translation (mask "
          f"warp = warp) matches its twin at {shape}: max rel {rel_40:.3g} <= 2e-4")
    err = max(err, e_40)
    add_row(rows, "moments" + sfx, shape, err, rel <= 2e-4,
            f"max rel {rel:.3g} <= 2e-4 (f32 reduction order)",
            lambda: K.ecc_gn_moments(imgs, tmpl, warps, mask),
            lambda: K.moments_plain(imgs, tmpl, warps, mask),
            e * (px + H * W) + B * 128 * 4, FLOPS["moments"] * px,
            **redesign("moments" + sfx))

    # K3 as the Gauss-Newton step launches it: the pre-shift composed into
    # the mask warp in the kernel, the update in its reduce stage.  Its
    # statistics are K3's (bit for bit against the host-composed mask, and
    # within the bound of the twin); its new warps, rho and drho equal the
    # twin's update of those statistics bit for bit, on the step's inputs,
    # on the 40 px translation without a pre-shift, and on a batch whose
    # lanes 5-7 take the update's guards: 5 has no valid pixel, 6 is the
    # brightness shift everywhere under the identity warp (no gradient, a
    # zero denominator), 7 overflows its statistics (a non-finite update
    # refused, rho -1)
    kshift = K.template_shift(tmpl)
    vs = torch.tensor([[1.0, -1.0]], device=DEVICE).repeat(B, 1)
    rho_prev = torch.linspace(-1.0, 0.9, B, device=DEVICE)

    def bits(t):
        return t.contiguous().view(torch.int32)

    def update_case(iw, wp, shift, mask_w, what):
        got = K.ecc_gn_moments_update(iw, tmpl, wp, shift, kshift, rho_prev)
        mom = K.ecc_gn_moments(iw, tmpl, wp, mask_w, kshift)
        check(torch.equal(bits(got[3]), bits(mom)), f"moments_update{sfx} statistics "
              f"equal K3's bit for bit {what} at {shape}")
        want = R._gn_update(mom, wp, rho_prev)
        check(all(torch.equal(bits(g), bits(w_)) for g, w_ in zip(got[:3], want)),
              f"moments_update{sfx} new warps, rho and drho equal the twin's bit for "
              f"bit {what} at {shape}")
        return got

    got = update_case(imgs, warps, vs, mask, "with the pre-shift")
    check(all(torch.equal(bits(g), bits(h)) for g, h in zip(
        got, K.ecc_gn_moments_update(imgs, tmpl, warps, vs, kshift, rho_prev))),
        f"moments_update{sfx} bit-identical from call to call at {shape}")
    err, rel = stats_err(got[3], K.moments_plain(imgs, tmpl, warps, mask, kshift))
    update_case(iw40, t40, None, t40, "on the 40 px translation, no pre-shift")
    ig, wg = imgs.clone(), warps.clone()
    wg[5, :, 2] = torch.tensor([4.0e4, -3.0e4], device=DEVICE)
    ig[6] = kshift.to(dtype)  # the shift is in the images' dtype
    wg[6] = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=DEVICE)
    ig[7] = ig[7].float().mul(1e18).to(dtype)
    gg = update_case(ig, wg, vs, R._mask_warp(wg, vs), "with lanes 5-7 on the guards")
    _, i_proj, _, _, corr, _, _ = K.ecc_statistics_from_moments(gg[3])
    check(gg[3][5, 36] == 0 and corr[6] == 0 and not i_proj[6].any()
          and not torch.isfinite(gg[3][7]).all(),
          f"moments_update{sfx} guard lanes: no valid pixel, zero correlation and "
          f"projections, overflowed statistics at {shape}")
    check(all(torch.equal(gg[0][k], wg[k]) for k in (5, 6, 7))
          and gg[1][5] == 0 and gg[1][6] == 0 and gg[1][7] == -1.0
          and bool(torch.isfinite(gg[0]).all()),
          f"moments_update{sfx} guard lanes keep their warps, rho 0, 0, -1 at {shape}")
    add_row(rows, "moments_update" + sfx, shape, err, rel <= 2e-4,
            f"statistics max rel {rel:.3g} <= 2e-4, update bit for bit",
            lambda: K.ecc_gn_moments_update(imgs, tmpl, warps, vs, kshift, rho_prev),
            lambda: R._gn_update(K.moments_plain(imgs, tmpl, warps, mask, kshift),
                                 warps, rho_prev),
            e * (px + H * W) + B * (128 + 6 + 2) * 4,
            FLOPS["moments"] * px + UPDATE_FLOPS * B)

    o1 = K.warp_filter(imgs, warps, taps3)
    o2, iw = K.warp_filter(imgs, warps, taps3, with_warped=True)
    p_out, p_iw = K.warp_filter_plain(imgs, warps, taps3, True)
    e1, k1, d1 = image_err(o1, p_out)
    e2, k2, d2 = image_err(o2, p_out)
    e3, k3, d3 = image_err(iw, p_iw)
    g_out, g_iw = K.warp_filter(imgs, far, taps3, with_warped=True)
    f_out, f_iw = K.warp_filter_plain(imgs, far, taps3, True)
    e4, k4, d4 = image_err(g_out, f_out, edge=edge_mask(w_far))
    e5, k5, d5 = image_err(g_iw, f_iw, edge=edge_mask(w_far))
    check(k4 and k5, f"warp_filter{sfx} global-memory route (1.6x scale) matches "
          f"its twin at {shape}: filtered {d4}, warped {d5}")
    s_out, s_iw = K.warp_filter(imgs, shear, taps3, with_warped=True)
    t_out, t_iw = K.warp_filter_plain(imgs, shear, taps3, True)
    e6, k6, d6 = image_err(s_out, t_out, edge=edge_mask(w_shear))
    e7, k7, d7 = image_err(s_iw, t_iw, edge=edge_mask(w_shear))
    check(k6 and k7, f"warp_filter{sfx} on a 2.9 px shear matches its twin at "
          f"{shape}: filtered {d6}, warped {d7}")
    add_row(rows, "warp_filter" + sfx, shape, max(e1, e2, e3, e4, e5, e6, e7),
            k1 and k2 and k3, f"filtered {d1}; with_warped {d2}; warped {d3}",
            lambda: K.warp_filter(imgs, warps, taps3, with_warped=True),
            lambda: K.warp_filter_plain(imgs, warps, taps3, True), 3 * e * px,
            FLOPS["warp_filter"] * px, **redesign("warp_filter" + sfx))
    torch.cuda.synchronize()


def kernel_phase_gn_fused(rows, H, W, dtype_name):
    """K9 on B frames of H x W against its twin, and in f32 against K2
    then K3, within 2e-4 relative, also on a shear that moves the frame's
    corners by 2.9 px; bit-identical from call to call; timed beside K2 +
    K3 (``split_ms``/``split_device_ms``), with its registers and local
    (spilled) bytes a thread as built."""
    import numpy as np
    import torch

    from upsp_tpu_torch.ops import ecc_kernels as K

    dtype = getattr(torch, dtype_name)
    sfx = "" if dtype == torch.float32 else "_bf16"
    e = 4 if dtype == torch.float32 else 2
    shape = f"{B}x{H}x{W} {dtype_name}"
    imgs, tmpl, warps, mask, w = ecc_inputs(H, W, dtype)
    kshift = K.template_shift(tmpl)
    w_shear = w.copy()
    w_shear[:, 0, 1] = np.sign(w[:, 0, 1]) * 2.9 / ((H - 1) / 2)
    w_shear[:, 1, 0] = np.sign(w[:, 1, 0]) * 2.9 / ((W - 1) / 2)
    shear = torch.tensor(w_shear, device=DEVICE)
    px = B * H * W

    def fused(wp=warps):
        return K.ecc_gn_fused(imgs, tmpl, wp, mask, kshift)

    def split(wp=warps):
        return K.ecc_gn_moments(K.warp_affine_banded(imgs, wp), tmpl, wp, mask, kshift)

    got = fused()
    check(torch.equal(got, fused()), f"gn_fused{sfx} bit-identical from call to call "
          f"at {shape}")
    err, ok, details = 0.0, True, []
    for label, wp in (("", warps), (" (2.9 px shear)", shear)):
        g = fused(wp)
        e1, rel = stats_err(g, K.gn_fused_plain(imgs, tmpl, wp, mask, kshift))
        details.append(f"twin{label}: max rel {rel:.3g}")
        err, ok = max(err, e1), ok and rel <= 2e-4
        if dtype == torch.float32:
            e2, rel2 = stats_err(g, split(wp))
            details.append(f"K2 then K3{label}: max rel {rel2:.3g}")
            err, ok = max(err, e2), ok and rel2 <= 2e-4
    detail = "; ".join(details) + " <= 2e-4"
    if dtype != torch.float32:
        detail += " (the bf16 K2 then K3 rounds the warped image; K9 does not)"
    regs, local = K.gn_fused_attrs(dtype)
    split_device_ms = cuda_time(split, graph=True)
    print(f"  gn_fused{sfx} at {shape}: {regs} registers, {local} local bytes a "
          f"thread; K2 then K3 {split_device_ms:.4f} ms on the device", flush=True)
    add_row(rows, "gn_fused" + sfx, shape, err, ok, detail, fused,
            lambda: K.gn_fused_plain(imgs, tmpl, warps, mask, kshift),
            e * (px + H * W) + B * 128 * 4, FLOPS["gn_fused"] * px,
            prev_ms=PREV_MS["gn_fused" + sfx][ECC_SHAPES.index((H, W))],
            redesigned=True, split_ms=cuda_time(split),
            split_device_ms=split_device_ms, registers=regs, local_bytes=local)
    torch.cuda.synchronize()


def synthetic_plan(rng, n=None, skip_tile=None):
    """A full-config gather plan: a 1024x1024 grid seen by 4 cameras in
    strips (row-major image positions, as a plate grid projects), ~10%
    invisible (weight 0), 1% skipped, every 97th node a superseded copy of
    its neighbour, and two copies across tiles.  ``n`` keeps the first n
    nodes (a partial last tile); ``skip_tile`` skips every primary of
    that tile, so the whole tile is NaN."""
    import numpy as np

    from upsp_tpu_torch.ops.gather_kernels import GATHER_TILE, build_gather_plan

    gi = gj = 1024
    i, j = np.meshgrid(np.arange(gi), np.arange(gj), indexing="ij")
    cam = (i * FULL_C) // gi
    row = 40 + (j * (FULL_H - 80)) // gj
    col = 60 + ((i % (gi // FULL_C)) * (FULL_W - 120)) // (gi // FULL_C)
    idx = (cam * FULL_H * FULL_W + row * FULL_W + col).ravel()[:n]
    n = idx.size
    w = rng.uniform(0.5, 1.0, n).astype(np.float32)
    invisible = rng.random(n) < 0.1
    w[invisible] = 0.0
    idx[invisible] = 0
    skipped = invisible & (rng.random(n) < 0.1)
    sup = np.arange(n)
    sup[::97] = np.minimum(sup[::97] + 1, n - 1)
    t = GATHER_TILE
    sup[t - 1], sup[7 * t] = 5 * t + 7, 2  # copies of nodes in other tiles
    if skip_tile is not None:
        skipped[sup[skip_tile * t:(skip_tile + 1) * t]] = True
    return build_gather_plan(idx, w, skipped, sup, (), FULL_C * FULL_H * FULL_W,
                             device=DEVICE)


def read_sectors(plan, e):
    """32-byte sectors of one frame that the plan's non-skipped nodes read
    (``e`` bytes a pixel); every frame starts on a sector boundary."""
    import torch

    s = plan.src[plan.src >= 0].long() * e // 32
    return int(torch.unique(s).numel())


def gather_phase(rows, rng):
    """K5 from the C camera images in place (the path's call) and from one
    (B, C*H*W) stack, exactly equal to its twin with NaN at the same
    entries: on a plan with a partial last tile and an all-NaN tile, then
    timed on the full 1,048,576-node plan; beside it the same plan in plain
    model order (no sort inside a tile) and the sector floor."""
    import dataclasses

    import torch

    from upsp_tpu_torch.ops import gather_kernels as G

    frames = f"{B}x{FULL_C}x{FULL_H}x{FULL_W}"
    plan = synthetic_plan(rng)
    edge_plan = synthetic_plan(rng, n=plan.n_nodes - 333, skip_tile=3)
    # the same entries in model order: tile k's nodes in order, unsorted
    order = torch.argsort(plan.node.long())
    model_plan = dataclasses.replace(plan, src=plan.src[order], weight=plan.weight[order],
                                     node=plan.node[order])
    nodes = plan.n_nodes
    n_read = int((plan.src >= 0).sum())
    stacked32 = (2000 + 300 * torch.randn((B, plan.n_pixels), device=DEVICE,
                                          generator=torch.Generator(DEVICE).manual_seed(5)))

    def same(got, want):
        nan = torch.isnan(want)
        err = float((got[~nan] - want[~nan]).abs().max())
        return bool(torch.equal(torch.isnan(got), nan)) and err == 0.0, err, int(nan.sum())

    for name, stacked, e in (("gather", stacked32, 4),
                             ("gather_bf16", stacked32.to(torch.bfloat16), 2)):
        cams = list(stacked.reshape(B, FULL_C, FULL_H, FULL_W).unbind(1))
        cams = [c.contiguous() for c in cams]
        errs = []
        for label, p in (("partial last tile, an all-NaN tile", edge_plan),
                         ("model order", model_plan), ("full plan", plan)):
            want = G.gather_plain(stacked, p)
            for how, x in (("per-camera images", cams), ("stack", stacked)):
                ok, err, n_nan = same(G.project_gather(x, p), want)
                errs.append(err)
                check(ok, f"{name} from the {how} equals its twin ({label}; NaN at "
                      f"the same {n_nan} entries)")
        check(torch.equal(G.project_gather(cams, plan).view(torch.int32),
                          G.project_gather(cams, plan).view(torch.int32)),
              f"{name} bit-identical from call to call")
        sectors = read_sectors(plan, e)
        floor_ms = (B * sectors * 32 + B * nodes * 4 + nodes * 12) / HBM_BYTES_PER_S * 1e3
        model_ms = cuda_time(lambda: G.project_gather(cams, model_plan), graph=True)
        stack_ms = cuda_time(lambda: G.project_gather(stacked, plan), graph=True)
        print(f"  {name}: device ms from the stack {stack_ms:.4f}, in plain model "
              f"order {model_ms:.4f}; sector floor {floor_ms:.4f} ms ({sectors} "
              f"sectors a frame for {n_read} reads)", flush=True)
        add_row(rows, name, f"{frames} {stacked.dtype} -> {nodes} nodes", max(errs),
                True, "exact; NaN at the same entries",
                lambda: G.project_gather(cams, plan),
                lambda: G.gather_plain(cams, plan),
                B * (n_read * e + nodes * 4) + nodes * 12, FLOPS["gather"] * B * n_read,
                prev_ms=PREV_MS[name], redesigned=True, sector_floor_ms=floor_ms,
                stacked_device_ms=stack_ms, model_order_device_ms=model_ms)


def hot_phase(rows, rng):
    """K6 on 32 images of 1200x1800 with 0, 3, 5 and 6 hot pixels (6 > 5:
    left as it is), corners and edges included, exactly equal to its twin
    and bit-identical from call to call; also with an all-saturated frame
    and adjacent hot pixels on a 16-byte vector boundary."""
    import numpy as np
    import torch

    from upsp_tpu_torch.ops import ecc_kernels as K

    n_img, px = B * FULL_C, FULL_H * FULL_W
    imgs = torch.tensor(rng.normal(2000, 150, (n_img, FULL_H, FULL_W)).astype(np.float32),
                        device=DEVICE)
    spots = [(0, 0), (0, FULL_W - 1), (FULL_H - 1, 0), (FULL_H - 1, FULL_W - 1),
             (0, FULL_W // 2), (FULL_H // 2, 0), (FULL_H // 2, FULL_W // 2)]
    for k in range(n_img):
        for y, x in spots[: (0, 3, 5, 6)[k % 4]]:
            imgs[k, y, x] = 4095.0
    odd = imgs.clone()
    odd[1] = 4095.0  # every pixel a candidate: left as it is
    odd[0, 100, 3:5] = 4095.0  # adjacent, either side of a 16-byte boundary
    odd[0, 101, 4] = 4095.0  # and below one of them
    for x, what in ((imgs, "0, 3, 5 and 6 hot pixels"),
                    (odd, "an all-saturated frame, adjacent hot pixels")):
        got, want = K.fix_hot_pixels_kernel(x), K.fix_hot_pixels(x)
        check(torch.equal(got, want), f"hot equals its twin ({what}; the twin "
              f"repaired {int((want != x).sum())} pixels)")
        check(torch.equal(got, K.fix_hot_pixels_kernel(x)),
              f"hot bit-identical from call to call ({what})")
    got, want = K.fix_hot_pixels_kernel(imgs), K.fix_hot_pixels(imgs)
    err = float((got - want).abs().max())
    add_row(rows, "hot", f"{n_img}x{FULL_H}x{FULL_W}", err,
            bool(torch.equal(got, want)), "exact",
            lambda: K.fix_hot_pixels_kernel(imgs), lambda: K.fix_hot_pixels(imgs),
            8 * n_img * px, FLOPS["hot"] * n_img * px, prev_ms=PREV_MS["hot"],
            redesigned=True)


def kernel_phase_ingest(rows):
    """K5-K8 against their twins at the full configuration's shapes: all
    four do selects, integer operations and one multiply, so they must
    match exactly (K5 with f32 and with bf16 frames)."""
    import numpy as np
    import torch

    from upsp_tpu_torch.io.video.cine import LUT_10_TO_12
    from upsp_tpu_torch.ops import unpack_kernels as U

    rng = np.random.default_rng(2)
    n_img, px = B * FULL_C, FULL_H * FULL_W
    frames = f"{B}x{FULL_C}x{FULL_H}x{FULL_W}"
    gather_phase(rows, rng)
    hot_phase(rows, rng)

    # K7/K8: random packed bytes of 8 frames x 4 cameras x 1200x1800
    gen = torch.Generator(DEVICE).manual_seed(7)
    b12 = torch.randint(0, 256, (n_img * px * 3 // 2,), dtype=torch.uint8,
                        device=DEVICE, generator=gen)
    got, want = U.unpack_12bpp(b12), U.unpack_12bpp_plain(b12)
    err = float((got - want).abs().max())
    add_row(rows, "unpack12", f"{frames} packed", err, bool(torch.equal(got, want)), "exact",
            lambda: U.unpack_12bpp(b12), lambda: U.unpack_12bpp_plain(b12),
            n_img * px * 11 // 2, 0)
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
            n_img * px * 21 // 4 + 4096, 0)
    torch.cuda.synchronize()


def kernel_phase_pool(rows):
    """K10, the phase correlation's k x k pooling, against its twin at the
    full configuration's shapes (8 frames x 4 cameras x 1200x1800, k = 4),
    f32 and bf16, bit for bit (both sum in one fixed order, each product
    and sum rounded); also on one camera's strided slice of the chunk.
    ``library_ms`` is ``F.avg_pool2d`` (its window summed row-major, so up
    to 1 ulp from K10); ``gemm_ms`` the parent's form, ``P_h @ x @ P_w^T``
    with dense pooling matrices (cuBLAS), both timed, neither used."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from upsp_tpu_torch.ops import fftreg as TF

    k = TF.default_decimate(FULL_H, FULL_W)
    rng = np.random.default_rng(10)
    x32 = torch.tensor(rng.uniform(0, 4095, (B, FULL_C, FULL_H, FULL_W)).astype(np.float32),
                       device=DEVICE)
    ho, wo = FULL_H // k, FULL_W // k
    p_h = ((torch.arange(ho, device=DEVICE)[:, None]
            == torch.arange(FULL_H, device=DEVICE)[None] // k).float() / k)
    p_wt = ((torch.arange(wo, device=DEVICE)[:, None]
             == torch.arange(FULL_W, device=DEVICE)[None] // k).float() / k).T.contiguous()
    n_img = B * FULL_C
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        name = "pool" if dtype == torch.float32 else "pool_bf16"
        got, want = TF.decimate_image(x, k), TF.decimate_plain(x, k)
        cam = TF.decimate_image(x[:, 2], k)
        ok = (torch.equal(got, want) and torch.equal(cam, want[:, 2])
              and torch.equal(TF.decimate_image(x, k), got))
        err = float((got - want).abs().max())
        flat = x.reshape(n_img, 1, FULL_H, FULL_W)
        gemm_ms = cuda_time(lambda: p_h @ x.float() @ p_wt)
        add_row(rows, name, f"{B}x{FULL_C}x{FULL_H}x{FULL_W} {str(dtype)[6:]}, k={k}",
                err, ok, "bit for bit, also a camera's strided slice, and call to call",
                lambda: TF.decimate_image(x, k), lambda: TF.decimate_plain(x, k),
                x.numel() * x.element_size() + n_img * ho * wo * 4,
                n_img * ho * wo * pool_flops(k),
                library_fn=lambda: F.avg_pool2d(flat, k), gemm_ms=gemm_ms)
        print(f"  {name}: the parent's two pooling GEMMs {gemm_ms:.4f} ms "
              f"(in f32, as the parent computed them)", flush=True)
    torch.cuda.synchronize()


def walk_rig():
    """The full configuration's plate and cameras as write_datapoint writes
    them (1,048,576 nodes, FULL_C cameras of FULL_H x FULL_W) and the flat
    BVH run_phase0 builds over them: (model, flat BVH, camera parameters,
    oblique angle)."""
    import torch

    from upsp_tpu_torch.camera.model import make_camera_params
    from upsp_tpu_torch.geometry.grids import load_model
    from upsp_tpu_torch.io.camera_json import read_camera_json
    from upsp_tpu_torch import native
    from upsp_tpu_torch.pipeline import phase0 as P0
    from upsp_tpu_torch.pipeline.config import read_input_deck
    from upsp_tpu_torch.pipeline.synthetic import write_datapoint

    dp = write_datapoint(os.path.join(WORK, "walk"), n_cameras=FULL_C,
                         image_hw=(FULL_H, FULL_W), n_frames=1, n_distinct=1,
                         grid_shape=FULL["grid_shape"])
    cfg = read_input_deck(dp["deck"])
    model = load_model(cfg.grid, tolerance=cfg.grid_tol)
    native.native_library()
    params = []
    for cam in cfg.cameras:
        cal = read_camera_json(cam.calibration, dims_hw=(FULL_H, FULL_W))
        params.append(make_camera_params(cal.rmat, cal.tvec, cal.camera_matrix,
                                         cal.dist_coeffs, dtype=torch.float32))
    return model, P0._build_bvh(model, 4), params, cfg.oblique_angle


def kernel_phase_walk(rows):
    """K11, phase 0's visibility walk, against the native rays the host
    route casts (``projection._native_rays``: numpy around cpp/'s
    multithreaded walk) on the full configuration (:func:`walk_rig`: the
    SAH BVH of 2,093,058 triangles): every node's last ray ``t`` and
    ``prim``, ``own``, ``settled``, the oblique test and the retries, bit
    for bit, from each camera centre.  A call is the FULL_C cameras' walks;
    ``plain_ms`` is the native rays over them, no library call.  The bound
    is the scene read once and a byte a node and camera written: the boxes
    and triangles a ray visits depend on its path and are not counted, so
    it is a floor far below the walk.  ``rays_per_s``: the rays cast
    (primary and retries) over ``device_ms``; ``upload_s`` the scene's copy
    to the card."""
    import numpy as np
    import torch

    from upsp_tpu_torch.camera.model import cam_center
    from upsp_tpu_torch.ops import projection as TP
    from upsp_tpu_torch.ops import walk_kernels as WK

    model, flat, params, oblique = walk_rig()
    th = TP._oblique_threshold(oblique)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = WK.upload_scene(flat, model.triangles, model.vertices, model.normals, DEVICE)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    centers = [cam_center(p) for p in params]
    c64 = [c.numpy().astype(np.float64) for c in centers]

    def host():
        return [TP._native_rays(flat, model.triangles, model.vertices, model.normals, c,
                                th, WK.MAX_JITTER, 1e-4) for c in c64]

    differ, rays = 0, 0
    for c, want in zip(centers, host()):
        got = WK.walk_nodes(scene, c, th, detail=True)
        bad = torch.zeros(model.size, dtype=torch.bool)
        for k in WK.NodeRays._fields:
            bad |= getattr(got, k).cpu() != getattr(want, k)
        differ += int(bad.sum())
        rays += model.size + int(want.retries.sum())
    nbytes = sum(t.numel() * t.element_size() for t in scene) + model.size * FULL_C
    shape = f"{model.size:,} nodes x {FULL_C} cameras, {flat.n_tris:,} triangles"
    add_row(rows, "walk", shape, float(differ), differ == 0,
            "nodes differing from the native rays: t, prim, own, settled, forward, retries",
            lambda: [WK.walk_nodes(scene, c, th) for c in centers], host, nbytes, 0,
            rays=rays, upload_s=upload_s)
    row = next(r for r in rows if r["name"] == "walk")
    row["rays_per_s"] = row["shapes"][-1]["rays_per_s"] = rays / row["device_ms"] * 1e3
    print(f"  walk: {rays:,} rays ({rays - FULL_C * model.size:,} retries) in "
          f"{row['device_ms']:.3f} device ms, {row['rays_per_s']:.4g} rays/s; the "
          f"native rays {row['plain_ms']:.1f} ms; scene upload {upload_s:.4f} s "
          f"({nbytes / 1e6:.1f} MB)", flush=True)
    del scene
    shutil.rmtree(os.path.join(WORK, "walk"), ignore_errors=True)
    torch.cuda.synchronize()


def run_cli(argv):
    """Run the script ``argv[0]`` in this process with ``argv``."""
    saved = sys.argv
    sys.argv = argv
    try:
        runpy.run_path(argv[0], run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise SmokeFailure(f"{os.path.basename(argv[0])} exited with {e.code}")
    finally:
        sys.argv = saved


def bf16_bounds(got, want, scale):
    """tests/test_torch_bf16.py's bounds on intensities: NaN where NaN,
    mean |diff| < 2e-3 and the 99.9% quantile < 2e-2 of full scale."""
    import numpy as np

    v = np.isfinite(want)
    d = np.abs(got[v] - want[v])
    mean, q = float(d.mean()) / scale, float(np.quantile(d, 0.999)) / scale
    ok = np.array_equal(np.isnan(got), np.isnan(want)) and mean < 2e-3 and q < 2e-2
    return ok, f"mean |d| {mean:.3g} < 2e-3, 99.9% {q:.3g} < 2e-2 of full scale"


def write_path_datapoint(p, spec):
    """Write path ``p``'s datapoint under WORK from a seed."""
    import numpy as np

    from upsp_tpu_torch.pipeline.synthetic import write_datapoint

    rng = np.random.default_rng(1)
    # jitter <= 2 px whose fractional parts stay clear of +-0.5, so the
    # integer pre-shift cannot round differently on the card and the CPU
    shifts = rng.integers(-1, 2, (N_DISTINCT, 2)) + rng.uniform(-0.3, 0.3, (N_DISTINCT, 2))
    shifts[0] = 0.0
    root = os.path.join(WORK, p)
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    dp = write_datapoint(root, n_targets=N_TARGETS, seed=1, shifts=shifts,
                         hot_pixels=True, **spec)
    print(f"  datapoint written in {time.perf_counter() - t0:.2f} s", flush=True)
    return dp


def print_stages(what, wall, t):
    """Print a run's stage seconds (``stage_times``) and add its frames/s
    over phase 1 less its set-up."""
    t["frames_per_s"] = t["n_frames"] / (t["phase1"] - t["phase1_setup"])
    transpose = (f"disk transpose {t['disk_transpose']:.3f} s; "
                 if "disk_transpose" in t else "")
    print(f"  {what} {wall:.2f} s: phase 0 {t['phase0']:.3f} s; phase 1 "
          f"{t['phase1']:.3f} s = {t['n_frames'] / t['phase1']:.1f} frames/s, of "
          f"which set-up {t['phase1_setup']:.3f} s and frames "
          f"{t['phase1'] - t['phase1_setup']:.3f} s = {t['frames_per_s']:.1f} "
          f"frames/s, ingest included; {transpose}phase 2 {t['phase2']:.3f} s; "
          f"outputs {t['outputs']:.3f} s", flush=True)


def cli_run(dp, dtype, streaming=False, flags=()):
    """The datapoint once through the CLI (out of core with ``streaming``,
    ``flags`` added); prints and returns its stage seconds
    (``--timings``)."""
    import torch

    timings = os.path.join(os.path.dirname(dp["deck"]), "timings.json")
    t0 = time.perf_counter()
    run_cli([SCRIPT, "-input_deck", dp["deck"], "--registration-telemetry",
             "--timings", timings, "--device", DEVICE, "--compute-dtype", dtype]
            + (["--streaming"] if streaming else []) + list(flags))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(timings) as fh:
        t = json.load(fh)
    print_stages(f"{dtype}{' streaming' if streaming else ''}"
                 f"{' ' + ' '.join(flags) if flags else ''} CLI run", wall, t)
    return t


def datapoint_path(label, dp, spec, batch, expect, dtype, ref=None,
                   warm_start="fft", flags=(), absent=()):
    """One datapoint through the CLI (``flags`` added), its outputs, and
    one batch of its packed frames on the card against the CPU twins with
    the same ECC start (``warm_start``, as ``make_chunk_processor`` takes
    it; a bf16 batch also against ``ref``, an f32 path's result on the
    same files).  ``absent``: kernels the path must not launch.  With the
    while loop (any start but "fft") column 1 of the telemetry must hold
    iteration counts, its sidecar must say so, and the card's counts must
    equal the twins' within one.  Returns the kernel launch counts of the
    CLI run and the batch's card results with the CLI's telemetry."""
    import numpy as np
    import torch

    from upsp_tpu_torch.io.flatfile import FLAT_FILES, read_flat
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.pipeline.config import read_input_deck
    from upsp_tpu_torch.pipeline.phase0 import run_phase0
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
    from upsp_tpu_torch.pipeline.run import open_videos, packed_ingest_config

    print(f"  -- path {label}", flush=True)
    n_frames = spec["n_frames"]
    n_cams = spec["n_cameras"]
    n_nodes = spec["grid_shape"][0] * spec["grid_shape"][1]

    cuda_lib.reset_launch_counts()
    stages = cli_run(dp, dtype, flags=flags)
    counts = cuda_lib.launch_counts()
    print(f"  launches on this path: {counts}", flush=True)
    for name in expect:
        check(counts[name] > 0, f"kernel {name} launched on this path")
    for name in absent:
        check(counts[name] == 0, f"kernel {name} not launched on this path")
    if dtype == "bfloat16":
        check(not any(counts[k] for k in F32_ECC + ("gather",)),
              "no f32 ECC or gather kernel launched on this path")

    t_check = time.perf_counter()
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
    loop = warm_start != "fft"
    if loop:
        with open(os.path.join(out, "registration.json")) as fh:
            check(json.load(fh)["conv_semantics"] == "iters",
                  "the sidecar says column 1 holds iteration counts")
        n = tele[..., 1]
        check(bool((n == np.rint(n)).all() and n.min() >= 1 and n.max() <= 50),
              "column 1 holds integers in [1, 50]")
        hist = np.bincount(n.astype(np.int64).ravel())
        print(f"  iterations a frame and camera: mean {n.mean():.3f}, histogram "
              f"{ {k: int(v) for k, v in enumerate(hist) if v} }", flush=True)

    print(f"  outputs checked in {time.perf_counter() - t_check:.2f} s", flush=True)

    # one batch: the videos' packed bytes unpacked on the card, against the
    # CPU twins on the decoded frames
    t_batch = time.perf_counter()
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
    gpu, gtele = make_chunk_processor(state, with_telemetry=True, packed=True,
                                      compute_dtype=dtype, warm_start=warm_start,
                                      frame_batch=8,
                                      **kw)(torch.from_numpy(packed).to(DEVICE))
    torch.cuda.synchronize()
    t_cpu = time.perf_counter()
    cpu, ctele = make_chunk_processor(state.to("cpu"), with_telemetry=True,
                                      compute_dtype=dtype, warm_start=warm_start,
                                      frame_batch=8)(
        dp["frames"][batch])
    print(f"  batch of {batch.stop - batch.start} frames: phase 0 and the card "
          f"{t_cpu - t_batch:.2f} s, the CPU twins {time.perf_counter() - t_cpu:.2f} s",
          flush=True)
    gpu, cpu = gpu.cpu().numpy(), cpu.numpy()
    gtele, ctele = gtele.cpu().numpy(), ctele.numpy()
    d_t = float(np.abs(gtele[..., 2:4] - ctele[..., 2:4]).max())
    rows = np.ones(gpu.shape[0], bool)  # frames held to the intensity bound
    if loop:
        d_n = np.abs(gtele[..., 1] - ctele[..., 1])
        rows = (d_n == 0).all(axis=1)
        print(f"  iteration counts, card vs CPU twins: {int((d_n > 0).sum())} of "
              f"{d_n.size} frame-cameras differ (by at most {d_n.max():.0f}); rho "
              f"max abs {np.abs(gtele[..., 0] - ctele[..., 0]).max():.3g}; "
              f"translations max abs {d_t:.3g} px", flush=True)
        check(d_n.max() <= 1 and rows.sum() * 2 > rows.size,
              "iteration counts within one of the twins', equal on most frames")
        check(d_t < 0.05 and np.abs(gtele[..., 0] - ctele[..., 0]).max() < 1e-3,
              "card telemetry matches the twins' (rho 1e-3, translations 0.05 px)")
    if dtype == "float32":
        check(np.array_equal(np.isnan(gpu), np.isnan(cpu)), "NaN at the same nodes")
        v = np.isfinite(cpu) & rows[:, None]
        d = np.abs(gpu[v] - cpu[v])
        viol = int((d > 0.2 + 1e-4 * np.abs(cpu[v])).sum())
        # nearest sampling is discontinuous: a translation that differs by
        # d_t px takes a sample across a half-pixel line with probability
        # ~2 d_t per axis, so a few nodes may show a neighbouring pixel
        allowed = int(1e-3 * v.sum()) if cfg.pixel_interpolation == "nearest" else 0
        print(f"  frames {k0}-{k1 - 1} ({int(rows.sum())} with equal iteration "
              f"counts held), card (packed) vs CPU twins: max abs {d.max():.4g} "
              f"counts, {viol} of {int(v.sum())} beyond rtol 1e-4 + atol 0.2 "
              f"(allowed {allowed}); telemetry max abs "
              f"{np.abs(gtele - ctele).max():.3g}", flush=True)
        check(viol <= allowed,
              "card path matches the CPU twin path (rtol 1e-4, atol 0.2)")
        check(np.allclose(intensity[batch][:, visible], gpu[:, visible], rtol=1e-5,
                          atol=1e-3), "the batch equals the CLI's intensity rows")
    else:
        scale = float(np.max(dp["frames"]))
        ok, det = bf16_bounds(gpu, cpu, scale)
        print(f"  frames {k0}-{k1 - 1}, card (packed, bf16) vs CPU bf16 twins: "
              f"{det}; max abs {np.nanmax(np.abs(gpu - cpu)):.4g} counts; "
              f"translations max abs {d_t:.3g} px", flush=True)
        check(ok and d_t < 0.05, "card bf16 path matches the CPU bf16 path")
        ok, det = bf16_bounds(gpu, ref["gpu"], scale)
        d_f = float(np.abs(gtele[..., 2:4] - ref["tele"][..., 2:4]).max())
        print(f"  the same frames, bf16 vs path ({ref['label']})'s f32 on the "
              f"card: {det}; max abs {np.nanmax(np.abs(gpu - ref['gpu'])):.4g} "
              f"counts; translations max abs {d_f:.3g} px", flush=True)
        check(ok and d_f < 0.05, "card bf16 path matches the card f32 path")
        ok, det = bf16_bounds(intensity[batch][:, visible], gpu[:, visible], scale)
        check(ok, f"the batch matches the CLI's intensity rows ({det})")
    return counts, dict(gpu=gpu, tele=gtele, label=label.split(":")[0], stages=stages,
                        cli_tele=tele)


def same_values(got, want, what, rtol=0.0, atol=0.0):
    """NaN at the same places and the finite values within rtol/atol (both
    0: equal); prints the largest difference."""
    import numpy as np

    v = np.isfinite(want)
    d = np.abs(got[v].astype(np.float64) - want[v])
    print(f"  {what}: max abs diff {d.max() if d.size else 0.0:.4g}", flush=True)
    check(got.shape == want.shape and np.array_equal(np.isnan(got), np.isnan(want))
          and bool((d <= atol + rtol * np.abs(want[v])).all()),
          f"{what} within rtol {rtol:g}, atol {atol:g}")


def timed_transpose(route, src, rows, cols, want):
    """Time the ``route`` ("native" or "numpy") flat-file transpose of
    ``src`` and require the bytes of ``want``, the transpose that the run
    wrote by the other route; returns seconds."""
    from upsp_tpu_torch import native

    dst = f"{src}.{route}_transpose"
    t0 = time.perf_counter()
    getattr(native, f"transpose_f32_{route}")(src, dst, rows, cols)
    sec = time.perf_counter() - t0
    with open(dst, "rb") as a, open(want, "rb") as b:
        same = True
        while same:
            x, y = a.read(1 << 26), b.read(1 << 26)
            same = x == y
            if not x:
                break
    os.remove(dst)
    check(same, f"{route} transpose of {rows} x {cols} equals the run's "
          f"({sec:.3f} s)")
    return sec


def tall_transpose(rows=TALL[0], cols=TALL[1]):
    """The flat-file transpose of a (rows, cols) file with more frames
    than a native block, as a production datapoint's node block has:
    native (the route ``transpose_f32`` takes there) against numpy;
    returns (native s, numpy s)."""
    import torch

    from upsp_tpu_torch import native

    root = os.path.join(WORK, "b", "tall")
    os.makedirs(root, exist_ok=True)
    src, dst = os.path.join(root, "src"), os.path.join(root, "dst")
    gen = torch.Generator(DEVICE).manual_seed(12)
    with open(src, "wb") as fh:
        for r0 in range(0, rows, 1024):
            torch.rand(min(1024, rows - r0), cols, generator=gen,
                       device=DEVICE).cpu().numpy().tofile(fh)
    t0 = time.perf_counter()
    native.transpose_f32(src, dst, rows, cols)
    t_native = time.perf_counter() - t0
    t_numpy = timed_transpose("numpy", src, rows, cols, dst)
    # the out-of-core multi-rank route: each of RANKS ranks transposes its
    # node columns into its rows of one sized file, one after the other
    cdst = f"{dst}.columns"
    with open(cdst, "wb") as fh:
        fh.truncate(rows * cols * 4)
    t0 = time.perf_counter()
    for r in range(RANKS):
        native.transpose_f32_numpy(src, cdst, rows, cols, columns=(
            r * cols // RANKS, (r + 1) * cols // RANKS))
    t_cols = time.perf_counter() - t0
    with open(cdst, "rb") as a, open(dst, "rb") as b:
        same = True
        while same:
            x, y = a.read(1 << 26), b.read(1 << 26)
            same = x == y
            if not x:
                break
    check(same, f"{RANKS} ranks' column transposes of {rows} x {cols} equal the "
          f"whole file's ({t_cols:.3f} s)")
    shutil.rmtree(root, ignore_errors=True)
    print(f"  disk transpose of {rows} x {cols} f32 ({rows * cols * 4 / 2**30:.2f} "
          f"GiB): native {t_native:.3f} s, numpy {t_numpy:.3f} s, {RANKS} ranks' "
          f"columns in turn {t_cols:.3f} s", flush=True)
    return t_native, t_numpy, t_cols


def own_output(dp, name):
    """``dp`` with a deck of its own under WORK/b/``name`` that writes to
    an output directory there: the same videos, (b)'s outputs kept."""
    root = os.path.join(WORK, "b", name)
    os.makedirs(root)
    with open(dp["deck"]) as fh:
        deck = fh.read()
    check(deck.count(dp["out_dir"]) == 1,
          f"path ({name})'s deck names (b)'s output dir once")
    out = os.path.join(root, "out")
    new = dict(dp, deck=os.path.join(root, "deck.inp"), out_dir=out)
    with open(new["deck"], "w") as fh:
        fh.write(deck.replace(dp["out_dir"], out))
    return new


def identity_path(dp, b_tele):
    """Path (g), reference parity at full width: (b)'s files through
    ``upsp-process-torch --no-warm-start`` (identity starts, the while
    loop, frames batched 8 with per-frame stopping) into an output
    directory of its own, with FULL_BATCH's frames held against the CPU
    twins' while loop.  Prints the largest |translation| difference from
    (b)'s fft-mode telemetry ``b_tele`` (informative: the fft solve's
    pre-shift blur moves it, ROADMAP.md queue 3).  Returns the launch
    counts and the run's results."""
    import numpy as np

    g_dp = own_output(dp, "g")
    counts, res = datapoint_path(G_LABEL, g_dp, FULL, FULL_BATCH,
                                 FRAME_KERNELS + ("unpack12",), "float32",
                                 warm_start=False, flags=("--no-warm-start",),
                                 absent=("pool",))
    d_t = np.abs(res["cli_tele"][..., 2:4] - b_tele[..., 2:4])
    print(f"  (g) against (b)'s fft telemetry: largest |translation difference| "
          f"{d_t.max():.4f} px, mean {d_t.mean():.4f} px (informative)", flush=True)
    shutil.rmtree(os.path.dirname(g_dp["deck"]), ignore_errors=True)
    return counts, res


def streaming_cli_path(dp, n_nodes):
    """Path (e): (b)'s files through ``upsp-process-torch --streaming`` in
    f32, into an output directory of its own, with the launch counts reset
    just before.  Its outputs are held against (b)'s, which are still on
    disk: what phase 1 writes exactly (the frame statistics, summed in f64
    in another order, within rtol 1e-5, carried to ratio_0 as atol 1e-5
    since avg / I0 is near 1), phase 2 within tests/test_outputs.py's
    bounds (rtol 1e-4, atol 1e-6): E_TOL.  Returns the launch counts, the
    stage seconds, (b)'s first 64 intensity rows and frame statistics,
    and (e)'s datapoint, whose outputs stay on disk for (j)."""
    import numpy as np

    from upsp_tpu_torch.io.flatfile import FLAT_FILES, read_flat
    from upsp_tpu_torch.ops import cuda_lib

    print("  -- path e: (b)'s files through upsp-process-torch --streaming, f32",
          flush=True)
    e_dp = own_output(dp, "e")
    root, out = os.path.dirname(e_dp["deck"]), e_dp["out_dir"]
    cuda_lib.reset_launch_counts()
    stages = cli_run(e_dp, "float32", streaming=True)
    counts = cuda_lib.launch_counts()
    print(f"  launches on this path: {counts}", flush=True)
    for name in FRAME_KERNELS + ("unpack12",) + PHASE0_KERNELS:
        check(counts[name] > 0, f"kernel {name} launched on this path")
    for name in FLAT_FILES:
        check(os.path.exists(os.path.join(out, name)), f"output {name}")
    b_out = {}
    for name in E_FILES:
        want = read_flat(os.path.join(dp["out_dir"], name))
        same_values(read_flat(os.path.join(out, name)), want,
                    f"(e) {name} against (b)", **E_TOL.get(name, {}))
        if name in ("intensity", "intensity_avg", "intensity_rms"):
            b_out[name] = want
    b_out["intensity"] = b_out["intensity"].reshape(-1, n_nodes)
    # the run transposed (b)'s 64 rows with numpy (fewer than a native block)
    stages["native_transpose"] = timed_transpose(
        "native", os.path.join(out, "intensity"), b_out["intensity"].shape[0],
        n_nodes, os.path.join(out, "intensity_transpose"))
    return counts, stages, b_out, e_dp


def phase2_memory_sweep():
    """Phase 2's device memory against the frame count: ``phase2_convert``
    on a block of P2_NODE_BLOCK nodes at each of P2_SWEEP_FRAMES frames,
    the peak of what it allocates (its input block included) over the
    memory allocated before; returns the least-squares bytes per node and
    frame."""
    import numpy as np
    import torch

    from upsp_tpu_torch.ops.polyfit import make_detrender
    from upsp_tpu_torch.pipeline.phase2 import Phase2Constants, phase2_convert

    const = Phase2Constants(
        paint=torch.tensor([1.0, 0.01, 1e-4, 1e-4, 1e-6, 1e-8], device=DEVICE),
        qbar=torch.tensor(500.0, device=DEVICE), ps=torch.tensor(2000.0, device=DEVICE))
    n = P2_NODE_BLOCK
    gen = torch.Generator(DEVICE).manual_seed(11)
    per_node = [torch.rand(n, generator=gen, device=DEVICE) + 1.0 for _ in range(4)]
    peaks = []
    for f in P2_SWEEP_FRAMES:
        det = make_detrender(f, 6, DEVICE)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        block = torch.rand(n, f, generator=gen, device=DEVICE) + 1000.0
        out = phase2_convert(block, *per_node, const, det)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        check(bool(torch.isfinite(out.pressure_transpose).all()),
              f"phase 2 at {n} nodes x {f} frames: finite")
        del block, out
    slope, icpt = np.polyfit(np.asarray(P2_SWEEP_FRAMES, np.float64) * n,
                             np.asarray(peaks, np.float64), 1)
    print(f"  phase-2 peak device memory at {n} nodes a block: " + ", ".join(
        f"{f} frames {p / 2**20:.1f} MiB" for f, p in zip(P2_SWEEP_FRAMES, peaks))
        + f"; slope {slope:.3f} bytes per node and frame, intercept "
        f"{icpt / 2**20:.2f} MiB", flush=True)
    return slope


def streaming_long_path(dp, b_out, slope):
    """Path (f): ``run_datapoint_streaming`` in this process on LONG_FRAMES
    frames at 1,048,576 nodes from a callable source that tiles (b)'s 64
    frames (hot pixels included, so the frame statistics repeat) from one
    int16 tensor on the card.  Checks that it launches the frame kernels,
    that its first 64 intensity rows equal (b)'s and its frame statistics
    equal (b)'s within rtol 1e-5; prints its stage seconds, its peak device
    memory, phase 2's memory at its first node block, the bytes it wrote
    and the largest frame count that blocks of 65,536 nodes hold on this
    card, reckoned from ``slope``; then deletes its output."""
    import numpy as np
    import torch

    import upsp_tpu_torch.pipeline.run as run_mod
    from upsp_tpu_torch.io.flatfile import read_flat
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.pipeline.config import read_input_deck

    print(f"  -- path f: {LONG_FRAMES} frames, (b)'s 64 tiled from the card, "
          "run_datapoint_streaming in this process", flush=True)
    period = dp["frames"].shape[0]
    stack = torch.from_numpy(dp["frames"].astype(np.int16)).to(DEVICE)

    def source(start, count):
        return stack[torch.arange(start, start + count, device=DEVICE) % period]

    cfg = read_input_deck(dp["deck"])
    cfg.out_dir = os.path.join(WORK, "b", "f")
    cfg.frames = LONG_FRAMES
    n_nodes = b_out["intensity"].shape[1]
    blocks = []  # (rows, frames, allocated at entry, peak in the call)
    phase1_peak = []  # the peak before phase 2's first block
    convert = run_mod.phase2_convert

    def measured(block, *args):
        if not blocks:
            phase1_peak.append(torch.cuda.max_memory_allocated())
        torch.cuda.synchronize()
        entry = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = convert(block, *args)
        torch.cuda.synchronize()
        blocks.append((*block.shape, entry, torch.cuda.max_memory_allocated()))
        return out

    stages = {}
    run_mod.phase2_convert = measured
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_mod.run_datapoint_streaming(cfg, device=DEVICE, frames_array=source,
                                              stage_times=stages)
        wall = time.perf_counter() - t0
        counts = cuda_lib.launch_counts()
    finally:
        run_mod.phase2_convert = convert
    stages.update(n_frames=res.n_frames, n_nodes=n_nodes)
    print_stages("in-process streaming run", wall, stages)
    print(f"  launches on this path: {counts}", flush=True)
    for name in FRAME_KERNELS:
        check(counts[name] > 0, f"kernel {name} launched on this path")
    check(res.n_frames == LONG_FRAMES, f"{LONG_FRAMES} frames processed")
    (phase1_peak,), (rows, frames, entry, p2_peak) = phase1_peak, blocks[0]
    peak = max([phase1_peak] + [b[3] for b in blocks])
    # held across phase 2, less the input block and this script's source
    fixed = entry - 4 * rows * frames - stack.numel() * 2
    total = torch.cuda.get_device_properties(0).total_memory
    f_max = (total - fixed) / (slope * P2_NODE_BLOCK)
    written = sum(os.path.getsize(os.path.join(cfg.out_dir, n))
                  for n in os.listdir(cfg.out_dir))
    print(f"  peak device memory {peak / 2**30:.3f} GiB (phases 0-1 "
          f"{phase1_peak / 2**30:.3f} GiB, the {period}-frame source "
          f"{stack.numel() * 2 / 2**30:.3f} GiB of it); phase 2, block of {rows} "
          f"nodes x {frames} frames: {entry / 2**30:.3f} GiB allocated at entry, "
          f"peak {p2_peak / 2**30:.3f} GiB; {len(blocks)} blocks; "
          f"{written / 2**30:.3f} GiB written", flush=True)
    print(f"  reckoned from the slope: blocks of {P2_NODE_BLOCK} nodes fit "
          f"{total / 2**30:.1f} GiB up to {f_max:.0f} frames (fixed "
          f"{fixed / 2**30:.3f} GiB)", flush=True)
    head = read_flat(os.path.join(cfg.out_dir, "intensity"), count=period * n_nodes)
    same_values(head.reshape(period, n_nodes), b_out["intensity"],
                f"(f) intensity rows 0-{period - 1} against (b)")
    same_values(res.intensity_avg, b_out["intensity_avg"],
                "(f) intensity_avg against (b)", rtol=1e-5)
    same_values(res.intensity_rms, b_out["intensity_rms"],
                "(f) intensity_rms against (b)", rtol=1e-5)
    del stack
    shutil.rmtree(cfg.out_dir, ignore_errors=True)
    return counts, dict(stages, peak_bytes=peak, phase2_peak_bytes=p2_peak,
                        written_bytes=written, frames_max=f_max)


def two_rank_path(dp, b_counts, e_dp=None):
    """Path (i) (in memory) or, with ``e_dp``, (j) (out of core): (b)'s
    files through ``upsp-process-torch --distributed`` as RANKS CLI
    processes on the one card (torchrun's environment on a free local
    port: both ranks on cuda:0, so the transport rule gives gloo), into an
    output directory of its own.  Each rank's process starts with its
    launch counts at 0 and writes them with its stage seconds
    (``--timings``).  Checks that every rank ran on the card through gloo
    and launched K1-K7, fewer per-frame launches than (b)'s ``b_counts``
    each; (i): every flat file, the registration file and output.h5
    against (b)'s (intensity and its statistics rtol 1e-6, atol 1e-3
    counts, printed whether bit for bit; phase 2 rtol 1e-4, atol 1e-6;
    the rest exactly); (j): ``intensity_transpose`` equal to (e)'s bit for
    bit and the other files within E_TOL of (b)'s.  Returns the ranks'
    launch counts summed and their stage seconds."""
    import numpy as np

    from upsp_tpu_torch.io.flatfile import FLAT_FILES, read_flat
    from upsp_tpu_torch.parallel.launcher import run_local_ranks

    p = "j" if e_dp else "i"
    print(f"  -- path {p}: (b)'s files through {RANKS} ranks of upsp-process-torch "
          f"--distributed{' --streaming' if e_dp else ''} on the one card, f32",
          flush=True)
    r_dp = own_output(dp, p)
    root, out = os.path.dirname(r_dp["deck"]), r_dp["out_dir"]
    timings = os.path.join(root, "timings.json")
    log = os.path.join(root, "ranks.log")
    cmd = [sys.executable, SCRIPT, "-input_deck", r_dp["deck"], "--registration-telemetry",
           "--timings", timings, "--device", DEVICE, "--distributed"]
    t0 = time.perf_counter()
    with open(log, "a") as fh:  # appends: the ranks' lines stay whole
        rcs = run_local_ranks(cmd + (["--streaming"] if e_dp else []), RANKS,
                              timeout_s=RANK_TIMEOUT_S, stdout=fh,
                              stderr=subprocess.STDOUT)
    wall = time.perf_counter() - t0
    with open(log) as fh:
        text = fh.read()
    print("  " + "\n  ".join(l for l in text.splitlines() if l.startswith("processed")),
          flush=True)
    if any(rcs):
        print(text[-6000:], flush=True)
    check(rcs == [0] * RANKS, f"{RANKS} ranks exited 0 ({rcs}) in {wall:.2f} s")
    ranks = []
    for r in range(RANKS):
        with open(timings if r == 0 else f"{timings}.rank{r}") as fh:
            ranks.append(json.load(fh))
    for r, t in enumerate(ranks):
        check((t["rank"], t["world"], t["transport"]) == (r, RANKS, "gloo"),
              f"rank {r} of {RANKS}, transport gloo (the ranks share a card)")
        check(f"rank {r} of {RANKS} on cuda:0" in text, f"rank {r} ran on cuda:0")
        c = t["launches"]
        print(f"  rank {r} launches: {c}", flush=True)
        print(f"  rank {r} per-frame launches against (b)'s: " + ", ".join(
            f"{k} {c[k]}/{b_counts[k]} = {c[k] / b_counts[k]:.3f}"
            for k in FRAME_KERNELS), flush=True)
        for k in FRAME_KERNELS:
            check(0 < c[k] < b_counts[k], f"rank {r} launched {k}, fewer times than (b)")
        check(c["unpack12"] > 0, f"rank {r} launched unpack12")
        print(f"  rank {r} stages: phase 0 {t['phase0']:.3f} s, phase 1 "
              f"{t['phase1']:.3f} s (set-up {t['phase1_setup']:.3f} s)"
              + (f", disk transpose {t['disk_transpose']:.3f} s"
                       if "disk_transpose" in t else "")
              + f", phase 2 {t['phase2']:.3f} s, outputs {t['outputs']:.3f} s; "
              f"barrier waits {t['barrier']}", flush=True)
    for name in FLAT_FILES + (() if e_dp else ("registration", "registration.json")):
        check(os.path.exists(os.path.join(out, name)), f"output {name}")
    if importlib.util.find_spec("h5py") is None:
        print("  h5py is not installed here: output.h5 not written", flush=True)
    else:
        check(os.path.exists(os.path.join(out, "output.h5")), "output output.h5")
    if e_dp:
        with open(os.path.join(out, "intensity_transpose"), "rb") as a, \
                open(os.path.join(e_dp["out_dir"], "intensity_transpose"), "rb") as b:
            check(a.read() == b.read(), "(j) intensity_transpose equals (e)'s bit for bit")
        for name in E_FILES:
            same_values(read_flat(os.path.join(out, name)),
                        read_flat(os.path.join(dp["out_dir"], name)),
                        f"(j) {name} against (b)", **E_TOL.get(name, {}))
    else:
        for name in FLAT_FILES + ("registration",):
            got = read_flat(os.path.join(out, name))
            want = read_flat(os.path.join(dp["out_dir"], name))
            if name.startswith("intensity") and name != "intensity_ratio_0":
                tol = dict(rtol=1e-6, atol=1e-3)
                print(f"  (i) {name} bit for bit against (b): "
                      f"{np.array_equal(got, want, equal_nan=True)}", flush=True)
            elif name in ("intensity_ratio_0", "pressure_transpose", "avg", "rms",
                          "registration"):
                tol = dict(rtol=1e-4, atol=1e-6)
            else:
                tol = {}
            same_values(got, want, f"(i) {name} against (b)", **tol)
        if importlib.util.find_spec("h5py") is not None:
            import h5py

            with h5py.File(os.path.join(out, "output.h5")) as a, \
                    h5py.File(os.path.join(dp["out_dir"], "output.h5")) as b:
                for key in ("frames", "rms", "average", "coverage"):
                    same_values(a[key][()], b[key][()], f"(i) output.h5 {key}",
                                rtol=1e-4, atol=1e-6)
    print(f"  path {p}: rank 0's stages {json.dumps({k: v for k, v in ranks[0].items() if k != 'launches'})}",
          flush=True)
    shutil.rmtree(root, ignore_errors=True)
    counts = {k: sum(t["launches"][k] for t in ranks) for k in ranks[0]["launches"]}
    return counts, ranks


def op_audit():
    """A ``TorchDispatchMode`` that counts the ops by the device of the
    tensors they make; ``host_ops()`` lists the ops outside ``HOST_OPS`` (and
    not views) that made a float CPU tensor of one or more dimensions, with
    the call site of the first."""
    import collections
    import traceback

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Audit(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()
            self.sites = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func.overloadpacket)
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    view = (func.is_view or name in HOST_OPS or t.dim() == 0
                            or not t.is_floating_point())
                    self.counts[(name, t.device.type, view)] += 1
                    if t.device.type == "cpu" and not view and name not in self.sites:
                        self.sites[name] = " < ".join(
                            f"{os.path.basename(f.filename)}:{f.lineno}"
                            for f in traceback.extract_stack()[-8:-1][::-1])
            return out

        def on(self, device_type, host_ok=None):
            return {k[0]: n for k, n in self.counts.items() if k[1] == device_type
                    and (host_ok is None or k[2] == host_ok)}

        def host_ops(self):
            return {k: (n, self.sites.get(k)) for k, n in
                    self.on("cpu", host_ok=False).items()}

    return Audit()


def calibration_path():
    """Path (l): ``scripts/upsp-external-calibration-torch --joint_ba`` on
    the card, in this process, on (b)'s rig with L_TARGETS targets: each
    camera's JSON pose perturbed by 0.25 deg about x and (0.02, -0.01, 0.02)
    is the wind-off start, and the solve must recover the JSON's pose
    (rmat within L_RMAT_TOL, tvec within L_TVEC_TOL) with a reprojection rms
    below L_RMS_PX.  Every op is audited: device memory is allocated and no
    op but copies, tensors made from host data and views makes a float CPU
    tensor (of one or more dimensions).
    Then the device walk against the native walk: ``node_visibility`` of
    every grid node from each camera centre, timed.  Returns (the launch
    counts of the run, its summary)."""
    import numpy as np
    import torch

    from upsp_tpu_torch.geometry.grids import load_model
    from upsp_tpu_torch.io.camera_json import read_camera_json
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.ops import raycast as R
    from upsp_tpu_torch.native import native_library
    from upsp_tpu_torch.pipeline.synthetic import (
        target_positions, write_calibration_inputs, write_datapoint)

    n_nodes = L_SPEC["grid_shape"][0] * L_SPEC["grid_shape"][1]
    h, w = L_SPEC["image_hw"]
    print(f"  -- path l: external calibration, {L_SPEC['n_cameras']} x {h}x{w}, "
          f"{n_nodes:,} nodes, {L_TARGETS} targets, --joint_ba", flush=True)
    root = os.path.join(WORK, "l")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    n_tgts = len(target_positions(L_TARGETS, L_SPEC["seed"]))
    check(n_tgts == L_TARGETS, f"the plate holds {n_tgts} targets at "
          f"target_positions' spacing ({L_TARGETS} asked)")
    dp = write_datapoint(root, **L_SPEC)
    ci = write_calibration_inputs(root, dp["frames"])
    print(f"  datapoint and calibration inputs written in "
          f"{time.perf_counter() - t0:.2f} s (max_dist {ci['max_dist']} px)", flush=True)
    out, timings = os.path.join(root, "out"), os.path.join(root, "timings.json")
    argv = [CAL_SCRIPT, "--tgts", f"{root}/plate.tgts", "--grd", f"{root}/plate.grid",
            "--wtd", f"{root}/t.wtd", "--cfg", ci["cfg"], "--cal_dir", ci["cal_dir"],
            "--img", *ci["imgs"], "--out_dir", out, "--joint_ba", "--device", DEVICE,
            "--timings", timings]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    audit = op_audit()
    t0 = time.perf_counter()
    with audit:
        run_cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(peak > 0, f"the calibration allocated device memory (peak "
          f"{peak / 2**20:.1f} MiB)")
    on_card = sum(audit.on("cuda").values())
    host = audit.host_ops()
    check(on_card > 0 and not host, f"{on_card:,} op outputs on the card; no float "
          f"tensor on the CPU but copies, host data and views ({host or 'none'}; "
          f"those {sum(audit.on('cpu', host_ok=True).values()):,})")
    with open(timings) as fh:
        t = json.load(fh)
    check(t["device"].startswith(DEVICE) and t["ba_device"].startswith(DEVICE),
          f"the solve and the BA problem on {t['device']} / {t['ba_device']} "
          f"({t['walk']} occlusion walk)")
    errs = []
    for c, cam in enumerate(ci["cams"]):
        want = read_camera_json(cam, (h, w))
        got = read_camera_json(os.path.join(out, f"cam{c + 1:02d}-to-model.json"), (h, w))
        errs.append((float(np.abs(got.rmat - want.rmat).max()),
                     float(np.abs(got.tvec - want.tvec).max())))
    check(all(r < L_RMAT_TOL and v < L_TVEC_TOL for r, v in errs),
          "every camera's pose recovered: max |rmat - true| " + ", ".join(
              f"{r:.2e}" for r, _ in errs) + f" < {L_RMAT_TOL}; max |tvec - true| "
          + ", ".join(f"{v:.2e}" for _, v in errs) + f" < {L_TVEC_TOL}")
    check(max(t["rms"]) < L_RMS_PX and t["ba_rms"] < L_RMS_PX,
          "reprojection rms " + ", ".join(f"{r:.4f}" for r in t["rms"])
          + f" px, joint BA {t['ba_rms']:.4f} px over {t['ba_observations']} "
          f"observations, all < {L_RMS_PX} (inliers {t['inliers']})")
    st = t["stages"]
    print(f"  path l {wall:.2f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in st.items())
          + f"; peak device memory {peak / 2**20:.1f} MiB", flush=True)

    # the device walk against the native walk, every node from each centre
    model = load_model(f"{root}/plate.grid")
    flat = native_library().build_bvh(model.vertices, model.triangles)
    bvh = R.bvh_to_device(flat, device=DEVICE)
    tris = torch.from_numpy(model.triangles.astype(np.int64)).to(DEVICE)
    verts = torch.from_numpy(model.vertices).to(DEVICE)
    nodes = torch.arange(verts.shape[0], device=DEVICE)
    walk = {"device_s": [], "native_s": [], "differ": [], "grazing": [],
            "primary_differ": []}
    for c, cam in enumerate(ci["cams"]):
        true = read_camera_json(cam, (h, w))
        centre = torch.from_numpy(-(true.rmat.T @ true.tvec)).float().to(DEVICE)
        res = {}
        for name, fn in (("device", None), ("native", R.native_intersector(flat))):
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vis, _ = R.node_visibility(bvh, tris, verts, nodes, centre, stats=stats,
                                       intersect=fn)
            torch.cuda.synchronize()
            walk[f"{name}_s"].append(time.perf_counter() - t0)
            res[name] = (vis, stats["primary"], stats["rays"])
        (dv, dp_, dr), (nv, np_, nr) = res["device"], res["native"]
        differ = dv != nv
        recovered = min(int((dv & ~dp_).sum()), int((nv & ~np_).sum()))
        n_diff = int(differ.sum())
        walk["differ"].append(n_diff)
        walk["grazing"].append(recovered)
        walk["primary_differ"].append(int((dp_ != np_).sum()))
        if c == 0:  # the device walk's look interval, on camera 1's rays
            for k in L_CHECK_EVERY:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vk, _ = R.node_visibility(bvh, tris, verts, nodes, centre, check_every=k)
                torch.cuda.synchronize()
                walk[f"check_every_{k}_s"] = time.perf_counter() - t0
                check(torch.equal(vk, dv), f"device walk with a look every {k} steps: "
                      f"the same visibility, {walk[f'check_every_{k}_s']:.3f} s")
        check(not bool((differ & dp_ & np_).any()) and n_diff <= recovered,
              f"camera {c + 1}: the walks disagree on {n_diff} of {n_nodes:,} nodes "
              f"(their unjittered rays on {walk['primary_differ'][-1]:,}), each one "
              f"whose unjittered ray grazed in a walk, at most the {recovered} the "
              f"retries recovered (device {int(dv.sum()):,} visible, "
              f"{dr:,} rays, {walk['device_s'][-1]:.3f} s; native "
              f"{int(nv.sum()):,}, {nr:,} rays, {walk['native_s'][-1]:.3f} s)")
    shutil.rmtree(root, ignore_errors=True)
    return counts, dict(wall=wall, stages=st, peak=peak, rms=t["rms"],
                        ba_rms=t["ba_rms"], errs=errs, walk=walk)


def nccl_path():
    """Path (k): a one-rank NCCL group in this process (the only NCCL code
    a one-card machine can run): ``global_transpose``, ``fetch_global``,
    ``gather`` and the f64 ``all_reduce`` on a K_SHAPE f32 block, against
    torch's ``.T``, the block and the sums, exactly, and ``barrier``,
    which must leave the card's stream idle; the exchange timed by CUDA
    events beside ``.T.contiguous()``.  Returns its ms."""
    import torch
    import torch.distributed as dist

    from upsp_tpu_torch.parallel import mesh as M
    from upsp_tpu_torch.parallel.launcher import free_port, initialize_distributed

    print(f"  -- path k: the NCCL exchange of one rank in this process, "
          f"{K_SHAPE[0]} x {K_SHAPE[1]} f32 (two or more NCCL ranks need a card "
          f"each: not run on a one-card machine)", flush=True)
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, timeout_s=120)
    try:
        mesh = M.make_mesh(DEVICE)
        check(mesh.backend == "nccl", f"transport nccl for one rank on its own card "
              f"({mesh.device})")
        gen = torch.Generator(DEVICE).manual_seed(13)
        block = torch.rand(K_SHAPE, generator=gen, device=DEVICE)
        check(torch.equal(M.global_transpose(mesh, block), block.T),
              "global_transpose equals .T")
        check(torch.equal(M.fetch_global(mesh, block), block), "fetch_global equals the block")
        check(torch.equal(M.gather(mesh, block, "cpu"), block.cpu()),
              "gather to rank 0 equals the block")
        M.global_transpose(mesh, block)
        M.barrier(mesh)
        check(torch.cuda.current_stream(mesh.device).query(),
              "the NCCL barrier returns with the card's stream idle")
        sums = block.double().sum(0)
        check(torch.equal(M.all_reduce(mesh, sums.clone()), sums), "f64 all_reduce")
        ms = cuda_time(lambda: M.global_transpose(mesh, block), iters=10, warmup=2)
        t_ms = cuda_time(lambda: block.T.contiguous(), iters=10, warmup=2)
        nbytes = 2 * block.numel() * 4
        print(f"  NCCL global_transpose (one rank) {ms:.4f} ms = "
              f"{nbytes / ms / 1e6:.0f} GB/s read + written; .T.contiguous() "
              f"{t_ms:.4f} ms", flush=True)
    finally:
        dist.destroy_process_group()
    return ms


def device_phase0_path(dp):
    """Path (m): ``run_phase0`` on the device walk (``native.native_library``
    made to raise, so ``ops/projection.py`` ``NodeWalk`` finds no library;
    the loaded library still builds the flat BVH) against the native walk
    on (b)'s files, each timed (on the card the native walk's rays are
    K11's, so the pair launches K11 once a camera); then the native walk
    on the CPU, the host's rays: every ``NodeProjection`` field and the skip mask
    equal to K11's route on every node, the walk's seconds and nodes
    rechecked of both.  Per camera ``visible`` and the best-view
    ``weight`` equal on every node, ``pixel_index`` only where the f32 and
    the f64 projection round to other pixels (the f64 position within
    M_HALF_PX of a half pixel), ``u``/``v`` within M_UV_PX px, the patch
    operators and ``skipped`` exactly, and the native walk's readings
    (``phase0.walk``, ``phase0.walk_recheck``, ``phase0.walk_rechecked``).
    Then ``keyframe_mapping`` of every node of each camera on the card
    against a float64 CPU evaluation on M_SAMPLE nodes (M_KEY_TOL), and
    ``remap_error_bound`` at a pose step of M_POSE_STEP.  Returns (the
    launch counts of the two phase-0 runs, a summary with the native
    state and the video frame rate)."""
    import numpy as np
    import torch

    from upsp_tpu_torch import native
    from upsp_tpu_torch.camera.model import CameraParams, project_points
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.ops.node_pixel_mapping import keyframe_mapping, remap_error_bound
    from upsp_tpu_torch.pipeline.config import read_input_deck
    from upsp_tpu_torch.pipeline.phase0 import run_phase0
    from upsp_tpu_torch.pipeline.run import open_videos

    print("  -- path m: phase 0 on the device walk against the native walk, "
          "(b)'s files", flush=True)
    cfg = read_input_deck(dp["deck"])
    readers, _, _ = open_videos(cfg)
    try:
        first = [r.read_frame(0) for r in readers]
        bits = [r.bit_depth for r in readers]
        fs = float(readers[0].frame_rate)
    finally:
        for r in readers:
            r.close()
    def missing():
        raise RuntimeError("the native library is made unavailable for the device walk")

    cuda_lib.reset_launch_counts()
    sec, st, times = {}, {}, {}
    loader = native.native_library
    for walk in ("device", "native"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        times[walk] = {}
        native.native_library = missing if walk == "device" else loader
        try:
            st[walk] = run_phase0(cfg, first, bits, device=DEVICE,
                                  stage_times=times[walk])
        finally:
            native.native_library = loader
        torch.cuda.synchronize()
        sec[walk] = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    # the native walk's rays on the host, as on the CPU: K11's must equal them
    times["host"] = {}
    t0 = time.perf_counter()
    host = run_phase0(cfg, first, bits, device="cpu", stage_times=times["host"])
    sec["host"] = time.perf_counter() - t0
    dev, nat = st["device"], st["native"]
    k11_t, host_t = times["native"], times["host"]
    check(all(torch.equal(a.cpu(), b) for pn, ph in zip(nat.projections, host.projections)
              for a, b in zip(pn, ph)) and torch.equal(nat.skipped.cpu(), host.skipped)
          and k11_t["phase0.walk_rechecked"] == host_t["phase0.walk_rechecked"],
          f"the native walk on K11 equals it on the host, every NodeProjection field of "
          f"all {nat.n_nodes:,} nodes x {nat.n_cameras} cameras and the skip mask; walk "
          f"{k11_t['phase0.walk']:.4f} s on K11, {host_t['phase0.walk']:.4f} s on the host; "
          f"nodes rechecked {k11_t['phase0.walk_rechecked']:.0f} / "
          f"{host_t['phase0.walk_rechecked']:.0f}")
    del host
    check(dev.bvh_dev is not None and dev.bvh_dev.leaf_v0.is_cuda and nat.bvh_dev is None,
          f"phase 0: device walk {sec['device']:.3f} s (BVH on {dev.bvh_dev.leaf_v0.device}), "
          f"native walk {sec['native']:.3f} s; the native walk's readings "
          + ", ".join(f"{k} {v:.4f}" for k, v in times["native"].items()))
    model = nat.model
    h, w = nat.image_hw
    verts = torch.from_numpy(model.vertices).to(DEVICE)
    verts64 = torch.from_numpy(model.vertices.astype(np.float64))
    res = dict(moved=[], key_err=[], remap_px=[],
               rechecked=times["native"]["phase0.walk_rechecked"])
    for c, (pd, pn) in enumerate(zip(dev.projections, nat.projections)):
        both = (pd.visible & pn.visible).cpu().numpy()
        moved = both & (pd.pixel_index != pn.pixel_index).cpu().numpy()
        pix = project_points(nat.cam_params[c], verts64).numpy()
        half = np.abs(pix - np.floor(pix) - 0.5).min(axis=1)
        d_uv = max(float((torch.abs(pd.u - pn.u) * w).cpu().numpy()[both].max()),
                   float((torch.abs(pd.v - pn.v) * h).cpu().numpy()[both].max()))
        res["moved"].append(int(moved.sum()))
        check(torch.equal(pd.visible, pn.visible) and torch.equal(pd.weight, pn.weight)
              and bool((half[moved] < M_HALF_PX).all()) and d_uv < M_UV_PX,
              f"camera {c + 1}: visible and weight equal on all {model.size:,} nodes "
              f"({int(pn.visible.sum()):,} seen), pixel_index differs on "
              f"{int(moved.sum())}, each within {M_HALF_PX} px of a half pixel; u, v "
              f"within {d_uv:.2e} px")
    for a, b in zip(dev.patch_ops, nat.patch_ops):
        check((a is None) == (b is None) and (a is None or all(
            torch.equal(x, y) for x, y in zip(a[:3], b[:3]))), "patch operators equal")
    check(torch.equal(dev.skipped, nat.skipped),
          f"skipped equal ({int(nat.skipped.sum())} nodes no camera sees)")
    # keyframe mapping of every node on the card, f64 on the CPU on a sample
    rng = np.random.default_rng(3)
    sample = np.sort(rng.choice(model.size, M_SAMPLE, replace=False))
    t0 = time.perf_counter()
    for c, params in enumerate(nat.cam_params):
        km = keyframe_mapping(params, verts)
        step = km.pose + M_POSE_STEP
        bound = remap_error_bound(km, step)
        torch.cuda.synchronize()
        p64 = CameraParams(*(t.to(torch.float64) for t in params))
        want = keyframe_mapping(p64, verts64[sample])
        errs = []
        for k in ("uv", "jac"):
            g = getattr(km, k)[torch.from_numpy(sample).to(DEVICE)].double().cpu()
            wk = getattr(want, k)
            tol = M_KEY_TOL * wk.abs() + 1e-2 * M_KEY_TOL * wk.abs().max()
            check(bool(((g - wk).abs() <= tol).all()),
                  f"camera {c + 1}: keyframe {k} {tuple(getattr(km, k).shape)} on "
                  f"{km.uv.device} matches the f64 CPU evaluation on {M_SAMPLE} nodes "
                  f"(max rel {float(((g - wk).abs() / wk.abs().clamp_min(1e-30)).max()):.2e};"
                  f" tol {M_KEY_TOL} relative + {1e-2 * M_KEY_TOL} of the largest)")
            errs.append(float(((g - wk).abs() / (wk.abs().max())).max()))
        res["key_err"].append(max(errs))
        b = bound.cpu().numpy()
        res["remap_px"].append((float(b.min()), float(np.median(b)), float(b.max())))
    res.update(sec=sec, key_s=time.perf_counter() - t0, state=nat, fs=fs)
    print(f"  path m: phase 0 device walk {sec['device']:.3f} s, native walk "
          f"{sec['native']:.3f} s (rays on K11; on the host {sec['host']:.3f} s, its walk "
          f"{host_t['phase0.walk']:.4f} s against K11's {k11_t['phase0.walk']:.4f} s, equal on "
          f"every node); visible and weight equal on every node, the recheck "
          f"recast {res['rechecked']:.0f} nodes in {k11_t['phase0.walk_recheck']:.4f} s of the "
          f"{len(nat.cam_params)} cameras' walk {k11_t['phase0.walk']:.4f} s "
          f"({k11_t['phase0.walk_recheck'] / k11_t['phase0.walk']:.2%}); pixel_index on "
          f"{res['moved']}; "
          f"keyframe mapping of {model.size:,} nodes x {len(nat.cam_params)} cameras "
          f"{res['key_s']:.3f} s (worst error {max(res['key_err']):.2e} of the largest); "
          f"remap_error_bound at a pose step of {M_POSE_STEP} (min, median, max px): "
          + ", ".join(f"({a:.3f}, {m:.3f}, {x:.3f})" for a, m, x in res["remap_px"]),
          flush=True)
    del st, dev
    return counts, res


def camera_batch_path(dp, state):
    """Path (n): one 64-frame chunk of (b) on the card through
    ``make_chunk_processor(vmap_cameras=True)`` against the per-camera loop
    with the dense step and no pre-shift (the form it stands for): NaN at
    the same nodes, intensities within rtol 1e-4 / atol 1e-2 and telemetry
    columns 2-3 within 1e-3 px (tests/test_phase1_cams.py's bounds).  The
    batched run alone must launch K1, K2, K5 and K6 and not K3, K4 or K9.
    Prints the frames/s of both and of the default loop route (each called
    once on 8 frames first).  Returns (the batched run's launch counts, a
    summary)."""
    import numpy as np
    import torch

    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor

    print("  -- path n: the cameras batched (vmap_cameras) on one 64-frame chunk of "
          "(b), on the card", flush=True)
    # 12-bit codes: int16 holds them, so the chunk crosses at two bytes a pixel
    chunk = torch.from_numpy(dp["frames"].view(np.int16)).to(DEVICE).float()
    n = chunk.shape[0]
    forms = {
        "batched": dict(vmap_cameras=True),
        "loop, dense step": dict(vmap_cameras=False, ecc_impl="jnp", pre_shift=False),
        "loop, default": dict(),
    }
    out, fps = {}, {}
    for name, kw in forms.items():
        fn = make_chunk_processor(state, with_telemetry=True, warm_start="fft",
                                  frame_batch=8, **kw)
        fn(chunk[:8])
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        sol, tele = fn(chunk)
        torch.cuda.synchronize()
        fps[name] = n / (time.perf_counter() - t0)
        if name == "batched":
            counts = cuda_lib.launch_counts()
        out[name] = (sol.cpu().numpy(), tele.cpu().numpy())
        del sol, tele
    print(f"  launches of the batched run: {counts}", flush=True)
    for k in ("blur", "warp", "gather", "hot", "pool"):
        check(counts[k] > 0, f"kernel {k} launched by the batched run")
    for k in ("moments", "moments_update", "warp_filter", "gn_fused"):
        check(counts[k] == 0 and counts[f"{k}_bf16"] == 0,
              f"kernel {k} not launched by the batched run")
    (sv, tv), (sl, tl) = out["batched"], out["loop, dense step"]
    v = np.isfinite(sl)
    d = np.abs(sv[v] - sl[v])
    viol = int((d > 1e-2 + 1e-4 * np.abs(sl[v])).sum())
    d_t = float(np.abs(tv[..., 2:4] - tl[..., 2:4]).max())
    check(np.isnan(sv).sum() == np.isnan(sl).sum() and viol == 0 and d_t < 1e-3,
          f"batched against the loop: NaN counts {int(np.isnan(sv).sum())} / "
          f"{int(np.isnan(sl).sum())}, intensities max abs {d.max():.3g} ({viol} beyond "
          f"rtol 1e-4 + atol 1e-2), translations max abs {d_t:.2e} px (< 1e-3)")
    print(f"  path n: frames/s on the card (printed, not a claim): " + ", ".join(
        f"{k} {v:.2f}" for k, v in fps.items()), flush=True)
    del chunk
    return counts, dict(fps=fps, d_t=d_t, d_max=float(d.max()))


def pooled_batch_check(state, frames):
    """(s1): each camera's pooled frames (K10, on the camera's strided slice
    of the (F, C, H, W) chunk, as the frame program takes it) and phase
    correlation are the same bit for bit in batches of all the frames, of 8
    and of 1."""
    import torch

    from upsp_tpu_torch.ops.fftreg import (
        correlate,
        decimate_image,
        default_decimate,
        prepare_template,
    )
    from upsp_tpu_torch.pipeline.phase1 import phase1_params

    dec = default_decimate(*state.image_hw)
    refs = phase1_params(state).ref_frames
    n_frames = frames.shape[0]
    for c in range(frames.shape[1]):
        tmpl = prepare_template(refs[c], dec)
        cam = frames[:, c]
        pooled, est = decimate_image(cam, dec), correlate(tmpl, cam)
        same = all(torch.equal(decimate_image(cam[i : i + n], dec), pooled[i : i + n])
                   and torch.equal(correlate(tmpl, cam[i : i + n]), est[i : i + n])
                   for n in (8, 1) for i in range(0, n_frames, n))
        check(same, f"(s1) camera {c}: a frame's pooled image and phase correlation "
              f"are the same bit for bit in batches of {n_frames}, 8 and 1 on "
              "the card")


def drop_in_path(dp, state, by_path, b_stages, n_fps):
    """Path (s), in this process on (b)'s files and outputs, each part with
    the launch counts reset just before it and read just after (``by_path``
    "s1", "s2", "s3"):

    (s1) ``run_datapoint(frame_batch=S_FRAME_BATCH)`` into an output
         directory of its own: every flat file against (b)'s (S_INTENSITY,
         S_RATIO, the rest exactly), whether it is bit for bit printed;
         then each stage's largest difference between frame batches of
         8 and of S_FRAME_BATCH on (b)'s first frames, and the first
         stage that differs (``tools.batch_stages``); and each camera's
         patch products alone, a frame's values the same bit for bit in
         batches of S_FRAME_BATCH, 8 and 1;
    (s2) frame 1 through ``process_frame(adjust_overlap=False)`` and
         ``=True`` on the card (the while loop from identity): with
         supersession equals without it indexed by ``superseded_by``, bit
         for bit, on (b)'s plan and on one where S_SUPERSEDED live nodes
         take another node's value;
    (s3) ``make_chunk_processor(state)`` at the JAX package's defaults (scan
         starts, a frame at a time) on (b)'s first S_FRAMES frames on the
         card: K1-K6 launched; its frames/s printed beside (b)'s CLI run
         (ingest included) and (n)'s default loop (fft, 8 a batch).

    ``state`` is (b)'s native phase-0 state on the card.  Returns a
    summary."""
    import dataclasses

    import numpy as np
    import torch

    from upsp_tpu_torch.io.flatfile import FLAT_FILES, read_flat
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.pipeline.config import read_input_deck
    from upsp_tpu_torch.pipeline.phase1 import (
        best_view_gather_plan,
        make_chunk_processor,
        phase1_params,
        process_frame,
    )
    from upsp_tpu_torch.pipeline.run import run_datapoint
    from upsp_tpu_torch.tools import batch_stages, benchlib

    res = {}
    print(f"  -- path s1: run_datapoint(frame_batch={S_FRAME_BATCH}) on (b)'s files, "
          "in process", flush=True)
    s_dp = own_output(dp, "s")
    times = {}
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    run_datapoint(read_input_deck(s_dp["deck"]), device=DEVICE,
                  frame_batch=S_FRAME_BATCH, registration_telemetry=True,
                  stage_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["s1"] = cuda_lib.launch_counts()
    print(f"  launches on this path: {by_path['s1']}", flush=True)
    for name in FRAME_KERNELS + ("pool", "unpack12") + PHASE0_KERNELS:
        check(by_path["s1"][name] > 0, f"kernel {name} launched on this path")
    times["n_frames"] = FULL["n_frames"]
    print_stages(f"run_datapoint(frame_batch={S_FRAME_BATCH})", wall, times)
    res["s1_fps"] = times["frames_per_s"]
    exact = []
    for name in FLAT_FILES:
        got = read_flat(os.path.join(s_dp["out_dir"], name))
        want = read_flat(os.path.join(dp["out_dir"], name))
        tol = (dict(rtol=1e-4, atol=0.2) if name in S_INTENSITY
               else dict(atol=5e-4) if name in S_RATIO else {})
        same_values(got, want, f"(s1) {name} against (b)", **tol)
        if np.array_equal(got, want, equal_nan=True):
            exact.append(name)
    res["s1_exact"] = exact
    print(f"  (s1) bit for bit against (b): {len(exact)} of {len(FLAT_FILES)} files "
          f"({', '.join(exact) or 'none'})", flush=True)
    shutil.rmtree(os.path.dirname(s_dp["deck"]), ignore_errors=True)
    # which stage of the frame program first depends on the batch, on (b)'s
    # first S_FRAME_BATCH frames (outside the launch counts of s1)
    frames = torch.from_numpy(dp["frames"][:S_FRAME_BATCH].view(np.int16)).to(
        DEVICE).float()
    stages = batch_stages.stage_diffs(state, frames, (8, S_FRAME_BATCH))
    res["s1_stages"] = stages
    check(all(np.isfinite(v) for v in stages["max_abs_diff"].values()),
          "(s1) every stage's batch difference is finite")
    print(f"  (s1) frame batch 8 against {S_FRAME_BATCH}, each stage's largest "
          f"difference: {json.dumps(stages['max_abs_diff'])}; the first stage that "
          f"differs: {stages['first_differs']}", flush=True)
    check(stages["max_abs_diff"]["hot pixels"] == 0.0
          and stages["max_abs_diff"]["phase correlation"] == 0.0,
          "(s1) batch_stages: hot pixels and the phase correlation do not depend "
          "on the batch")
    pooled_batch_check(state, frames)
    del frames
    # the patch products alone on the card: a frame's values are the same
    # bit for bit in a batch of S_FRAME_BATCH, of 8 and alone (random
    # images at (b)'s size through each camera's operators)
    from upsp_tpu_torch.ops.patching import apply_patches, patch_correction_values

    params = phase1_params(state)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    shapes = []
    for c, op in enumerate(params.patch_ops):
        corr = params.patch_corr[c] if c < len(params.patch_corr) else None
        x = 1000 + 2000 * torch.rand((S_FRAME_BATCH, *state.image_hw), device=DEVICE,
                                     generator=gen)
        for fn, arg in ((apply_patches, op), (patch_correction_values, corr)):
            if arg is None:
                continue
            whole = fn(x, arg)
            check(torch.equal(whole[:8], fn(x[:8], arg))
                  and torch.equal(whole[5:6], fn(x[5:6], arg)),
                  f"(s1) camera {c} {fn.__name__}: a frame's values are the same "
                  f"in batches of {S_FRAME_BATCH}, 8 and 1 on the card")
            shapes.append(tuple((arg.M if fn is apply_patches else arg.C).shape))
    check(bool(shapes), "(s1) the batch check reached a patch operator")
    print(f"  (s1) patch products on the card: operators (K, R, S) {shapes}, each "
          f"frame's values the same in batches of {S_FRAME_BATCH}, 8 and 1", flush=True)

    print("  -- path s2: one frame through process_frame(adjust_overlap=False/True) "
          "on the card", flush=True)
    cfg = state.config
    frame_kw = dict(registration=cfg.registration,
                    patch=cfg.target_patcher == "polynomial", filter_type=cfg.filter,
                    filter_size=cfg.filter_size, interpolation=cfg.pixel_interpolation)
    frame = torch.from_numpy(dp["frames"][1].view(np.int16)).to(DEVICE)
    p = phase1_params(state)
    n = p.superseded_by.shape[0]
    live = torch.nonzero(~p.skipped).flatten().cpu().numpy()
    rng = np.random.default_rng(14)
    sup = np.arange(n)
    sup[rng.choice(live, S_SUPERSEDED, replace=False)] = rng.choice(
        live, S_SUPERSEDED)
    sup_t = torch.from_numpy(sup).to(DEVICE)
    g = p.gather
    remapped = dataclasses.replace(p, superseded_by=sup_t, gather=best_view_gather_plan(
        g.combined_index, g.combined_weight, g.skipped, sup_t, g.corr_nodes,
        p.ref_frames))
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    for what, params in (("(b)'s plan", p), (f"{S_SUPERSEDED:,} nodes superseded",
                                            remapped)):
        with_ = process_frame(frame, params, **frame_kw).cpu().numpy()
        without = process_frame(frame, params, adjust_overlap=False,
                                **frame_kw).cpu().numpy()
        idx = params.superseded_by.cpu().numpy()
        moved = int((idx != np.arange(n)).sum())
        check(np.array_equal(with_, without[idx], equal_nan=True)
              and (moved == 0 or not np.array_equal(with_, without, equal_nan=True)),
              f"(s2) {what} ({moved:,} superseded): process_frame equals "
              "adjust_overlap=False indexed by superseded_by, bit for bit")
    torch.cuda.synchronize()
    res["s2_s"] = time.perf_counter() - t0
    by_path["s2"] = cuda_lib.launch_counts()
    print(f"  launches on this path: {by_path['s2']}", flush=True)
    for name in FRAME_KERNELS:
        check(by_path["s2"][name] > 0, f"kernel {name} launched on this path")
    del remapped

    print(f"  -- path s3: make_chunk_processor(state) at its defaults (scan starts, "
          f"a frame at a time) on {S_FRAMES} frames of (b) on the card", flush=True)
    chunk = torch.from_numpy(dp["frames"][:S_FRAMES].view(np.int16)).to(DEVICE).float()
    fn = make_chunk_processor(state)
    fn(chunk[:1])
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    sol = fn(chunk)
    torch.cuda.synchronize()
    res["s3_fps"] = S_FRAMES / (time.perf_counter() - t0)
    by_path["s3"] = cuda_lib.launch_counts()
    print(f"  launches on this path: {by_path['s3']}", flush=True)
    for name in FRAME_KERNELS:
        check(by_path["s3"][name] > 0, f"kernel {name} launched on this path")
    visible = read_flat(os.path.join(dp["out_dir"], "coverage")) > 0
    check(tuple(sol.shape) == (S_FRAMES, n)
          and bool(torch.isfinite(sol[:, torch.from_numpy(visible).to(DEVICE)]).all()),
          "(s3) intensities finite on visible nodes")
    del chunk, sol
    res["card"] = benchlib.card()
    print(f"  path s: (s1) {res['s1_fps']:.2f} frames/s after set-up at frame_batch "
          f"{S_FRAME_BATCH} against (b) {b_stages['frames_per_s']:.2f} (CLI); (s2) "
          f"{res['s2_s']:.3f} s for four process_frame calls; (s3) {res['s3_fps']:.2f} "
          f"frames/s (scan, a frame at a time, frames on the card) against (n)'s "
          f"default loop {n_fps:.2f}; {res['card']} (printed, not a claim)", flush=True)
    return res


def finite_positive(x):
    return x is not None and math.isfinite(x) and x > 0


def tools_path(state):
    """Path (t), in this process right after (s): the port's measurement
    tools (``upsp_tpu_torch/tools/``), each through ``run(argv)`` on the
    card, each record printed on a line of its own:

    - ``bench`` (f32 and bf16, T_TRIALS trials): frames/s > 0 and finite;
    - ``bench_fullconfig`` (fft, f32, phase 2; its own synthetic state):
      phase-1 and end-to-end frames/s > 0 and finite;
    - ``profile_phase1`` at the 1 MP default and at (b)'s shapes on
      ``state`` ((b)'s phase-0 state): the profiler saw device time, its
      launches of each K1-K6 kernel equal the wrappers' counts over the
      same window, and the busy share lies in (0, 1];
    - ``bench_ablate`` (1 MP): the GN step and the splits finite;
    - ``bench_components`` (1 MP): every ported op's ms a frame finite;
    - ``bench_hbm``: every probe's GB/s > 0, the best printed beside the
      3.35 TB/s that the kernels' bounds assume;
    - T_CORRELATE_CALLS ``correlate`` calls at (b)'s shapes under the
      profiler: K10 launched and no matrix product (cuBLAS, CUTLASS);
    - ``bench_endurance`` at T_ENDURANCE_FRAMES frames (1,048,576 nodes)
      after its free-space check: the 15 flat files written, the
      intensity statistics finite on every covered node.

    Returns (the launch counts of the whole path, the records)."""
    import numpy as np
    import torch

    from upsp_tpu_torch.io.flatfile import FLAT_FILES, read_flat
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.tools import (
        bench,
        bench_ablate,
        bench_components,
        bench_endurance,
        bench_fullconfig,
        bench_hbm,
        profile_phase1,
    )

    recs = {}

    def show(name, rec):
        recs[name] = rec
        print(f"  (t) {name} {json.dumps(rec)}", flush=True)

    cuda_lib.reset_launch_counts()
    print(f"  -- path t: bench, {T_TRIALS} trials, f32 and bf16", flush=True)
    rec = bench.run(["--trials", str(T_TRIALS)])
    show("bench", rec)
    for k in ("value", "trial_fps_min", "trial_fps_max", "bf16_optin_fps"):
        check(finite_positive(rec[k]), f"(t) bench {k} > 0 and finite")

    print("  -- path t: bench_fullconfig (fft, f32, with phase 2)", flush=True)
    rec = bench_fullconfig.run([])
    show("bench_fullconfig", rec)
    for k in ("fps_phase1", "fps_end2end"):
        check(finite_positive(rec[k]), f"(t) bench_fullconfig {k} > 0 and finite")

    for name, argv, st in (("profile_phase1 1MP", [], None),
                           ("profile_phase1 (b)", T_FULL_ARGS, state)):
        print(f"  -- path t: {name}", flush=True)
        rec = profile_phase1.run(argv + ["--top", str(T_TOP)], state=st)
        show(name, rec)
        prof, want = rec["kernel_launches"], rec["wrapper_launches"]
        for k in T_PROFILED:
            check(prof[k] == want[k] > 0,
                  f"(t) {name}: the profiler's {k} launches ({prof[k]}) equal the "
                  f"wrappers' ({want[k]}) over the same chunks")
        check(0 < rec["busy_share"] <= 1, f"(t) {name}: busy share in (0, 1]")

    print("  -- path t: bench_ablate", flush=True)
    rec = bench_ablate.run([])
    show("bench_ablate", rec)
    for k in ("gn_step_ms_per_frame", "ecc_fixed_ms_per_frame",
              "non_registration_ms_per_frame"):
        check(math.isfinite(rec[k]), f"(t) bench_ablate {k} finite")

    print("  -- path t: bench_components (1 MP)", flush=True)
    rec = bench_components.run([])
    show("bench_components", rec)
    check(set(rec["ms_per_frame"]) == set(bench_components.LABELS)
          - set(bench_components.NOT_PORTED)
          and all(math.isfinite(v) for v in rec["ms_per_frame"].values()),
          "(t) bench_components: every ported op's ms a frame finite")

    print("  -- path t: bench_hbm", flush=True)
    rec = bench_hbm.run([])
    show("bench_hbm", rec)
    check(all(finite_positive(p["gb_per_s"]) for p in rec["probes"].values()),
          "(t) bench_hbm: every probe's GB/s > 0 and finite")
    print(f"  (t) bench_hbm: best {rec['best_gb_per_s']} GB/s measured against the "
          f"{rec['assumed_gb_per_s']:.0f} GB/s the kernels' bounds assume "
          f"({rec['best_over_assumed']})", flush=True)

    # the phase correlation alone under the profiler, at (b)'s shapes: K10
    # pools, no matrix product (CUPTI can miss a window's first kernels, so
    # the window holds several calls)
    print("  -- path t: correlate at (b)'s shapes under the profiler", flush=True)
    from torch.profiler import ProfilerActivity, profile

    from upsp_tpu_torch.ops.fftreg import correlate, default_decimate, prepare_template

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    x = 1000 + 2000 * torch.rand((B,) + tuple(state.image_hw), device=DEVICE,
                                 generator=gen)
    tmpl = prepare_template(x[0], default_decimate(*state.image_hw))
    correlate(tmpl, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
        for _ in range(T_CORRELATE_CALLS):
            correlate(tmpl, x)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU
               and e.self_device_time_total > 0]
    print(f"  (t) correlate's device ops: {kernels}", flush=True)
    check(any("pool_kernel" in k for k in kernels)
          and not any(profile_phase1.GEMM_RE.search(k) for k in kernels),
          "(t) the phase correlation pools with K10 and runs no matrix product")
    del x, tmpl

    print(f"  -- path t: bench_endurance, {T_ENDURANCE_FRAMES} frames", flush=True)
    out_root = os.path.join(WORK, "t_endurance")
    try:
        rec = bench_endurance.run(["--frames", str(T_ENDURANCE_FRAMES), "--out-dir",
                                   out_root, "--keep-files", "--disk-probe-bytes",
                                   str(1 << 30)])
        show("bench_endurance", rec)
        out_dir = rec["out_dir"]
        missing = [n for n in FLAT_FILES if not os.path.exists(os.path.join(out_dir, n))]
        check(not missing, f"(t) bench_endurance wrote every flat file (missing: {missing})")
        covered = read_flat(os.path.join(out_dir, "coverage")) > 0
        for n in ("intensity_avg", "intensity_rms"):
            v = read_flat(os.path.join(out_dir, n))[covered]
            check(covered.sum() > 0 and np.isfinite(v).all(),
                  f"(t) bench_endurance {n} finite on the {int(covered.sum()):,} "
                  "covered nodes")
        check(finite_positive(rec["value"]), "(t) bench_endurance frames/s > 0")
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    counts = cuda_lib.launch_counts()
    print(f"  launches on this path: {counts}", flush=True)
    for name in FRAME_KERNELS:
        check(counts[name] > 0, f"kernel {name} launched on path t")
    check(counts["unpack12"] == counts["unpack10"] == 0,
          "path t feeds frames from the card (no K7, K8)")
    return counts, recs


def forces_path(dp):
    """Path (o): ``scripts/upsp-integrate-forces-torch`` on (b)'s
    ``pressure_transpose`` (1,048,576 x 64) with an O_PANELS x O_PANELS
    surface panel grid over the plate, which this script writes as PLOT3D:
    ``fomo`` within 1e-4 of the float64 numpy product of the same operator
    (relative to the sum of the products' magnitudes, |op| @ |cp|, which is
    |fomo| where nothing cancels), ``panels.csv`` with a row a panel.
    Returns (its launch counts, a summary)."""
    import numpy as np

    from upsp_tpu_torch.geometry.grids import load_model
    from upsp_tpu_torch.io.plot3d import write_p3d_grid
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.ops.integration import integration_matrices
    from upsp_tpu_torch.ops.panels import panel_node_map, panels_from_grid
    from upsp_tpu_torch.pipeline.synthetic import PLATE, make_plate_grid

    print(f"  -- path o: forces and moments of {O_PANELS} x {O_PANELS} panels from "
          f"(b)'s pressure_transpose", flush=True)
    root = os.path.join(WORK, "o")
    os.makedirs(root, exist_ok=True)
    panel_grid = make_plate_grid(O_PANELS + 1, O_PANELS + 1, *PLATE)
    write_p3d_grid(os.path.join(root, "panels.g"), panel_grid)
    grid = os.path.join(os.path.dirname(dp["deck"]), "plate.grid")
    pt_path = os.path.join(dp["out_dir"], "pressure_transpose")
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli([FORCES_SCRIPT, "--grid", grid, "--panel-grid",
             os.path.join(root, "panels.g"), "--pressure", pt_path, "--out",
             os.path.join(root, "out"), "--device", DEVICE])
    wall = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    model = load_model(grid)
    n_frames = os.path.getsize(pt_path) // 4 // model.size
    fomo = np.fromfile(os.path.join(root, "out", "fomo"), "<f4")
    with open(os.path.join(root, "out", "panels.csv")) as fh:
        rows = fh.read().strip().splitlines()[1:]
    n_panels = O_PANELS * O_PANELS
    check(fomo.size == n_panels * 6 * n_frames and len(rows) == n_panels,
          f"fomo ({n_panels}, 6, {n_frames}) and panels.csv with {len(rows)} rows, in "
          f"{wall:.3f} s")
    t0 = time.perf_counter()
    panels = panels_from_grid(panel_grid)
    op = integration_matrices(model, panel_node_map(model, panels),
                              n_panels=panels.size).reshape(n_panels * 6, model.size)
    cp = np.nan_to_num(np.fromfile(pt_path, "<f4").reshape(model.size, n_frames)
                       .astype(np.float64))
    op64 = op.astype(np.float64)
    want = op64 @ cp
    scale = np.abs(op64) @ np.abs(cp)
    err = np.abs(fomo.reshape(n_panels * 6, n_frames) - want)
    check(bool((err <= 1e-4 * scale).all()) and np.abs(want).max() > 0,
          f"fomo matches the f64 numpy product (max error {float((err / np.maximum(scale, 1e-30)).max()):.2e} "
          f"of |op| @ |cp|, bound 1e-4; the check took {time.perf_counter() - t0:.2f} s)")
    shutil.rmtree(root, ignore_errors=True)
    return counts, dict(wall=wall, n_frames=n_frames)


def psd_path(dp, fs):
    """Path (p): ``surface_psd`` of (b)'s pressure_transpose on the card
    (nperseg P_NPERSEG, P_NAN_ROWS nodes set to NaN), against
    ``scipy.signal.welch`` in float64 on P_SAMPLE finite nodes: within
    1e-4 relative plus 1e-6 of the node's largest bin; NaN nodes all NaN,
    the others finite.  Prints its seconds and the peak device memory it
    added.  Returns (its launch counts, a summary)."""
    import numpy as np
    import scipy.signal
    import torch

    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.ops.psd import surface_psd

    print(f"  -- path p: surface PSD of (b)'s pressure_transpose, nperseg {P_NPERSEG}",
          flush=True)
    pt = np.fromfile(os.path.join(dp["out_dir"], "pressure_transpose"), "<f4")
    n_nodes = FULL["grid_shape"][0] * FULL["grid_shape"][1]
    pt = pt.reshape(n_nodes, -1)
    rng = np.random.default_rng(5)
    nan_rows = rng.choice(n_nodes, P_NAN_ROWS, replace=False)
    pt[nan_rows] = np.nan
    x = torch.from_numpy(pt).to(DEVICE)
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f, p = surface_psd(x, fs, nperseg=P_NPERSEG)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    counts = cuda_lib.launch_counts()
    p = p.cpu().numpy()
    bad = ~np.isfinite(pt).all(axis=1)
    check(np.isnan(p[bad]).all() and np.isfinite(p[~bad]).all(),
          f"{int(bad.sum())} NaN nodes all NaN, the other {int((~bad).sum()):,} finite")
    good = np.nonzero(~bad)[0]
    sample = np.sort(rng.choice(good, P_SAMPLE, replace=False))
    sf, sp = scipy.signal.welch(pt[sample].astype(np.float64), fs=fs, nperseg=P_NPERSEG,
                                detrend="linear", window="hann")
    err = np.abs(p[sample] - sp)
    tol = 1e-4 * np.abs(sp) + 1e-6 * np.abs(sp).max(axis=1, keepdims=True)
    check(bool((err <= tol).all()) and np.allclose(f.cpu().numpy(), sf, rtol=1e-6),
          f"PSD ({n_nodes:,}, {p.shape[1]}) in {sec:.3f} s matches scipy's welch on "
          f"{P_SAMPLE} nodes (max rel {float((err / np.abs(sp).clip(1e-30)).max()):.2e}); "
          f"peak device memory {peak / 2**20:.1f} MiB")
    del x
    return counts, dict(sec=sec, peak=peak)


def deck_entries(path):
    """(section, key, value) of each line of an input deck, in order; a
    camera's "cine"/"mraw"/"filename" read as its "video"."""
    out, section = [], None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("@"):
                section = line[1:].split()[0]
                continue
            key, _, val = line.partition("=")
            key = key.strip()
            if section == "camera" and key in ("cine", "mraw", "filename"):
                key = "video"
            out.append((section, key, val.strip()))
    return out


def tree_path(dp):
    """Path (r): the processing tree on (a)'s files.  A data/user/proc JSON
    names every input and option of (a)'s deck;
    ``upsp-make-processing-tree-torch`` builds the tree; ``03_launchers/step+psp_process`` runs with scripts/
    on PATH, behind a wrapper named ``upsp-process-torch`` that adds
    ``--timings`` (so the run's launch counts can be read; its process
    starts with them at 0).  The keys of (a)'s deck are held against the
    tree's deck: where (a) sets one the tree did not render, the
    flat files are held bit for bit against a direct ``upsp-process-torch
    -input_deck`` on the tree's deck, else against (a)'s own; (a)'s are
    compared in any case, and printed.  The run must launch K1-K7.
    Returns its launch counts and a summary."""
    print("  -- path r: (a)'s files through the processing tree "
          "(upsp-make-processing-tree-torch, then 03_launchers/step+psp_process)",
          flush=True)
    from upsp_tpu_torch.io.flatfile import FLAT_FILES
    from upsp_tpu_torch.ops import cuda_lib

    root = os.path.join(WORK, "r")
    os.makedirs(root)
    entries = deck_entries(dp["deck"])
    data, opts = {"camera_videos": [], "camera_calibrations": []}, {}
    for section, key, val in entries:
        if section == "general":
            data["test_id" if key == "test" else key] = val
        elif section == "all":
            data[key] = val
        elif section == "camera" and key in ("video", "calibration"):
            data[f"camera_{key}s"].append(val)
        elif section == "options":
            opts[key] = val
    configs = {"data": {"datapoints": {R_DP: data}}, "user": {},
               "proc": {"processing": {"psp_process": opts}}}
    for name, cfg in configs.items():
        with open(os.path.join(root, f"{name}.json"), "w") as fh:
            json.dump(cfg, fh)
    tree = os.path.join(root, "tree")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, TREE_SCRIPT, tree] + [
        a for n in ("data", "user", "proc") for a in (f"--{n}", os.path.join(root, f"{n}.json"))],
        capture_output=True, text=True, timeout=120)
    build_s = time.perf_counter() - t0
    check(r.returncode == 0, f"upsp-make-processing-tree-torch built the tree in "
          f"{build_s:.2f} s ({r.stdout.strip() or r.stderr[-2000:]})")
    tree_deck = os.path.join(tree, "04_processing", "psp_process", R_DP, "input_deck.inp")
    rendered = {(s, k) for s, k, _ in deck_entries(tree_deck)}
    unrendered = sorted({f"@{s} {k}" for s, k, _ in entries
                         if s != "output" and (s, k) not in rendered})
    out = os.path.join(tree, "05_products", "00_data", "psp_process", R_DP)
    launcher = os.path.join(tree, "03_launchers", "step+psp_process")
    with open(launcher) as fh:
        check(f"upsp-process-torch --datapoint \"$dp\" --root" in fh.read(),
              "the launcher runs upsp-process-torch in tree mode")
    bin_dir = os.path.join(root, "bin")
    os.makedirs(bin_dir)
    timings = os.path.join(root, "timings.json")
    wrapper = os.path.join(bin_dir, "upsp-process-torch")
    with open(wrapper, "w") as fh:
        fh.write(f'#!/bin/sh\nexec "{sys.executable}" "{SCRIPT}" "$@" --timings '
                 f'"{timings}"\n')
    os.chmod(wrapper, 0o755)
    env = dict(os.environ, PATH=os.pathsep.join(
        [bin_dir, os.path.join(REPO, "scripts"), os.environ.get("PATH", "")]))
    t0 = time.perf_counter()
    r = subprocess.run([launcher, R_DP], capture_output=True, text=True, env=env,
                       timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode:
        print(r.stdout[-3000:] + r.stderr[-6000:], flush=True)
    check(r.returncode == 0, f"step+psp_process ran datapoint {R_DP} in {wall:.2f} s "
          f"({r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ''})")
    with open(timings) as fh:
        t = json.load(fh)
    counts = t["launches"]
    print(f"  launches on this path: {counts}", flush=True)
    for name in FRAME_KERNELS + ("unpack12",) + PHASE0_KERNELS:
        check(counts[name] > 0, f"kernel {name} launched on this path")
    for name in FLAT_FILES:
        check(os.path.exists(os.path.join(out, name)), f"output {name}")
    print(f"  (a)'s deck sets {len(entries)} keys; the tree cannot render: "
          f"{', '.join(unrendered) or 'none'}", flush=True)
    same_a = all(open(os.path.join(out, n), "rb").read()
                 == open(os.path.join(dp["out_dir"], n), "rb").read() for n in FLAT_FILES)
    print(f"  (r)'s flat files bit for bit against (a)'s: {same_a}", flush=True)
    if unrendered:
        tree_out = out + ".launcher"
        os.rename(out, tree_out)
        t0 = time.perf_counter()
        run_cli([SCRIPT, "-input_deck", tree_deck, "--device", DEVICE])
        direct_s = time.perf_counter() - t0
        for name in FLAT_FILES:
            with open(os.path.join(tree_out, name), "rb") as a, \
                    open(os.path.join(out, name), "rb") as b:
                check(a.read() == b.read(), f"(r) {name} equals the direct run's on the "
                      f"tree's deck bit for bit")
        print(f"  direct upsp-process-torch -input_deck on the tree's deck in this "
              f"process: {direct_s:.2f} s", flush=True)
    else:
        check(same_a, "(r)'s flat files equal (a)'s bit for bit")
    print_stages("tree launcher (upsp-process-torch --datapoint --root)", wall, t)
    shutil.rmtree(root, ignore_errors=True)
    return counts, dict(build_s=build_s, wall=wall, unrendered=unrendered, same_a=same_a,
                        stages=t)


# one rank of path (q): its apportioned block of each problem's
# observations, bundle_adjust over the mesh (the card: gloo, since the
# ranks share it), twice (the second timed), its result and times saved
Q_RANK = r"""
import faulthandler, json, sys, time
import numpy as np
import torch
import torch.distributed as dist
from upsp_tpu_torch.camera.ba import BAProblem, bundle_adjust
from upsp_tpu_torch.ops import cuda_lib
from upsp_tpu_torch.parallel.launcher import initialize_distributed
from upsp_tpu_torch.parallel.mesh import apportion, barrier, make_mesh

root, device, n_iters = sys.argv[1], sys.argv[2], int(sys.argv[3])
faulthandler.dump_traceback_later(240, exit=True)  # a hang shows where
initialize_distributed(timeout_s=120)
mesh = make_mesh(device)
cuda_lib.reset_launch_counts()
info = dict(rank=mesh.rank, world=mesh.world, device=str(mesh.device),
            backend=mesh.backend)
sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
for name in sys.argv[4:]:
    z = np.load(f"{root}/{name}.npz")
    a, n = apportion(z["uv"].shape[0], mesh.world)[mesh.rank]
    prob = BAProblem(**{k: torch.from_numpy(z[k][a:a + n] if k in OBS else z[k]).to(
        mesh.device) for k in BAProblem._fields})
    ms = []
    for _ in range(2):
        barrier(mesh)
        t0 = time.perf_counter()
        res = bundle_adjust(prob, n_iters=n_iters, mesh=mesh)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    np.savez(f"{root}/{name}.rank{mesh.rank}.npz", poses=res.poses.cpu().numpy(),
             points=res.points.cpu().numpy(), rms=res.rms.cpu().numpy())
    info[name] = dict(ms=ms, n_obs=n, n_iters=res.n_iters)
info["launches"] = cuda_lib.launch_counts()
with open(f"{root}/rank{mesh.rank}.json", "w") as fh:
    json.dump(info, fh)
dist.destroy_process_group()
""".replace("OBS", repr(Q_OBS))


def ba_problems():
    """Path (q)'s two problems, f64 on the CPU: (b)'s rig (FULL_C overhead
    cameras of write_datapoint at 1200x1800 over the plate) with (l)'s
    L_TARGETS targets, and the same cameras over Q_WIDE_POINTS points; the
    noise and perturbations of tests/test_torch_ba.py (0.05 px, poses
    turned 0.15 deg about x and -0.1 deg about y and moved (0.03, -0.02,
    0.05), points moved by 0.004, one observation unseen and one weighted
    out, prior 0.01)."""
    import numpy as np
    import torch

    from upsp_tpu_torch.camera.ba import build_problem
    from upsp_tpu_torch.camera.model import make_camera_params, project_points, rot
    from upsp_tpu_torch.pipeline.synthetic import (
        CAM_X, CAM_Y, CAM_Z, PLATE, camera_focal, target_positions)

    h, w = FULL_H, FULL_W
    fx = camera_focal((h, w))
    K = np.array([[fx, 0.0, w / 2], [0.0, fx, h / 2], [0.0, 0.0, 1.0]])
    dist = np.zeros(5)
    rng = np.random.default_rng(57)
    xy = target_positions(L_TARGETS, L_SPEC["seed"])
    rig = np.concatenate([xy, np.zeros((len(xy), 1))], 1)
    wide = np.stack([rng.uniform(0, PLATE[0], Q_WIDE_POINTS),
                     rng.uniform(0, PLATE[1], Q_WIDE_POINTS),
                     rng.normal(0, 0.05, Q_WIDE_POINTS)], 1)
    out = {}
    for name, pts in (("rig", rig), ("wide", wide)):
        cams, obs = [], []
        for c in range(FULL_C):
            rmat = np.diag([1.0, -1.0, -1.0])
            tvec = np.array([-CAM_X[c], CAM_Y, CAM_Z])
            uv = project_points(make_camera_params(rmat, tvec, K, dist),
                                torch.from_numpy(pts)).numpy()
            uv = uv + rng.normal(0, 0.05, uv.shape)
            obs += [(c, k, uv[k]) for k in range(len(pts)) if (c, k) != (1, 7)]
            cams.append(make_camera_params(rot(0.15, "x") @ rot(-0.1, "y") @ rmat,
                                           tvec + np.array([0.03, -0.02, 0.05]), K, dist))
        prob = build_problem(cams, pts + rng.normal(0, 0.004, pts.shape), obs,
                             prior_sigma=0.01, device="cpu")
        out[name] = prob._replace(weight=prob.weight.index_fill(0, torch.tensor([5]), 0.0))
    return out


def ba_mesh_path():
    """Path (q): ``bundle_adjust(mesh=)`` on the card in f64, on the two
    problems of :func:`ba_problems`.  In this process: ``mesh=None``, then
    a one-rank NCCL group (as path (k) makes one), which must equal
    ``mesh=None`` bit for bit.  Then RANKS gloo ranks on the one card
    (``run_local_ranks``, under RANK_TIMEOUT_S), each holding its
    ``mesh.apportion`` block of the observations: every rank's poses and
    points within Q_POSE_TOL and rms within Q_RMS_TOL of ``mesh=None``,
    and all ranks equal bit for bit.  Each form is timed (host clock after
    a synchronize, the second of two solves); no K1-K9 kernel may launch.
    Returns the in-process launch counts and the times."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from upsp_tpu_torch.camera.ba import bundle_adjust
    from upsp_tpu_torch.ops import cuda_lib
    from upsp_tpu_torch.parallel.launcher import (
        free_port, initialize_distributed, run_local_ranks)
    from upsp_tpu_torch.parallel.mesh import make_mesh

    print(f"  -- path q: bundle_adjust(mesh=) in f64 on {DEVICE}: (b)'s rig with "
          f"{L_TARGETS} targets and {FULL_C} cameras x {Q_WIDE_POINTS} points, "
          f"{Q_ITERS} LM steps", flush=True)
    probs = ba_problems()
    root = os.path.join(WORK, "q")
    os.makedirs(root)
    for name, prob in probs.items():
        np.savez(os.path.join(root, f"{name}.npz"),
                 **{k: getattr(prob, k).numpy() for k in prob._fields})

    def same(a, b):
        return all(torch.equal(getattr(a, k), getattr(b, k))
                   for k in ("poses", "points", "rms"))

    def timed(prob, mesh=None):
        """Two solves (the second timed), which must agree bit for bit."""
        ms, out = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(bundle_adjust(prob, n_iters=Q_ITERS, mesh=mesh))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        check(same(*out), "the solve repeats bit for bit")
        return out[1], ms

    cuda_lib.reset_launch_counts()
    single, res = {}, {}
    on_card = {n: p._replace(**{k: getattr(p, k).to(DEVICE) for k in p._fields})
               for n, p in probs.items()}
    for name, prob in on_card.items():
        single[name], ms = timed(prob)
        W = prob.poses.shape[0] * prob.points.shape[0] * 18
        res[name] = dict(none_ms=ms, n_obs=prob.uv.shape[0], W=W,
                         rms=float(single[name].rms), n_iters=single[name].n_iters)
        check(bool(torch.isfinite(single[name].poses).all()) and float(single[name].rms) < 1.0,
              f"{name}: mesh=None on {DEVICE}, O = {prob.uv.shape[0]}, W "
              f"{W:,} f64, rms {float(single[name].rms):.4f} px, {single[name].n_iters} "
              f"LM steps, {ms[1]:.1f} ms (first {ms[0]:.1f} ms)")
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, timeout_s=120)
    try:
        mesh = make_mesh(DEVICE)
        want = "nccl" if DEVICE == "cuda" else "gloo"
        check(mesh.backend == want and mesh.group is not None,
              f"a one-rank {want} group on {mesh.device}")
        for name, prob in on_card.items():
            got, ms = timed(prob, mesh)
            res[name]["one_rank_ms"] = ms
            check(same(got, single[name]), f"{name}: bundle_adjust(mesh=) on one "
                  f"{want} rank equals mesh=None bit for bit ({ms[1]:.1f} ms)")
    finally:
        dist.destroy_process_group()
    counts = cuda_lib.launch_counts()
    log = os.path.join(root, "ranks.log")
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        rcs = run_local_ranks([sys.executable, "-c", Q_RANK, root, DEVICE, str(Q_ITERS),
                               *probs], RANKS, timeout_s=RANK_TIMEOUT_S,
                              env=dict(os.environ, PYTHONPATH=REPO),
                              stdout=fh, stderr=subprocess.STDOUT)
    wall = time.perf_counter() - t0
    if any(rcs):
        with open(log) as fh:
            print(fh.read()[-6000:], flush=True)
    check(rcs == [0] * RANKS, f"{RANKS} ranks exited 0 ({rcs}) in {wall:.2f} s")
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(root, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
        t = ranks[-1]
        check((t["rank"], t["world"], t["backend"]) == (r, RANKS, "gloo")
              and t["device"].startswith(DEVICE) and not any(t["launches"].values()),
              f"rank {r} of {RANKS} on {t['device']} through gloo, no K1-K9 launched")
    for name in probs:
        results = [dict(np.load(os.path.join(root, f"{name}.rank{r}.npz")))
                   for r in range(RANKS)]
        s = single[name]
        d_pose = max(float(np.abs(results[0][k] - getattr(s, k).cpu().numpy()).max())
                     for k in ("poses", "points"))
        d_rms = abs(float(results[0]["rms"]) - float(s.rms))
        check(d_pose <= Q_POSE_TOL and d_rms <= Q_RMS_TOL,
              f"{name}: {RANKS} gloo ranks ({', '.join(str(t[name]['n_obs']) for t in ranks)}"
              f" observations) against mesh=None: poses and points within {d_pose:.2e} "
              f"<= {Q_POSE_TOL}, rms within {d_rms:.2e} <= {Q_RMS_TOL}")
        check(all(np.array_equal(x[k], results[0][k]) for x in results[1:]
                  for k in ("poses", "points", "rms")),
              f"{name}: every rank returns the same result bit for bit")
        res[name]["ranks_ms"] = [t[name]["ms"] for t in ranks]
        print(f"  {name}: {res[name]['n_iters']} LM steps; mesh=None "
              f"{res[name]['none_ms'][1]:.1f} ms, one NCCL rank "
              f"{res[name]['one_rank_ms'][1]:.1f} ms, {RANKS} gloo ranks on one card "
              + " / ".join(f"{t[name]['ms'][1]:.1f}" for t in ranks) + " ms (first "
              + " / ".join(f"{t[name]['ms'][0]:.1f}" for t in ranks) + " ms)", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return counts, dict(res, ranks_wall=wall)


def full_config_paths(by_path, phase_s):
    """Paths (b) and (d) on one full-config datapoint, written once: (b) in
    f32, (d) in bf16 with its batch also held against (b)'s; (g) on its
    files with identity starts.  (b) is the
    process's first run at 1200x1800 (it creates the cuFFT plans and the
    allocator's blocks), so the CLI then runs once more in f32 (b') and in
    bf16 (d'), and bf16 is compared with f32 as the mean of (d) and (d')
    against (b'): d, b', d' is balanced around b' in time.  The streaming
    paths (e) and (f) and then (g) run between (b) and (d), while (b)'s
    outputs are on disk."""
    dp = write_path_datapoint("b", FULL)
    n_nodes = FULL["grid_shape"][0] * FULL["grid_shape"][1]
    try:
        (lb, dtype_b, exp_b), (ld, dtype_d, exp_d) = FULL_PATHS
        by_path["b"], ref = datapoint_path(lb, dp, FULL, FULL_BATCH, exp_b, dtype_b)
        t0 = time.perf_counter()
        by_path["m"], m_res = device_phase0_path(dp)
        phase_s["path m"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = m_res.pop("state")
        by_path["n"], n_res = camera_batch_path(dp, state)
        phase_s["path n"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        s_res = drop_in_path(dp, state, by_path, ref["stages"],
                             n_res["fps"]["loop, default"])
        phase_s["path s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        by_path["t"], s_res["tools"] = tools_path(state)
        del state
        phase_s["path t"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        by_path["o"], o_res = forces_path(dp)
        phase_s["path o"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        by_path["p"], p_res = psd_path(dp, m_res["fs"])
        phase_s["path p"] = time.perf_counter() - t0
        for p in "mop":
            walks = FULL["n_cameras"] if p == "m" else 0
            check(by_path[p]["walk"] == walks
                  and not any(v for k, v in by_path[p].items() if k != "walk"),
                  f"path {p} launched K11 {walks} times and no other kernel")
        t0 = time.perf_counter()
        by_path["e"], e_stages, b_out, e_dp = streaming_cli_path(dp, n_nodes)
        phase_s["path e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        by_path["i"], i_ranks = two_rank_path(dp, by_path["b"])
        phase_s["path i"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        by_path["j"], j_ranks = two_rank_path(dp, by_path["b"], e_dp)
        shutil.rmtree(os.path.dirname(e_dp["deck"]), ignore_errors=True)
        phase_s["path j"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        slope = phase2_memory_sweep()
        by_path["f"], f_stages = streaming_long_path(dp, b_out, slope)
        del b_out
        tall = tall_transpose()
        phase_s["path f"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        by_path["g"], g_res = identity_path(dp, ref["cli_tele"])
        phase_s["path g"] = time.perf_counter() - t0
        by_path["d"], res = datapoint_path(ld, dp, FULL, FULL_BATCH, exp_d, dtype_d,
                                           ref=ref)
        print("  -- (b') and (d'): the same files through the CLI again, f32 then "
              "bf16, for the paired timing", flush=True)
        runs = [ref["stages"], res["stages"], cli_run(dp, dtype_b), cli_run(dp, dtype_d)]
    finally:
        shutil.rmtree(os.path.join(WORK, "b"), ignore_errors=True)
    b, d, b2, d2 = (t["frames_per_s"] for t in runs)
    g = g_res["stages"]["frames_per_s"]
    print(f"  phase-1 frames/s (ingest included): b {b:.2f} (first at this size), "
          f"d {d:.2f}, b' {b2:.2f}, d' {d2:.2f}; bf16 / f32 = mean(d, d') / b' = "
          f"{(d + d2) / 2 / b2:.3f}; g (identity, while loop) {g:.2f}, "
          f"g / b' = {g / b2:.3f}", flush=True)
    print(f"  streaming: (e) {e_stages['frames_per_s']:.2f} frames/s against b "
          f"{b:.2f} and b' {b2:.2f} (e / b' = {e_stages['frames_per_s'] / b2:.3f}); "
          f"(e) disk transpose {e_stages['disk_transpose']:.3f} s, phase 2 by "
          f"blocks {e_stages['phase2']:.3f} s, outputs {e_stages['outputs']:.3f} s "
          f"against b' {runs[2]['phase2']:.3f} s and {runs[2]['outputs']:.3f} s; "
          f"(f) {f_stages['frames_per_s']:.2f} frames/s over {LONG_FRAMES} frames, "
          f"peak device memory {f_stages['peak_bytes'] / 2**30:.3f} GiB, disk "
          f"transpose {f_stages['disk_transpose']:.3f} s; (e)'s transpose numpy "
          f"{e_stages['disk_transpose']:.3f} s (the run's) / native "
          f"{e_stages['native_transpose']:.3f} s; {TALL[0]} x {TALL[1]} native / numpy "
          f"/ {RANKS} ranks' columns {tall[0]:.3f} / {tall[1]:.3f} / {tall[2]:.3f} s",
          flush=True)
    for p, ranks in (("i", i_ranks), ("j", j_ranks)):
        print(f"  two ranks on one card, path ({p}): " + "; ".join(
            f"rank {t['rank']} phase 1 {t['phase1']:.3f} s = "
            f"{t['n_frames'] / (t['phase1'] - t['phase1_setup']):.2f} frames/s of "
            f"the datapoint after set-up, phase 2 {t['phase2']:.3f} s"
            for t in ranks) + f"; one rank, (b') phase 2 {runs[2]['phase2']:.3f} s",
            flush=True)
    return s_res


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
    from upsp_tpu_torch.tools import benchlib

    card = benchlib.card()
    print(card, flush=True)
    t_start = time.perf_counter()
    phase_s = {}  # seconds of each phase after the card check
    try:
        import upsp_tpu_torch  # noqa: F401  (sets the TF32 policy)
        from upsp_tpu_torch.ops import cuda_lib

        print("[1/3] build", flush=True)
        t0 = time.perf_counter()
        cuda_lib.build_all()
        phase_s["build"] = time.perf_counter() - t0
        print(f"  kernels built in {phase_s['build']:.2f} s", flush=True)
        print("[2/3] kernels against their twins", flush=True)
        rows = []
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            for h, w in ECC_SHAPES:
                kernel_phase_ecc(rows, h, w, dtype)
            phase_s[f"K1-K4 {dtype}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for h, w in ECC_SHAPES:
                kernel_phase_gn_fused(rows, h, w, dtype)
            phase_s[f"K9 {dtype}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kernel_phase_ingest(rows)
        phase_s["K5-K8"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kernel_phase_pool(rows)
        phase_s["K10"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kernel_phase_walk(rows)
        phase_s["K11"] = time.perf_counter() - t0
        print("[3/3] datapoints through scripts/upsp-process-torch", flush=True)
        by_path = {}  # "a".."f" -> the launch counts of its run
        for label, spec, batch, expect in PATHS:
            t0 = time.perf_counter()
            p = label.split(":")[0]
            dp = write_path_datapoint(p, spec)
            by_path[p], _ = datapoint_path(label, dp, spec, batch, expect, "float32")
            phase_s[f"path {p}"] = time.perf_counter() - t0
            if p == "a":  # the processing tree, on (a)'s files and outputs
                t0 = time.perf_counter()
                by_path["r"], r_res = tree_path(dp)
                phase_s["path r"] = time.perf_counter() - t0
            shutil.rmtree(os.path.join(WORK, p), ignore_errors=True)
        t0 = time.perf_counter()
        label, spec, batch, expect = H_PATH
        dp = write_path_datapoint("h", spec)
        by_path["h"], _ = datapoint_path(label, dp, spec, batch, expect, "float32",
                                         warm_start="scan", flags=("--ecc-init", "scan"),
                                         absent=("warp_filter", "pool"))
        shutil.rmtree(os.path.join(WORK, "h"), ignore_errors=True)
        phase_s["path h"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        s_res = full_config_paths(by_path, phase_s)
        phase_s["paths b, m, n, s, t, o, p, e, i, j, f, g, d, b', d'"] = (
            time.perf_counter() - t0)
        t0 = time.perf_counter()
        k_ms = nccl_path()
        phase_s["path k"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        by_path["l"], l_res = calibration_path()
        phase_s["path l"] = time.perf_counter() - t0
        check(not any(by_path["l"].values()), "path l launched no K1-K9 kernel "
              "(calibration reaches no TPU kernel)")
        t0 = time.perf_counter()
        by_path["q"], q_res = ba_mesh_path()
        phase_s["path q"] = time.perf_counter() - t0
        check(not any(by_path["q"].values()), "path q launched no K1-K9 kernel "
              "(bundle adjustment reaches no TPU kernel)")
        for r in rows:
            if r["name"] in KERNEL_PHASE_ONLY:
                r.update(launches_by_path={}, launches=0, kernel_phase_only=True)
                continue
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
    print(f"path (k): NCCL global_transpose of one rank, {K_SHAPE[0]} x {K_SHAPE[1]} "
          f"f32: {k_ms:.4f} ms", flush=True)
    lw = l_res["walk"]
    print(f"path (l): external calibration {l_res['wall']:.2f} s; stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in l_res["stages"].items())
          + f"; rms {max(l_res['rms']):.4f} px (BA {l_res['ba_rms']:.4f}); "
          f"node_visibility of {L_SPEC['grid_shape'][0] * L_SPEC['grid_shape'][1]:,} "
          f"nodes a camera: device walk " + ", ".join(f"{x:.3f}" for x in lw["device_s"])
          + " s, native walk " + ", ".join(f"{x:.3f}" for x in lw["native_s"])
          + f" s; disagreements {lw['differ']} (unjittered rays "
          f"{lw['primary_differ']}; bound: retried nodes recovered "
          f"{lw['grazing']}); camera 1's device walk with a look every k steps: "
          + ", ".join(f"k={k} {lw[f'check_every_{k}_s']:.3f} s" for k in L_CHECK_EVERY),
          flush=True)
    print(f"path (q): bundle_adjust(mesh=), f64, {Q_ITERS} LM steps: " + "; ".join(
        f"{n} (O = {q_res[n]['n_obs']}, W {q_res[n]['W']:,} f64) mesh=None "
        f"{q_res[n]['none_ms'][1]:.1f} ms, one NCCL rank {q_res[n]['one_rank_ms'][1]:.1f} "
        f"ms, {RANKS} gloo ranks " + " / ".join(f"{m[1]:.1f}" for m in q_res[n]["ranks_ms"])
        + " ms" for n in ("rig", "wide")) + f"; the ranks' processes {q_res['ranks_wall']:.2f} s",
        flush=True)
    print(f"path (r): processing tree built in {r_res['build_s']:.2f} s; step+psp_process "
          f"ran (a)'s datapoint in {r_res['wall']:.2f} s (phase 1 "
          f"{r_res['stages']['frames_per_s']:.1f} frames/s after set-up); deck keys the "
          f"tree cannot render: {', '.join(r_res['unrendered']) or 'none'}; flat files "
          f"bit for bit against (a)'s: {r_res['same_a']}", flush=True)
    print(f"path (s): the JAX package's calls on (b)'s files: (s1) "
          f"run_datapoint(frame_batch={S_FRAME_BATCH}) {s_res['s1_fps']:.2f} frames/s "
          f"after set-up, {len(s_res['s1_exact'])} of 15 flat files bit for bit against "
          f"(b)'s, the rest within bounds; (s2) process_frame's supersession an index, "
          f"bit for bit; (s3) make_chunk_processor(state) at its defaults "
          f"{s_res['s3_fps']:.2f} frames/s; {s_res['card']}", flush=True)
    t = s_res["tools"]
    tb, tf, ta, te = (t[k] for k in ("bench", "bench_fullconfig", "bench_ablate",
                                     "bench_endurance"))
    print(f"path (t): the measurement tools: bench {tb['value']} frames/s f32 (trials "
          f"{tb['trial_fps_min']}-{tb['trial_fps_max']}), bf16 {tb['bf16_optin_fps']}; "
          f"bench_fullconfig phase 1 {tf['fps_phase1']} frames/s, end to end "
          f"{tf['fps_end2end']}; " + "; ".join(
              f"{n}: device {t[n]['device_us_per_frame']} us a frame, busy share "
              f"{t[n]['busy_share']}, K1-K10 {t[n]['k_share_of_device']} of device time, "
              f"matrix products {t[n]['gemm_us_per_frame']} us a frame"
              for n in ("profile_phase1 1MP", "profile_phase1 (b)"))
          + f"; GN step {ta['gn_step_ms_per_frame']} ms a frame; bench_components "
          f"{t['bench_components']['ms_per_frame']}; bench_hbm best "
          f"{t['bench_hbm']['best_gb_per_s']} GB/s ({t['bench_hbm']['best_over_assumed']} "
          f"of the assumed 3.35 TB/s); endurance "
          f"{te['value']} frames/s sustained over {te['config']['frames']} frames "
          f"(stages {te['stages_s']}; disk {te['disk']}; link {te['link']})", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check; "
          f"by phase: " + ", ".join(f"{k} {v:.2f} s" for k, v in phase_s.items()),
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
