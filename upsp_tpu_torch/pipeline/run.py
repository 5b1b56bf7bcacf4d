"""End-to-end datapoint processing: the ``psp_process`` path.

Port of ``upsp_tpu/pipeline/run.py``:

- ``run_datapoint`` (:385-569), in memory: open the videos, phase 0 once,
  phase 1 per frame chunk, its rows kept on the device, the f64 frame
  statistics and phase 2 there, then the 15 flat files, the registration
  telemetry and ``output.h5``;
- ``run_datapoint_streaming`` (:572-833), out of core: phase-1 chunks
  stream to the ``intensity`` flat file while f64 per-node sums accumulate
  on the device, the file is transposed on disk, and phase 2 converts node
  blocks read back from it, with ``output.h5`` written per block.

Frames reach phase 1 as packed video bytes, unpacked on the device by
K7/K8, whenever every camera's video supports packed reads in one format
(``device_unpack="auto"``, the default); otherwise the
``upsp_tpu_torch.io.video`` readers decode them on the host.

Multi-device runs (``mesh``, :mod:`upsp_tpu_torch.parallel`): one
process per rank, each on its own device.  Every rank runs phase 0,
decodes and runs only its contiguous block of each frame chunk (the
reference's per-rank read-ahead and apportioning, psp_process.cpp:
867-908, 1520-1523), and phase 2 runs on each rank's block of nodes after
the frames->nodes exchange: in memory each chunk's, on the devices (the
reference's global_transpose, psp_process.cpp:707-771); out of core
through the shared ``intensity`` file, each rank transposing its node
columns.  Only rank 0 writes the whole-datapoint files
(psp_process.cpp:1930-2016); out of core, each rank writes its own rows
of the large files at their offsets.  The rows that pad a chunk's last
rank are not computed: they carry zeros through the exchange and are cut.

Not ported (ROADMAP.md): the band guard that re-runs out-of-band frames
on a dense path — the port's warp kernel has no band limit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from upsp_tpu_torch.io.flatfile import FlatFileSet, read_flat
from upsp_tpu_torch.io.paint import PaintCalibration
from upsp_tpu_torch.io.video import IntervalPrefetcher, video_reader
from upsp_tpu_torch.io.wtd import read_wtd
from upsp_tpu_torch.pipeline.config import ProcessingConfig
from upsp_tpu_torch.ops.projection import coverage as proj_coverage
from upsp_tpu_torch.pipeline.phase0 import Phase0State, run_phase0
from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
from upsp_tpu_torch.pipeline.phase2 import (
    Phase2Outputs,
    compute_model_temperature,
    load_steady_cp,
    make_phase2_constants,
    phase2_convert,
    run_phase2,
    run_phase2_sharded,
)
from upsp_tpu_torch.ops.polyfit import make_detrender
from upsp_tpu_torch.parallel import mesh as M
from upsp_tpu_torch.parallel.mesh import resolve_device
from upsp_tpu_torch.parallel.launcher import chunk_plan
from upsp_tpu_torch.utils import timing
from upsp_tpu_torch.utils.timing import StageClock

log = logging.getLogger("upsp_tpu")

@dataclasses.dataclass
class DatapointOutputs:
    state: Phase0State
    intensity: Optional[np.ndarray]  # (F, N)
    intensity_avg: Optional[np.ndarray]
    intensity_rms: Optional[np.ndarray]
    coverage: Optional[np.ndarray]
    phase2: Optional[Phase2Outputs]
    n_frames: int


def packed_ingest_config(readers, frames_array, device_unpack):
    """(use packed ingest, {"packed_bits", "lut"}): packed bytes go to the
    device when every camera's video supports packed reads with one bit
    depth and one linearisation LUT (upsp_tpu/pipeline/run.py:62-86)."""
    if (
        frames_array is not None
        or device_unpack not in ("auto", True)
        or not readers
        or not all(r.supports_packed_reads for r in readers)
    ):
        return False, {}
    bits = {r.packed_bits for r in readers}
    if len(bits) != 1:
        return False, {}
    luts = [r.packed_lut for r in readers]
    lut0 = luts[0]
    for lut in luts[1:]:
        if (lut is None) != (lut0 is None) or (
            lut0 is not None and not np.array_equal(lut, lut0)
        ):
            return False, {}
    return True, {"packed_bits": bits.pop(), "lut": lut0}


def open_videos(cfg: ProcessingConfig):
    """Open every camera's video; returns (readers, n_frames, start0) with
    ``start0`` the 0-based first frame (the deck's 1-based start_frame)."""
    readers = []
    for cam in cfg.cameras:
        r = video_reader(cam.video)
        r.open()
        readers.append(r)
    start0 = max(int(getattr(cfg, "start_frame", 1)) - 1, 0)
    avail = min(r.frame_count for r in readers) - start0
    if avail <= 0:
        raise ValueError(f"start_frame {cfg.start_frame} leaves no frames to process")
    n_frames = avail if cfg.frames <= 0 else min(avail, cfg.frames)
    return readers, n_frames, start0


def _resolve_mesh(mesh, device):
    """None | "none" | "auto" | Mesh -> a Mesh of two or more ranks, or
    None (one device).  "auto" is the mesh of the default process group
    (upsp_tpu_torch.parallel.launcher.initialize_distributed) when it has
    two or more ranks, else one device (upsp_tpu/pipeline/run.py:127-139):
    this process cannot start ranks of its own (``upsp-process-torch
    --mesh auto`` does, one a card)."""
    if mesh is None or mesh in ("none", ""):
        return None
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"unknown mesh spec {mesh!r}")
        if not (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            log.info("mesh auto: no process group of two or more ranks; "
                     "one device")
            return None
        mesh = M.make_mesh(device)
    if mesh.world == 1:
        return None
    if mesh.device.type != device.type:
        raise ValueError(f"the mesh's device {mesh.device} is not a "
                         f"{device.type} device")
    return mesh


def _stage_clock(device: torch.device, stage_times: Optional[dict], mesh=None):
    """A StageClock whose points wait for the device (and, on a mesh, for
    every rank) and record their wall seconds in ``stage_times`` and, while
    recording, as stage spans."""
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else None
    barrier = None if mesh is None else (lambda: M.barrier(mesh))
    return StageClock(barrier=barrier, enabled=False, sync=sync, times=stage_times,
                      spans=True)


class _StreamClock:
    """The points of a streaming run: the port's clock (the ``stage_times``
    keys) and the caller's StageClock under the JAX package's labels
    (upsp_tpu/pipeline/run.py:655-802), which has no ``phase1_setup`` and
    no ``outputs``."""

    JAX_LABELS = {"phase0": "phase0", "phase1": "phase1_stream",
                  "disk_transpose": "disk_transpose", "phase2": "phase2_blocks"}

    def __init__(self, clock: StageClock, caller: StageClock):
        self.clock, self.caller = clock, caller

    def point(self, label: str) -> None:
        self.clock.point(label)
        if label in self.JAX_LABELS:
            self.caller.point(self.JAX_LABELS[label])

    def split(self, label: str) -> None:
        self.clock.split(label)


def _open_inputs(cfg, frames_array):
    """(frames_array, readers, n_frames, start0, first_frames, bit_depths)
    from the videos, an (F, C, H, W) array, or a callable frame source
    ``source(start, count) -> (count, C, H, W)`` whose frame count is
    ``cfg.frames``."""
    if callable(frames_array):
        if cfg.frames <= 0:
            raise ValueError("a callable frame source requires cfg.frames > 0")
        f0 = frames_array(0, 1)
        f0 = f0.cpu().numpy() if isinstance(f0, torch.Tensor) else np.asarray(f0)
        first_frames = [f0[0, c] for c in range(f0.shape[1])]
        return (frames_array, None, cfg.frames, 0, first_frames,
                [12] * len(first_frames))
    if frames_array is not None:
        frames_array, n_frames = _apply_frame_window(cfg, frames_array)
        first_frames = [np.asarray(frames_array[0, c])
                        for c in range(frames_array.shape[1])]
        return (frames_array, None, n_frames, 0, first_frames,
                [12] * len(first_frames))
    readers, n_frames, start0 = open_videos(cfg)
    first_frames = [r.read_frame(start0) for r in readers]
    return (None, readers, n_frames, start0, first_frames,
            [r.bit_depth for r in readers])


def _close(readers):
    for r in readers or ():
        r.close()


def _apply_frame_window(cfg, frames_array):
    """The deck's 1-based start_frame + frame count on an array input."""
    fa_start = max(int(getattr(cfg, "start_frame", 1)) - 1, 0)
    if fa_start:
        frames_array = frames_array[fa_start:]
    if frames_array.shape[0] == 0:
        raise ValueError(f"start_frame {cfg.start_frame} leaves no frames to process")
    n_frames = frames_array.shape[0]
    if cfg.frames > 0:
        n_frames = min(n_frames, cfg.frames)
        frames_array = frames_array[:n_frames]
    return frames_array, n_frames


def _camera_settings(readers, cfg, state) -> Dict:
    """Camera settings for the HDF5 Condition group (psp_process.cpp:
    1583-1588: rate/fstop/exposure from camera 0, focal lengths)."""
    out = dict(
        focal_lengths=[float(p.fx) for p in state.cam_params],
        cam_nums=[c.number for c in cfg.cameras],
    )
    if readers:
        r0 = readers[0]
        out["framerate"] = int(getattr(r0, "frame_rate", 0) or 0)
        out["fstop"] = float(getattr(r0, "aperture", 0.0) or 0.0)
        out["exposure"] = float(getattr(r0, "exposure_us", 0.0) or 0.0)
    return out


class _HostBuffer:
    """One reused host buffer that device results are copied into:
    page-locked, grown when a larger result comes.  A CPU tensor is
    returned as it is.  ``fetch``'s array is valid until the next call,
    so a new buffer's one fetch gives an array the caller keeps."""

    def __init__(self):
        self.buffer = None

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        if t.device.type == "cpu":
            return t.numpy()
        n = t.numel()
        if self.buffer is None or self.buffer.numel() < n:
            self.buffer = torch.empty(n, dtype=t.dtype, pin_memory=True)
        host = self.buffer[:n].view(t.shape)
        host.copy_(t)
        timing.count("bytes.d2h.pinned", host.nbytes)
        return host.numpy()


class _PinnedStaging:
    """One page-locked host buffer: each chunk's per-camera bytes are
    gathered into it and copied to the card with ``non_blocking=True``.
    The buffer is refilled only after its last copy has finished."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buffer = None
        self.copied = None  # event after the last copy out of the buffer

    def to_device(self, per_cam) -> torch.Tensor:
        shape = (per_cam[0].shape[0], len(per_cam)) + per_cam[0].shape[1:]
        buf = self.buffer
        if buf is None or buf.shape[0] < shape[0] or buf.shape[1:] != shape[1:]:
            buf = self.buffer = torch.empty(shape, dtype=torch.uint8,
                                            pin_memory=True)
        elif self.copied is not None:
            self.copied.synchronize()
            timing.count("host_syncs.staging")
        host = buf[: shape[0]]
        for c, a in enumerate(per_cam):
            host[:, c].copy_(torch.from_numpy(a))
        dev = host.to(self.device, non_blocking=True)
        timing.count("bytes.h2d.pinned", host.nbytes)
        self.copied = torch.cuda.Event()
        self.copied.record()
        return dev


def _chunk_iter(frames_array, readers, n_frames, start0, frames_per_chunk,
                packed=False, device=torch.device("cpu"), mesh=None):
    """Yield (ChunkSlice, chunk) for this rank's block of each chunk
    (:func:`~upsp_tpu_torch.parallel.launcher.chunk_plan`; one device
    takes every frame of the chunk); ``chunk`` is None where the block
    holds no frame.  A callable ``frames_array`` is called as
    ``source(start, count)`` for each block (a tensor on the device or a
    numpy array).  File input is read by background prefetchers of the
    rank's frames only: with ``packed`` the chunk is the (count, C,
    nbytes) uint8 packed bytes, already on ``device`` (through pinned host
    memory on CUDA); otherwise the (count, C, H, W) frames decoded on the
    host."""
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    plan = chunk_plan(n_frames, frames_per_chunk, world, rank, world)
    if callable(frames_array):
        for c in plan:
            yield c, (frames_array(c.local_start, c.local_valid)
                      if c.local_valid else None)
        return
    if frames_array is not None:
        for c in plan:
            yield c, (frames_array[c.local_start : c.local_start + c.local_valid]
                      if c.local_valid else None)
        return
    prefetchers = [
        iter(IntervalPrefetcher(
            r, [(start0 + c.local_start, c.local_valid) for c in plan],
            packed=packed))
        for r in readers
    ]
    staging = _PinnedStaging(device) if packed and device.type == "cuda" else None
    for c in plan:
        with timing.span("phase1.ingest_wait"):
            per_cam = [next(p) for p in prefetchers]
        if not c.local_valid:
            yield c, None
            continue
        with timing.span("phase1.stage"):
            if staging is not None:
                chunk = staging.to_device(per_cam)
            elif packed:
                chunk = torch.from_numpy(np.stack(per_cam, axis=1)).to(device)
            else:
                chunk = np.stack(per_cam, axis=1)
        yield c, chunk


def _run_block(fn, chunk, n_nodes, n_cams, device, with_telemetry=True):
    """This rank's block through the chunk program: (rows, N) intensities
    [and (rows, C, 5) telemetry]; no rows for an empty block."""
    if chunk is None:
        out = torch.zeros((0, n_nodes), device=device)
        return (out, torch.zeros((0, n_cams, 5), device=device)) if with_telemetry else out
    return fn(np.ascontiguousarray(chunk) if isinstance(chunk, np.ndarray) else chunk)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows added up to ``rows``."""
    if t.shape[0] == rows:
        return t
    pad = t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad])


def _count_fetch(t: torch.Tensor) -> None:
    """Count a blocking copy of ``t`` from a card as a host sync."""
    if t.device.type != "cpu":
        timing.count("host_syncs.fetch")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array: from a card, a blocking copy to pageable
    host memory (its bytes counted)."""
    if t.device.type != "cpu":
        timing.count("bytes.d2h.pageable", t.numel() * t.element_size())
    return t.cpu().numpy()


class _DeviceRows:
    """One device's (F, N) intensity: each chunk's (rows, N) intensities
    are copied into the node-major (N, F) matrix ``it_t`` that phase 2
    reads on the device and, on a card, on a side stream into a
    page-locked (F, N) host tensor that the caller will own; the (rows, C,
    5) telemetry stays on the device until the loop ends.  Nothing in
    :meth:`add` waits for the card.  ``resume`` starts from the (F, N)
    host matrix of the intensity file instead (:meth:`from_host`)."""

    def __init__(self, n_frames: int, n_nodes: int, n_cams: int,
                 device: torch.device, host: Optional[np.ndarray] = None):
        on_card = device.type == "cuda"
        self.it_t = torch.empty((n_nodes, n_frames), device=device)
        self.tele = torch.empty((n_frames, n_cams, 5), device=device)
        self.host = (torch.empty((n_frames, n_nodes), pin_memory=on_card)
                     if host is None else torch.from_numpy(host))
        self.stream = torch.cuda.Stream(device) if on_card and host is None else None

    @classmethod
    def from_host(cls, intensity: np.ndarray, device: torch.device) -> "_DeviceRows":
        """The rows of an (F, N) host matrix, which the caller then owns."""
        rows = cls(*intensity.shape, 0, device, host=intensity)
        if device.type != "cpu":
            timing.count("bytes.h2d.pageable", intensity.nbytes)
        rows.it_t.copy_(rows.host.to(device).T)
        return rows

    def add(self, start: int, out: torch.Tensor, tele: torch.Tensor) -> None:
        """Frames ``start:start + len(out)``: rows ``out``, telemetry ``tele``."""
        rows = slice(start, start + out.shape[0])
        self.it_t[:, rows] = out.T
        self.tele[rows] = tele
        if self.stream is None:
            self.host[rows] = out
            return
        self.stream.wait_stream(torch.cuda.current_stream(out.device))
        with torch.cuda.stream(self.stream):
            self.host[rows].copy_(out, non_blocking=True)
        out.record_stream(self.stream)  # not reused before its copy is done
        timing.count("bytes.d2h.pinned", out.numel() * out.element_size())

    def telemetry(self) -> np.ndarray:
        """The (F, C, 5) telemetry on the host: one blocking copy."""
        _count_fetch(self.tele)
        return _to_host(self.tele)

    def intensity(self) -> np.ndarray:
        """The (F, N) host copy, once every row has reached it."""
        if self.stream is not None:
            self.stream.synchronize()
        return self.host.numpy()


def _gather_chunk(mesh, t: torch.Tensor, c) -> Optional[np.ndarray]:
    """The chunk's valid rows from every rank's block (this rank's ``t``),
    on rank 0's host; None on the other ranks."""
    whole = M.gather(mesh, _pad_rows(t, c.local_rows), "cpu")
    return None if whole is None else whole[: c.valid].numpy()


def _exchange_chunk(mesh, out: torch.Tensor, c, n_pad: int,
                    it_local: torch.Tensor) -> None:
    """The frames->nodes exchange of one chunk: this rank's nodes of every
    rank's block, into columns ``[c.start, c.start + c.valid)`` of its
    (N_pad/D, F) node block ``it_local``; the pad rows are cut."""
    block = out.new_zeros((c.local_rows, n_pad))
    block[: out.shape[0], : out.shape[1]] = out
    it_local[:, c.start : c.start + c.valid] = (
        M.global_transpose(mesh, block)[:, : c.valid])


@timing.datapoint
def run_datapoint(
    cfg: ProcessingConfig,
    device="cuda",
    checkout: bool = False,
    frames_per_chunk: int = 64,
    frames_array: Optional[np.ndarray] = None,
    registration_telemetry: bool = False,
    stage_times: Optional[dict] = None,
    device_unpack="auto",
    compute_dtype: str = "float32",
    resume: bool = False,
    write_outputs: bool = True,
    warm_start="fft",
    mesh=None,
    frame_batch: int = 8,
) -> DatapointOutputs:
    """Process one datapoint end to end on ``device``; outputs go to
    ``cfg.out_dir`` when set.

    ``warm_start``: each frame's ECC start, as
    :func:`~upsp_tpu_torch.pipeline.phase1.make_chunk_processor` takes it:
    "fft" (default; per-frame phase correlation, fixed steps, 8-frame
    batches), True/"scan" (the previous frame's warp, identity at each
    chunk's start) or False (identity, the while loop with the reference's
    criteria: reference parity, batched with per-frame stopping).
    ``frame_batch``: the frames of one batch in fft and identity modes
    (scan runs a frame at a time).  The JAX package passes 1 in identity
    mode, where it solves a frame at a time; the port's batched while loop
    gives each lane the result of its solve alone
    (tests/test_torch_registration.py), so it keeps the batch.

    ``frames_array`` (F, C, H, W) bypasses the video files.
    ``device_unpack``: "auto" (or True) ships the videos' packed bytes to
    the device and unpacks them there (K7/K8) when every camera supports
    packed reads in one format; False decodes frames on the host.
    ``compute_dtype``: the images' dtype between phase-1 stages, "float32"
    or "bfloat16" (:func:`~upsp_tpu_torch.pipeline.phase1.make_chunk_processor`).
    ``registration_telemetry`` writes the per-frame, per-camera ECC record
    [rho, conv, tx, ty, disp_bound] to the ``registration`` flat file with
    its ``registration.json`` sidecar: ``conv`` is the final |drho| in fft
    mode ("drho") and the iteration count otherwise ("iters").  ``resume`` reuses an
    ``intensity`` flat file in ``cfg.out_dir`` whose size fits the
    datapoint and skips phase 1.  ``write_outputs=False`` writes no file.
    ``stage_times``, when a dict, receives the wall seconds of phase 0,
    phase 1 (ingest included; ``phase1_setup`` is its set-up part, before
    the first frame), phase 2 and the output writes, each ended by a
    device synchronise (and on a mesh by a barrier, whose waits go under
    ``"barrier"``), and before them phase 0's walk readings
    (:func:`~upsp_tpu_torch.pipeline.phase0.run_phase0`: ``phase0.walk``,
    ``phase0.walk_recheck``, ``phase0.walk_rechecked``).

    One device: phase 1's rows stay on the device (:class:`_DeviceRows`),
    and phase 2 takes its statistics and delta-Cp from there
    (:func:`_finish_on_device`); ``resume`` uploads the intensity file's
    rows and runs the same phase 2.

    ``mesh``: None (one device), "auto" or a
    :class:`~upsp_tpu_torch.parallel.mesh.Mesh` (:func:`_resolve_mesh`).
    On a mesh of two or more ranks every rank calls this: it runs on the
    mesh's device, phase 1 on its block of each chunk; each chunk is
    exchanged frames->nodes on the devices into the rank's node block,
    and gathered to rank 0 alone.  Phase 2 runs on each rank's nodes
    (:func:`~upsp_tpu_torch.pipeline.phase2.run_phase2_sharded`) and is
    gathered to rank 0, which writes the files and returns the whole
    outputs; the other ranks return the state and the coverage, and None
    for the rest.  Host memory: rank 0 holds what one device's run holds,
    each other rank none of the (F, N) arrays; each card holds its 1/D of
    the node-major matrix.
    """
    device = resolve_device(device)
    mesh = _resolve_mesh(mesh, device)
    if mesh is not None:
        device = mesh.device
    rank0 = mesh is None or mesh.rank == 0
    clock = _stage_clock(device, stage_times, mesh)
    with timing.span("phase0.inputs"):
        frames_array, readers, n_frames, start0, first_frames, bit_depths = (
            _open_inputs(cfg, frames_array))
    use_packed, packed_kw = packed_ingest_config(readers, frames_array,
                                                 device_unpack)
    if use_packed:
        log.info("phase1: packed %d-bit bytes go to %s and unpack there",
                 packed_kw["packed_bits"], device)
    else:
        log.info("phase1: frames decode on the host")

    state = run_phase0(cfg, first_frames, bit_depths, device=device,
                       stage_times=stage_times)
    camset = _camera_settings(readers, cfg, state)
    diag_dir = cfg.add_out_dir or cfg.out_dir
    if write_outputs and diag_dir and rank0:
        try:
            from upsp_tpu_torch.pipeline.diagnostics import write_phase0_diagnostics

            write_phase0_diagnostics(state, diag_dir)
        except ImportError:
            log.warning("opencv unavailable; skipped diagnostic images")
    clock.point("phase0")
    if checkout:
        _close(readers)
        return DatapointOutputs(state, None, None, None, None, None, n_frames)

    n_nodes = state.n_nodes
    if resume and cfg.out_dir:
        ipath = os.path.join(cfg.out_dir, "intensity")
        if (os.path.exists(ipath)
                and os.path.getsize(ipath) == n_frames * n_nodes * 4):
            log.info("resume: reusing existing intensity file, skipping phase 1")
            _close(readers)
            if mesh is None:
                rows = _DeviceRows.from_host(
                    read_flat(ipath).reshape(n_frames, n_nodes), device)
                clock.point("phase1")
                return _finish_on_device(cfg, state, rows, camset=camset,
                                         clock=clock, write_outputs=write_outputs)
            intensity = (read_flat(ipath).reshape(n_frames, n_nodes)
                         if rank0 else None)
            it_local = _node_block_from_file(mesh, ipath, n_frames, n_nodes)
            clock.point("phase1")
            return _finish_sharded(cfg, state, it_local, intensity, camset,
                                   clock, write_outputs, mesh)
        log.info("resume requested but no consistent intensity file; running")

    with timing.span("phase1.processor"):
        fn = make_chunk_processor(state, with_telemetry=True, packed=use_packed,
                                  compute_dtype=compute_dtype, warm_start=warm_start,
                                  frame_batch=frame_batch, **packed_kw)
    clock.split("phase1_setup")  # part of phase 1: parameters, templates
    rows_kept = (_DeviceRows(n_frames, n_nodes, state.n_cameras, device)
                 if mesh is None else None)
    intensity = (np.empty((n_frames, n_nodes), np.float32)
                 if rank0 and mesh is not None else None)
    reg_telemetry = it_local = None
    if mesh is not None:
        log.info("phase1: frame axis over %d ranks, this rank's block of "
                 "each chunk on %s", mesh.world, device)
        n_pad = M.padded(n_nodes, mesh.world)
        it_local = torch.zeros((n_pad // mesh.world, n_frames), device=device)
        egress = 0
    for c, chunk in _chunk_iter(frames_array, readers, n_frames, start0,
                                frames_per_chunk, use_packed, device, mesh):
        timing.count("frames.phase1", c.local_valid)
        with timing.span("phase1.program"):
            out, tele = _run_block(fn, chunk, n_nodes, state.n_cameras, device)
        if mesh is None:
            with timing.span("phase1.store"):
                rows_kept.add(c.start, out, tele)
        else:
            with timing.span("phase1.exchange"):
                _exchange_chunk(mesh, out, c, n_pad, it_local)
            egress += 4 * c.local_rows * n_pad * (mesh.world - 1) // mesh.world
            with timing.span("phase1.fetch"):
                rows, tele_np = _gather_chunk(mesh, out, c), _gather_chunk(mesh, tele, c)
        if rank0 and mesh is not None:
            with timing.span("phase1.store"):
                if reg_telemetry is None:
                    reg_telemetry = np.empty((n_frames,) + tele_np.shape[1:],
                                             np.float32)
                reg_telemetry[c.start : c.start + c.valid] = tele_np
                intensity[c.start : c.start + c.valid] = rows
        if c.start % (frames_per_chunk * 8) == 0:
            log.info("phase1: processed frame %d / %d", c.start, n_frames)
    if mesh is not None:
        # each rank holds (F/D, N) of each chunk and keeps its (F/D, N/D)
        # diagonal; the rest leaves it (upsp_tpu/pipeline/phase2.py:236-244)
        log.info("phase1: frames->nodes exchange over %d ranks (%s): %.2f MB "
                 "egress from rank %d", mesh.world, mesh.backend, egress / 1e6,
                 mesh.rank)
    if readers:
        decoded = sum(r.frames_decoded for r in readers)
        timing.count("frames.decoded", decoded)
        log.info("phase1: rank %d decoded %d frames across %d cameras",
                 0 if mesh is None else mesh.rank, decoded, len(readers))
    _close(readers)
    if mesh is None:
        with timing.span("phase1.fetch"):
            reg_telemetry = rows_kept.telemetry()

    if registration_telemetry and reg_telemetry is not None:
        rho, conv = reg_telemetry[..., 0], reg_telemetry[..., 1]
        conv_semantics = "drho" if warm_start == "fft" else "iters"
        log.info(
            "registration: rho min/mean %.4f/%.4f, conv(%s) mean/max "
            "%.3g/%.3g, |t| max %.2f px",
            rho.min(), rho.mean(), conv_semantics, conv.mean(), conv.max(),
            np.abs(reg_telemetry[..., 2:4]).max(),
        )
        if write_outputs and cfg.out_dir and rank0:
            from upsp_tpu_torch.pipeline.diagnostics import write_registration_meta

            os.makedirs(cfg.out_dir, exist_ok=True)
            FlatFileSet(cfg.out_dir).write("registration", reg_telemetry)
            write_registration_meta(cfg.out_dir, conv_semantics)
    clock.point("phase1")
    if mesh is not None:
        return _finish_sharded(cfg, state, it_local, intensity, camset, clock,
                               write_outputs, mesh)
    return _finish_on_device(cfg, state, rows_kept, camset=camset, clock=clock,
                             write_outputs=write_outputs)


@timing.datapoint
def run_datapoint_streaming(
    cfg: ProcessingConfig,
    device="cuda",
    frames_per_chunk: int = 64,
    node_block: int = 65536,
    frames_array=None,
    device_unpack="auto",
    write_hdf5: bool = True,
    compute_dtype: str = "float32",
    stage_times: Optional[dict] = None,
    warm_start="fft",
    mesh=None,
    frame_batch: int = 8,
    stage_clock: Optional[StageClock] = None,
) -> DatapointOutputs:
    """Out-of-core datapoint processing on ``device``, for datapoints
    larger than host or device memory.

    The (frames x nodes) intensity never exists in memory: each phase-1
    chunk goes to the host through one reused page-locked buffer and on
    to the ``intensity`` flat file through the write-behind queue, while
    the per-node f64 sum (NaN frames left out) and sum of squares (NaN
    kept) accumulate on the device.  The blocked transpose writes
    ``intensity_transpose``; phase 2 then converts blocks of
    ``node_block`` nodes read back from it, writing ``pressure_transpose``
    and (``write_hdf5``, with h5py) the ``.h5`` file block by block.  This
    is the reference's disk-intermediate pattern (psp_process.cpp:524-563,
    upsp_matrix_transpose) with the compute on the device.

    ``frames_array``, ``warm_start`` and ``frame_batch``: as in
    :func:`run_datapoint`;
    ``frames_array`` may also be a callable frame
    source ``source(start, count) -> (count, C, H, W)`` (a tensor on the
    device or a numpy array), ``cfg.frames`` frames long.  Requires an
    output directory, a wtd (sds) file and a paint calibration; raises
    ``ValueError`` without them.  ``stage_times``: as in
    :func:`run_datapoint`, with ``disk_transpose`` between phase 1 and
    phase 2.  ``stage_clock``: a
    :class:`~upsp_tpu_torch.utils.timing.StageClock` (a new one when None)
    that gets the JAX package's points, each after the device's work:
    ``phase0``, ``phase1_stream``, ``disk_transpose`` and ``phase2_blocks``.
    Returns no (F, N) array: ``intensity`` and the phase-2
    ``pressure_transpose`` are None.

    ``mesh``: as in :func:`run_datapoint`; one device runs as a mesh of
    one rank.  Each rank writes its rows of each chunk into ``intensity``
    at their offsets and sums its f64 partials; the sums are summed over
    the ranks and frame 0's row broadcast from rank 0.  Once every rank's
    rows are on disk, each rank transposes its node columns of
    ``intensity`` into its rows of ``intensity_transpose``
    (:func:`upsp_tpu_torch.native.transpose_f32`), so the (F, N) matrix is
    never whole on any device or host, and the disk is the frames->nodes
    exchange, as in the reference's disk-intermediate mode
    (upsp_tpu/pipeline/run.py:846-1092).  Phase 2 converts each rank's
    node slice by blocks of ``node_block`` and writes it at its offsets in
    ``pressure_transpose``; rank 0 writes its blocks to the ``.h5`` file
    as it converts them, then the other ranks' from
    ``pressure_transpose``, and the per-node files.  The output directory
    is shared by the ranks.
    """
    from upsp_tpu_torch import native

    if not cfg.out_dir:
        raise ValueError("streaming mode requires an output directory")
    if not (cfg.sds and cfg.paint_cal):
        raise ValueError(
            "streaming mode runs phase 2 inline and requires both a wtd "
            "(sds) file and a paint calibration (the reference refuses to "
            "start without -paint_cal, psp_process.cpp:1240-1243); use "
            "run_datapoint for an intensity-only run"
        )
    device = resolve_device(device)
    mesh = _resolve_mesh(mesh, device)
    clock = _StreamClock(_stage_clock(device if mesh is None else mesh.device,
                                      stage_times, mesh),
                         StageClock() if stage_clock is None else stage_clock)
    if mesh is None:
        mesh = M.Mesh(0, 1, device, None, "none")
    device = mesh.device
    with timing.span("phase0.inputs"):
        frames_array, readers, n_frames, start0, first_frames, bit_depths = (
            _open_inputs(cfg, frames_array))
    try:
        state = run_phase0(cfg, first_frames, bit_depths, device=device,
                           stage_times=stage_times)
        camset = _camera_settings(readers, cfg, state)
        clock.point("phase0")
        n_nodes = state.n_nodes
        use_packed, packed_kw = packed_ingest_config(readers, frames_array,
                                                     device_unpack)
        with timing.span("phase1.processor"):
            fn = make_chunk_processor(state, packed=use_packed,
                                      compute_dtype=compute_dtype,
                                      warm_start=warm_start, frame_batch=frame_batch,
                                      **packed_kw)
        clock.split("phase1_setup")
        ffs = FlatFileSet(cfg.out_dir)
        if mesh.rank == 0:
            for name in ("intensity", "intensity_transpose", "pressure_transpose"):
                _ensure_file_size(ffs.path(name), n_nodes * n_frames * 4)
        M.barrier(mesh)  # every file sized before any rank writes
        sum_i = torch.zeros(n_nodes, dtype=torch.float64, device=device)
        sumsq_i = torch.zeros(n_nodes, dtype=torch.float64, device=device)
        ratio0_src = torch.zeros(n_nodes, dtype=torch.float32, device=device)
        host = _HostBuffer()
        with native.AsyncWriter(ffs.path("intensity")) as writer:
            for c, chunk in _chunk_iter(frames_array, readers, n_frames, start0,
                                        frames_per_chunk, use_packed, device, mesh):
                if chunk is None:
                    continue
                timing.count("frames.phase1", c.local_valid)
                with timing.span("phase1.program"):
                    out = _run_block(fn, chunk, n_nodes, state.n_cameras, device,
                                     with_telemetry=False)
                with timing.span("phase1.fetch"):
                    rows = host.fetch(out)
                _count_fetch(out)
                with timing.span("phase1.store"):
                    writer.submit(c.local_start * n_nodes * 4, rows)
                with timing.span("phase1.program"):
                    sum_i += torch.nansum(out, dim=0, dtype=torch.float64)
                    sumsq_i += out.double().square_().sum(dim=0)
                    if c.local_start == 0:
                        ratio0_src = out[0].clone()
                if c.start % (frames_per_chunk * 8) == 0:
                    log.info("phase1: processed frame %d / %d", c.start, n_frames)
    finally:
        _close(readers)
    del fn  # phase 1's device state
    sol_avg_t, sol_avg, sol_rms, ratio0 = _frame_statistics(
        M.all_reduce(mesh, sum_i), M.all_reduce(mesh, sumsq_i),
        M.broadcast(mesh, ratio0_src, src=0), n_frames)
    cov_t = proj_coverage(state.projections, *state.image_hw)[state.superseded_by]
    cov = cov_t.cpu().numpy()
    clock.point("phase1")  # every rank's rows of intensity are on disk

    n0, n1 = (min(n, n_nodes) for n in M.node_sharding(mesh, n_nodes))
    tpath = ffs.path("intensity_transpose")
    native.transpose_f32(ffs.path("intensity"), tpath, n_frames, n_nodes,
                         columns=(n0, n1))
    clock.point("disk_transpose")

    cond, const, det, steady, mtemp = _phase2_inputs(cfg, state, n_frames, device)
    steady_t = torch.as_tensor(steady, device=device)
    mtemp_t = torch.as_tensor(mtemp, device=device)
    steady_out = _steady_for_output(steady)
    local = {k: torch.full((M.padded(n_nodes, mesh.world) // mesh.world,), float("nan"),
                           device=device) for k in ("rms", "avg", "gain")}
    h5w = (_open_hdf5(cfg, state, n_frames, cond, camset)
           if write_hdf5 and mesh.rank == 0 else None)
    try:
        with native.AsyncWriter(ffs.path("pressure_transpose")) as pwriter:
            for b0 in range(n0, n1, node_block):
                nw = min(node_block, n1 - b0)
                block = read_flat(tpath, count=nw * n_frames,
                                  offset_values=b0 * n_frames).reshape(nw, n_frames)
                nodes = slice(b0, b0 + nw)
                out2 = phase2_convert(
                    torch.from_numpy(block).to(device), sol_avg_t[nodes],
                    cov_t[nodes], steady_t[nodes], mtemp_t[nodes], const, det,
                )
                press = host.fetch(out2.pressure_transpose)
                pwriter.submit(b0 * n_frames * 4, press)
                if h5w is not None:
                    h5w.write_frames_block(press, node_start=b0)
                for k in local:
                    local[k][b0 - n0 : b0 - n0 + nw] = getattr(out2, k)
        # rank-major node slices: the gather is the global node order
        rms_all, avg_all, gain_all = (
            M.fetch_global(mesh, local[k], "cpu")[:n_nodes].numpy()
            for k in ("rms", "avg", "gain"))
        M.barrier(mesh)  # every rank's pressure_transpose is on disk
        if h5w is not None:
            for b0 in range(n1, n_nodes, node_block):  # the other ranks' nodes
                nw = min(node_block, n_nodes - b0)
                h5w.write_frames_block(read_flat(
                    ffs.path("pressure_transpose"), count=nw * n_frames,
                    offset_values=b0 * n_frames).reshape(nw, n_frames), node_start=b0)
            _write_node_datasets(h5w, rms_all, avg_all, cov, steady_out, mtemp)
    finally:
        if h5w is not None:
            h5w.close()
    clock.point("phase2")

    if mesh.rank == 0:
        ffs.write_standard_outputs(
            state.model,
            {"intensity_avg": sol_avg, "intensity_rms": sol_rms,
             "intensity_ratio_0": ratio0, "coverage": cov},
            {"avg": avg_all, "rms": rms_all, "gain": gain_all,
             "steady_state": steady_out, "model_temp": mtemp},
        )
    clock.point("outputs")
    return DatapointOutputs(
        state=state, intensity=None, intensity_avg=sol_avg,
        intensity_rms=sol_rms, coverage=cov,
        phase2=Phase2Outputs(pressure_transpose=None, rms=rms_all,
                             avg=avg_all, gain=gain_all, steady_state=steady,
                             model_temp=mtemp),
        n_frames=n_frames,
    )


def _frame_statistics(sum_i, sumsq_i, ratio0_src, n_frames):
    """(avg on the device, avg, rms, intensity_ratio_0) from the f64 sums
    and frame 0's row; NaN where frame 0 is NaN."""
    nan_mask = torch.isnan(ratio0_src)
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=sum_i.device)
    sol_avg_t = torch.where(nan_mask, nan, sum_i / n_frames).float()
    sol_avg = sol_avg_t.cpu().numpy()
    sol_rms = torch.where(nan_mask, nan, torch.sqrt(sumsq_i / n_frames)).float(
    ).cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio0 = sol_avg / ratio0_src.cpu().numpy() - 1.0
    return sol_avg_t, sol_avg, sol_rms, ratio0


def _phase2_inputs(cfg, state, n_frames, device):
    """(tunnel conditions, constants, detrender, steady Cp, model
    temperature) of a streaming run's phase 2."""
    cond = read_wtd(cfg.sds)
    cond.test_id, cond.run, cond.seq = cfg.test_id, cfg.run, cfg.sequence
    const = make_phase2_constants(PaintCalibration.read(cfg.paint_cal), cond,
                                  device)
    det = make_detrender(n_frames, cfg.degree, device)
    steady = load_steady_cp(cfg, state.n_nodes, state.model)
    mtemp = compute_model_temperature(cfg, cond, state.n_nodes, state.model)
    return cond, const, det, steady, mtemp


def _ensure_file_size(path: str, nbytes: int) -> None:
    """Create or resize a file to exactly ``nbytes``: a target that several
    ranks write at their own offsets."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if os.fstat(fd).st_size != nbytes:
            os.ftruncate(fd, nbytes)
    finally:
        os.close(fd)


def _steady_for_output(steady: np.ndarray) -> np.ndarray:
    """Steady Cp values > 3.0 write as NaN (psp_process.cpp:2567-2572)."""
    s = np.asarray(steady, np.float32)
    return np.where(s > 3.0, np.nan, s)


def _phase2_conditions(cfg):
    """(tunnel conditions, paint calibration) of phase 2, or None (with a
    warning) where the deck lacks the wtd file or the paint calibration."""
    if not (cfg.sds and cfg.paint_cal):
        log.warning("phase 2 skipped: missing %s — intensity outputs only",
                    "sds (wtd)" if not cfg.sds else "paint_cal")
        return None
    cond = read_wtd(cfg.sds)
    cond.test_id, cond.run, cond.seq = cfg.test_id, cfg.run, cfg.sequence
    return cond, PaintCalibration.read(cfg.paint_cal)


def _finish_outputs(cfg, state, intensity, sol_avg, sol_rms, ratio0, cov, phase2,
                    camset, clock, write_outputs) -> DatapointOutputs:
    """The files and the whole datapoint's outputs, after phase 2."""
    if write_outputs and cfg.out_dir:
        _write_outputs(cfg, state, intensity, sol_avg, sol_rms, ratio0, cov,
                       phase2, camset)
    if clock is not None:
        clock.point("outputs")
    return DatapointOutputs(
        state=state, intensity=intensity, intensity_avg=sol_avg,
        intensity_rms=sol_rms, coverage=cov, phase2=phase2,
        n_frames=intensity.shape[0],
    )


def _finish_on_device(cfg, state, rows: _DeviceRows, camset=None, clock=None,
                      write_outputs=True) -> DatapointOutputs:
    """Statistics + coverage + phase 2 + outputs, from one device's rows
    (:class:`_DeviceRows`): the f64 statistics of its node-major matrix
    there (:func:`_node_statistics`, as on a mesh; NaN where a frame is
    NaN) and phase 2 on it as it is.  The host gets the per-node vectors,
    the (F, N) intensity and, from a card, the (N, F) delta-Cp through
    page-locked memory, all in arrays the caller owns."""
    it_t = rows.it_t
    with timing.span("phase2.stats"):
        avg_t, rms_t = _node_statistics(it_t)
        ratio0_t = avg_t / it_t[:, 0] - 1.0
    with timing.span("phase2.coverage"):
        cov_t = proj_coverage(state.projections, *state.image_hw)[state.superseded_by]

    phase2 = None
    conditions = _phase2_conditions(cfg)
    if conditions is not None:
        with timing.span("phase2.device"):
            phase2 = run_phase2(cfg, it_t, avg_t, cov_t, *conditions,
                                model=state.model)
    with timing.span("phase2.download"):
        intensity = rows.intensity()
        sol_avg, sol_rms, ratio0, cov = (
            _to_host(t) for t in (avg_t, rms_t, ratio0_t, cov_t))
        if phase2 is not None:
            phase2 = Phase2Outputs(*(
                None if v is None else
                _HostBuffer().fetch(v) if v.dim() == 2 else _to_host(v)
                for v in phase2
            ))
    if clock is not None:
        clock.point("phase2")
    return _finish_outputs(cfg, state, intensity, sol_avg, sol_rms, ratio0, cov,
                           phase2, camset, clock, write_outputs)


def _node_block_from_file(mesh, path: str, n_frames: int, n_nodes: int
                          ) -> torch.Tensor:
    """This rank's (N_pad/D, F) node block of an (F, N) ``intensity``
    file, on its device; node pads are zero."""
    n0, n1 = M.node_sharding(mesh, n_nodes)
    rows = M.padded(n_nodes, mesh.world) // mesh.world
    it_local = torch.zeros((rows, n_frames), device=mesh.device)
    if n0 < n_nodes:
        cols = np.memmap(path, "<f4", mode="r", shape=(n_frames, n_nodes))
        it_local[: min(n1, n_nodes) - n0] = torch.from_numpy(
            np.ascontiguousarray(cols[:, n0:n1].T))
    return it_local


def _node_statistics(it_local: torch.Tensor, block: int = 65536):
    """(avg, rms) over the frames of each row of a node-major block, as f32
    from f64 sums (psp_process.cpp:1725-1730); NaN where a frame is NaN.
    ``block`` rows at a time, so the f64 copy stays small."""
    n_frames = it_local.shape[1]
    avg = torch.empty(it_local.shape[0], device=it_local.device)
    rms = torch.empty_like(avg)
    for b in range(0, it_local.shape[0], block):
        x = it_local[b : b + block].double()
        avg[b : b + block] = x.sum(1) / n_frames
        rms[b : b + block] = torch.sqrt(x.square_().sum(1) / n_frames)
    return avg, rms


def _finish_sharded(cfg, state, it_local: torch.Tensor,
                    intensity: Optional[np.ndarray], camset, clock,
                    write_outputs, mesh) -> DatapointOutputs:
    """Statistics + coverage + phase 2 over the ranks of ``mesh``, from
    this rank's (N_pad/D, F) node block; ``intensity`` is the (F, N)
    matrix on rank 0 (None elsewhere), which gathers every node's results
    and writes the files."""
    n_nodes, n_frames = state.n_nodes, it_local.shape[1]
    rank0 = mesh.rank == 0
    with timing.span("phase2.stats"):
        avg_loc, rms_loc = _node_statistics(it_local)
    with timing.span("phase2.coverage"):
        cov = _to_host(proj_coverage(state.projections, *state.image_hw)[
            state.superseded_by])
    with timing.span("phase2.download"):
        sol_avg, sol_rms = (M.gather(mesh, t, "cpu") for t in (avg_loc, rms_loc))
    phase2 = None
    conditions = _phase2_conditions(cfg)
    if conditions is not None:
        with timing.span("phase2.device"):
            phase2 = run_phase2_sharded(cfg, it_local, avg_loc, cov, *conditions,
                                        mesh, model=state.model)
    clock.point("phase2")
    if not rank0:
        clock.point("outputs")
        return DatapointOutputs(state, None, None, None, cov, None, n_frames)
    sol_avg, sol_rms = sol_avg[:n_nodes].numpy(), sol_rms[:n_nodes].numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio0 = sol_avg / intensity[0] - 1.0
    if phase2 is not None:
        with timing.span("phase2.download"):
            phase2 = Phase2Outputs(*(None if v is None else _to_host(v)
                                     for v in phase2))
    return _finish_outputs(cfg, state, intensity, sol_avg, sol_rms, ratio0, cov,
                           phase2, camset, clock, write_outputs)


def _write_outputs(cfg, state, intensity, sol_avg, sol_rms, ratio0, cov,
                   phase2, camset=None):
    """The 15 flat files and ``output.h5`` (run.py:1177-1238)."""
    ffs = FlatFileSet(cfg.out_dir)
    p1 = {
        "intensity": intensity,
        "intensity_avg": sol_avg,
        "intensity_rms": sol_rms,
        "intensity_ratio_0": ratio0,
        "coverage": cov,
    }
    p2 = None
    steady_out = mtemp = None
    if phase2 is not None:
        p2 = {
            "pressure_transpose": phase2.pressure_transpose,
            "avg": phase2.avg,
            "rms": phase2.rms,
            "gain": phase2.gain,
        }
        if phase2.steady_state is not None:
            steady_out = _steady_for_output(phase2.steady_state)
            p2["steady_state"] = steady_out
        if phase2.model_temp is not None:
            mtemp = phase2.model_temp
            p2["model_temp"] = mtemp
    ffs.write_standard_outputs(state.model, p1, p2)
    if phase2 is None:
        return
    cond = read_wtd(cfg.sds)
    cond.test_id, cond.run, cond.seq = cfg.test_id, cfg.run, cfg.sequence
    w = _open_hdf5(cfg, state, intensity.shape[0], cond, camset)
    if w is None:
        return
    with w:
        w.write_frames_block(phase2.pressure_transpose)
        _write_node_datasets(w, phase2.rms, phase2.avg, cov, steady_out, mtemp)


def _open_hdf5(cfg, state, n_frames, cond, camset=None):
    """The ``.h5`` output open, with its grid, tunnel conditions and
    camera settings written; None (with a warning) without h5py."""
    if importlib.util.find_spec("h5py") is None:
        log.warning("h5py unavailable; skipped HDF5 output")
        return None
    from upsp_tpu_torch.io.hdf5io import PSPWriter

    name = cfg.out_name or "output"
    w = PSPWriter(
        cfg.h5_out or os.path.join(cfg.out_dir, f"{name}.h5"),
        state.model, n_frames=n_frames, transposed=True,
        chunk_nodes=cfg.trans_nodes or 4096,
    )
    try:
        w.write_grid(cfg.grid_units)
        w.write_tunnel_conditions(cond)
        w.write_camera_settings(**(camset or dict(
            focal_lengths=[float(p.fx) for p in state.cam_params],
            cam_nums=[c.number for c in cfg.cameras],
        )))
    except BaseException:
        w.close()
        raise
    return w


def _write_node_datasets(w, rms, avg, cov, steady_out, mtemp):
    """The per-node datasets of the ``.h5`` output."""
    w.write_new_dataset("rms", rms, "delta Cp")
    w.write_new_dataset("average", avg, "delta Cp")
    w.write_new_dataset("coverage", cov)
    if steady_out is not None:
        w.write_new_dataset("steady_state", steady_out, "Cp")
    if mtemp is not None:
        w.write_new_dataset("model_temp", mtemp, "F")
