"""End-to-end datapoint processing on one device: the ``psp_process`` path.

Port of ``upsp_tpu/pipeline/run.py`` (``run_datapoint`` :385-569) in
memory and on a single device: open the videos, phase 0 once, phase 1 per
frame chunk, f64 frame statistics on the host, phase 2 on the device, then
the 15 flat files, the registration telemetry and ``output.h5``.

Frames reach phase 1 as packed video bytes, unpacked on the device by
K7/K8, whenever every camera's video supports packed reads in one format
(``device_unpack="auto"``, the default); otherwise the
``upsp_tpu_torch.io.video`` readers decode them on the host.

Not ported here (ROADMAP.md): out-of-core streaming, device meshes and
multi-process runs, and the band guard that re-runs out-of-band frames on
a dense path — the port's warp kernel has no band limit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from upsp_tpu_torch.io.flatfile import FlatFileSet
from upsp_tpu_torch.io.paint import PaintCalibration
from upsp_tpu_torch.io.video import FramePrefetcher, video_reader
from upsp_tpu_torch.io.wtd import read_wtd
from upsp_tpu_torch.pipeline.config import ProcessingConfig
from upsp_tpu_torch.ops.projection import coverage as proj_coverage
from upsp_tpu_torch.pipeline.phase0 import Phase0State, run_phase0
from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
from upsp_tpu_torch.pipeline.phase2 import Phase2Outputs, run_phase2

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


def resolve_device(device) -> torch.device:
    """``cuda`` or ``cpu``; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


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
        host = buf[: shape[0]]
        for c, a in enumerate(per_cam):
            host[:, c].copy_(torch.from_numpy(a))
        dev = host.to(self.device, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()
        return dev


def _chunk_iter(frames_array, readers, n_frames, start0, frames_per_chunk,
                packed=False, device=torch.device("cpu")):
    """Yield (start, chunk).  File input is read by background prefetchers:
    with ``packed`` the chunk is the (chunk, C, nbytes) uint8 packed bytes,
    already on ``device`` (through pinned host memory on CUDA); otherwise
    the (chunk, C, H, W) frames decoded on the host."""
    if frames_array is not None:
        for s in range(0, n_frames, frames_per_chunk):
            yield s, frames_array[s : s + frames_per_chunk]
        return
    prefetchers = [
        iter(FramePrefetcher(r, n_frames, start=start0,
                             frames_per_chunk=frames_per_chunk, packed=packed))
        for r in readers
    ]
    staging = _PinnedStaging(device) if packed and device.type == "cuda" else None
    s = 0
    while s < n_frames:
        per_cam = [next(p) for p in prefetchers]
        if staging is not None:
            chunk = staging.to_device(per_cam)
        elif packed:
            chunk = torch.from_numpy(np.stack(per_cam, axis=1)).to(device)
        else:
            chunk = np.stack(per_cam, axis=1)
        yield s, chunk
        s += chunk.shape[0]


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
) -> DatapointOutputs:
    """Process one datapoint end to end on ``device`` (ECC from the fft
    warm start, 8-frame batches); outputs go to ``cfg.out_dir`` when set.

    ``frames_array`` (F, C, H, W) bypasses the video files.
    ``device_unpack``: "auto" (or True) ships the videos' packed bytes to
    the device and unpacks them there (K7/K8) when every camera supports
    packed reads in one format; False decodes frames on the host.
    ``compute_dtype``: the images' dtype between phase-1 stages, "float32"
    or "bfloat16" (:func:`~upsp_tpu_torch.pipeline.phase1.make_chunk_processor`).
    ``registration_telemetry`` writes the per-frame, per-camera ECC record
    [rho, final |drho|, tx, ty, disp_bound] to the ``registration`` flat
    file with its ``registration.json`` sidecar.  ``stage_times``, when a
    dict, receives the wall seconds of phase 0, phase 1 (ingest included;
    ``phase1_setup`` is its set-up part, before the first frame), phase 2
    and the output writes, each ended by a device synchronise.
    """
    import time

    device = resolve_device(device)

    def mark(name, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        if stage_times is not None:
            stage_times[name] = t1 - t0
        return t1

    t0 = time.perf_counter()
    start0 = 0
    if frames_array is not None:
        frames_array, n_frames = _apply_frame_window(cfg, frames_array)
        first_frames = [np.asarray(frames_array[0, c])
                        for c in range(frames_array.shape[1])]
        bit_depths = [12] * len(first_frames)
        readers = None
    else:
        readers, n_frames, start0 = open_videos(cfg)
        first_frames = [r.read_frame(start0) for r in readers]
        bit_depths = [r.bit_depth for r in readers]
    use_packed, packed_kw = packed_ingest_config(readers, frames_array,
                                                 device_unpack)
    if use_packed:
        log.info("phase1: packed %d-bit bytes go to %s and unpack there",
                 packed_kw["packed_bits"], device)
    else:
        log.info("phase1: frames decode on the host")

    state = run_phase0(cfg, first_frames, bit_depths, device=device)
    camset = _camera_settings(readers, cfg, state)
    diag_dir = cfg.add_out_dir or cfg.out_dir
    if diag_dir:
        try:
            from upsp_tpu_torch.pipeline.diagnostics import write_phase0_diagnostics

            write_phase0_diagnostics(state, diag_dir)
        except ImportError:
            log.warning("opencv unavailable; skipped diagnostic images")
    t0 = mark("phase0", t0)
    if checkout:
        for r in readers or ():
            r.close()
        return DatapointOutputs(state, None, None, None, None, None, n_frames)

    fn = make_chunk_processor(state, with_telemetry=True, packed=use_packed,
                              compute_dtype=compute_dtype, **packed_kw)
    mark("phase1_setup", t0)  # part of phase 1: parameters, templates
    n_nodes = state.n_nodes
    intensity = np.empty((n_frames, n_nodes), np.float32)
    reg_telemetry = None
    for start, chunk in _chunk_iter(frames_array, readers, n_frames, start0,
                                    frames_per_chunk, use_packed, device):
        out, tele = fn(chunk if use_packed else np.ascontiguousarray(chunk))
        valid = out.shape[0]
        tele_np = tele.cpu().numpy()
        if reg_telemetry is None:
            reg_telemetry = np.empty((n_frames,) + tele_np.shape[1:], np.float32)
        reg_telemetry[start : start + valid] = tele_np
        intensity[start : start + valid] = out.cpu().numpy()
        if start % (frames_per_chunk * 8) == 0:
            log.info("phase1: processed frame %d / %d", start, n_frames)
    if readers:
        log.info("phase1: decoded %d frames across %d cameras",
                 sum(r.frames_decoded for r in readers), len(readers))
        for r in readers:
            r.close()

    if registration_telemetry and reg_telemetry is not None:
        rho, conv = reg_telemetry[..., 0], reg_telemetry[..., 1]
        log.info(
            "registration: rho min/mean %.4f/%.4f, conv(drho) mean/max "
            "%.3g/%.3g, |t| max %.2f px",
            rho.min(), rho.mean(), conv.mean(), conv.max(),
            np.abs(reg_telemetry[..., 2:4]).max(),
        )
        if cfg.out_dir:
            from upsp_tpu_torch.pipeline.diagnostics import write_registration_meta

            os.makedirs(cfg.out_dir, exist_ok=True)
            FlatFileSet(cfg.out_dir).write("registration", reg_telemetry)
            write_registration_meta(cfg.out_dir)
    t0 = mark("phase1", t0)
    return _finish_from_intensity(cfg, state, intensity, camset=camset,
                                  mark=mark, t0=t0)


def _steady_for_output(steady: np.ndarray) -> np.ndarray:
    """Steady Cp values > 3.0 write as NaN (psp_process.cpp:2567-2572)."""
    s = np.asarray(steady, np.float32)
    return np.where(s > 3.0, np.nan, s)


def _finish_from_intensity(cfg, state, intensity: np.ndarray, camset=None,
                           mark=None, t0=None) -> DatapointOutputs:
    """Statistics + coverage + phase 2 + outputs, from a (F, N) intensity."""
    n_frames = intensity.shape[0]
    with np.errstate(invalid="ignore"):
        # f64 accumulation of both moments (psp_process.cpp:1725-1730)
        sol_avg = intensity.mean(axis=0, dtype=np.float64).astype(np.float32)
        sol_rms = np.sqrt(
            np.einsum("fn,fn->n", intensity, intensity, dtype=np.float64)
            / n_frames
        ).astype(np.float32)
    cov_t = proj_coverage(state.projections, *state.image_hw)
    cov = cov_t.cpu().numpy()[state.superseded_by.cpu().numpy()]
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio0 = sol_avg / intensity[0] - 1.0

    phase2 = None
    if not (cfg.sds and cfg.paint_cal):
        log.warning("phase 2 skipped: missing %s — intensity outputs only",
                    "sds (wtd)" if not cfg.sds else "paint_cal")
    else:
        cond = read_wtd(cfg.sds)
        cond.test_id, cond.run, cond.seq = cfg.test_id, cfg.run, cfg.sequence
        dev = state.device
        phase2 = run_phase2(
            cfg,
            torch.as_tensor(np.ascontiguousarray(intensity.T), device=dev),
            torch.as_tensor(sol_avg, device=dev),
            torch.as_tensor(cov, device=dev),
            cond, PaintCalibration.read(cfg.paint_cal), model=state.model,
        )
        phase2 = Phase2Outputs(*(
            None if v is None else v.cpu().numpy() for v in phase2
        ))
    if mark is not None:
        t0 = mark("phase2", t0)
    if cfg.out_dir:
        _write_outputs(cfg, state, intensity, sol_avg, sol_rms, ratio0, cov,
                       phase2, camset)
    if mark is not None:
        mark("outputs", t0)
    return DatapointOutputs(
        state=state, intensity=intensity, intensity_avg=sol_avg,
        intensity_rms=sol_rms, coverage=cov, phase2=phase2, n_frames=n_frames,
    )


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
    if importlib.util.find_spec("h5py") is None:
        log.warning("h5py unavailable; skipped HDF5 output")
        return
    from upsp_tpu_torch.io.hdf5io import PSPWriter

    cond = read_wtd(cfg.sds)
    cond.test_id, cond.run, cond.seq = cfg.test_id, cfg.run, cfg.sequence
    name = cfg.out_name or "output"
    with PSPWriter(
        cfg.h5_out or os.path.join(cfg.out_dir, f"{name}.h5"),
        state.model, n_frames=intensity.shape[0], transposed=True,
        chunk_nodes=cfg.trans_nodes or 4096,
    ) as w:
        w.write_grid(cfg.grid_units)
        w.write_tunnel_conditions(cond)
        w.write_camera_settings(**(camset or dict(
            focal_lengths=[float(p.fx) for p in state.cam_params],
            cam_nums=[c.number for c in cfg.cameras],
        )))
        w.write_frames_block(phase2.pressure_transpose)
        w.write_new_dataset("rms", phase2.rms, "delta Cp")
        w.write_new_dataset("average", phase2.avg, "delta Cp")
        w.write_new_dataset("coverage", cov)
        if steady_out is not None:
            w.write_new_dataset("steady_state", steady_out, "Cp")
        if mtemp is not None:
            w.write_new_dataset("model_temp", mtemp, "F")
