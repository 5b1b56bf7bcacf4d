"""The combined projection gather of phase 1 (csrc/gather.cu) and its plain
twin.

Counterpart of ``upsp_tpu/ops/pallas_gather.py``.  On the best-view path
every node sees at most one camera, so a frame batch projects with ONE
gather from the C cameras' processed frames, indexed as if stacked into
(B, C*H*W).  The port keeps that module's contract — supersession composed
into the sources, the skip mask applied, patch overlays on every node whose
primary is overlaid — and not its slot order: the kernel writes model
order directly, so there is no host un-permute (``finalize_host``) and no
node-count gate.  It reads the C (B, H, W) camera images where they are
(no stacked copy), or one (B, C*H*W) stack.

| wrapper | kernel | replaces |
| --- | --- | --- |
| :func:`project_gather` | K5 ``gather_kernel`` | ``_slab_gather_apply`` (pallas_gather.py:251) |

The frames may be float32 or bfloat16 (``compute_dtype="bfloat16"``); the
output is float32 either way, each pixel widened before its one multiply
(pallas_gather.py:328).  The launch counts tell the two apart: ``gather``
and ``gather_bf16``.

:func:`build_gather_plan` runs once, when the phase-1 parameters are
derived.  It cuts the nodes into tiles of :data:`GATHER_TILE` consecutive
model-order nodes, one block of the kernel each, and sorts each tile's
entries by source pixel (``tests/test_torch_gather_tiles.py`` streams the
plan tile by tile in torch).  :func:`gather_plain` is the port's plain
tail (gather, NaN for skipped nodes, overlap supersession) and the
kernel's oracle.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from upsp_tpu_torch.ops.cuda_lib import (
    CudaLibrary,
    check_rc,
    count_launch,
    register_kernels,
    stream_of,
)

KERNELS = register_kernels(("gather", "gather_bf16"))
GATHER_TILE = 4096  # model-order nodes a tile: a block of csrc/gather.cu
GATHER_MAX_CAMS = 8  # camera images one launch takes (csrc/gather.cu)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.upsp_gather, lib.upsp_gather_bf16):
        fn.argtypes = [ctypes.POINTER(p), i, i, p, p, p, p, i, i, i, p]
        fn.restype = i


LIBRARY = CudaLibrary("gather", _bind)


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Phase-0 product: the best-view gather in kernel order and in model
    order.  ``skipped`` and ``superseded_by`` are the tensors it was built
    from (the phase-1 parameters'), not copies."""

    # kernel order: tiles of ``tile`` model-order nodes, each tile's
    # entries sorted by source pixel
    src: torch.Tensor  # (N,) int32 into (C*H*W,) frames; -1 = skipped (NaN)
    weight: torch.Tensor  # (N,) float32
    node: torch.Tensor  # (N,) int32 model node written
    # model order (the plain twin)
    combined_index: torch.Tensor  # (N,) int64 into (C*H*W,) frames
    combined_weight: torch.Tensor  # (N,) float32
    skipped: torch.Tensor  # (N,) bool
    superseded_by: torch.Tensor  # (N,) int64
    # per camera: (target nodes, value slot, weight) | None — the overlay
    # of every node whose primary is an overlaid, non-skipped node
    overlays: Tuple = ()
    n_pixels: int = 0  # C*H*W
    tile: int = GATHER_TILE
    # per camera: the overlay's (node, value slot, weight) numpy arrays in
    # model order before supersession | None (what the plan was built from)
    corr_nodes: Tuple = ()

    @property
    def n_nodes(self) -> int:
        return int(self.src.shape[0])


def _np(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype)


def build_gather_plan(combined_index, combined_weight, skipped, superseded_by,
                      corr_nodes: Sequence, n_pixels: int,
                      device="cpu") -> GatherPlan:
    """The gather plan from the combined projection, the skip mask, the
    supersession map and the per-camera overlay nodes ``corr_nodes``
    ((node, value slot, weight) | None each, model order)."""
    if n_pixels >= 2**31:
        raise ValueError(f"{n_pixels} stacked pixels exceed the int32 plan")
    ci = _np(combined_index, np.int64)
    cw = _np(combined_weight, np.float32)
    sk = _np(skipped, bool)
    sup = _np(superseded_by, np.int64)
    n = ci.shape[0]
    skipped_primary = sk[sup]
    src = np.where(skipped_primary, -1, ci[sup])
    # tile by tile in model order; by source within a tile (stable)
    order = np.lexsort((src, np.arange(n) // GATHER_TILE))
    corr_nodes = tuple(
        None if cn is None else tuple(
            _np(a, t) for a, t in zip(cn, (np.int64, np.int64, np.float32)))
        for cn in corr_nodes)
    overlays = []
    for cn in corr_nodes:
        if cn is None:
            overlays.append(None)
            continue
        ni, ns, nw = cn
        entry = np.full(n, -1, np.int64)
        entry[ni] = np.arange(ni.shape[0])
        sel = entry[sup]
        targets = np.nonzero((sel >= 0) & ~skipped_primary)[0]
        j = sel[targets]
        overlays.append(tuple(
            torch.as_tensor(a, device=device) for a in (targets, ns[j], nw[j])
        ))

    def t(a, dtype):
        # a tensor already of this dtype on ``device`` is kept, not copied
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtype)
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return GatherPlan(
        src=t(src[order], torch.int32),
        weight=t(cw[sup][order], torch.float32),
        node=t(order, torch.int32),
        combined_index=t(combined_index, torch.int64),
        combined_weight=t(combined_weight, torch.float32),
        skipped=t(skipped, torch.bool),
        superseded_by=t(superseded_by, torch.int64),
        overlays=tuple(overlays),
        n_pixels=int(n_pixels),
        tile=GATHER_TILE,
        corr_nodes=corr_nodes,
    )


def without_supersession(plan: GatherPlan) -> GatherPlan:
    """The plan of the same gather with no overlap supersession, each node
    keeping its own view (``process_frame(adjust_overlap=False)``): its
    result indexed by ``plan.superseded_by`` is ``plan``'s."""
    own = torch.arange(plan.n_nodes, device=plan.superseded_by.device)
    return build_gather_plan(plan.combined_index, plan.combined_weight,
                             plan.skipped, own, plan.corr_nodes, plan.n_pixels,
                             device=plan.src.device)


Frames = Union[torch.Tensor, Sequence[torch.Tensor]]


def _stack(frames: Frames) -> torch.Tensor:
    if isinstance(frames, torch.Tensor):
        return frames
    return torch.stack(list(frames), dim=1).reshape(frames[0].shape[0], -1)


def gather_plain(frames: Frames, plan: GatherPlan) -> torch.Tensor:
    """(B, C*H*W) stacked frames, or the C (B, H, W) camera images (float32
    or bfloat16) -> (B, N) float32: the combined gather, NaN for skipped
    nodes, then overlap supersession (model order throughout)."""
    stacked = _stack(frames)
    sol = stacked[:, plan.combined_index].float() * plan.combined_weight
    sol = torch.where(plan.skipped, torch.full_like(sol, float("nan")), sol)
    return sol[:, plan.superseded_by]


def _camera_images(frames: Frames, plan: GatherPlan):
    """Check ``frames``; returns (images, pixels a frame of each): the
    camera images as the kernel reads them (one stack is one "camera" of
    C*H*W pixels)."""
    if isinstance(frames, torch.Tensor):
        if frames.dim() != 2:
            raise ValueError("gather: stacked frames must be a (B, C*H*W) tensor")
        cams = [frames]
    else:
        cams = list(frames)
        if not cams or len(cams) > GATHER_MAX_CAMS:
            raise ValueError(
                f"gather: 1 to {GATHER_MAX_CAMS} camera images, got {len(cams)}"
            )
        if any(not isinstance(c, torch.Tensor) or c.dim() != 3 for c in cams):
            raise ValueError("gather: camera images must be (B, H, W) tensors")
        if any(c.shape != cams[0].shape for c in cams):
            raise ValueError("gather: camera images of different shapes")
    first = cams[0]
    if any(c.dtype != first.dtype or c.device != first.device for c in cams):
        raise TypeError("gather: camera images of different dtypes or devices")
    if (first.dtype not in (torch.float32, torch.bfloat16)
            or not all(c.is_contiguous() for c in cams)):
        raise TypeError("gather: frames must be contiguous float32 or bfloat16")
    per_cam = math.prod(first.shape[1:])
    if per_cam * len(cams) != plan.n_pixels:
        raise ValueError(
            f"gather: {per_cam * len(cams)} pixels per frame, the plan has "
            f"{plan.n_pixels}"
        )
    if plan.src.device != first.device:
        raise ValueError("gather: plan and frames on different devices")
    return cams, per_cam


def project_gather(frames: Frames, plan: GatherPlan) -> torch.Tensor:
    """K5: :func:`gather_plain` in one pass, on the frames' device, float32
    out.  ``frames``: the C (B, H, W) camera images, read in place, or one
    (B, C*H*W) stack; float32 or bfloat16."""
    cams, per_cam = _camera_images(frames, plan)
    first = cams[0]
    if first.device.type == "cpu":
        return gather_plain(frames, plan)
    if first.device.type != "cuda":
        raise ValueError(f"gather: unsupported device {first.device}")
    b = first.shape[0]
    n = plan.n_nodes
    out = torch.empty((b, n), dtype=torch.float32, device=first.device)
    if b and n:
        bf16 = first.dtype == torch.bfloat16
        lib = LIBRARY.lib()
        ptrs = (ctypes.c_void_p * len(cams))(*(c.data_ptr() for c in cams))
        rc = (lib.upsp_gather_bf16 if bf16 else lib.upsp_gather)(
            ptrs, len(cams), per_cam, plan.src.data_ptr(),
            plan.weight.data_ptr(), plan.node.data_ptr(), out.data_ptr(), n, b,
            plan.tile, stream_of(first),
        )
        check_rc(rc, "gather")
        count_launch("gather_bf16" if bf16 else "gather")
    return out


def apply_overlays(sol: torch.Tensor, plan: GatherPlan,
                   overlays: Sequence[Tuple[int, torch.Tensor]]) -> torch.Tensor:
    """Write the fused tail's patch-overlay values ((camera, (B, K, A))
    pairs) onto ``sol`` (B, N) in place, at every node they display."""
    b = sol.shape[0]
    for c, vals in overlays:
        targets, slots, w = plan.overlays[c]
        sol[:, targets] = vals.reshape(b, -1)[:, slots] * w
    return sol
