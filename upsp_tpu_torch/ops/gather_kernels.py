"""The combined projection gather of phase 1 (csrc/gather.cu) and its plain
twin.

Counterpart of ``upsp_tpu/ops/pallas_gather.py``.  On the best-view path
every node sees at most one camera, so a frame batch projects with ONE
gather from the stacked (B, C*H*W) processed frames.  The port keeps that
module's contract — supersession composed into the sources, the skip mask
applied, patch overlays on every node whose primary is overlaid — and not
its slot order: the kernel writes model order directly, so there is no
host un-permute (``finalize_host``) and no node-count gate.

| wrapper | kernel | replaces |
| --- | --- | --- |
| :func:`project_gather` | K5 ``gather_kernel`` | ``_slab_gather_apply`` (pallas_gather.py:251) |

The frames may be float32 or bfloat16 (``compute_dtype="bfloat16"``); the
output is float32 either way, each pixel widened before its one multiply
(pallas_gather.py:328).  The launch counts tell the two apart: ``gather``
and ``gather_bf16``.

:func:`build_gather_plan` runs once, when the phase-1 parameters are
derived; :func:`gather_plain` is the port's plain tail (gather, NaN for
skipped nodes, overlap supersession) and the kernel's oracle.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

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


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.upsp_gather, lib.upsp_gather_bf16):
        fn.argtypes = [p, p, p, p, p, i, ctypes.c_longlong, i, p]
        fn.restype = i


LIBRARY = CudaLibrary("gather", _bind)


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Phase-0 product: the best-view gather in kernel order and in model
    order.  ``skipped`` and ``superseded_by`` are the tensors it was built
    from (the phase-1 parameters'), not copies."""

    # kernel order: nodes sorted by source pixel
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
    order = np.argsort(src, kind="stable")
    overlays = []
    for cn in corr_nodes:
        if cn is None:
            overlays.append(None)
            continue
        ni, ns, nw = (_np(a, t) for a, t in zip(cn, (np.int64, np.int64, np.float32)))
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
    )


def gather_plain(stacked: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    """(B, C*H*W) stacked frames (float32 or bfloat16) -> (B, N) float32:
    the combined gather, NaN for skipped nodes, then overlap supersession
    (model order throughout)."""
    sol = stacked[:, plan.combined_index].float() * plan.combined_weight
    sol = torch.where(plan.skipped, torch.full_like(sol, float("nan")), sol)
    return sol[:, plan.superseded_by]


def project_gather(stacked: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    """K5: :func:`gather_plain` of a (B, C*H*W) float32 or bfloat16 frame
    stack in one pass, on the stack's device; float32 out."""
    if not isinstance(stacked, torch.Tensor) or stacked.dim() != 2:
        raise ValueError("gather: stacked frames must be a (B, C*H*W) tensor")
    if (stacked.dtype not in (torch.float32, torch.bfloat16)
            or not stacked.is_contiguous()):
        raise TypeError(
            "gather: stacked frames must be contiguous float32 or bfloat16"
        )
    if stacked.shape[1] != plan.n_pixels:
        raise ValueError(
            f"gather: {stacked.shape[1]} pixels per frame, the plan has "
            f"{plan.n_pixels}"
        )
    if plan.src.device != stacked.device:
        raise ValueError("gather: plan and frames on different devices")
    if stacked.device.type == "cpu":
        return gather_plain(stacked, plan)
    if stacked.device.type != "cuda":
        raise ValueError(f"gather: unsupported device {stacked.device}")
    b = stacked.shape[0]
    n = plan.n_nodes
    out = torch.empty((b, n), dtype=torch.float32, device=stacked.device)
    if b and n:
        bf16 = stacked.dtype == torch.bfloat16
        lib = LIBRARY.lib()
        rc = (lib.upsp_gather_bf16 if bf16 else lib.upsp_gather)(
            stacked.data_ptr(), plan.src.data_ptr(), plan.weight.data_ptr(),
            plan.node.data_ptr(), out.data_ptr(), n, plan.n_pixels, b,
            stream_of(stacked),
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
