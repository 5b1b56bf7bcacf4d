"""The JAX package's phase-0 state as the port's tensors.

There is no weights file: what carries across from setup to the frame
program is phase 0's state.  :func:`from_jax_state` takes an
``upsp_tpu.pipeline.phase0.Phase0State`` (and, optionally, the
``Phase1Params`` derived from it) and returns the port's
:class:`~upsp_tpu_torch.pipeline.phase0.Phase0State`, every array read
through ``np.asarray`` — so both packages can be fed one phase-0 result.
This module imports no jax: it only reads the objects it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from upsp_tpu_torch.camera.model import CameraParams
from upsp_tpu_torch.ops.patching import PatchNodeCorrection, PatchOperator
from upsp_tpu_torch.ops.projection import NodeProjection
from upsp_tpu_torch.ops.raycast import BVHArrays
from upsp_tpu_torch.pipeline.phase0 import Phase0State
from upsp_tpu_torch.pipeline.phase1 import Phase1Params, best_view_gather_plan


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def _projection(p, device) -> NodeProjection:
    return NodeProjection(
        pixel_index=_t(p.pixel_index, device, np.int64),
        weight=_t(p.weight, device, np.float32),
        u=_t(p.u, device, np.float32),
        v=_t(p.v, device, np.float32),
        visible=_t(p.visible, device, bool),
    )


def _patch_op(op, device):
    if op is None:
        return None
    return PatchOperator(
        M=_t(op.M, device, np.float32),
        boundary_idx=_t(op.boundary_idx, device, np.int64),
        internal_idx=_t(op.internal_idx, device, np.int64),
        n_clusters=int(op.n_clusters),
    )


def _patch_corr(corr, device):
    if corr is None:
        return None
    return PatchNodeCorrection(
        src_flat=_t(corr.src_flat, device, np.int64),
        C=_t(corr.C, device, np.float64),
        src_slot=_t(corr.src_slot, device, np.int64),
        pix_idx=_t(corr.pix_idx, device, np.int64),
        n_clusters=int(corr.n_clusters),
    )


def _camera(p) -> CameraParams:
    return CameraParams(*(torch.as_tensor(np.array(v)) for v in p))


def _params_from_jax(params, device) -> Phase1Params:
    """A JAX ``Phase1Params`` as the port's :class:`Phase1Params`, with the
    K5 gather plan built from its combined projection and overlay nodes."""
    dev = torch.device(device)
    skipped = _t(params.skipped, dev, bool)
    superseded_by = _t(params.superseded_by, dev, np.int64)
    ref_frames = _t(params.ref_frames, dev, np.float32)
    gather = None
    if params.combined_index is not None:
        # np.array copies: a jax array reads back as a read-only buffer
        gather = best_view_gather_plan(
            np.array(params.combined_index), np.array(params.combined_weight),
            skipped, superseded_by,
            [None if cn is None else tuple(np.array(a) for a in cn)
             for cn in params.corr_nodes],
            ref_frames,
        )
    return Phase1Params(
        projections=tuple(_projection(p, dev) for p in params.projections),
        skipped=skipped,
        patch_ops=tuple(_patch_op(op, dev) for op in params.patch_ops),
        ref_frames=ref_frames,
        superseded_by=superseded_by,
        patch_corr=tuple(_patch_corr(c, dev) for c in params.patch_corr),
        corr_filter=params.corr_filter,
        gather=gather,
    )


def _bvh_dev(bvh, device):
    """A JAX ``BVHArrays`` (the device walk's BVH) as the port's, or None."""
    if bvh is None:
        return None
    return BVHArrays(
        bbox_min=_t(bvh.bbox_min, device, np.float32),
        bbox_max=_t(bvh.bbox_max, device, np.float32),
        escape=_t(bvh.escape, device, np.int64),
        leaf_count=_t(bvh.leaf_count, device, np.int32),
        leaf_v0=_t(bvh.leaf_v0, device, np.float32),
        leaf_e1=_t(bvh.leaf_e1, device, np.float32),
        leaf_e2=_t(bvh.leaf_e2, device, np.float32),
        leaf_tri_id=_t(bvh.leaf_tri_id, device, np.int32),
    )


def from_jax_state(state, device="cpu", params=None) -> Phase0State:
    """A JAX ``Phase0State`` (plus its ``Phase1Params``, if given) as the
    port's phase-0 state on ``device``.  Host-side members (the surface
    model, the BVH, the config) are shared, not copied; the device walk's
    BVH (``bvh_dev``, None on the native walk) is copied to ``device``."""
    dev = torch.device(device)
    return Phase0State(
        model=state.model,
        bvh=state.bvh,
        cam_params=[_camera(p) for p in state.cam_params],
        projections=[_projection(p, dev) for p in state.projections],
        skipped=_t(state.skipped, dev, bool),
        patch_ops=[_patch_op(op, dev) for op in state.patch_ops],
        ref_frames=_t(state.ref_frames, dev, np.float32),
        superseded_by=_t(state.superseded_by, dev, np.int64),
        image_hw=tuple(state.image_hw),
        config=state.config,
        patch_diags=state.patch_diags,
        device=dev,
        params=None if params is None else _params_from_jax(params, dev),
        bvh_dev=_bvh_dev(getattr(state, "bvh_dev", None), dev),
    )
