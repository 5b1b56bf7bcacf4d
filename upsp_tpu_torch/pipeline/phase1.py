"""Phase 1: the per-frame program — register, patch, filter, project.

Port of ``upsp_tpu/pipeline/phase1.py`` on its kernel branch, batched over
frames instead of ``vmap``-ped: per chunk, the optional on-card unpack of
packed video bytes (K7/K8); per frame batch and camera, hot-pixel repair
(K6), the FFT phase-correlation estimate, the integer pre-shift, a
fixed-iteration ECC solve (K1 pre-blur, K2 warp + K3 statistics per
Gauss-Newton step), and the fused warp+filter tail (K4) with the patch
overlays; then the combined best-view gather with NaN for skipped nodes
and overlap supersession (K5), in model order.

Images between stages are float32, or bfloat16 with
``compute_dtype="bfloat16"`` (the JAX package's ``--compute-dtype``):
hot-pixel repair, the phase correlation and the integer shift run on the
f32 frame, which is then cast, and K1-K5 run their bf16 instantiations;
warps, statistics, telemetry and intensities stay f32.

The ECC start (``make_chunk_processor(warm_start=...)``): "fft" (above;
what the datapoint runs pass), True/"scan" (the default, as in the JAX
package: the previous frame's warp, identity at each chunk's first frame;
frames run in order) or False (identity, the reference's semantics).
Scan and identity solve with the while loop
(``ops/registration.ecc_affine``), identity batched over frames with
per-lane stopping.  With ``pixel_interpolation = nearest`` the final warp
is the nearest-neighbour ``warp_affine``, then patches and the filter, so
K4 does not run.

``vmap_cameras`` (opt-in, fft or no-registration mode) runs a batch's C
cameras as one: a (B, C, H, W) batch becomes B·C lanes, each with its
camera's template, through :func:`process_frames_cams_batched` (the JAX
package's ``_process_frame_cams_batched``).  Not ported, by design: the
banded XLA oracle (``ecc_band``), which raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from upsp_tpu_torch.ops.ecc_kernels import (
    filter_taps,
    fix_hot_pixels_kernel,
    template_shift,
    warp_affine_banded,
    warp_displacement_bound,
    warp_filter,
)
from upsp_tpu_torch.ops.fftreg import (
    correlate,
    default_decimate,
    prepare_template,
    translation_warp,
)
from upsp_tpu_torch.ops.gather_kernels import (
    GatherPlan,
    apply_overlays,
    build_gather_plan,
    project_gather,
    without_supersession,
)
from upsp_tpu_torch.ops.image import apply_filter
from upsp_tpu_torch.ops.patching import (
    apply_patches,
    build_patch_node_correction,
    patch_correction_values,
)
from upsp_tpu_torch.ops.projection import NodeProjection, project_frame
from upsp_tpu_torch.ops.registration import (
    EPSILON,
    MAX_ITERS,
    ecc_affine,
    ecc_blur,
    ecc_route,
    identity_warp,
    warp_affine,
)
from upsp_tpu_torch.ops.unpack_kernels import make_unpacker
from upsp_tpu_torch.ops.warp import MAX_INTEGER_SHIFT, integer_shift
from upsp_tpu_torch.utils import timing

ECC_GAUSS_SIZE = 5  # the ECC pre-blur (registration.py default)
ECC_ITERS = 2  # fixed Gauss-Newton steps of fft mode (phase1.py:702-703)


@dataclasses.dataclass(frozen=True)
class Phase1Params:
    """Per-frame program inputs derived from the phase-0 state."""

    projections: Tuple[NodeProjection, ...]  # per camera
    skipped: torch.Tensor  # (N,) bool
    patch_ops: Tuple  # per camera: PatchOperator | None
    ref_frames: torch.Tensor  # (C, H, W) float32
    superseded_by: torch.Tensor  # (N,) int64
    # fused-tail patch corrections, per camera: PatchNodeCorrection | None
    patch_corr: Tuple = ()
    # the (filter_type, filter_size) the corrections were precomposed for
    corr_filter: Optional[Tuple[str, int]] = None
    # best-view fast path (every node has at most one positive camera
    # weight): the K5 plan of ONE gather from the C cameras' frames,
    # indexed as if stacked into (C*H*W,),
    # with the per-camera patch overlays (ops/gather_kernels.py)
    gather: Optional[GatherPlan] = None


def best_view_gather_plan(combined_index, combined_weight, skipped,
                          superseded_by, corr_nodes, ref_frames) -> GatherPlan:
    """The K5 plan of the best-view path, on the reference frames' device;
    ``corr_nodes`` per camera: (node_idx, value_slot, weight) | None."""
    return build_gather_plan(combined_index, combined_weight, skipped,
                             superseded_by, corr_nodes,
                             int(np.prod(ref_frames.shape)),
                             device=ref_frames.device)


def _as_compute_dtype(compute_dtype) -> torch.dtype:
    """A ``compute_dtype`` spec (str or dtype) as a torch dtype."""
    if compute_dtype in (None, "float32", torch.float32):
        return torch.float32
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(
        f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}"
    )


def phase1_params(state) -> Phase1Params:
    """Derive (or return the handed-over) :class:`Phase1Params`."""
    if state.params is not None:
        return state.params
    dev = state.device
    projections = tuple(state.projections)
    H, W = state.image_hw
    HW = H * W
    combined_index = combined_weight = None
    w = np.stack([p.weight.cpu().numpy() for p in projections])  # (C, N)
    if ((w > 0).sum(axis=0) <= 1).all():
        idx = np.stack([p.pixel_index.cpu().numpy() for p in projections])
        best = w.argmax(axis=0)  # 0 where all-zero (weight 0 kills it)
        n = np.arange(w.shape[1])
        combined_index = (best * HW + idx[best, n]).astype(np.int64)
        combined_weight = w[best, n].astype(np.float32)
    patch_corr: list = []
    corr_nodes: list = []
    if combined_index is not None and any(op is not None for op in state.patch_ops):
        cfg = state.config
        wgt = combined_weight
        best = combined_index // HW
        pixel = combined_index % HW
        for c, op in enumerate(state.patch_ops):
            corr = build_patch_node_correction(op, state.image_hw, cfg.filter,
                                               cfg.filter_size)
            if corr is None:
                patch_corr.append(None)
                corr_nodes.append(None)
                continue
            pixn = corr.pix_idx.numpy()
            K, A_max = pixn.shape
            slot_arr = np.full(HW + 1, -1, np.int64)
            valid = pixn != HW
            slot_arr[pixn[valid]] = (
                np.arange(K)[:, None] * A_max + np.arange(A_max)[None, :]
            )[valid]
            ni = np.nonzero((best == c) & (wgt > 0) & (slot_arr[pixel] >= 0))[0]
            patch_corr.append(corr.to(dev))
            corr_nodes.append((ni, slot_arr[pixel[ni]], wgt[ni]))
    return Phase1Params(
        projections=projections,
        skipped=state.skipped,
        patch_ops=tuple(state.patch_ops),
        ref_frames=state.ref_frames,
        superseded_by=state.superseded_by,
        patch_corr=tuple(patch_corr),
        corr_filter=(
            (state.config.filter, state.config.filter_size) if patch_corr else None
        ),
        gather=None if combined_index is None else best_view_gather_plan(
            combined_index, combined_weight, state.skipped, state.superseded_by,
            corr_nodes, state.ref_frames,
        ),
    )


def process_frames_core(
    frames: torch.Tensor,  # (B, C, H, W) float32 frames
    params: Phase1Params,
    registration: str,
    patch: bool,
    filter_type: str,
    filter_size: int,
    interpolation: str = "linear",
    warp_init: Optional[torch.Tensor] = None,  # (B, C, 2, 3)
    valid_shift: Optional[torch.Tensor] = None,  # (B, C, 2) pre-shift
    fix_hot: bool = True,
    ecc_templates: Optional[List[torch.Tensor]] = None,  # blurred, per cam
    ecc_shifts: Optional[List[torch.Tensor]] = None,  # their template_shift
    compute_dtype: torch.dtype = torch.float32,  # images between stages
    ecc_unroll_iters: Optional[int] = ECC_ITERS,  # None: the while loop
    ecc_coarse_iters: int = 0,
    ecc_epsilon: Optional[float] = None,  # while loop |drho| stop (1e-3)
    ecc_max_iters: Optional[int] = None,  # while loop cap (50)
    ecc_impl: str = "auto",
    adjust_overlap: bool = True,
):
    """A frame batch -> (intensity (B, N), warps (B, C, 2, 3), telemetry
    (B, C, 5)), all f32.  Telemetry per camera is [rho, conv, total tx,
    total ty, displacement bound]: ``conv`` is the final |drho| of the
    ``ecc_unroll_iters`` fixed steps, or with ``ecc_unroll_iters=None``
    the while loop's iteration count; the bound (written for format
    parity: the port's K2 has no band limit) is 0 for the while loop and
    for nearest warps, as the JAX package's dense path writes it.
    ``adjust_overlap=False`` leaves out the overlap supersession: each
    node keeps its own view (K5 on a plan without it)."""
    b, n_cams, h, w = frames.shape
    dev = frames.device
    nearest = interpolation == "nearest"
    tail_taps = (filter_taps(filter_type, filter_size)
                 if registration == "pixel" and not nearest else None)
    if ecc_unroll_iters is None:
        ecc_kw = dict(max_iters=MAX_ITERS if ecc_max_iters is None else ecc_max_iters,
                      epsilon=EPSILON if ecc_epsilon is None else ecc_epsilon)
    else:
        ecc_kw = dict(max_iters=ecc_unroll_iters, unroll=True,
                      coarse_iters=ecc_coarse_iters)
    warps, teles, processed, overlays = [], [], [], []
    sol = None
    for c in range(n_cams):
        img = frames[:, c].to(torch.float32).contiguous()
        if fix_hot:
            img = fix_hot_pixels_kernel(img)
        img = img.to(compute_dtype).contiguous()
        tail_done = False
        if registration == "pixel":
            vs_c = None if valid_shift is None else valid_shift[:, c]
            warp, rho, conv = ecc_affine(
                params.ref_frames[c], img,
                warp_init=None if warp_init is None else warp_init[:, c],
                gauss_size=ECC_GAUSS_SIZE, return_iters=True, valid_shift=vs_c,
                impl=ecc_impl,
                tmpl_blurred=None if ecc_templates is None else ecc_templates[c],
                tmpl_shift=None if ecc_shifts is None else ecc_shifts[c],
                **ecc_kw,
            )
            t_tot = warp[:, :, 2] if vs_c is None else warp[:, :, 2] + vs_c
            cert = (warp_displacement_bound(warp, h, w)
                    if ecc_unroll_iters is not None and not nearest
                    else torch.zeros_like(rho))
            teles.append(torch.stack([rho, conv.to(torch.float32), t_tot[:, 0],
                                      t_tot[:, 1], cert], dim=1))
            warps.append(warp)
            # a correction exists only on the best-view path, and with it
            # the plan's overlay of camera c
            corr = params.patch_corr[c] if c < len(params.patch_corr) else None
            need_patch = patch and params.patch_ops[c] is not None
            corr_ok = (
                corr is not None
                and params.corr_filter == (filter_type, filter_size)
            )
            if nearest:
                img = warp_affine(img, warp, "nearest")
            elif tail_taps is not None and (not need_patch or corr_ok):
                if need_patch:
                    img, iw = warp_filter(img, warp, tail_taps, with_warped=True)
                    overlays.append((c, patch_correction_values(iw, corr)))
                else:
                    img = warp_filter(img, warp, tail_taps)
                tail_done = True
            else:
                img = warp_affine_banded(img, warp)
        else:
            teles.append(torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.0]],
                                      device=dev).expand(b, 5))
            warps.append(translation_warp(torch.zeros((b, 2), device=dev)))
        if not tail_done:
            if patch and params.patch_ops[c] is not None:
                img = apply_patches(img, params.patch_ops[c])
            img = apply_filter(img, filter_type, filter_size)
        if params.gather is not None:
            processed.append(img.contiguous())
        else:
            c_sol = project_frame(img, params.projections[c])
            sol = c_sol if sol is None else sol + c_sol
    if params.gather is not None:
        # K5: gather + skip mask + supersession in model order from the
        # camera images as they are, then the patch overlays on every node
        # that displays an overlaid node
        plan = params.gather if adjust_overlap else without_supersession(params.gather)
        sol = apply_overlays(project_gather(processed, plan), plan, overlays)
    else:
        sol = torch.where(params.skipped, torch.full_like(sol, float("nan")), sol)
        if adjust_overlap:
            sol = sol[:, params.superseded_by]  # overlap supersession
    return sol, torch.stack(warps, dim=1), torch.stack(teles, dim=1)


def process_frames_cams_batched(
    frames: torch.Tensor,  # (B, C, H, W) float32 frames
    params: Phase1Params,
    registration: str,
    patch: bool,
    filter_type: str,
    filter_size: int,
    interpolation: str = "linear",
    warp_init: Optional[torch.Tensor] = None,  # (B, C, 2, 3)
    valid_shift: Optional[torch.Tensor] = None,
    fix_hot: bool = True,
    ecc_templates: Optional[List[torch.Tensor]] = None,  # blurred, per cam
    ecc_shifts: Optional[List[torch.Tensor]] = None,  # the kernel route's
    compute_dtype: torch.dtype = torch.float32,
    ecc_unroll_iters: Optional[int] = ECC_ITERS,
    ecc_coarse_iters: int = 0,
    ecc_epsilon: Optional[float] = None,  # the while loop's; unused here
    ecc_max_iters: Optional[int] = None,  # the while loop's; unused here
    ecc_impl: str = "jnp",
):
    """:func:`process_frames_core` with the cameras batched
    (``upsp_tpu/pipeline/phase1.py:362-472``): the B·C images of a batch
    are lanes b·C + c, hot pixels (K6) and the ECC solve run over all of
    them, each lane against its camera's template on the dense step (K1
    blurs them; K3 takes one template, so ``ecc_impl`` "kernels" raises),
    then the final warp (K2, or the nearest ``warp_affine``), each
    camera's patches, the filter, and the combined projection (K5 on the
    best-view path).  Fixed-step ECC only, without the pre-shift
    (``valid_shift`` raises); telemetry column 4 is 0, as the JAX
    package's dense path writes it.  Returns what
    :func:`process_frames_core` returns."""
    if valid_shift is not None:
        raise NotImplementedError(
            "valid_shift (the integer pre-shift) is not supported with the "
            "cameras batched; use the per-camera loop")
    if registration == "pixel" and ecc_unroll_iters is None:
        raise NotImplementedError(
            "the while-loop ECC does not batch the cameras; use the per-camera "
            "loop")
    del ecc_shifts, ecc_epsilon, ecc_max_iters
    b, n_cams, h, w = frames.shape
    lanes = b * n_cams
    dev = frames.device
    imgs = frames.to(torch.float32).reshape(lanes, h, w).contiguous()
    if fix_hot:
        imgs = fix_hot_pixels_kernel(imgs)
    imgs = imgs.to(compute_dtype).contiguous()
    if registration == "pixel":
        ref = params.ref_frames.repeat(b, 1, 1)  # lane b·C + c: camera c
        tmpl = (None if ecc_templates is None
                else torch.stack(ecc_templates).repeat(b, 1, 1))
        warps, rho, conv = ecc_affine(
            ref, imgs,
            warp_init=None if warp_init is None else warp_init.reshape(lanes, 2, 3),
            max_iters=ecc_unroll_iters, unroll=True, coarse_iters=ecc_coarse_iters,
            gauss_size=ECC_GAUSS_SIZE, return_iters=True, impl=ecc_impl,
            tmpl_blurred=tmpl,
        )
        tele = torch.stack([rho, conv.to(torch.float32), warps[:, 0, 2],
                            warps[:, 1, 2], torch.zeros_like(rho)], dim=1)
        if interpolation == "nearest":
            imgs = warp_affine(imgs, warps, "nearest")
        else:
            imgs = warp_affine_banded(imgs, warps)
    else:
        tele = torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.0]], device=dev).expand(lanes, 5)
        warps = translation_warp(torch.zeros((lanes, 2), device=dev))
    imgs = imgs.reshape(b, n_cams, h, w)
    if patch and any(op is not None for op in params.patch_ops):
        imgs = torch.stack([
            imgs[:, c] if op is None else apply_patches(imgs[:, c].contiguous(), op)
            for c, op in enumerate(params.patch_ops)
        ], dim=1)
    imgs = apply_filter(imgs.reshape(lanes, h, w), filter_type, filter_size)
    imgs = imgs.reshape(b, n_cams, h, w).contiguous()
    if params.gather is not None:
        # K5 (skip mask and supersession in it) from the (B, C·H·W) stack
        sol = project_gather(imgs.reshape(b, n_cams * h * w), params.gather)
    else:
        sol = sum(project_frame(imgs[:, c], params.projections[c])
                  for c in range(n_cams))
        sol = torch.where(params.skipped, torch.full_like(sol, float("nan")), sol)
        sol = sol[:, params.superseded_by]
    return (sol, warps.reshape(b, n_cams, 2, 3),
            tele.reshape(b, n_cams, 5).contiguous())


def process_frame(frames, params: Phase1Params, registration: str = "pixel",
                  patch: bool = True, filter_type: str = "gaussian",
                  filter_size: int = 3, interpolation: str = "linear",
                  adjust_overlap: bool = True, with_telemetry: bool = False):
    """One multi-camera (C, H, W) frame -> per-node intensity (N,), with
    the while-loop ECC from identity (the JAX package's ``process_frame``);
    ``adjust_overlap`` applies the overlap supersession (without it the
    result indexed by ``params.superseded_by`` is the result with it).
    ``with_telemetry`` also returns the (C, 5) record [rho, iterations,
    tx, ty, 0]."""
    x = torch.as_tensor(frames).to(params.ref_frames.device, torch.float32)
    sol, _, tele = process_frames_core(
        x[None], params, registration, patch, filter_type, filter_size,
        interpolation=interpolation, ecc_unroll_iters=None,
        adjust_overlap=adjust_overlap,
    )
    return (sol[0], tele[0]) if with_telemetry else sol[0]


def make_frame_processor(state, with_telemetry: bool = False):
    """Bind the phase-0 state and its config into a (C, H, W) frame ->
    (N,) callable (:func:`process_frame`)."""
    p = phase1_params(state)
    cfg = state.config

    def fn(frames):
        return process_frame(
            frames, p, registration=cfg.registration,
            patch=(cfg.target_patcher == "polynomial"),
            filter_type=cfg.filter, filter_size=cfg.filter_size,
            interpolation=cfg.pixel_interpolation,
            with_telemetry=with_telemetry,
        )

    return fn


def make_chunk_processor(state, with_telemetry: bool = False,
                         frame_batch: int = 1, packed: bool = False,
                         packed_bits: int = 12, lut=None,
                         compute_dtype="float32", warm_start=True,
                         ecc_iters: Optional[int] = None,
                         ecc_coarse_iters: Optional[int] = None,
                         ecc_epsilon: Optional[float] = None,
                         ecc_max_iters: Optional[int] = None,
                         ecc_impl: str = "auto",
                         pre_shift: Optional[bool] = None,
                         ecc_band: Optional[int] = None,
                         vmap_cameras: Optional[bool] = None, mesh=None):
    """Build the chunk program: (F, C, H, W) frames (numpy or tensor, any
    numeric dtype) -> (F, N) intensities [and (F, C, 5) telemetry], on the
    state's device.

    ``packed``: the chunk is (F, C, nbytes) uint8 packed video bytes
    (``packed_bits`` 12 or 10, with the optional (1024,) 10->12-bit
    ``lut``), unpacked on the device by K7/K8 before the frame program.

    ``warm_start``, the start of each frame's ECC solve with pixel
    registration (default ``True``, and ``frame_batch`` 1, as in the JAX
    package; ``run_datapoint`` passes "fft" and 8):

    - ``"fft"``: the phase-correlation estimate; with
      ``pre_shift`` (default on with the kernel route) split into an
      integer pre-shift applied to the hot-pixel-repaired frame and a
      sub-pixel start, the shift composed into the ECC validity mask
      (phase1.py:895-928); without it the whole estimate starts the solve
      on the raw frame (:929-956).  ``ecc_iters`` (2) fixed Gauss-Newton
      steps, after ``ecc_coarse_iters`` (0) on a 2x decimated pair.
    - ``True`` / ``"scan"``: the previous frame's converged warp, identity
      at the chunk's first frame (:833-846); the chunk's frames run in
      order, one frame per solve.
    - ``False``: identity starts, the reference's semantics
      (registration.cpp:53-64).

    Scan and identity run the while loop (``ecc_epsilon`` 1e-3,
    ``ecc_max_iters`` 50); identity batches ``frame_batch`` frames with
    per-lane stopping (the JAX package runs it a frame at a time; a
    lane's result does not depend on its batch).  Other frames run in
    batches of ``frame_batch``.  ``ecc_impl``: "auto"/"kernels" (K2 then
    K3 a step; the JAX package's "pallas") or "jnp" (the dense step),
    ``ops/registration``.

    ``compute_dtype``: "float32" or "bfloat16", the images' dtype between
    stages (raises ``ValueError`` on anything else).

    ``vmap_cameras`` (default off): with two or more cameras in fft mode
    or without registration, each batch's cameras run as one
    (:func:`process_frames_cams_batched`), with the JAX package's rules
    (phase1.py:746-758): no pre-shift, ``ecc_impl`` "auto" takes the dense
    "jnp" step and "kernels" raises ``NotImplementedError``, the phase
    correlation runs over the cameras at once.  In the other modes it is
    ignored, as there.  ``ecc_band`` is not ported, by design, and raises
    ``NotImplementedError``.

    ``mesh`` (:class:`~upsp_tpu_torch.parallel.mesh.Mesh` of two or more
    ranks): the chunk, whose frame count the caller pads to a multiple of
    the world size, is split into one contiguous block a rank
    (phase1.py:959-970's ``shard_map``); this rank runs its own block and
    returns its rows.  In scan mode each block starts from identity.
    """
    if ecc_band is not None:
        raise NotImplementedError(
            "ecc_band (the banded XLA warp oracle) is not ported, by design: it "
            "is MXU and banded-warp machinery, and the port's K2 has no band "
            "limit (ROADMAP.md queue 1, item 2)")
    cfg = state.config
    cdtype = _as_compute_dtype(compute_dtype)
    route = ecc_route(ecc_impl)
    with timing.span("phase1.params"):
        p = phase1_params(state)
    n_cams = int(p.ref_frames.shape[0])
    pixel = cfg.registration == "pixel"
    mode = warm_start if pixel else False
    if mode is True:
        mode = "scan"
    if mode not in ("fft", "scan", False):
        raise ValueError(f"warm_start must be 'fft', 'scan', True or False, "
                         f"got {warm_start!r}")
    if pre_shift is None:
        pre_shift = route == "kernels"
    pre_shift = pre_shift and mode == "fft"
    vmap_cameras = bool(vmap_cameras) and n_cams > 1 and (mode == "fft" or not pixel)
    if vmap_cameras:
        if ecc_impl == "kernels":
            raise NotImplementedError(
                "vmap_cameras runs the dense 'jnp' Gauss-Newton step: K3 takes one "
                "template for the batch, and the lanes carry one each (as the JAX "
                "package's Pallas moments refuse batched templates, "
                "upsp_tpu/ops/pallas_ecc.py:633-634)")
        ecc_impl, pre_shift = "jnp", False
    core = process_frames_cams_batched if vmap_cameras else process_frames_core
    static = dict(
        registration=cfg.registration,
        patch=(cfg.target_patcher == "polynomial"),
        filter_type=cfg.filter,
        filter_size=cfg.filter_size,
        interpolation=cfg.pixel_interpolation,
        compute_dtype=cdtype,
        ecc_unroll_iters=(ECC_ITERS if ecc_iters is None else ecc_iters)
        if mode == "fft" else None,
        ecc_coarse_iters=ecc_coarse_iters or 0,
        ecc_epsilon=ecc_epsilon,
        ecc_max_iters=ecc_max_iters,
        ecc_impl=ecc_impl,
    )
    if pixel:
        # the ECC template is blurred once, not once per frame, in the
        # images' dtype (ecc_affine's rule), and K3's brightness shift of
        # each computed once
        ecc_tmpls = [
            ecc_blur(p.ref_frames[c][None].to(cdtype).contiguous(),
                     ECC_GAUSS_SIZE)[0]
            for c in range(n_cams)
        ]
        static.update(ecc_templates=ecc_tmpls,
                      ecc_shifts=[template_shift(t) for t in ecc_tmpls])
    if mode == "fft":
        dec = default_decimate(*state.image_hw)
        corr_tmpls = [prepare_template(p.ref_frames[c], dec) for c in range(n_cams)]
        corr_stack = corr_tmpls[0]._replace(
            spectrum=torch.stack([t.spectrum for t in corr_tmpls]))

    unpack = (make_unpacker(packed_bits, lut, state.image_hw, state.device)
              if packed else None)

    def fft_batch(frames: torch.Tensor):
        b = frames.shape[0]
        if not pre_shift:
            if vmap_cameras:  # one batched FFT over the cameras
                tvecs = correlate(corr_stack, frames)
            else:
                tvecs = torch.stack(
                    [correlate(corr_tmpls[c], frames[:, c]) for c in range(n_cams)],
                    dim=1)  # (B, C, 2), on the raw frames
            init = translation_warp(tvecs.reshape(-1, 2)).reshape(b, n_cams, 2, 3)
            return core(frames, p, warp_init=init, **static)
        # hot-pixel repair first, then split the translation estimate:
        # integer part shifted off, sub-pixel residual solved by ECC; all
        # on the f32 frame, cast to the compute dtype after
        fixed = fix_hot_pixels_kernel(frames)
        tvecs = torch.stack(
            [correlate(corr_tmpls[c], fixed[:, c]) for c in range(n_cams)], dim=1
        )  # (B, C, 2)
        t_int = torch.round(tvecs).clamp(-MAX_INTEGER_SHIFT, MAX_INTEGER_SHIFT)
        shifted = torch.stack(
            [integer_shift(fixed[:, c], t_int[:, c]) for c in range(n_cams)],
            dim=1,
        )
        init = translation_warp((tvecs - t_int).reshape(-1, 2)).reshape(
            b, n_cams, 2, 3
        )
        return process_frames_core(shifted, p, warp_init=init, valid_shift=t_int,
                                   fix_hot=False, **static)

    def to_device(frames: torch.Tensor) -> torch.Tensor:
        if frames.device.type == "cpu" and state.device.type != "cpu":
            timing.count("bytes.h2d.pageable", frames.numel() * frames.element_size())
        return frames.to(state.device, torch.float32)

    def scan_chunk(x: torch.Tensor):
        """The chunk's frames in order, each solve from the last one's
        warps; identity at the chunk's first frame."""
        carry = identity_warp(batch=n_cams, device=state.device)
        sols, teles = [], []
        for f in range(x.shape[0]):
            frame = to_device(x[f : f + 1])
            sol, warps, tele = process_frames_core(frame, p, warp_init=carry[None],
                                                   **static)
            carry = warps[0]
            sols.append(sol)
            teles.append(tele)
        return sols, teles

    def process(chunk):
        x = torch.as_tensor(chunk)
        if unpack is not None:
            x = unpack(x.to(state.device))
        if mode == "scan":
            sols, teles = scan_chunk(x)
        else:
            sols, teles = [], []
            step = max(frame_batch, 1)
            for s in range(0, x.shape[0], step):
                frames = to_device(x[s : s + step])
                if mode == "fft":
                    sol, _, tele = fft_batch(frames)
                else:
                    sol, _, tele = core(frames, p, **static)
                sols.append(sol)
                teles.append(tele)
        sols = torch.cat(sols)
        teles = torch.cat(teles)
        return (sols, teles) if with_telemetry else sols

    if mesh is None or mesh.world == 1:
        return process

    from upsp_tpu_torch.parallel.mesh import frame_sharding

    def process_block(chunk):
        if chunk.shape[0] % mesh.world:
            raise ValueError(f"a chunk of {chunk.shape[0]} frames does not "
                             f"divide over {mesh.world} ranks; pad it first")
        start, stop = frame_sharding(mesh, chunk.shape[0])
        return process(chunk[start:stop])

    return process_block


def make_packed_chunk_processor(state, with_telemetry: bool = False,
                                packed_bits: int = 12, lut=None, mesh=None,
                                warm_start=True, **kw):
    """Fused ingest (``upsp_tpu/pipeline/phase1.py:993-1017``): the chunk
    program of (F, C, nbytes) uint8 packed camera bytes, unpacked on the
    device (K7/K8) before the frame program; :func:`make_chunk_processor`
    with ``packed=True`` (``warm_start`` defaults to the JAX wrapper's
    scan starts; ``kw``: the other options)."""
    return make_chunk_processor(state, with_telemetry=with_telemetry, packed=True,
                                packed_bits=packed_bits, lut=lut, mesh=mesh,
                                warm_start=warm_start, **kw)


def process_frames(state, frames, batched: bool = True) -> torch.Tensor:
    """(F, C, H, W) frames -> (F, N) intensities with identity starts: the
    stateless oracle of the warm-started chunk program.  ``batched`` runs
    the frames in batches of 8 through the identity chunk program, else
    one :func:`process_frame` call a frame: the same ECC solves and
    intensities (no stage's result depends on the batch on the CPU)."""
    if batched:
        return make_chunk_processor(state, warm_start=False, frame_batch=8)(frames)
    fn = make_frame_processor(state)
    x = torch.as_tensor(frames)
    return torch.stack([fn(x[i]) for i in range(x.shape[0])])


class Phase1Outputs(NamedTuple):
    """Phase 1's results (``upsp_tpu/pipeline/phase1.py:1037``)."""

    intensity: torch.Tensor  # (F, N) overlap-adjusted per-frame solutions
    sol_avg: torch.Tensor  # (N,) mean over frames (NaN where skipped)
    sol_rms: torch.Tensor  # (N,) root-mean-square over frames
    coverage: torch.Tensor  # (N,)


def phase1_statistics(intensity) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-axis mean and root mean square of an (F, N) intensity,
    accumulated in f64 as the reference does (psp_process.cpp:1722-1730),
    returned f32 (NaN where a node is NaN)."""
    i64 = torch.as_tensor(intensity).to(torch.float64)
    avg = i64.mean(dim=0).to(torch.float32)
    rms = torch.sqrt((i64 * i64).mean(dim=0)).to(torch.float32)
    return avg, rms
