"""ECC hot-loop kernels for the H100 (csrc/ecc.cu) and their plain twins.

Counterpart of ``upsp_tpu/ops/pallas_ecc.py``.  Five kernels carry the
phase-1 frame program, and K9 fuses one Gauss-Newton step; each has a
wrapper here that

- checks device, dtype, shape and contiguity and raises on anything else;
- on a CPU tensor runs the kernel's plain PyTorch twin (written from the
  JAX semantics: ``ops/image.gaussian_blur``, ``ops/warp.warp_affine_mxu``
  at order 2, the ``_ecc_core`` jnp statistics, ``ops/image.fix_hot_pixels``);
- on a CUDA tensor launches the hand-written kernel on the current stream,
  raises if the launch fails, and adds one to its launch count.

| wrapper | kernel | replaces |
| --- | --- | --- |
| :func:`blur` | K1 ``blur_kernel<T, R>`` | ``_blur_batched`` (pallas_ecc.py:829) |
| :func:`warp_affine_banded` | K2 ``warp_kernel`` | ``_warp_banded_batched`` (:285) |
| :func:`ecc_gn_moments` | K3 ``moments_kernel`` | ``_moments_batched`` (:587) |
| :func:`ecc_gn_moments_update` | K3 with the update in ``moments_reduce_kernel<true>`` | ``_moments_batched`` and the update after it (``body_pallas``) |
| :func:`warp_filter` | K4 ``warp_filter_kernel`` | ``_warp_filter_batched`` (:444) |
| :func:`fix_hot_pixels_kernel` | K6 ``hot_scan_kernel`` + ``hot_repair_kernel`` | ``_hot_batched`` (:739) |
| :func:`ecc_gn_fused` | K9 ``gn_fused_kernel`` | ``_gn_fused_batched`` (:1044) |

K1-K4 and K9 take float32 or bfloat16 images, as the JAX kernels do under
``compute_dtype="bfloat16"``: the kernel loads bf16, computes in f32 and
rounds once at its store (round to nearest even); warps and statistics
stay f32.  The plain twins do the same: they widen bf16 to f32, compute as
for f32 and round the output once (never bf16 arithmetic op by op).  The
launch counts tell the instantiations apart (``blur`` and ``blur_bf16``,
...).  ``registration._gn_step`` runs K2 then K3 in both dtypes, K3 as
:func:`ecc_gn_moments_update` (counts ``moments_update`` and
``moments_update_bf16``); K9 runs in no datapoint path (it lost to the
pair at 1200x1800 on the H100).

The library is compiled from ``csrc/ecc.cu`` with ``nvcc`` for ``sm_90a``
at first use, into ``build/torch_kernels/`` at the repository root
(``ops/cuda_lib.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from upsp_tpu_torch.ops.cuda_lib import (
    CudaLibrary,
    check_rc,
    count_launch,
    launch_counts,  # noqa: F401  (re-exported: every kernel's count)
    register_kernels,
    reset_launch_counts,  # noqa: F401
    stream_of,
)
from upsp_tpu_torch.ops.image import (
    fix_hot_pixels,
    gaussian_kernel_1d,
    separable_filter,
)
from upsp_tpu_torch.ops.warp import warp_validity_mask

MAX_TAPS = 7
NSTAT = 42
HOT_THRESH, HOT_MIN_CHANGE, HOT_MAX = 4064, 512, 5  # fix_hot_pixels defaults

# the image-type kernels: (kernel, its bf16 instantiation) each
TYPED = ("blur", "warp", "moments", "warp_filter", "gn_fused")
# K3 with the Gauss-Newton update in its reduce stage
UPDATE = ("moments_update", "moments_update_bf16")
KERNELS = register_kernels(TYPED + ("hot",) + tuple(f"{k}_bf16" for k in TYPED)
                           + UPDATE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    taps = [i] + [f] * MAX_TAPS
    lib.upsp_ecc_moments_blocks.argtypes = [i, i]
    lib.upsp_ecc_gn_fused_blocks.argtypes = [i, i]
    argtypes = {
        "blur": [p, p, i, i, i] + taps + [p],
        "warp": [p, p, p, i, i, i, p],
        "warp_filter": [p, p, p, p, i, i, i] + taps + [p],
        "moments": [p] * 7 + [i, i, i, p],
        "moments_update": [p] * 11 + [i, i, i, p],
        "gn_fused": [p] * 7 + [i, i, i, p],
        "hot": [p, p, p, i, i, i, f, f, i, p],
    }
    for name, args in argtypes.items():
        for suffix in ("", "_bf16") if name in TYPED + UPDATE else ("",):
            fn = getattr(lib, f"upsp_ecc_{name}{suffix}")
            fn.argtypes = args
            fn.restype = i
    lib.upsp_ecc_moments_blocks.restype = i
    lib.upsp_ecc_gn_fused_blocks.restype = i
    ip = ctypes.POINTER(i)
    lib.upsp_ecc_gn_fused_attrs.argtypes = [i, ip, ip]
    lib.upsp_ecc_gn_fused_attrs.restype = i


LIBRARY = CudaLibrary("ecc", _bind)


def _launch(name: str, imgs: torch.Tensor, *args) -> None:
    """Launch the instantiation of ``name`` for ``imgs``' dtype, raise if
    the launch failed, and count it under its own name."""
    kname = name if imgs.dtype == torch.float32 else f"{name}_bf16"
    rc = getattr(LIBRARY.lib(), f"upsp_ecc_{kname}")(*args, stream_of(imgs))
    check_rc(rc, kname)
    count_launch(kname)


def _taps_args(taps: Sequence[float]):
    t = [float(v) for v in taps] + [0.0] * (MAX_TAPS - len(taps))
    return [len(taps)] + t


# ---------------------------------------------------------------------------
# argument checks


def _check_images(imgs: torch.Tensor, name: str) -> None:
    if not isinstance(imgs, torch.Tensor) or imgs.dim() != 3:
        raise ValueError(f"{name}: images must be a (B, H, W) tensor")
    if imgs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"{name}: images must be float32 or bfloat16, got {imgs.dtype}"
        )
    if not imgs.is_contiguous():
        raise ValueError(f"{name}: images must be contiguous")
    if imgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {imgs.device}")


def _check_warps(warps: torch.Tensor, imgs: torch.Tensor, name: str) -> None:
    if warps.shape != (imgs.shape[0], 2, 3):
        raise ValueError(
            f"{name}: warps must be ({imgs.shape[0]}, 2, 3), got "
            f"{tuple(warps.shape)}"
        )
    if warps.dtype != torch.float32 or not warps.is_contiguous():
        raise TypeError(f"{name}: warps must be contiguous float32")
    if warps.device != imgs.device:
        raise ValueError(f"{name}: warps and images on different devices")


def _check_taps(taps: Sequence[float], imgs: torch.Tensor, name: str) -> None:
    k = len(taps)
    if k > MAX_TAPS or k % 2 == 0:
        raise ValueError(f"{name}: need an odd tap count <= {MAX_TAPS}, got {k}")
    h, w = imgs.shape[-2:]
    if min(h, w) <= k // 2:
        raise ValueError(f"{name}: image {h}x{w} too small for {k} taps")


# ---------------------------------------------------------------------------
# plain twins (the CPU path and the kernels' oracle)


def blur_plain(imgs: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """Separable reflect-101 filter, horizontal then vertical
    (``ops/image.gaussian_blur`` semantics), in f32, rounded once to the
    images' dtype."""
    return separable_filter(imgs, taps).to(imgs.dtype)


def _tent_pair(pos: torch.Tensor, n: int):
    """Indices and weights of the two tent taps at ``pos``; taps outside
    [0, n) get weight 0 (BORDER_CONSTANT)."""
    pos = pos.clamp(-2.0, n + 1.0)
    p0 = torch.floor(pos)
    w1 = pos - p0
    w0 = 1.0 - w1
    i0 = p0.long()
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 < n), w0, torch.zeros_like(w0))
    w1 = torch.where((i1 >= 0) & (i1 < n), w1, torch.zeros_like(w1))
    return i0.clamp(0, n - 1), w0, i1.clamp(0, n - 1), w1


def _warp_scalars(warps: torch.Tensor):
    return warps.reshape(-1, 6).unbind(1)


def separable_warp_plain(imgs: torch.Tensor, warps: torch.Tensor):
    """R @ img @ C^T of f32 images: rows resampled at y_sep, then columns
    at x_sep."""
    b, h, w = imgs.shape
    a00, a01, tx, a10, a11, ty = _warp_scalars(warps)
    dev = imgs.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    cy = (h - 1) * 0.5
    cx = (w - 1) * 0.5
    y_sep = a11[:, None] * ys + ty[:, None] + a10[:, None] * cx  # (B, H)
    x_sep = a00[:, None] * xs + tx[:, None] + a01[:, None] * cy  # (B, W)
    i0, w0, i1, w1 = _tent_pair(y_sep, h)
    rows = (
        w0[:, :, None] * imgs.gather(1, i0[:, :, None].expand(b, h, w))
        + w1[:, :, None] * imgs.gather(1, i1[:, :, None].expand(b, h, w))
    )
    j0, v0, j1, v1 = _tent_pair(x_sep, w)
    return (
        v0[:, None, :] * rows.gather(2, j0[:, None, :].expand(b, h, w))
        + v1[:, None, :] * rows.gather(2, j1[:, None, :].expand(b, h, w))
    )


def warp_plain(imgs: torch.Tensor, warps: torch.Tensor) -> torch.Tensor:
    """``warp_affine_mxu(img, warp, order=2)`` semantics, batched, in f32,
    rounded once to the images' dtype."""
    return _warp_f32(imgs.float(), warps).to(imgs.dtype)


def _warp_f32(imgs: torch.Tensor, warps: torch.Tensor) -> torch.Tensor:
    """The separable resample plus the 2nd-order shear Taylor term, whose
    derivatives are zero on the outer ring (ops/warp.py:159-197)."""
    b, h, w = imgs.shape
    sep = separable_warp_plain(imgs, warps)
    a00, a01, _, a10, a11, _ = (v[:, None, None] for v in _warp_scalars(warps))
    dev = imgs.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    cy = (h - 1) * 0.5
    cx = (w - 1) * 0.5
    dy = a10 * (xs - cx)[None, None, :]  # (B, 1, W)
    dx = a01 * (ys - cy)[None, :, None]  # (B, H, 1)
    inv_ax = 1.0 / a00
    inv_ay = 1.0 / a11
    gx, gxx, gy, gyy, gxy = (torch.zeros_like(sep) for _ in range(5))
    gx[:, :, 1:-1] = 0.5 * (sep[:, :, 2:] - sep[:, :, :-2]) * inv_ax
    gy[:, 1:-1, :] = 0.5 * (sep[:, 2:, :] - sep[:, :-2, :]) * inv_ay
    gxx[:, :, 1:-1] = (
        (sep[:, :, 2:] - 2 * sep[:, :, 1:-1] + sep[:, :, :-2]) * inv_ax * inv_ax
    )
    gyy[:, 1:-1, :] = (
        (sep[:, 2:, :] - 2 * sep[:, 1:-1, :] + sep[:, :-2, :]) * inv_ay * inv_ay
    )
    gxy[:, 1:-1, 1:-1] = (
        0.25
        * (
            sep[:, 2:, 2:] - sep[:, 2:, :-2] - sep[:, :-2, 2:]
            + sep[:, :-2, :-2]
        )
        * inv_ax
        * inv_ay
    )
    out = sep + dx * gx + dy * gy
    return out + 0.5 * dx * dx * gxx + dx * dy * gxy + 0.5 * dy * dy * gyy


def template_shift(tmpl: torch.Tensor) -> torch.Tensor:
    """(1,) f32: the brightness shift mean(tmpl), in the template's dtype as
    ``jnp.mean`` gives it (bf16 rounded).  K3 takes it as ``kshift``; a
    caller with a fixed template computes it once."""
    return tmpl.float().mean().to(tmpl.dtype).float().reshape(1)


def moments_plain(iw: torch.Tensor, tmpl: torch.Tensor, warps: torch.Tensor,
                  mask_warps: torch.Tensor,
                  kshift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 128) raw GN statistics (layout of ``ecc_gn_moments``) from the
    ``_ecc_core`` jnp step's fields, brightness-shifted by mean(tmpl)
    (``kshift``, :func:`template_shift` when None); f32 fields (bf16
    widened), summed in f64."""
    if kshift is None:
        kshift = template_shift(tmpl)
    iw = iw.float()
    tmpl = tmpl.float()
    b, h, w = iw.shape
    dev = iw.device
    a00, a01, _, a10, a11, _ = (v[:, None, None] for v in _warp_scalars(warps))
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    gix = torch.zeros_like(iw)
    giy = torch.zeros_like(iw)
    gix[:, :, 1:-1] = 0.5 * (iw[:, :, 2:] - iw[:, :, :-2])
    giy[:, 1:-1, :] = 0.5 * (iw[:, 2:, :] - iw[:, :-2, :])
    m = warp_validity_mask((h, w), mask_warps)
    inv_det = 1.0 / (a00 * a11 - a01 * a10)
    gx = (a11 * gix - a10 * giy) * inv_det * m
    gy = (-a01 * gix + a00 * giy) * inv_det * m
    iv = iw - kshift
    tv = (tmpl - kshift)[None]

    def s(f):
        return f.sum(dim=(1, 2), dtype=torch.float64)

    vals = []
    for f in (gx * gx, gx * gy, gy * gy):
        vals += [s(f * xs * xs), s(f * xs * ys), s(f * ys * ys),
                 s(f * xs), s(f * ys), s(f)]
    for z in (tv, iv, None):
        gxz = gx if z is None else gx * z
        gyz = gy if z is None else gy * z
        vals += [s(gxz * xs), s(gyz * xs), s(gxz * ys), s(gyz * ys),
                 s(gxz), s(gyz)]
    tmm = tv * m
    iwm = iv * m
    vals += [s(m), s(tmm), s(iwm), s(tmm * tv), s(iwm * iv), s(tmm * iv)]
    out = torch.zeros((b, 128), dtype=torch.float32, device=dev)
    out[:, :NSTAT] = torch.stack(vals, dim=1).to(torch.float32)
    return out


def warp_filter_plain(imgs, warps, taps, with_warped: bool = False):
    """Filter of the f32 warped image; both outputs rounded once to the
    images' dtype (the warp is not rounded before the filter)."""
    iw = _warp_f32(imgs.float(), warps)
    out = separable_filter(iw, taps) if taps else iw
    out, iw = out.to(imgs.dtype), iw.to(imgs.dtype)
    return (out, iw) if with_warped else out


def gn_fused_plain(imgs, tmpl, warps, mask_warps,
                   kshift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 then K3 with the warped image kept in f32 (not rounded to a bf16
    image's dtype): ``ecc_gn_fused`` semantics."""
    return moments_plain(_warp_f32(imgs.float(), warps), tmpl, warps,
                         mask_warps, kshift)


# ---------------------------------------------------------------------------
# wrappers


def blur(imgs: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """K1: separable reflect-101 blur of a (B, H, W) float32 or bfloat16
    stack with <= 7 taps (``make_blur(taps)`` under vmap); same dtype out."""
    _check_images(imgs, "blur")
    if not taps:
        return imgs
    _check_taps(taps, imgs, "blur")
    if imgs.device.type == "cpu":
        return blur_plain(imgs, taps)
    b, h, w = imgs.shape
    out = torch.empty_like(imgs)
    _launch("blur", imgs, imgs.data_ptr(), out.data_ptr(), b, h, w,
            *_taps_args(taps))
    return out


def warp_affine_banded(imgs: torch.Tensor, warps: torch.Tensor) -> torch.Tensor:
    """K2: out(y, x) = img(W @ [x, y, 1]) at Taylor order 2, zero outside
    the image, for (B, H, W) images and (B, 2, 3) warps.  No band limit."""
    _check_images(imgs, "warp")
    _check_warps(warps, imgs, "warp")
    if imgs.device.type == "cpu":
        return warp_plain(imgs, warps)
    b, h, w = imgs.shape
    out = torch.empty_like(imgs)
    _launch("warp", imgs, imgs.data_ptr(), warps.data_ptr(), out.data_ptr(),
            b, h, w)
    return out


def ecc_gn_moments(iw: torch.Tensor, tmpl: torch.Tensor, warps: torch.Tensor,
                   mask_warps: torch.Tensor,
                   kshift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: (B, 128) float32 raw GN statistics of warped images against one
    template of their dtype.  Layout as ``pallas_ecc.ecc_gn_moments``:
    [0:18] Hessian moments, [18:36] template/image/mask projections,
    [36:42] the masked sums [area, S_t, S_i, S_tt, S_ii, S_ti]; validity
    from ``mask_warps``.  ``kshift``: the template's
    :func:`template_shift`, computed here when None."""
    _check_stats_args(iw, tmpl, warps, mask_warps, "moments")
    if kshift is None:
        kshift = template_shift(tmpl)
    if iw.device.type == "cpu":
        return moments_plain(iw, tmpl, warps, mask_warps, kshift)
    return _launch_stats("moments", iw, tmpl, warps, mask_warps, kshift,
                         LIBRARY.lib().upsp_ecc_moments_blocks(*iw.shape[1:]))


def ecc_gn_moments_update(iw: torch.Tensor, tmpl: torch.Tensor,
                          warps: torch.Tensor, valid_shift: Optional[torch.Tensor],
                          kshift: torch.Tensor, rho_prev: torch.Tensor):
    """K3 and the Gauss-Newton update in one launch, CUDA tensors only:
    the statistics of :func:`ecc_gn_moments` (masked by ``warps`` with the
    (B, 2) integer pre-shift ``valid_shift`` composed into its
    translation, or by ``warps`` when None), then, in the reduce stage,
    the closed-form update from them.  Returns (new warps (B, 2, 3), rho
    (B,), |rho - rho_prev| (B,), statistics (B, 128)), equal on the card
    to ``registration._gn_update`` of the statistics, its twin, bit for
    bit; on a CPU tensor call the twin (``registration._gn_step`` does)."""
    _check_stats_args(iw, tmpl, warps, warps, "moments_update")
    b = iw.shape[0]
    if iw.device.type != "cuda":
        raise ValueError("moments_update: CUDA tensors only (its twin is "
                         "registration._gn_update of ecc_gn_moments)")
    for name, t, shape in (("valid_shift", valid_shift, (b, 2)),
                           ("rho_prev", rho_prev, (b,))):
        if t is None and name == "valid_shift":
            continue
        if (t is None or t.shape != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != iw.device):
            raise ValueError(f"moments_update: {name} must be a contiguous "
                             f"float32 {shape} on the images' device")
    return _launch_stats("moments_update", iw, tmpl, warps, valid_shift, kshift,
                         LIBRARY.lib().upsp_ecc_moments_blocks(*iw.shape[1:]),
                         rho_prev)


def ecc_gn_fused(imgs: torch.Tensor, tmpl: torch.Tensor, warps: torch.Tensor,
                 mask_warps: torch.Tensor,
                 kshift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9: ``ecc_gn_moments(warp_affine_banded(imgs, warps), ...)`` in one
    kernel from the UNWARPED (blurred) (B, H, W) images; the warped image
    never reaches device memory and stays f32 for bf16 images (in f32 its
    values are K2's to the bit).  ``kshift``: the template's
    :func:`template_shift`, computed here when None."""
    _check_stats_args(imgs, tmpl, warps, mask_warps, "gn_fused")
    if kshift is None:
        kshift = template_shift(tmpl)
    if imgs.device.type == "cpu":
        return gn_fused_plain(imgs, tmpl, warps, mask_warps, kshift)
    return _launch_stats("gn_fused", imgs, tmpl, warps, mask_warps, kshift,
                         LIBRARY.lib().upsp_ecc_gn_fused_blocks(*imgs.shape[1:]))


def gn_fused_attrs(dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(registers a thread, local bytes a thread) of K9's instantiation for
    ``dtype`` as built (``cudaFuncGetAttributes``; local bytes above 0 mean
    spills)."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = LIBRARY.lib().upsp_ecc_gn_fused_attrs(
        int(dtype == torch.bfloat16), ctypes.byref(regs), ctypes.byref(local))
    check_rc(rc, "gn_fused attributes")
    return regs.value, local.value


def _check_stats_args(imgs, tmpl, warps, mask_warps, name: str) -> None:
    _check_images(imgs, name)
    _check_warps(warps, imgs, name)
    _check_warps(mask_warps, imgs, name)
    if tmpl.shape != imgs.shape[1:] or tmpl.dtype != imgs.dtype:
        raise ValueError(
            f"{name}: template must be ({imgs.shape[1]}, {imgs.shape[2]}) "
            f"of the images' dtype {imgs.dtype}"
        )
    if not tmpl.is_contiguous() or tmpl.device != imgs.device:
        raise ValueError(f"{name}: template must be contiguous, same device")


def _check_kshift(kshift, imgs, name: str) -> None:
    if (kshift.shape != (1,) or kshift.dtype != torch.float32
            or kshift.device != imgs.device):
        raise ValueError(f"{name}: kshift must be (1,) float32 on the images' device")


def _launch_stats(name, imgs, tmpl, warps, mask, kshift, nblk: int,
                  rho_prev=None):
    """K3 or K9: per-block f64 partials, then their fixed-order sum, the
    (B, 128) statistics.  With ``rho_prev``, K3 with the update in its
    reduce stage (``mask`` is then the (B, 2) pre-shift or None): (new
    warps, rho, drho, statistics)."""
    b, h, w = imgs.shape
    _check_kshift(kshift, imgs, name)
    dev = imgs.device
    partials = torch.empty((b, nblk, NSTAT), dtype=torch.float64, device=dev)
    out = torch.empty((b, 128), dtype=torch.float32, device=dev)
    upd, prev = (), ()
    if rho_prev is not None:
        upd = (torch.empty((b, 2, 3), dtype=torch.float32, device=dev),
               torch.empty((b,), dtype=torch.float32, device=dev),
               torch.empty((b,), dtype=torch.float32, device=dev))
        prev = (rho_prev.data_ptr(),)
    _launch(name, imgs, imgs.data_ptr(), tmpl.data_ptr(), warps.data_ptr(),
            None if mask is None else mask.data_ptr(), kshift.data_ptr(), *prev,
            partials.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in upd),
            b, h, w)
    return (*upd, out) if upd else out


def warp_filter(imgs: torch.Tensor, warps: torch.Tensor, taps: Sequence[float],
                with_warped: bool = False):
    """K4: ``blur(warp_affine_banded(imgs, warps), taps)`` in one pass; with
    ``with_warped`` also the pre-filter warped images.  ``taps=()`` is K2
    alone."""
    _check_images(imgs, "warp_filter")
    _check_warps(warps, imgs, "warp_filter")
    if not taps:
        iw = warp_affine_banded(imgs, warps)
        return (iw, iw) if with_warped else iw
    _check_taps(taps, imgs, "warp_filter")
    if imgs.device.type == "cpu":
        return warp_filter_plain(imgs, warps, taps, with_warped)
    b, h, w = imgs.shape
    out = torch.empty_like(imgs)
    warped = torch.empty_like(imgs) if with_warped else None
    _launch("warp_filter", imgs, imgs.data_ptr(), warps.data_ptr(),
            out.data_ptr(), warped.data_ptr() if with_warped else None, b, h,
            w, *_taps_args(taps))
    return (out, warped) if with_warped else out


def fix_hot_pixels_kernel(imgs: torch.Tensor) -> torch.Tensor:
    """K6: hot-pixel repair of a (..., H, W) float32 stack, each frame on
    its own, with the ``fix_hot_pixels`` defaults: a pixel >= 4064 that is
    more than 512 above its 4-neighbour median takes the median, and a
    frame with more than 5 such candidates is left unchanged.  On the card
    one pass copies each frame and lists its candidates, then a second
    kernel repairs the listed ones (``tests/test_torch_hot_candidates.py``
    emulates both)."""
    if not isinstance(imgs, torch.Tensor) or imgs.dim() < 2:
        raise ValueError("hot: images must be a (..., H, W) tensor")
    if imgs.dtype != torch.float32:
        raise TypeError(f"hot: images must be float32, got {imgs.dtype}")
    if not imgs.is_contiguous():
        raise ValueError("hot: images must be contiguous")
    if imgs.device.type == "cpu":
        return fix_hot_pixels(imgs, HOT_THRESH, HOT_MIN_CHANGE, HOT_MAX)
    if imgs.device.type != "cuda":
        raise ValueError(f"hot: unsupported device {imgs.device}")
    h, w = imgs.shape[-2:]
    b = imgs.numel() // max(h * w, 1)
    out = torch.empty_like(imgs)
    if b == 0 or h * w == 0:
        return out
    # the B per-frame counts (zero on entry), then B lists of HOT_MAX slots
    lists = torch.zeros(b * (1 + HOT_MAX), dtype=torch.int32, device=imgs.device)
    rc = LIBRARY.lib().upsp_ecc_hot(
        imgs.data_ptr(), lists.data_ptr(), out.data_ptr(), b, h, w,
        float(HOT_THRESH), float(HOT_MIN_CHANGE), HOT_MAX, stream_of(imgs),
    )
    check_rc(rc, "hot")
    count_launch("hot")
    return out


# ---------------------------------------------------------------------------
# host-side helpers of pallas_ecc.py that carry over unchanged


def filter_taps(filter_type: str, ksize: int) -> Optional[Tuple[float, ...]]:
    """Static separable tap tuple for the tail kernel (None = unsupported)."""
    if filter_type == "gaussian":
        if ksize > MAX_TAPS:
            return None
        return tuple(float(t) for t in gaussian_kernel_1d(ksize))
    if filter_type == "box":
        if ksize > MAX_TAPS:
            return None
        return tuple(1.0 / ksize for _ in range(ksize))
    if filter_type == "none":
        return ()
    return None


@functools.lru_cache(maxsize=None)
def _corners(h: int, w: int, device: torch.device) -> torch.Tensor:
    """(4, 2) [x, y] corners of an (h, w) image, made once per device."""
    return torch.tensor(
        [[0.0, 0.0], [w - 1.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0]],
        dtype=torch.float32, device=device,
    )


def warp_displacement_bound(warps: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B,) worst-case |sample displacement| (px, L-inf) of affine warps
    over an (h, w) image: the displacement field is affine, so its extrema
    sit at the four corners (pallas_ecc.py:312)."""
    corners = _corners(h, w, warps.device)
    wf = warps.to(torch.float32)
    pos = torch.einsum("kj,bij->bki", corners, wf[:, :, :2]) + wf[:, None, :, 2]
    return (pos - corners).abs().amax(dim=(1, 2))


def ecc_statistics_from_moments(mom: torch.Tensor):
    """(B, 128) raw moments -> (Hmat (B,6,6), i_proj, t_proj, iw_norm2,
    corr, tmpl_norm, area), the zero-mean expansion of
    ``pallas_ecc.ecc_statistics_from_moments``."""
    hm = mom[:, 0:18].reshape(-1, 3, 6)
    p_t = mom[:, 18:24]
    p_i = mom[:, 24:30]
    p_1 = mom[:, 30:36]
    area = mom[:, 36].clamp_min(1.0)
    s_t, s_i, s_tt, s_ii, s_ti = (mom[:, 37 + k] for k in range(5))
    a_xx, a_xy, a_yy, a_x, a_y, a_1 = hm[:, 0].unbind(1)
    b_xx, b_xy, b_yy, b_x, b_y, b_1 = hm[:, 1].unbind(1)
    c_xx, c_xy, c_yy, c_x, c_y, c_1 = hm[:, 2].unbind(1)
    rows = [
        [a_xx, b_xx, a_xy, b_xy, a_x, b_x],
        [b_xx, c_xx, b_xy, c_xy, b_x, c_x],
        [a_xy, b_xy, a_yy, b_yy, a_y, b_y],
        [b_xy, c_xy, b_yy, c_yy, b_y, c_y],
        [a_x, b_x, a_y, b_y, a_1, b_1],
        [b_x, c_x, b_y, c_y, b_1, c_1],
    ]
    hmat = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    t_mean = s_t / area
    i_mean = s_i / area
    t_proj = p_t - t_mean[:, None] * p_1
    i_proj = p_i - i_mean[:, None] * p_1
    iw_norm2 = s_ii - s_i * s_i / area
    corr = s_ti - s_t * s_i / area
    tmpl_norm = torch.sqrt((s_tt - s_t * s_t / area).clamp_min(0.0)).clamp_min(
        1e-12
    )
    return hmat, i_proj, t_proj, iw_norm2, corr, tmpl_norm, area
