"""Per-frame ECC affine registration, batched over frames.

Port of ``upsp_tpu/ops/registration.py``: one template (or, on the dense
route, one a lane), (B, H, W) inputs, (B, 2, 3) warps.  :func:`ecc_affine` solves in one of two forms:

- the while loop (``unroll=False``, the default): the reference's
  criteria, at most ``max_iters`` (50) Gauss-Newton steps and a stop once
  |rho - rho_prev| < ``epsilon`` (1e-3) (registration.cpp:53-64).  Each
  lane (frame) stops on its own; the lanes still running are compacted
  into contiguous tensors (``index_select``) whenever one stops, so every
  step runs on those lanes only, and the loop ends when none runs or at
  the cap.  Returns the iteration count of each lane.
- a fixed number of steps (``unroll=True``, fft mode's two), optionally
  after ``coarse_iters`` steps on a 2x box-decimated pair; returns the
  final |drho|, the convergence signal of that form.

A lane's result does not depend on the batch it ran in: every kernel is
per image and the update is elementwise per lane (``_dot6`` and
``_sum6`` fix the order of the 6-term sums).

The Gauss-Newton step, ``impl``:

- ``"auto"`` = ``"kernels"`` (the JAX package's ``"pallas"``): K2 warp,
  K3 statistics, then the closed-form update (``body_pallas``,
  registration.py:298-343); on a CPU tensor the kernels' plain twins.
  K2 has no band limit, so this route serves every start, identity
  included: the JAX package's while loop takes its dense step only
  because its banded Pallas warp needs bounded displacements
  (registration.py:249-255).
- ``"jnp"``: the JAX package's dense ``body`` (:345-455) in plain
  PyTorch, statistics summed in f32 as XLA sums them; the kernel route's
  oracle.

Conventions (as the reference): the warp maps template pixel coordinates
to input coordinates, ``out(x) = input(W @ [x, y, 1])``; zero outside
the image; the pre-blur is a ksize-5 Gaussian (K1); with ``valid_shift``
(the fft integer pre-shift) the statistics are masked by the composed
warp.  If either image is bfloat16, template and image are blurred and
warped in bfloat16 (registration.py:259-269); warps, statistics and the
solve stay f32.

:func:`warp_affine` is the gather warp (bilinear or nearest) of the JAX
package, plain PyTorch as XLA runs it there.  Its sample coordinates are
f32 whatever the image dtype: the JAX package builds them in the image's
dtype, so a bfloat16 nearest warp there samples up to 4 px off
(ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from upsp_tpu_torch.ops.ecc_kernels import (
    MAX_TAPS,
    blur,
    ecc_gn_moments,
    ecc_statistics_from_moments,
    template_shift,
    warp_affine_banded,
    warp_plain,
)
from upsp_tpu_torch.ops.image import gaussian_blur, gaussian_kernel_1d
from upsp_tpu_torch.ops.warp import downsample2, scale_warp, warp_validity_mask
from upsp_tpu_torch.utils import timing

MAX_ITERS, EPSILON = 50, 1e-3  # the reference's criteria (psp_process.cpp:1665-1667)


def ecc_route(impl: str) -> str:
    """The Gauss-Newton step of ``impl``: "kernels" (for "auto" and
    "kernels") or "jnp"."""
    if impl in ("auto", "kernels"):
        return "kernels"
    if impl == "jnp":
        return "jnp"
    raise ValueError(f"ecc impl must be auto|kernels|jnp, got {impl!r}")


def identity_warp(dtype=torch.float32, batch: Optional[int] = None,
                  device=None) -> torch.Tensor:
    """The (2, 3) identity warp of ``dtype``, as the JAX package's, or with
    ``batch`` (batch, 2, 3) of them; made on ``device`` (no host copy)."""
    w = torch.zeros((1 if batch is None else batch, 2, 3), dtype=dtype, device=device)
    w[:, 0, 0] = 1.0
    w[:, 1, 1] = 1.0
    return w[0] if batch is None else w


# ---------------------------------------------------------------------------
# the gather warp (registration.py:34-81)


def _sample_coords(warps: torch.Tensor, h: int, w: int):
    """(B, H, W) f32 sample positions (x, y) = W @ [x, y, 1]."""
    dev = warps.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    a = warps.to(torch.float32)[..., None, None]
    wx = a[:, 0, 0] * xs + a[:, 0, 1] * ys + a[:, 0, 2]
    wy = a[:, 1, 0] * xs + a[:, 1, 1] * ys + a[:, 1, 2]
    return wx, wy


def _tap(imgs: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """imgs[b, yi, xi], zero where (yi, xi) is outside the image."""
    b, h, w = imgs.shape
    out = ((xi < 0) | (xi >= w) | (yi < 0) | (yi >= h))
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    v = imgs.reshape(b, h * w).gather(1, idx.reshape(b, -1)).reshape(b, h, w)
    return v.masked_fill(out, 0.0)


def _sample_bilinear(imgs: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Bilinear samples with constant-0 out of bounds (cv2 BORDER_CONSTANT)."""
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    x0i = x0.long()
    y0i = y0.long()
    v00 = _tap(imgs, y0i, x0i)
    v01 = _tap(imgs, y0i, x0i + 1)
    v10 = _tap(imgs, y0i + 1, x0i)
    v11 = _tap(imgs, y0i + 1, x0i + 1)
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def _sample_nearest(imgs: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """The nearest pixel (round half to even), 0 out of bounds."""
    return _tap(imgs, torch.round(ys).long(), torch.round(xs).long())


def warp_affine(imgs: torch.Tensor, warps: torch.Tensor,
                interpolation: str = "linear") -> torch.Tensor:
    """out(b, y, x) = imgs[b](W_b @ [x, y, 1]) for (B, H, W) images and
    (B, 2, 3) warps, cv2.warpAffine WARP_INVERSE_MAP parity: "linear"
    computes in f32 and rounds once to the images' dtype (float32 or
    bfloat16), "nearest" copies pixels."""
    if imgs.dim() != 3 or warps.shape != (imgs.shape[0], 2, 3):
        raise ValueError("warp_affine: need (B, H, W) images and (B, 2, 3) warps")
    if interpolation not in ("linear", "nearest"):
        raise ValueError(f"interpolation must be linear|nearest, got {interpolation!r}")
    h, w = imgs.shape[1:]
    xs, ys = _sample_coords(warps, h, w)
    if interpolation == "nearest":
        return _sample_nearest(imgs, xs, ys)
    dtype = torch.bfloat16 if imgs.dtype == torch.bfloat16 else torch.float32
    return _sample_bilinear(imgs.to(torch.float32), xs, ys).to(dtype)


# ---------------------------------------------------------------------------
# the Gauss-Newton update


def chol_factor_unrolled(hmat: torch.Tensor, n: int = 6) -> List[List]:
    """Unrolled Cholesky of a batch of small SPD matrices (B, n, n);
    returns L as nested lists of (B,) tensors (pivots clamped at 1e-30)."""
    L: List[List[Optional[torch.Tensor]]] = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = hmat[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s.clamp_min(1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def chol_solve_unrolled(L, b: torch.Tensor, n: int = 6) -> torch.Tensor:
    """Solve (L L^T) x = b for (B, n) right-hand sides."""
    y: List[Optional[torch.Tensor]] = [None] * n
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x: List[Optional[torch.Tensor]] = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=1)


def _sum6(v: torch.Tensor) -> torch.Tensor:
    """(B,) sums of (B, 6) rows, added left to right (the same order for
    every batch size, unlike a reduction kernel's)."""
    return v[:, 0] + v[:, 1] + v[:, 2] + v[:, 3] + v[:, 4] + v[:, 5]


def _dot6(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _sum6(a * b)


def _solve_update(hmat, i_proj, t_proj, iw_norm2, corr, tmpl_norm, warp,
                  rho_prev):
    """The closed-form ECC update from a step's statistics: (new warps,
    rho, |rho - rho_prev|)."""
    eye = torch.eye(6, dtype=hmat.dtype, device=hmat.device)
    reg = 1e-9 * _sum6(hmat.diagonal(dim1=1, dim2=2)) / 6.0 + 1e-12
    lc = chol_factor_unrolled(hmat + reg[:, None, None] * eye)
    hinv_i = chol_solve_unrolled(lc, i_proj)
    hinv_t = chol_solve_unrolled(lc, t_proj)
    num = iw_norm2 - _dot6(i_proj, hinv_i)
    den = corr - _dot6(t_proj, hinv_i)
    den = torch.where(den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
    lam = num / den
    dp = lam[:, None] * hinv_t - hinv_i
    dwarp = torch.stack(
        [dp[:, [0, 2, 4]], dp[:, [1, 3, 5]]], dim=1
    )  # [[a00 a01 tx], [a10 a11 ty]] increments
    new_warp = warp + dwarp
    new_warp = torch.where(torch.isfinite(new_warp), new_warp, warp).contiguous()
    rho = corr / (tmpl_norm * torch.sqrt(iw_norm2.clamp_min(0.0))).clamp_min(1e-12)
    rho = torch.where(torch.isfinite(rho), rho, torch.full_like(rho, -1.0))
    return new_warp, rho, (rho - rho_prev).abs()


def _gn_update(mom, warp, rho_prev):
    """The update from K3's (B, 128) statistics."""
    return _solve_update(*ecc_statistics_from_moments(mom)[:6], warp, rho_prev)


def _mask_warp(warp, valid_shift):
    """The warp the statistics are masked by: ``warp`` with the integer
    pre-shift composed into its translation."""
    if valid_shift is None:
        return warp
    return torch.cat(
        [warp[:, :, :2], (warp[:, :, 2] + valid_shift)[:, :, None]], dim=2
    ).contiguous()


def _gn_step(img, tmpl, kshift, warp, rho_prev, valid_shift):
    """One Gauss-Newton step of the kernel route (``body_pallas``): K2
    warp, K3 statistics (``kshift``: the template's brightness shift),
    closed-form update.  K2 then K3, not K9 (``ecc_gn_fused``, the same
    statistics in one kernel): on the H100 K9 is the faster of the two at
    1024x1024 but not at the full configuration's 1200x1800 (PERF.md
    section 6)."""
    iw = warp_affine_banded(img, warp)
    return _gn_update(
        ecc_gn_moments(iw, tmpl, warp, _mask_warp(warp, valid_shift), kshift),
        warp, rho_prev)


def _gradients(imgs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences of (B, H, W) images, zero on the outer ring
    ([-0.5, 0, 0.5] filter, registration.py:123-129)."""
    gx = torch.zeros_like(imgs)
    gx[:, :, 1:-1] = 0.5 * (imgs[:, :, 2:] - imgs[:, :, :-2])
    gy = torch.zeros_like(imgs)
    gy[:, 1:-1, :] = 0.5 * (imgs[:, 2:, :] - imgs[:, :-2, :])
    return gx, gy


def _dense_step(img, tmpl, warp, rho_prev, valid_shift):
    """One Gauss-Newton step of the dense route (``body``): the warped
    image (K2's twin), its gradients carried through the affine chain
    rule, the validity mask, the 18 Hessian moments and the two
    projections, summed in f32; then the update."""
    b, h, w = img.shape
    iw = warp_plain(img, warp).to(torch.float32)
    tm = tmpl.to(torch.float32)
    gix, giy = _gradients(iw)
    a00, a01, _, a10, a11, _ = (v[:, None, None] for v in warp.reshape(-1, 6).unbind(1))
    det = a00 * a11 - a01 * a10
    gx = (a11 * gix - a10 * giy) / det
    gy = (-a01 * gix + a00 * giy) / det
    m = warp_validity_mask((h, w), _mask_warp(warp, valid_shift))

    def s(f):
        return f.sum(dim=(1, 2))

    area = s(m).clamp_min(1.0)
    gx = gx * m
    gy = gy * m
    t_zm = (tm - (s(tm * m) / area)[:, None, None]) * m
    tmpl_norm = torch.sqrt(s(t_zm * t_zm)).clamp_min(1e-12)
    i_zm = (iw - (s(iw * m) / area)[:, None, None]) * m
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]

    def mom(f):
        return (s(f * xs * xs), s(f * xs * ys), s(f * ys * ys), s(f * xs),
                s(f * ys), s(f))

    a_xx, a_xy, a_yy, a_x, a_y, a_1 = mom(gx * gx)
    b_xx, b_xy, b_yy, b_x, b_y, b_1 = mom(gx * gy)
    c_xx, c_xy, c_yy, c_x, c_y, c_1 = mom(gy * gy)
    rows = [
        [a_xx, b_xx, a_xy, b_xy, a_x, b_x],
        [b_xx, c_xx, b_xy, c_xy, b_x, c_x],
        [a_xy, b_xy, a_yy, b_yy, a_y, b_y],
        [b_xy, c_xy, b_yy, c_yy, b_y, c_y],
        [a_x, b_x, a_y, b_y, a_1, b_1],
        [b_x, c_x, b_y, c_y, b_1, c_1],
    ]
    hmat = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    def proj(z):
        return torch.stack([s(gx * xs * z), s(gy * xs * z), s(gx * ys * z),
                            s(gy * ys * z), s(gx * z), s(gy * z)], dim=1)

    return _solve_update(hmat, proj(i_zm), proj(t_zm), s(i_zm * i_zm),
                         s(t_zm * i_zm), tmpl_norm, warp, rho_prev)


# ---------------------------------------------------------------------------
# the solve


def ecc_blur(imgs: torch.Tensor, gauss_size: int = 5) -> torch.Tensor:
    """The ECC pre-blur of (B, H, W) float32 or bfloat16 images, same dtype
    out: kernel K1 up to 7 taps, the plain Gaussian beyond (as the JAX
    package falls back to XLA)."""
    if gauss_size <= MAX_TAPS:
        taps = tuple(float(t) for t in gaussian_kernel_1d(gauss_size))
        return blur(imgs.contiguous(), taps)
    return gaussian_blur(imgs, gauss_size).contiguous()


def _while_loop(step: Callable, img, warp, valid_shift, max_iters: int,
                epsilon: float):
    """Run each lane's steps until its |drho| < ``epsilon`` or
    ``max_iters`` steps (the ``cond`` of registration.py:457-459); one host
    sync a step for the count of lanes still running.  Returns (warps,
    rho, iteration counts (B,) int32)."""
    b = img.shape[0]
    dev = img.device
    warp = warp.clone()
    rho = torch.full((b,), -1.0, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    lanes = torch.arange(b, device=dev)
    img_a, warp_a, rho_a, vs_a = img, warp, rho, valid_shift
    n_active = b
    for it in range(1, max_iters + 1):
        if n_active == 0:
            break
        warp_a, rho_a, drho_a = step(img_a, warp_a, rho_a, vs_a)
        warp.index_copy_(0, lanes, warp_a)
        rho.index_copy_(0, lanes, rho_a)
        iters.index_fill_(0, lanes, it)
        go = drho_a >= epsilon
        timing.count("gn.steps")
        timing.count("gn.lane_steps", n_active)
        with timing.span("phase1.gn_sync"):
            n = int(go.sum())
        if go.device.type != "cpu":
            timing.count("host_syncs.gn")
        if n < n_active:
            keep = go.nonzero().squeeze(1)
            lanes = lanes[keep]
            img_a = img_a.index_select(0, keep)
            warp_a = warp_a.index_select(0, keep)
            rho_a = rho_a[keep]
            vs_a = None if vs_a is None else vs_a.index_select(0, keep)
            n_active = n
    return warp, rho, iters


def _ecc_core(ref, inp, warp, max_iters, epsilon, gauss_size, unroll,
              valid_shift, impl, tmpl_blurred=None, tmpl_shift=None):
    b = inp.shape[0]
    im_dtype = (
        torch.bfloat16
        if torch.bfloat16 in (ref.dtype, inp.dtype) else torch.float32
    )
    tmpl = (
        tmpl_blurred if tmpl_blurred is not None
        else ecc_blur(ref.to(im_dtype).reshape((-1,) + ref.shape[-2:]),
                      gauss_size).reshape(ref.shape)
    ).contiguous()
    img = ecc_blur(inp.to(im_dtype).contiguous(), gauss_size)
    if tmpl.dim() == 3 and ecc_route(impl) == "kernels":
        # as the JAX package's Pallas moments refuse batched templates
        # (upsp_tpu/ops/pallas_ecc.py:633-634)
        raise NotImplementedError(
            "a template per lane needs the dense 'jnp' step: K3 reads one "
            "template for the whole batch")
    if ecc_route(impl) == "jnp":
        def step(im, wp, rho, vs):
            return _dense_step(im, tmpl, wp, rho, vs)
    else:
        kshift = template_shift(tmpl) if tmpl_shift is None else tmpl_shift

        def step(im, wp, rho, vs):
            return _gn_step(im, tmpl, kshift, wp, rho, vs)
    if not unroll:
        return _while_loop(step, img, warp, valid_shift, max_iters, epsilon)
    rho = torch.full((b,), -1.0, device=inp.device)
    drho = torch.full((b,), float("inf"), device=inp.device)
    for _ in range(max_iters):
        warp, rho, drho = step(img, warp, rho, valid_shift)
    return warp, rho, drho


def ecc_affine(
    ref: torch.Tensor,
    inp: torch.Tensor,
    max_iters: int = MAX_ITERS,
    epsilon: float = EPSILON,
    gauss_size: int = 5,
    warp_init: Optional[torch.Tensor] = None,
    return_iters: bool = False,
    unroll: bool = False,
    coarse_iters: int = 0,
    valid_shift: Optional[torch.Tensor] = None,
    impl: str = "auto",
    tmpl_blurred: Optional[torch.Tensor] = None,
    tmpl_shift: Optional[torch.Tensor] = None,
):
    """Align (B, H, W) ``inp`` to the (H, W) template ``ref`` by ECC
    maximisation, from ``warp_init`` (B, 2, 3) or identity.  ``ref`` may
    also be (B, H, W), a template per lane, on the dense route only (the
    kernel route raises ``NotImplementedError``).  An (H, W) ``inp`` is one
    frame, as the JAX package takes it, with a (2, 3) ``warp_init`` and
    (2,) ``valid_shift``, and returns a (2, 3) warp and scalars.  The
    parameters come in the JAX package's order (but its ``band``).

    Returns (warps (B, 2, 3), rho (B,)), or with ``return_iters`` (warps,
    rho, conv (B,)): ``conv`` is the iteration count (int32) of the while
    loop, or with ``unroll`` the final |drho| of ``max_iters`` fixed
    steps.  With ``unroll``, ``coarse_iters`` > 0 first runs that many fixed steps on a 2x
    box-decimated f32 pair (``valid_shift`` halved) and starts from their
    warp scaled back (registration.py:213-232).  ``valid_shift`` (B, 2):
    the integer pre-shift already applied to ``inp``, composed into the
    statistics' mask.  ``impl``: the step's route (module docstring).
    ``tmpl_blurred`` passes a template already blurred by :func:`ecc_blur`
    in the images' dtype (the chunk processor blurs each camera's template
    once), and ``tmpl_shift`` its :func:`template_shift` (computed here
    when None); both serve the full-resolution stage.
    """
    if inp.dim() == 2:  # one (H, W) frame, as the JAX package takes it
        out = ecc_affine(
            ref, inp[None], max_iters, epsilon, gauss_size,
            None if warp_init is None else warp_init[None], True, unroll,
            coarse_iters, None if valid_shift is None else valid_shift[None],
            impl, tmpl_blurred, tmpl_shift)
        return tuple(o[0] for o in out[: 3 if return_iters else 2])
    b = inp.shape[0]
    warp = (
        identity_warp(batch=b, device=inp.device) if warp_init is None
        else warp_init.to(torch.float32).contiguous()
    )
    if valid_shift is not None:
        valid_shift = valid_shift.to(torch.float32)
    if unroll and coarse_iters > 0:
        wc, _, _ = _ecc_core(
            downsample2(ref.to(torch.float32)),
            downsample2(inp.to(torch.float32)).contiguous(),
            scale_warp(warp, 0.5).contiguous(), coarse_iters, epsilon,
            gauss_size, True, None if valid_shift is None else valid_shift * 0.5,
            impl,
        )
        warp = scale_warp(wc, 2.0).contiguous()
    out = _ecc_core(ref, inp, warp, max_iters, epsilon, gauss_size, unroll,
                    valid_shift, impl, tmpl_blurred, tmpl_shift)
    return out if return_iters else out[:2]


def ecc_affine_pyramid(ref: torch.Tensor, inp: torch.Tensor,
                       max_iters: int = MAX_ITERS, epsilon: float = EPSILON,
                       gauss_size: int = 5, levels: int = 2,
                       impl: str = "auto"):
    """Coarse-to-fine ECC (registration.py:132-162): the while loop at 2^k
    decimation, k = levels-1 .. 0, each level starting from the last
    one's warp.  Returns (warps (B, 2, 3), rho (B,)) of the finest level."""
    warp = identity_warp(batch=inp.shape[0], device=inp.device)
    rho = None
    for lev in range(levels - 1, -1, -1):
        r, i = ref.to(torch.float32), inp.to(torch.float32)
        for _ in range(lev):
            r = downsample2(r)
            i = downsample2(i)
        w_lv, rho, _ = _ecc_core(r, i.contiguous(),
                                 scale_warp(warp, 0.5**lev).contiguous(),
                                 max_iters, epsilon, gauss_size, False, None, impl)
        warp = scale_warp(w_lv, 2.0**lev)
    return warp, rho


def register_frame(ref: torch.Tensor, inp: torch.Tensor,
                   max_iters: int = MAX_ITERS, epsilon: float = EPSILON,
                   interpolation: str = "linear", impl: str = "auto"):
    """ECC-align (B, H, W) ``inp`` to ``ref`` from identity and return
    (aligned f32 images, warps, rho): the warp estimated on the blurred
    images is applied to the raw input (upsp::register_pixel,
    registration.cpp:31-84), by K2 ("linear", ``warp_affine_mxu``'s order-2
    warp as in the JAX package) or by :func:`warp_affine` ("nearest")."""
    warp, rho = ecc_affine(ref, inp, max_iters=max_iters, epsilon=epsilon,
                           impl=impl)
    raw = inp.to(torch.float32).contiguous()
    if interpolation == "nearest":
        aligned = warp_affine(raw, warp, "nearest")
    else:
        aligned = warp_affine_banded(raw, warp)
    return aligned, warp, rho
