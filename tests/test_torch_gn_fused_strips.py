"""K9's strip-and-band decomposition against the plain twin and the JAX
kernel.

``gn_fused_kernel`` (upsp_tpu_torch/csrc/ecc.cu) cuts a frame's width
into equal strips of at most 128 columns and its height into bands of
whole 32-row chunks, about 33 blocks a frame (``gn_grid``), and walks each
band chunk by chunk.  A chunk computes its
new separable rows from the tent tables (K2's ``sep_window``/
``tent_table``/``sep_tile``), its new warped rows with ``taylor_px``, and
the statistics of its rows, folded per row (K3's ``mom_pixel`` and
``mom_fold_row``); the last four separable and two warped rows move to
the top of their tiles for the next chunk instead of being recomputed,
and only a band's first chunk computes its upper ring.  Each block writes
one partial; the partials are summed in a fixed order.

``k9_model`` below is that decomposition in torch: the separable and
warped values in f32, every operation rounded on its own as the kernel
rounds it (tests/test_torch_warp_tables.py's functions), the statistics'
row sums and partials in f64.  So the tests check the blocking, the halo
carried across chunk and band seams, and the row folding; the kernel's
f32 sums are checked against the twin on the card
(tests/test_torch_cuda.py).

Tolerances and why:
- the warped image the chunks assemble equals the twin's ``_warp_f32``
  exactly, in f32 and from bf16 images, on a 2.9 px shear as well: the
  same tables, the same order of rounded operations;
- the statistics: ``assert_stats_close`` (tests/test_torch_gn_fused.py:
  2e-4 relative per group with a floor of 2e-4 of the group's scale, f32
  reduction order), against ``gn_fused_plain`` and against the JAX
  ``ecc_gn_fused`` in interpret mode.

Heights 90 and 97 and widths 130 and 200 are not multiples of the chunk
or the strip.  At these sizes the kernel's bands are one chunk each, so
the model also runs with bands of 64 and 40 rows, whose chunk seams carry
the halo rows as the full-size bands do.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from upsp_tpu.ops import pallas_ecc as P
from upsp_tpu_torch.ops import ecc_kernels as K

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_cuda import assert_stats_close, images, shear_warps, warps  # noqa: E402
from test_torch_warp_tables import col_pos, row_pos, tent  # noqa: E402

GN_TX, GN_TY, GN_FRAME_BLOCKS = 128, 32, 33  # the kernel's (gn_grid)


def gn_grid(h, wd):
    """(band rows, strip columns) of ``gn_grid``."""
    ncol = -(-wd // GN_TX)
    bands = max(1, GN_FRAME_BLOCKS // ncol)
    return max(1, -(-(-(-h // bands)) // GN_TY)) * GN_TY, -(-wd // ncol)


def _sep_rows(g, w, rows, cols, h, wd):
    """Separable rows ``rows`` x columns ``cols`` of image g from the tent
    tables, rows first, then columns (sep_tile's order)."""
    ri0, ri1, rw0, rw1 = tent(row_pos(w, rows, wd), h)
    ci0, ci1, cw0, cw1 = tent(col_pos(w, cols, h), wd)
    t0 = rw0[:, None] * g[ri0][:, ci0] + rw1[:, None] * g[ri1][:, ci0]
    t1 = rw0[:, None] * g[ri0][:, ci1] + rw1[:, None] * g[ri1][:, ci1]
    return cw0[None] * t0 + cw1[None] * t1


def _warped_rows(sep, w, ys, xs, h, wd):
    """taylor_px over the separable tile ``sep`` (rows ys[0]-1 .., columns
    xs[0]-1 ..) for warped rows ys and columns xs, zero outside the
    image."""
    cy, cx = (h - 1) * 0.5, (wd - 1) * 0.5
    dx = (w[0, 1] * (ys.float() - cy))[:, None]
    dy = (w[1, 0] * (xs.float() - cx))[None, :]
    inv_ax, inv_ay = 1.0 / w[0, 0], 1.0 / w[1, 1]
    ey = ((ys > 0) & (ys < h - 1))[:, None]
    ex = ((xs > 0) & (xs < wd - 1))[None, :]
    n, m = len(ys), len(xs)

    def s(dr, dc):
        return sep[1 + dr:1 + dr + n, 1 + dc:1 + dc + m]

    zero = torch.zeros(())
    mc = s(0, 0)
    gx = torch.where(ex, 0.5 * (s(0, 1) - s(0, -1)) * inv_ax, zero)
    gxx = torch.where(ex, ((s(0, 1) - 2.0 * mc) + s(0, -1)) * inv_ax * inv_ax, zero)
    gy = torch.where(ey, 0.5 * (s(1, 0) - s(-1, 0)) * inv_ay, zero)
    gyy = torch.where(ey, ((s(1, 0) - 2.0 * mc) + s(-1, 0)) * inv_ay * inv_ay, zero)
    hxy = ((s(1, 1) - s(1, -1)) - s(-1, 1)) + s(-1, -1)
    gxy = torch.where(ex & ey, 0.25 * hxy * inv_ax * inv_ay, zero)
    v = (mc + dx * gx) + dy * gy
    v = ((v + 0.5 * dx * dx * gxx) + dx * dy * gxy) + 0.5 * dy * dy * gyy
    inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < wd))[None, :]
    return torch.where(inside, v, zero)


def _mask_axes(mw, h, wd):
    ys = torch.arange(h, dtype=torch.float32)
    xs = torch.arange(wd, dtype=torch.float32)
    y_sep = (mw[1, 1] * ys + mw[1, 2]) + mw[1, 0] * torch.tensor((wd - 1) * 0.5)
    x_sep = (mw[0, 0] * xs + mw[0, 2]) + mw[0, 1] * torch.tensor((h - 1) * 0.5)
    return (y_sep >= 0) & (y_sep <= h - 1.0), (x_sep >= 0) & (x_sep <= wd - 1.0)


def _chunk_stats(wrp, tv, w, mw_rows, cols, ys, xs, h, wd, kshift):
    """The 42 statistics of output rows ys, columns xs (f64) from the
    chunk's warped tile (rows ys[0]-1 .., columns xs[0]-1 ..): each row's
    x-only sums folded with y and y^2 (K3's mom_fold_row)."""
    n, m = len(ys), len(xs)
    mid = wrp[1:1 + n, 1:1 + m]
    gmask = ((ys > 0) & (ys < h - 1))[:, None]
    dv = torch.where(gmask, wrp[2:2 + n, 1:1 + m] - wrp[0:n, 1:1 + m], torch.zeros(()))
    inner = ((xs > 0) & (xs < wd - 1))[None, :]
    dh = torch.where(inner, wrp[1:1 + n, 2:2 + m] - wrp[1:1 + n, 0:m], torch.zeros(()))
    inv_det = 1.0 / (w[0, 0] * w[1, 1] - w[0, 1] * w[1, 0])
    p, q = 0.5 * w[1, 1] * inv_det, -0.5 * w[1, 0] * inv_det
    r, s = -0.5 * w[0, 1] * inv_det, 0.5 * w[0, 0] * inv_det
    gx = (p * dh + q * dv).double()
    gy = (r * dh + s * dv).double()
    iv = (mid - kshift).double()
    tv = tv.double()
    valid = (mw_rows[:, None] & cols[None, :]).double()
    x = xs.double()[None, :]
    y = ys.double()

    def row(v):  # (n,): each valid row's sum over its valid columns
        return (v * valid).sum(1)

    vals = []
    for f in (gx * gx, gx * gy, gy * gy):
        rfx, rf = row(f * x), row(f)
        vals += [row(f * x * x).sum(), (y * rfx).sum(), (y * y * rf).sum(),
                 rfx.sum(), (y * rf).sum(), rf.sum()]
    for z in (tv, iv, None):
        gs = (gx, gy) if z is None else (gx * z, gy * z)
        rg = [row(g) for g in gs]
        vals += [row(gs[0] * x).sum(), row(gs[1] * x).sum(), (y * rg[0]).sum(),
                 (y * rg[1]).sum(), rg[0].sum(), rg[1].sum()]
    vals += [row(v).sum() for v in (torch.ones_like(iv), tv, iv, tv * tv, iv * iv, tv * iv)]
    return torch.stack(vals)


def k9_model(imgs, tmpl, warps_t, mask_warps, band=None):
    """(B, 128) f32 statistics and the (B, H, W) f32 warped image the
    chunks assemble, by K9's strips, bands (the kernel's, or ``band``
    rows) and chunks with the halo rows carried from chunk to chunk."""
    x = imgs.float()
    t = tmpl.float()
    b, h, wd = x.shape
    kshift = K.template_shift(tmpl)
    kband, cw = gn_grid(h, wd)
    band = band or kband
    out = torch.zeros((b, 128), dtype=torch.float32)
    warped = torch.full((b, h, wd), float("nan"))
    for i in range(b):
        w, mw = warps_t[i], mask_warps[i]
        rows_ok, cols_ok = _mask_axes(mw, h, wd)
        partials = []  # blockIdx.y * gridDim.z + blockIdx.z order
        for by0 in range(0, h, band):
            by1 = min(by0 + band, h)
            for c0 in range(0, wd, cw):
                c1 = min(wd, c0 + cw)
                scols = torch.arange(c0 - 2, c1 + 2)
                xs = torch.arange(c0, c1)
                sep = torch.zeros((GN_TY + 4, len(scols)))
                wrp = torch.zeros((GN_TY + 2, len(scols) - 2))
                part = torch.zeros(42, dtype=torch.float64)
                for r0 in range(by0, by1, GN_TY):
                    n = min(GN_TY, by1 - r0)
                    first = r0 == by0
                    if not first:  # the carried rows
                        sep[:4] = sep[GN_TY:GN_TY + 4].clone()
                        wrp[:2] = wrp[GN_TY:GN_TY + 2].clone()
                    s0 = r0 - 2 if first else r0 + 2
                    ns = n + 4 if first else n
                    at = s0 - (r0 - 2)
                    sep[at:at + ns] = _sep_rows(x[i], w, torch.arange(s0, s0 + ns),
                                                scols, h, wd)
                    w0 = 0 if first else 2
                    ys = torch.arange(r0 - 1 + w0, r0 + n + 1)
                    wrp[w0:n + 2] = _warped_rows(sep[w0:n + 4], w, ys,
                                                 torch.arange(c0 - 1, c1 + 1), h, wd)
                    oy = torch.arange(r0, r0 + n)
                    warped[i, r0:r0 + n, c0:c1] = wrp[1:n + 1, 1:c1 - c0 + 1]
                    part += _chunk_stats(wrp[:n + 2], t[r0:r0 + n, c0:c1] - kshift, w,
                                         rows_ok[r0:r0 + n], cols_ok[c0:c1], oy, xs,
                                         h, wd, kshift)
                partials.append(part)
        total = torch.zeros(42, dtype=torch.float64)
        for part in partials:  # moments_reduce_kernel's fixed order
            total += part
        out[i, :42] = total.float()
    return out, warped


def _inputs(seed, shape, pre_shift, shear=False):
    x = images(seed, *shape)
    tm = images(seed + 100, 1, *shape[1:])[0]
    w = shear_warps(seed, *shape) if shear else warps(seed, shape[0])
    mw = w.copy()
    if pre_shift:
        mw[:, :, 2] += np.array([2.0, -1.0], np.float32)  # composed pre-shift
    return x, tm, w, mw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shear", [False, True])
def test_chunks_assemble_k2s_warped_image(dtype, shear):
    """The warped rows the chunks compute, halo rows carried across chunk
    and band seams, are the twin's f32 warped image bit for bit (from bf16
    images: the f32 values before K2's rounding)."""
    dt = getattr(torch, dtype)
    for shape, band in (((2, 90, 130), None), ((1, 97, 200), 40), ((1, 97, 130), 64)):
        x, tm, w, mw = _inputs(40, shape, True, shear)
        xt, tt = torch.tensor(x).to(dt), torch.tensor(tm).to(dt)
        _, warped = k9_model(xt, tt, torch.tensor(w), torch.tensor(mw), band)
        assert torch.equal(warped, K._warp_f32(xt.float(), torch.tensor(w))), (shape, band)


@pytest.mark.parametrize("shape,band", [((2, 90, 130), None), ((2, 97, 200), None),
                                        ((2, 97, 200), 40), ((2, 90, 130), 64)])
@pytest.mark.parametrize("pre_shift", [False, True])
def test_strip_model_matches_twin_and_jax(shape, band, pre_shift):
    """The strip, band and chunk statistics against ``gn_fused_plain`` and
    the JAX ``ecc_gn_fused`` (interpret mode off-TPU)."""
    x, tm, w, mw = _inputs(41, shape, pre_shift)
    xt, tt, wt, mt = (torch.tensor(a) for a in (x, tm, w, mw))
    got, _ = k9_model(xt, tt, wt, mt, band)
    assert_stats_close(got.numpy(), K.gn_fused_plain(xt, tt, wt, mt).numpy(), tm)
    want = np.asarray(jax.vmap(P.ecc_gn_fused, in_axes=(0, None, 0, 0))(
        jnp.asarray(x), jnp.asarray(tm), jnp.asarray(w), jnp.asarray(mw)))
    assert_stats_close(got.numpy(), want, tm)


def test_strip_model_bf16_matches_twin():
    """bf16 images and template: the warped values stay f32, the shift is
    the bf16 mean, as ``gn_fused_plain``."""
    x, tm, w, mw = _inputs(42, (2, 97, 130), True)
    xt = torch.tensor(x).to(torch.bfloat16)
    tt = torch.tensor(tm).to(torch.bfloat16)
    wt, mt = torch.tensor(w), torch.tensor(mw)
    got, _ = k9_model(xt, tt, wt, mt)
    assert_stats_close(got.numpy(), K.gn_fused_plain(xt, tt, wt, mt).numpy(),
                       tt.float().numpy())
