"""K2's table algebra against the plain twin and the JAX kernel.

``warp_kernel`` (upsp_tpu_torch/csrc/ecc.cu) and ``warp_filter_kernel``
share their separable stage.  A block owning a 32 x 128 output tile stages
the source window its tent taps read, and it finds the window's span from
the first and last separable row and column alone, before it builds any
table: a sample position is affine in the index and rounded monotonically,
and the tent taps are monotone in the position.  The taps then come from
per-row and per-column tables (``tent``), the separable image is formed
rows first, then columns, and the warped value comes from the 3x3
separable neighbourhood with the row's and the column's displacement
(``taylor_px``).  The functions below are that arithmetic in torch, in f32
with every operation rounded on its own, as the kernels round it.

Tolerances and why:
- the window span from the ends equals the min/max over every table entry
  of the tile, and holds every tap the twin weights, exactly (integer
  indices);
- against the twin: exact, in f32 and bf16, on a shear that moves the
  frame's corners by 2.9 px and off the staged window.  The tables give
  the twin's taps and weights, and the sums and the Taylor term run in the
  twin's order, one rounded operation at a time; the card tests hold the
  kernels to 2e-3 counts (tests/test_torch_cuda.py);
- against the JAX kernel (interpret mode off-TPU), inside its +-3 px band:
  atol 1e-3 counts in f32 (1 bf16 ulp in bf16) plus the slope of the image
  times 4 f32 ulps of the frame's larger side at every pixel: that kernel
  forms its tent weights from ``x_sep - x`` and band shifts, so its sample
  positions round differently everywhere; where a sample straddles the
  zero border, that bound times the pixel value on top.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from upsp_tpu.ops import pallas_ecc as P
from upsp_tpu_torch.ops import ecc_kernels as K

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_cuda import (  # noqa: E402
    bf16_ulp,
    border_straddle,
    far_warps,
    images,
    shear_warps,
    warps,
)

TY, TX = 32, 128  # the kernels' output tile
SHAPES = [(2, 97, 131), (2, 90, 97), (1, 40, 1800)]


def affine_pos(a, v, b, c, d):
    """a v + b + c d, every product and sum rounded on its own (f32)."""
    return (a * v + b) + c * d


def tent(p, n):
    """The kernel's ``tent``: (i0, i1, w0, w1) of positions p over [0, n),
    indices clamped into the image, weight 0 for a tap outside."""
    inside = (p > -1.0) & (p < float(n))
    f = torch.floor(torch.where(inside, p, torch.zeros_like(p)))
    k = f.long()
    w1 = p - f
    w0 = 1.0 - w1
    w0 = torch.where(inside & (k >= 0), w0, torch.zeros_like(w0))
    w1 = torch.where(inside & (k + 1 < n), w1, torch.zeros_like(w1))
    edge = torch.where(p >= float(n), n - 1, 0)
    i0 = torch.where(inside, k.clamp(min=0), edge)
    i1 = torch.where(inside, (k + 1).clamp(max=n - 1), edge)
    return i0, i1, w0, w1


def row_pos(w, rows, wd):
    return affine_pos(w[1, 1], rows.float(), w[1, 2], w[1, 0], torch.tensor((wd - 1) * 0.5))


def col_pos(w, cols, h):
    return affine_pos(w[0, 0], cols.float(), w[0, 2], w[0, 1], torch.tensor((h - 1) * 0.5))


def window_from_ends(w, h, wd, sr0, nys, sc0, nxs):
    """``sep_window``: (first row, last row, first column, last column)
    from the tile's first and last separable row and column."""
    ends_r = tent(row_pos(w, torch.tensor([sr0, sr0 + nys - 1]), wd), h)
    ends_c = tent(col_pos(w, torch.tensor([sc0, sc0 + nxs - 1]), h), wd)
    return (int(ends_r[0].min()), int(ends_r[1].max()),
            int(ends_c[0].min()), int(ends_c[1].max()))


def taps_of_tables(w, h, wd, sr0, nys, sc0, nxs):
    """Every tap of the tile's tables, and the taps the twin's
    ``_tent_pair`` weights, as (row taps, column taps) each."""
    rp = row_pos(w, torch.arange(sr0, sr0 + nys), wd)
    cp = col_pos(w, torch.arange(sc0, sc0 + nxs), h)
    tables = (torch.cat(tent(rp, h)[:2]), torch.cat(tent(cp, wd)[:2]))
    twin = []
    for p, n in ((rp, h), (cp, wd)):
        i0, w0, i1, w1 = K._tent_pair(p, n)
        twin.append(torch.cat([i0[w0 != 0], i1[w1 != 0]]))
    return tables, twin


def warp_tables(imgs, warps_t):
    """K2 from tables: the separable image over the frame plus a 1-pixel
    ring, rows first, then columns; then ``taylor_px``'s terms from the
    rows' and columns' displacements.  f32, rounded once to the images'
    dtype."""
    x = imgs.float()
    b, h, wd = x.shape
    out = torch.empty_like(x)
    ys = torch.arange(h, dtype=torch.float32)
    xs = torch.arange(wd, dtype=torch.float32)
    for i in range(b):
        w = warps_t[i]
        g = x[i]
        ri0, ri1, rw0, rw1 = tent(row_pos(w, torch.arange(-1, h + 1), wd), h)
        ci0, ci1, cw0, cw1 = tent(col_pos(w, torch.arange(-1, wd + 1), h), wd)
        t0 = rw0[:, None] * g[ri0][:, ci0] + rw1[:, None] * g[ri1][:, ci0]
        t1 = rw0[:, None] * g[ri0][:, ci1] + rw1[:, None] * g[ri1][:, ci1]
        sep = cw0[None] * t0 + cw1[None] * t1  # rows -1 .. h, columns -1 .. wd
        dx = (w[0, 1] * (ys - (h - 1) * 0.5))[:, None]  # the rows' (warped_at)
        dy = (w[1, 0] * (xs - (wd - 1) * 0.5))[None, :]  # the columns'
        inv_ax, inv_ay = 1.0 / w[0, 0], 1.0 / w[1, 1]
        ey = ((ys > 0) & (ys < h - 1))[:, None]
        ex = ((xs > 0) & (xs < wd - 1))[None, :]

        def s(dr, dc):
            return sep[1 + dr:1 + dr + h, 1 + dc:1 + dc + wd]

        zero = torch.zeros(())
        mc = s(0, 0)
        gx = torch.where(ex, 0.5 * (s(0, 1) - s(0, -1)) * inv_ax, zero)
        gxx = torch.where(ex, ((s(0, 1) - 2.0 * mc) + s(0, -1)) * inv_ax * inv_ax, zero)
        gy = torch.where(ey, 0.5 * (s(1, 0) - s(-1, 0)) * inv_ay, zero)
        gyy = torch.where(ey, ((s(1, 0) - 2.0 * mc) + s(-1, 0)) * inv_ay * inv_ay, zero)
        hxy = ((s(1, 1) - s(1, -1)) - s(-1, 1)) + s(-1, -1)
        gxy = torch.where(ex & ey, 0.25 * hxy * inv_ax * inv_ay, zero)
        v = (mc + dx * gx) + dy * gy
        out[i] = ((v + 0.5 * dx * dx * gxx) + dx * dy * gxy) + 0.5 * dy * dy * gyy
    return out.to(imgs.dtype)


def many_warps(seed, n):
    """Warps the window must span: scales of either sign up to 1.6, shears,
    translations up to 600 px (far off the image)."""
    rng = np.random.default_rng(seed)
    w = np.zeros((n, 2, 3), np.float32)
    w[:, 0, 0] = rng.choice([-1, 1], n) * rng.uniform(0.5, 1.6, n)
    w[:, 1, 1] = rng.choice([-1, 1], n) * rng.uniform(0.5, 1.6, n)
    w[:, 0, 1] = rng.uniform(-0.05, 0.05, n)
    w[:, 1, 0] = rng.uniform(-0.05, 0.05, n)
    w[:, :, 2] = rng.uniform(-600, 600, (n, 2)) * (rng.random((n, 1)) < 0.5)
    w[:3] = warps(seed, 3)  # near-identity ones too
    return torch.tensor(w)


def band_warps(seed, b, h, w):
    """``warps`` with the scale and shear cut in proportion on frames wider
    or taller than ~128 px, so every separable sample stays inside the JAX
    kernel's +-3 px band (``P.DEFAULT_BAND``)."""
    out = warps(seed, b)
    f = min(1.0, 128.0 / max(h, w))
    eye = np.eye(2, dtype=np.float32)
    out[:, :, :2] = eye + f * (out[:, :, :2] - eye)
    return out


@pytest.mark.parametrize("r", [0, 1, 3])
def test_window_span_from_the_ends(r):
    """The span from the tile's ends equals the min/max over all its
    table entries and holds every tap the twin weights, for every tile,
    negative scales and far translations included (r: K4's filter radius;
    K2's is 0)."""
    for _, h, wd in SHAPES:
        for w in many_warps(31 + r, 24):
            for ty0 in range(0, h, TY):
                for tx0 in range(0, wd, TX):
                    ty_n, tx_n = min(TY, h - ty0), min(TX, wd - tx0)
                    args = (w, h, wd, ty0 - r - 1, ty_n + 2 * r + 2, tx0 - r - 1,
                            tx_n + 2 * r + 2)
                    y0, y1, x0, x1 = window_from_ends(*args)
                    (rows, cols), (trows, tcols) = taps_of_tables(*args)
                    assert (y0, y1, x0, x1) == (int(rows.min()), int(rows.max()),
                                                int(cols.min()), int(cols.max()))
                    assert ((trows >= y0) & (trows <= y1)).all()
                    assert ((tcols >= x0) & (tcols <= x1)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tables_equal_twin(dtype):
    """Exactly the twin, on a 2.9 px shear of 1200-row frames and on the
    warps that take the kernels off their staged window (1.6x scale, 40 px
    translation, a mirror)."""
    dt = getattr(torch, dtype)
    cases = [((3, 1200, 131), shear_warps(30, 3, 1200, 131))]
    cases += [((2, 97, 131), far_warps(2, k)) for k in ("scale", "translate", "flip")]
    for shape, w in cases:
        xt = torch.tensor(images(33, *shape)).to(dt)
        got = warp_tables(xt, torch.tensor(w))
        assert got.dtype == dt
        assert torch.equal(got, K.warp_plain(xt, torch.tensor(w))), (shape, w)


def assert_close_to_jax(got, want, warp_np, base):
    """|got - want| within ``base`` (an array or a number) plus the slope
    bound of the JAX kernel's position rounding, plus the border bound
    where a sample straddles the zero border."""
    from scipy.ndimage import maximum_filter

    for i in range(got.shape[0]):
        gy, gx = np.gradient(want[i].astype(np.float64))
        slope = maximum_filter(np.abs(gx) + np.abs(gy), size=3)
        ulps = 4 * float(np.spacing(np.float32(max(got.shape[1:]))))
        bound = np.asarray(base[i] if np.ndim(base) else base) + ulps * slope
        edge = border_straddle(warp_np[i], *got.shape[1:])
        bound = np.where(edge, bound + ulps * np.abs(want[i]).max(), bound)
        d = np.abs(got[i].astype(np.float64) - want[i])
        assert (d <= bound).all(), (i, float((d / bound).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tables_match_jax_kernel(dtype):
    """Against ``_warp_banded_batched`` (interpret mode off-TPU) inside its
    band, on rows that are not 16-byte aligned (97, 131) and 1800 wide."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    for shape in SHAPES:
        x = images(32, *shape)
        w = band_warps(32, *shape)
        got = warp_tables(torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(w))
        want = np.asarray(P._warp_banded_batched(
            jnp.asarray(x, jdt), jnp.asarray(w), P.DEFAULT_BAND, 2,
            True).astype(jnp.float32))
        base = 1e-3 if dtype == "float32" else bf16_ulp(want)
        assert_close_to_jax(got.float().numpy(), want, w, base)
