"""K1's row-streamed blur against the plain twin and the JAX kernel.

``blur_kernel`` (upsp_tpu_torch/csrc/ecc.cu) does not filter a tile with a
staged halo.  A thread owns a few adjacent output columns of a strip of
rows and streams the strip's input rows top to bottom: its rows and R rows
above and below, reflected (reflect-101) when the row index is chosen, so a
strip's halo row may be another strip's row or a mirrored one.  It filters
each input row horizontally, reflecting at the row's ends, keeps the last
2R+1 filtered rows and sums them vertically into an output row, each pass
from tap 0 upwards.  ``blur_rows`` below is that algorithm in torch, strip
by strip (every column of a strip at once: a column's arithmetic does not
depend on its neighbours'), so the tests check the streaming and the
reflections at strip boundaries and image edges.

Tolerances and why:
- against the twin: exact.  Both multiply and add in f32 in the same
  order, one operation at a time (the kernel on the card rounds each
  product and sum on its own too, and the card tests hold it to the twin
  bit for bit);
- against the JAX kernel (interpret mode off-TPU): atol 1e-3 counts in f32,
  as tests/test_torch_ecc_kernels.py (XLA sums the taps its own way); in
  bf16 1 bf16 ulp (both compute in f32 and round once);
- the strip height changes nothing: exact.
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

from test_torch_cuda import GAUSS, assert_within_ulp, images  # noqa: E402

TAPS = {0: (1.0,), 1: GAUSS[3], 2: GAUSS[5], 3: GAUSS[7]}


def reflect101(i, n):
    return np.where(i < 0, -i, np.where(i >= n, 2 * (n - 1) - i, i))


def blur_rows(imgs, taps, strip):
    """K1's streaming in torch: f32, rounded once to the images' dtype."""
    x = imgs.float()
    _, h, w = x.shape
    k = len(taps)
    r = k // 2
    t = [float(v) for v in taps]
    xs = np.arange(w)
    cols = [torch.from_numpy(reflect101(xs - r + j, w)) for j in range(k)]
    out = torch.empty_like(x)
    for y0 in range(0, h, strip):
        nrows = min(strip, h - y0)
        ring = []  # the last k filtered rows, oldest first
        for j in range(nrows + 2 * r):
            row = x[:, int(reflect101(y0 - r + j, h)), :]
            acc = t[0] * row[:, cols[0]]
            for i in range(1, k):
                acc = acc + t[i] * row[:, cols[i]]
            ring = ring[-(k - 1):] + [acc] if k > 1 else [acc]
            if j >= 2 * r:  # output row y0 + j - 2r
                v = t[0] * ring[0]
                for i in range(1, k):
                    v = v + t[i] * ring[i]
                out[:, y0 + j - 2 * r] = v
    return out.to(imgs.dtype)


def jax_blur(x, taps, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return np.asarray(P._blur_batched(jnp.asarray(x, jdt), taps, True).astype(jnp.float32))


def assert_close_to_jax(got, x, taps, dtype):
    want = jax_blur(x, taps, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    else:
        assert_within_ulp(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_streamed_matches_twin_and_jax_kernel(dtype):
    """Every R from 0 to 3 on heights the strip does not divide, rows not
    16-byte aligned (97, 131) and 1800 wide."""
    dt = getattr(torch, dtype)
    for shape, strip in [((2, 90, 97), 11), ((2, 97, 131), 25), ((1, 23, 1800), 7)]:
        for r, taps in TAPS.items():
            x = images(40 + r, *shape)
            xt = torch.tensor(x).to(dt)
            got = blur_rows(xt, taps, strip)
            assert got.dtype == dt
            assert torch.equal(got, K.blur_plain(xt, taps)), (shape, r)
            assert_close_to_jax(got, x, taps, dtype)


def test_strips_change_nothing():
    """Strips of 1 row (every halo row is another strip's or a mirrored
    one), of R rows, of 5 and of the whole frame give the same image, for
    every R from 0 to 3."""
    for r, taps in TAPS.items():
        x = torch.tensor(images(50 + r, 2, 37, 131))
        want = K.blur_plain(x, taps)
        for strip in sorted({1, max(r, 1), 5, 37}):
            assert torch.equal(blur_rows(x, taps, strip), want), (r, strip)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smallest_images(dtype):
    """H or W = R + 1, the least the wrapper takes: the reflected rows and
    columns reach across the whole image."""
    dt = getattr(torch, dtype)
    for r, taps in TAPS.items():
        for shape in [(2, r + 1, r + 1), (2, r + 1, 97), (2, 45, r + 1), (1, 2, 2)]:
            if min(shape[1:]) <= r:
                continue
            x = images(60 + r, *shape)
            xt = torch.tensor(x).to(dt)
            got = blur_rows(xt, taps, 1)
            assert torch.equal(got, K.blur_plain(xt, taps)), (shape, r)
            assert_close_to_jax(got, x, taps, dtype)
