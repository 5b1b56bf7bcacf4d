"""The hand-written CUDA kernels against their plain twins, on the card.

K1-K4, K6 and K9 compare within the stated bounds (K6, like K5, K7 and K8,
exactly: they only select, shift bits and multiply once; K1 also exactly:
it rounds each product and sum as its twin does).  The bfloat16
instantiations of K1, K2 and K4 hold their twins to 1 bf16 ulp of the
output (both compute in f32 and round once; the f32 sums may straddle one
rounding boundary), K3 and K9 to 2e-4 relative, K5 exactly.

Marked ``cuda``; skips where torch has no CUDA device (the kernels have no
CPU mode).  This file imports no jax, so it also runs on a machine with
only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

It also holds the seeded inputs and the image and statistics tolerances
shared with tests/test_torch_ecc_kernels.py, test_torch_bf16.py and
test_torch_gn_fused.py.
"""

import numpy as np
import pytest
import torch

from upsp_tpu_torch.ops import ecc_kernels as K

SHAPES = [(2, 96, 128), (2, 97, 131)]
GAUSS = {
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}
BOX5 = tuple(1.0 / 5 for _ in range(5))


def images(seed, b, h, w):
    """Blobs + fine texture on a 2000-count floor, float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((b, h, w), np.float32)
    for i in range(b):
        img = 2000.0 + 150.0 * np.sin(xx / 3.3 + i) * np.cos(yy / 4.1)
        for _ in range(10):
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            s = rng.uniform(3, 10)
            img += rng.uniform(-600, 900) * np.exp(
                -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)
            )
        out[i] = img
    return out


def warps(seed, b):
    """Shear/scale warps with displacements <= 2 px over a ~128 px image."""
    rng = np.random.default_rng(seed)
    w = np.zeros((b, 2, 3), np.float32)
    w[:, 0, 0] = 1 + rng.uniform(-4e-3, 4e-3, b)
    w[:, 1, 1] = 1 + rng.uniform(-4e-3, 4e-3, b)
    w[:, 0, 1] = rng.uniform(-4e-3, 4e-3, b)
    w[:, 1, 0] = rng.uniform(-4e-3, 4e-3, b)
    w[:, :, 2] = rng.uniform(-1.2, 1.2, (b, 2))
    return w


def shear_warps(seed, b, h, w, px=2.9):
    """``warps`` with a shear that moves the frame's corners by ``px`` in x
    and in y (inside the TPU kernel's +-3 px band): there the Taylor terms
    reach thousands of counts and cancel, so their rounding order shows."""
    out = warps(seed, b)
    out[:, 0, 1] = np.sign(out[:, 0, 1]) * px / max((h - 1) / 2, 1)
    out[:, 1, 0] = np.sign(out[:, 1, 0]) * px / max((w - 1) / 2, 1)
    return out


def border_straddle(warp, h, w, halo=0):
    """(H, W) bool: pixels whose separable sample (or a Taylor neighbour,
    or a filter tap within ``halo``) has a tent tap outside the image."""
    a00, a01, tx = warp[0]
    a10, a11, ty = warp[1]
    ys = a11 * np.arange(h) + ty + a10 * (w - 1) * 0.5
    xs = a00 * np.arange(w) + tx + a01 * (h - 1) * 0.5
    ry = (ys < 1.0) | (ys > h - 2.0)
    rx = (xs < 1.0) | (xs > w - 2.0)
    for _ in range(halo + 1):
        ry = ry | np.roll(ry, 1) | np.roll(ry, -1)
        rx = rx | np.roll(rx, 1) | np.roll(rx, -1)
    return ry[:, None] | rx[None, :]


def assert_images_close(got, want, warp_np, atol=1e-3, halo=0):
    """atol inside; at border-straddling pixels, the position-rounding bound
    (4 ulps of a coordinate ~ image size, times the pixel value)."""
    for i in range(got.shape[0]):
        edge = border_straddle(warp_np[i], *got.shape[1:], halo=halo)
        d = np.abs(got[i] - want[i])
        assert d[~edge].max(initial=0.0) <= atol, d[~edge].max(initial=0.0)
        bound = 4 * np.spacing(np.float32(max(got.shape[1:]))) * np.abs(want[i]).max()
        assert d[edge].max(initial=0.0) <= bound + atol


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(3, 1024, 1024)])
def test_kernels_match_twins_on_card(cuda, shape):
    x = torch.tensor(images(8, *shape))
    tm = torch.tensor(images(9, 1, *shape[1:])[0])
    w = torch.tensor(warps(8, shape[0]))
    mw = w.clone()
    mw[:, :, 2] += torch.tensor([1.0, -2.0])
    c = [t.to(cuda) for t in (x, tm, w, mw)]
    before = K.launch_counts()
    np.testing.assert_allclose(K.blur(c[0], GAUSS[5]).cpu(), K.blur_plain(x, GAUSS[5]),
                               atol=2e-3, rtol=0)
    assert_images_close(K.warp_affine_banded(c[0], c[2]).cpu().numpy(),
                        K.warp_plain(x, w).numpy(), w.numpy(), atol=2e-3)
    for taps in (GAUSS[3], GAUSS[7]):
        o, iw = K.warp_filter(c[0], c[2], taps, with_warped=True)
        po, piw = K.warp_filter_plain(x, w, taps, True)
        assert_images_close(o.cpu().numpy(), po.numpy(), w.numpy(), atol=2e-3,
                            halo=len(taps) // 2)
        assert_images_close(iw.cpu().numpy(), piw.numpy(), w.numpy(), atol=2e-3)
    got = K.ecc_gn_moments(*c).cpu().numpy()
    want = K.moments_plain(x, tm, w, mw).numpy()
    scale = np.abs(want[:, :42]).max(axis=1, keepdims=True)
    np.testing.assert_array_less(np.abs(got[:, :42] - want[:, :42]),
                                 2e-4 * np.abs(want[:, :42]) + 1e-5 * scale)
    hot = x.clone()
    hot[0, 0, 0] = hot[0, -1, 7] = hot[-1, 9, 9] = 4095.0  # repaired
    hot[1, 3:9, 5] = 4095.0  # 6 > 5: left as it is
    np.testing.assert_array_equal(K.fix_hot_pixels_kernel(hot.to(cuda)).cpu(),
                                  K.fix_hot_pixels(hot))
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert all(after[k] > before[k]
               for k in ("blur", "warp", "moments", "warp_filter", "hot"))


def bf16_ulp(x):
    """The spacing of bfloat16 (8 significant bits) at |x|."""
    a = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def assert_within_ulp(got, want, warp_np=None, halo=0):
    """|got - want| <= 1 bf16 ulp of ``want`` (float arrays); at
    border-straddling pixels the f32 position-rounding bound on top."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    for i in range(got.shape[0]):
        d = np.abs(got[i] - want[i])
        bound = bf16_ulp(want[i])
        if warp_np is not None:
            edge = border_straddle(warp_np[i], *got.shape[1:], halo=halo)
            pos = 4 * np.spacing(np.float32(max(got.shape[1:]))) * np.abs(want[i]).max()
            bound = np.where(edge, bound + pos, bound)
        assert (d <= bound).all(), (i, float((d / bound).max()))


GROUPS = [(0, 18), (18, 24), (24, 30), (30, 36), (36, 37), (37, 39), (39, 42)]


def assert_stats_close(got, want, tmpl):
    """The 42 statistics within 2e-4 relative per group, with a floor of
    2e-4 of the group's largest member (f32 reduction order).  S_t and S_i
    sum brightness-shifted values that nearly cancel, and each side takes
    the shift mean(tmpl) in f32 in its own order (a few ulps apart), so
    those two also get area x 8 f32 ulps of the shift."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert not got[..., 42:].any()
    shift_ulps = want[..., 36:37] * 8 * np.spacing(np.float32(np.mean(tmpl)))
    for lo, hi in GROUPS:
        scale = np.abs(want[..., lo:hi]).max(axis=-1, keepdims=True)
        err = np.abs(got[..., lo:hi] - want[..., lo:hi])
        bound = 2e-4 * np.abs(want[..., lo:hi]) + 2e-4 * scale
        if lo == 37:
            bound = bound + shift_ulps
        assert (err <= bound).all(), (lo, hi, float(err.max()))


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(3, 1024, 1024), (2, 1200, 1800)])
def test_bf16_kernels_match_twins_on_card(cuda, shape):
    x = torch.tensor(images(18, *shape)).to(torch.bfloat16)
    tm = torch.tensor(images(19, 1, *shape[1:])[0]).to(torch.bfloat16)
    w = torch.tensor(warps(18, shape[0]))
    mw = w.clone()
    mw[:, :, 2] += torch.tensor([1.0, -2.0])
    c = [t.to(cuda) for t in (x, tm, w, mw)]
    before = K.launch_counts()
    got = K.blur(c[0], GAUSS[5])
    assert got.dtype == torch.bfloat16
    assert_within_ulp(_np(got), _np(K.blur_plain(x, GAUSS[5])))
    assert_within_ulp(_np(K.warp_affine_banded(c[0], c[2])), _np(K.warp_plain(x, w)),
                      w.numpy())
    for taps in (GAUSS[3], GAUSS[7]):
        o, iw = K.warp_filter(c[0], c[2], taps, with_warped=True)
        po, piw = K.warp_filter_plain(x, w, taps, True)
        assert_within_ulp(_np(o), _np(po), w.numpy(), halo=len(taps) // 2)
        assert_within_ulp(_np(iw), _np(piw), w.numpy())
    t = _np(tm)
    assert_stats_close(_np(K.ecc_gn_moments(*c)), _np(K.moments_plain(x, tm, w, mw)), t)
    assert_stats_close(_np(K.ecc_gn_fused(*c)), _np(K.gn_fused_plain(x, tm, w, mw)), t)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert all(after[f"{k}_bf16"] > before[f"{k}_bf16"] for k in K.TYPED)


@pytest.mark.cuda
@pytest.mark.parametrize("shear", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(2, 90, 131), (2, 90, 4100),
                                            (8, 1200, 1800), (3, 1024, 1024)])
def test_gn_fused_matches_twin_and_split_pair_on_card(cuda, shape, shear):
    """K9 in f32 against its twin and against K2 then K3 on the card, also
    on a shear that moves the frame's corners by 2.9 px; the heights 90, 97
    and 1200 are not multiples of its 32-row chunk, and the widths 131,
    1800 and 4100 not of its strip; bit-identical from call to call, and a
    frame's statistics do not depend on its batch."""
    x = torch.tensor(images(20, *shape))
    tm = torch.tensor(images(21, 1, *shape[1:])[0])
    w = torch.tensor(shear_warps(20, *shape) if shear else warps(20, shape[0]))
    mw = w.clone()
    mw[:, :, 2] += torch.tensor([2.0, -1.0])
    c = [t.to(cuda) for t in (x, tm, w, mw)]
    kshift = K.template_shift(c[1])
    before = K.launch_counts()["gn_fused"]
    got = K.ecc_gn_fused(*c, kshift)
    assert torch.equal(got, K.ecc_gn_fused(*c, kshift))
    one = K.ecc_gn_fused(c[0][1:2], c[1], c[2][1:2], c[3][1:2], kshift)
    assert torch.equal(got[1:2], one)
    got = _np(got)
    assert_stats_close(got, _np(K.gn_fused_plain(x, tm, w, mw)), tm.numpy())
    split = K.ecc_gn_moments(K.warp_affine_banded(c[0], c[2]), c[1], c[2], c[3])
    assert_stats_close(got, _np(split), tm.numpy())
    torch.cuda.synchronize()
    assert K.launch_counts()["gn_fused"] == before + 3


def clipped_mask_warps(b, h, w):
    """Mask warps scaled by 1.06 about the image centre, so the valid
    rectangle is clipped on all four sides."""
    mw = np.zeros((b, 2, 3), np.float32)
    mw[:, 0, 0] = mw[:, 1, 1] = 1.06
    mw[:, 0, 2] = -0.03 * (w - 1) + np.arange(b)
    mw[:, 1, 2] = -0.03 * (h - 1) - np.arange(b)
    return mw


UNALIGNED = [(2, 90, 131), (2, 97, 97), (3, 1200, 131)]
# rows wider than K3's 2048-column chunk: two and three unequal chunks
# (1301 + 1300, 1367 + 1367 + 1366 columns)
WIDE = [(2, 97, 2601), (2, 90, 4100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", UNALIGNED + WIDE)
def test_moments_unaligned_rows_clipped_mask_on_card(cuda, shape, dtype):
    """K3 on rows that are not 16-byte aligned (W = 97, 131), heights its
    37-row strips do not divide (90, 97, 1200) and rows split into column
    chunks (W = 2601, 4100), under a mask warp clipped on all four sides
    and under the path's integer pre-shift; two calls give bit-identical
    statistics, and a frame's statistics do not depend on its batch."""
    dt = getattr(torch, dtype)
    x = torch.tensor(images(22, *shape)).to(dt)
    tm = torch.tensor(images(23, 1, *shape[1:])[0]).to(dt)
    w = torch.tensor(warps(22, shape[0]))
    shifted = w.clone()
    shifted[:, :, 2] += torch.tensor([1.0, -2.0])
    for mw in (torch.tensor(clipped_mask_warps(*shape)), shifted):
        c = [t.to(cuda) for t in (x, tm, w, mw)]
        got = K.ecc_gn_moments(*c)
        assert torch.equal(got, K.ecc_gn_moments(*c))
        one = K.ecc_gn_moments(c[0][1:2], c[1], c[2][1:2], c[3][1:2])
        assert torch.equal(got[1:2], one)
        assert_stats_close(_np(got), _np(K.moments_plain(x, tm, w, mw)), _np(tm))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", UNALIGNED)
@pytest.mark.parametrize("taps", [(1.0,), GAUSS[3], GAUSS[5], GAUSS[7]])
def test_warp_filter_unaligned_rows_on_card(cuda, shape, dtype, taps):
    """K4 (both outputs) where rows are not 16-byte aligned and the 32x128
    tile divides neither side, for every filter radius."""
    dt = getattr(torch, dtype)
    x = torch.tensor(images(24, *shape)).to(dt)
    w = torch.tensor(warps(24, shape[0]))
    o, iw = K.warp_filter(x.to(cuda), w.to(cuda), taps, with_warped=True)
    assert torch.equal(o, K.warp_filter(x.to(cuda), w.to(cuda), taps))
    po, piw = K.warp_filter_plain(x, w, taps, True)
    halo = len(taps) // 2
    if dt == torch.float32:
        assert_images_close(_np(o), _np(po), w.numpy(), atol=2e-3, halo=halo)
        assert_images_close(_np(iw), _np(piw), w.numpy(), atol=2e-3)
    else:
        assert_within_ulp(_np(o), _np(po), w.numpy(), halo=halo)
        assert_within_ulp(_np(iw), _np(piw), w.numpy())


def far_warps(b, kind):
    """Warps K2 and K4 must handle off their staged-window route on a 97 x
    131 image: a 1.6x scale (the source window outgrows the block's budget,
    so the taps come from global memory), a 40 px translation (the window
    runs off the image) and a mirror (negative scales: the window's span
    comes from the tile's other ends)."""
    w = warps(25, b)
    if kind == "scale":
        w[:, 0, 0] = w[:, 1, 1] = 1.6
        w[:, :, 2] -= 20.0
    elif kind == "translate":
        w[:, :, 2] += np.array([40.0, -40.0], np.float32)
    else:
        w[:, 0, 0] = w[:, 1, 1] = -1.0
        w[:, :, 2] += np.array([130.0, 96.0], np.float32)
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["scale", "translate", "flip"])
def test_warp_filter_global_route_on_card(cuda, kind, dtype):
    shape = (2, 97, 131)
    dt = getattr(torch, dtype)
    x = torch.tensor(images(25, *shape)).to(dt)
    w = torch.tensor(far_warps(shape[0], kind))
    o, iw = K.warp_filter(x.to(cuda), w.to(cuda), GAUSS[3], with_warped=True)
    po, piw = K.warp_filter_plain(x, w, GAUSS[3], True)
    if dt == torch.float32:
        assert_images_close(_np(o), _np(po), w.numpy(), atol=2e-3, halo=1)
        assert_images_close(_np(iw), _np(piw), w.numpy(), atol=2e-3)
    else:
        assert_within_ulp(_np(o), _np(po), w.numpy(), halo=1)
        assert_within_ulp(_np(iw), _np(piw), w.numpy())


def assert_image_kernel_close(got, want, dt, warp_np=None):
    """f32 within 2e-3 counts (warps: the border allowance on top), bf16
    within 1 bf16 ulp of the twin (both compute in f32 and round once)."""
    if dt == torch.float32:
        if warp_np is None:
            np.testing.assert_allclose(_np(got), _np(want), atol=2e-3, rtol=0)
        else:
            assert_images_close(_np(got), _np(want), warp_np, atol=2e-3)
    else:
        assert_within_ulp(_np(got), _np(want), warp_np)


TAPS = [(1.0,), GAUSS[3], GAUSS[5], GAUSS[7]]
# rows 1800 and 2601 wide: K1's last group of columns is partial
BLUR_WIDE = [(2, 64, 1800), (2, 37, 2601)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", UNALIGNED + BLUR_WIDE)
@pytest.mark.parametrize("taps", TAPS)
def test_blur_unaligned_rows_every_radius_on_card(cuda, shape, dtype, taps):
    """K1 where rows are not 16-byte aligned (W = 97, 131), heights its
    strips do not divide, partial column groups, every tap count;
    bit-identical from call to call."""
    dt = getattr(torch, dtype)
    x = torch.tensor(images(26, *shape)).to(dt)
    before = K.launch_counts()
    got = K.blur(x.to(cuda), taps)
    assert torch.equal(got, K.blur(x.to(cuda), taps))
    assert_image_kernel_close(got, K.blur_plain(x, taps), dt)
    assert torch.equal(got.cpu(), K.blur_plain(x, taps))  # bit for bit
    torch.cuda.synchronize()
    name = "blur" if dt == torch.float32 else "blur_bf16"
    assert K.launch_counts()[name] == before[name] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("taps", TAPS)
def test_blur_smallest_images_on_card(cuda, dtype, taps):
    """K1 at H or W = R + 1, the least the wrapper takes: the reflected
    rows and columns reach across the whole image."""
    dt = getattr(torch, dtype)
    r = len(taps) // 2
    for shape in [(3, r + 1, r + 1), (2, r + 1, 97), (2, 131, r + 1), (1, 2, 2)]:
        if min(shape[1:]) <= r:
            continue
        x = torch.tensor(images(27, *shape)).to(dt)
        got = K.blur(x.to(cuda), taps)
        assert_image_kernel_close(got, K.blur_plain(x, taps), dt)
        assert torch.equal(got.cpu(), K.blur_plain(x, taps))  # bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", UNALIGNED + [(2, 64, 1800), (1, 1, 1), (2, 2, 133)])
def test_warp_unaligned_rows_on_card(cuda, shape, dtype):
    """K2 where rows are not 16-byte aligned and its 32x128 tile divides
    neither side; bit-identical from call to call."""
    dt = getattr(torch, dtype)
    x = torch.tensor(images(28, *shape)).to(dt)
    w = torch.tensor(warps(28, shape[0]))
    got = K.warp_affine_banded(x.to(cuda), w.to(cuda))
    assert torch.equal(got, K.warp_affine_banded(x.to(cuda), w.to(cuda)))
    assert_image_kernel_close(got, K.warp_plain(x, w), dt, w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 1200, 131), (2, 1200, 1800)])
def test_warp_large_shear_on_card(cuda, shape, dtype):
    """K2 and K4's warped output on 1200-row frames whose corners a shear
    moves by 2.9 px, within 2e-3 counts in f32."""
    dt = getattr(torch, dtype)
    x = torch.tensor(images(30, *shape)).to(dt)
    w = torch.tensor(shear_warps(30, *shape))
    got = K.warp_affine_banded(x.to(cuda), w.to(cuda))
    assert torch.equal(got, K.warp_affine_banded(x.to(cuda), w.to(cuda)))
    assert_image_kernel_close(got, K.warp_plain(x, w), dt, w.numpy())
    _, iw = K.warp_filter(x.to(cuda), w.to(cuda), GAUSS[3], with_warped=True)
    _, piw = K.warp_filter_plain(x, w, GAUSS[3], True)
    assert_image_kernel_close(iw, piw, dt, w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["scale", "translate", "flip"])
def test_gn_fused_far_warps_on_card(cuda, kind, dtype):
    """K9 off its staged windows (a 1.6x scale: every strip takes the
    global-memory route), with windows that run off the image (40 px) and
    with negative scales (a mirror), against its twin."""
    shape = (2, 97, 131)
    dt = getattr(torch, dtype)
    x = torch.tensor(images(31, *shape)).to(dt)
    tm = torch.tensor(images(32, 1, *shape[1:])[0]).to(dt)
    w = torch.tensor(far_warps(shape[0], kind))
    c = [t.to(cuda) for t in (x, tm, w, w)]
    assert_stats_close(_np(K.ecc_gn_fused(*c)), _np(K.gn_fused_plain(x, tm, w, w)),
                       _np(tm))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["scale", "translate", "flip"])
def test_warp_global_route_on_card(cuda, kind, dtype):
    shape = (2, 97, 131)
    dt = getattr(torch, dtype)
    x = torch.tensor(images(29, *shape)).to(dt)
    w = torch.tensor(far_warps(shape[0], kind))
    got = K.warp_affine_banded(x.to(cuda), w.to(cuda))
    assert torch.equal(got, K.warp_affine_banded(x.to(cuda), w.to(cuda)))
    assert_image_kernel_close(got, K.warp_plain(x, w), dt, w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n_bytes", [15, 3 * 5 * 257 * 256 + 7])
def test_unpack_kernels_match_twins_on_card(cuda, n_bytes):
    from upsp_tpu_torch.io.video.cine import LUT_10_TO_12
    from upsp_tpu_torch.ops import unpack_kernels as U

    b = torch.from_numpy(np.random.default_rng(n_bytes).integers(
        0, 256, n_bytes).astype(np.uint8))
    lut = torch.from_numpy(LUT_10_TO_12.astype(np.float32))
    before = K.launch_counts()
    np.testing.assert_array_equal(U.unpack_12bpp(b.to(cuda)).cpu(), U.unpack_12bpp_plain(b))
    np.testing.assert_array_equal(U.unpack_10bpp(b.to(cuda)).cpu(), U.unpack_10bpp_plain(b))
    np.testing.assert_array_equal(U.unpack_10bpp(b.to(cuda), lut.to(cuda)).cpu(),
                                  U.unpack_10bpp_plain(b, lut))
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["unpack12"] == before["unpack12"] + 1
    assert after["unpack10"] == before["unpack10"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes,frames", [(1000, 1), (200_000, 3)])
def test_gather_kernel_matches_twin_on_card(cuda, n_nodes, frames):
    from upsp_tpu_torch.ops import gather_kernels as G

    rng = np.random.default_rng(n_nodes)
    n_pixels = 3 * 97 * 131
    idx = rng.integers(0, n_pixels, n_nodes)
    w = rng.random(n_nodes).astype(np.float32)
    w[rng.random(n_nodes) < 0.3] = 0.0
    sup = np.arange(n_nodes)
    sup[::7] = rng.integers(0, n_nodes, sup[::7].size)
    skipped = rng.random(n_nodes) < 0.05
    plan = G.build_gather_plan(idx, w, skipped, sup, (), n_pixels)
    on_card = G.build_gather_plan(idx, w, skipped, sup, (), n_pixels, device=cuda)
    x = torch.from_numpy(rng.normal(2000, 300, (frames, n_pixels)).astype(np.float32))
    before = K.launch_counts()
    for xs in (x, x.to(torch.bfloat16)):
        got = G.project_gather(xs.to(cuda), on_card).cpu().numpy()
        want = G.gather_plain(xs, plan).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[~np.isnan(want)], want[~np.isnan(want)])
    after = K.launch_counts()
    assert after["gather"] == before["gather"] + 1
    assert after["gather_bf16"] == before["gather_bf16"] + 1


def hot_frames(h, w):
    """Frames of ``images`` with hot pixels (4095): 0, max_hot and max_hot
    + 1 of them, on corners, edges and either side of 16-byte vector and
    4096-pixel tile boundaries; adjacent pairs; a NaN neighbour; and an
    all-saturated frame."""
    x = torch.tensor(images(40, 8, h, w))
    hw = h * w
    flat = [0, w - 1, hw - w, hw - 1, 3, 4, 4095, 4096, hw // 2 - 1, hw // 2]
    for k, n in enumerate([0, 5, 6]):
        x[k].view(-1)[torch.tensor(flat[:n], dtype=torch.long)] = 4095.0
    x[3].view(-1)[torch.tensor([w + 3, w + 4, 2 * w + 4])] = 4095.0  # adjacent
    x[4, 5, 7] = 4095.0
    x[4, 5, 8] = float("nan")  # its right neighbour
    x[5] = 4095.0  # every pixel a candidate: left as it is
    x[6].view(-1)[torch.tensor(flat[4:8])] = 4095.0  # vector, tile boundaries
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 130), (97, 131), (1200, 1800), (1, 7)])
def test_hot_one_pass_on_card(cuda, shape):
    """K6's streaming pass and per-frame repair: hot pixels at 0, max_hot
    and max_hot + 1 per frame, adjacent ones, a NaN neighbour, an
    all-saturated frame; frames whose pixel count is and is not a multiple
    of 4 (the vector and the scalar route), several tiles a block, and a
    frame the size of one row; exact and bit-identical call to call."""
    if shape == (1, 7):
        x = 2000.0 + torch.arange(21, dtype=torch.float32).reshape(3, 1, 7)
        x[0, 0, 3] = x[1, 0, 0] = x[1, 0, 6] = 4095.0
        x[2] = 4095.0
    else:
        x = hot_frames(*shape)
    before = K.launch_counts()["hot"]
    got = K.fix_hot_pixels_kernel(x.to(cuda))
    again = K.fix_hot_pixels_kernel(x.to(cuda))
    want = K.fix_hot_pixels(x)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert ((want != x) & ~torch.isnan(x)).any()  # something was repaired
    torch.cuda.synchronize()
    assert K.launch_counts()["hot"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n_cams", [1, 4])
def test_gather_tiles_per_camera_on_card(cuda, n_cams):
    """K5 from C (B, H, W) camera images in place and from one stack: a
    partial last tile, an all-NaN tile, copies across tiles, f32 and bf16
    frames; exact, NaN at the same entries, and the stack's result equal
    to the cameras'."""
    from upsp_tpu_torch.ops import gather_kernels as G

    t = G.GATHER_TILE
    h, w = 37, 131
    n = 4 * t + 77
    rng = np.random.default_rng(50 + n_cams)
    idx = rng.integers(0, n_cams * h * w, n)
    wt = rng.random(n).astype(np.float32)
    wt[rng.random(n) < 0.2] = 0.0
    sup = np.arange(n)
    sup[t - 1], sup[3 * t + 5], sup[::11] = 2 * t + 9, 7, sup[::11] + 1
    sup = np.minimum(sup, n - 1)
    skipped = rng.random(n) < 0.03
    skipped[sup[t:2 * t]] = True  # tile 1 all NaN
    on_card = G.build_gather_plan(idx, wt, skipped, sup, (), n_cams * h * w,
                                  device=cuda)
    plan = G.build_gather_plan(idx, wt, skipped, sup, (), n_cams * h * w)
    x = torch.from_numpy(rng.normal(2000, 300, (3, n_cams, h, w)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        cams = [x[:, c].to(dt).contiguous() for c in range(n_cams)]
        want = G.gather_plain(cams, plan).numpy()
        assert np.isnan(want[:, t:2 * t]).all()
        got = G.project_gather([c.to(cuda) for c in cams], on_card).cpu().numpy()
        stacked = G.project_gather(x.to(dt).reshape(3, -1).to(cuda), on_card)
        for g in (got, stacked.cpu().numpy()):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
            np.testing.assert_array_equal(g[~np.isnan(want)], want[~np.isnan(want)])


# ---------------------------------------------------------------------------
# the while-loop ECC and the registration helpers on the card


def ecc_scenes(seed, b, h, w):
    """(template, (b, h, w) frames) of one broadband field
    (``pipeline/synthetic``), frame k shifted by up to 3 px; the last
    frame is noise (it never converges at a tight epsilon)."""
    from upsp_tpu_torch.pipeline.synthetic import scene_spectrum, shift_field

    rng = np.random.default_rng(seed)
    spec = scene_spectrum(rng, (h, w))
    shifts = rng.uniform(-3.0, 3.0, (b, 2))
    frames = np.stack([2000.0 + shift_field(spec, (h, w), dx, dy) for dx, dy in shifts])
    frames[-1] = rng.normal(2000.0, 300.0, (h, w))
    return (2000.0 + shift_field(spec, (h, w), 0.0, 0.0)).astype(np.float32), \
        frames.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_while_loop_on_card(cuda, dtype):
    """The while loop's K1-K3 solve on the card: each lane of a batch of 8
    equals its single-frame solve bit for bit, the lanes stopping at
    different steps (epsilon 3e-6) and the noise lane at the cap (set one
    below the step its uncapped solve stops at, so it is reached whatever
    that step is); and the converging lanes match the CPU twins (rho atol
    1e-3, translations 0.05 px, counts within one, equal on most).  The
    noise lane is left out there: it never converges, so its path follows
    its rounding."""
    from upsp_tpu_torch.ops import registration as R

    dt = getattr(torch, dtype)
    ref, frames = ecc_scenes(31, 8, 240, 320)
    r, f = torch.tensor(ref).to(dt), torch.tensor(frames).to(dt)
    before = K.launch_counts()
    cap = int(R.ecc_affine(r.to(cuda), f.to(cuda), epsilon=3e-6,
                           return_iters=True)[2].max()) - 1
    kw = dict(epsilon=3e-6, max_iters=cap, return_iters=True)
    warp, rho, iters = R.ecc_affine(r.to(cuda), f.to(cuda), **kw)
    after = K.launch_counts()
    sfx = "" if dtype == "float32" else "_bf16"
    assert all(after[k + sfx] > before[k + sfx]
               for k in ("blur", "warp", "moments_update"))
    assert int(iters[-1]) == cap > int(iters[:-1].max()), iters.tolist()
    assert len(set(iters.tolist())) >= 3, iters.tolist()
    for i in range(8):
        w1, r1, n1 = R.ecc_affine(r.to(cuda), f[i : i + 1].to(cuda), **kw)
        assert torch.equal(w1[0], warp[i]) and torch.equal(r1[0], rho[i])
        assert int(n1[0]) == int(iters[i])
    c_warp, c_rho, c_iters = R.ecc_affine(r, f, **kw)
    n, cn = iters.cpu().numpy()[:-1], c_iters.numpy()[:-1]
    assert np.abs(n - cn).max() <= 1 and (n != cn).sum() <= 2
    ok = n == cn  # a lane one step apart differs by that step
    np.testing.assert_allclose(warp.cpu().numpy()[:-1][ok][:, :, 2],
                               c_warp.numpy()[:-1][ok][:, :, 2], atol=0.05)
    np.testing.assert_allclose(rho.cpu().numpy()[:-1][ok], c_rho.numpy()[:-1][ok],
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 1024, 1024), (2, 1200, 1800)])
def test_warp_and_moments_translated_40px_on_card(cuda, shape, dtype):
    """K2 and K3 on what the while loop feeds them from identity: warps
    that translate by 40 px in x and -25 px in y with a small rotation, no
    pre-shift (the mask warp is the warp), so strips tens of pixels wide
    leave the mask and some of K3's row blocks are masked whole."""
    dt = getattr(torch, dtype)
    b, h, w = shape
    x = torch.tensor(images(40, *shape)).to(dt)
    tm = torch.tensor(images(41, 1, h, w)[0]).to(dt)
    wn = warps(40, b)
    wn[:, :, 2] += np.array([40.0, -25.0], np.float32)
    wp = torch.tensor(wn)
    got = K.warp_affine_banded(x.to(cuda), wp.to(cuda))
    want = K.warp_plain(x, wp)
    if dtype == "float32":
        assert_images_close(_np(got), _np(want), wn, atol=2e-3)
    else:
        assert_within_ulp(_np(got), _np(want), wn)
    assert_stats_close(K.ecc_gn_moments(x.to(cuda), tm.to(cuda), wp.to(cuda),
                                        wp.to(cuda)).cpu(),
                       K.moments_plain(x, tm, wp, wp), _np(tm))


@pytest.mark.cuda
def test_coarse_stage_and_warp_affine_on_card(cuda):
    """The coarse stage (K1-K3 at 600x900, whose rows end in partial
    tiles) against the CPU twins; the gather warp equal to its CPU run
    (nearest exactly)."""
    from upsp_tpu_torch.ops import registration as R

    ref, frames = ecc_scenes(32, 2, 1200, 1800)
    init = torch.tensor(np.tile(np.array([[1.0, 0.0, 0.3], [0.0, 1.0, -0.2]],
                                         np.float32), (2, 1, 1)))
    args = dict(max_iters=2, unroll=True, coarse_iters=1)
    gw, grho = R.ecc_affine(torch.tensor(ref).to(cuda), torch.tensor(frames).to(cuda),
                            warp_init=init.to(cuda), **args)
    cw, crho = R.ecc_affine(torch.tensor(ref), torch.tensor(frames), warp_init=init,
                            **args)
    np.testing.assert_allclose(gw.cpu().numpy()[:, :, 2], cw.numpy()[:, :, 2], atol=0.05)
    np.testing.assert_allclose(gw.cpu().numpy()[:, :, :2], cw.numpy()[:, :, :2], atol=1e-3)
    np.testing.assert_allclose(grho.cpu().numpy(), crho.numpy(), atol=1e-3)
    wp = torch.tensor(warps(33, 2)) + torch.tensor([[0, 0, 40.0], [0, 0, -25.0]])
    x = torch.tensor(frames)
    assert torch.equal(R.warp_affine(x.to(cuda), wp.to(cuda), "nearest").cpu(),
                       R.warp_affine(x, wp, "nearest"))
    np.testing.assert_allclose(R.warp_affine(x.to(cuda), wp.to(cuda)).cpu(),
                               R.warp_affine(x, wp), atol=2e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k", [((3, 96, 128), 2), ((2, 130, 197), 2),
                                     ((2, 97, 131), 4), ((2, 1200, 1800), 4),
                                     ((1, 1024, 1024), 8), ((2, 60, 75), 3)])
def test_pool_kernel_matches_twin_on_card(cuda, shape, k, dtype):
    """K10 (the phase correlation's k x k pooling) equals its plain twin
    bit for bit: unrolled (k = 2, 4, 8) and generic (k = 3), H or W not a
    multiple of k, bf16 frames widened on load; on a camera's strided
    slice of a (B, C, H, W) chunk and on a crop (rows longer than their
    pixels); a frame alone as in its batch."""
    from upsp_tpu_torch.ops import fftreg as TF

    x = torch.tensor(images(21, *shape)).to(getattr(torch, dtype))
    before = K.launch_counts()
    got = TF.decimate_image(x.to(cuda), k)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu(), TF.decimate_plain(x, k))
    y = x + 1
    chunk = torch.stack([x, y], dim=1).to(cuda)
    assert torch.equal(TF.decimate_image(chunk[:, 1], k).cpu(), TF.decimate_plain(y, k))
    crop = x[..., 1:, 2:]
    assert torch.equal(TF.decimate_image(crop.to(cuda), k).cpu(),
                       TF.decimate_plain(crop, k))
    assert torch.equal(TF.decimate_image(x[-1:].to(cuda), k), got[-1:])
    torch.cuda.synchronize()
    name = "pool" if dtype == "float32" else "pool_bf16"
    assert K.launch_counts()[name] == before[name] + 4
