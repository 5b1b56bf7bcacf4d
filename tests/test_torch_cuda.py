"""The hand-written CUDA kernels against their plain twins, on the card.

K1-K4 and K6 compare within the stated bounds (K6, like K5, K7 and K8,
exactly: they only select, shift bits and multiply once).

Marked ``cuda``; skips where torch has no CUDA device (the kernels have no
CPU mode).  This file imports no jax, so it also runs on a machine with
only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

It also holds the seeded inputs and the image tolerance shared with
tests/test_torch_ecc_kernels.py.
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
        assert d[~edge].max() <= atol, d[~edge].max()
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
    assert all(after[k] > before[k] for k in K.KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bytes", [15, 3 * 5 * 257 * 256 + 7])
def test_unpack_kernels_match_twins_on_card(cuda, n_bytes):
    from upsp_tpu.io.video.cine import LUT_10_TO_12
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
    before = K.launch_counts()["gather"]
    got = G.project_gather(x.to(cuda), on_card).cpu().numpy()
    want = G.gather_plain(x, plan).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(want)], want[~np.isnan(want)])
    assert K.launch_counts()["gather"] == before + 1
