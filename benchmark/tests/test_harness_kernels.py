"""Each kernel file counts a frame's operations and bytes as
chip_smoke.py's kernel table does at its shapes (8 frames, 1200 x 1800,
4 cameras, 1,048,576 nodes, k = 4)."""

import pytest

from benchmark import cells
from benchmark.kernels._peaks import F32_FLOPS_PER_S, HBM_BYTES_PER_S

H, W, NODES, K = 1200, 1800, 1 << 20, 4


def _work(**kw):
    w = {"frames": 8, "cameras": 1, "height": H, "width": W, "px": H * W, "nodes": NODES,
         "elem": 4, "gn_steps": 8, "frame_batch": 8, "frames_per_chunk": 64,
         "video_bits": 12, "warm_start": "fft", "decimate": K}
    w.update(kw)
    return w


def _per(mod, more, less):
    """(operations, bytes) of the work ``more`` asks beyond ``less``."""
    f1, b1 = mod.work(_work(**more))
    f0, b0 = mod.work(_work(**less))
    return f1 - f0, b1 - b0


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def kernels():
    return cells.kernel_bounds()


@pytest.mark.parametrize("elem", [4, 2])
def test_image_kernels(smoke, kernels, elem):
    px = 8 * H * W  # chip_smoke.py's call: B = 8 frames
    F = smoke.FLOPS
    one = dict(elem=elem)
    # a frame more: one image more for K1, K4, K6, K7, K10; a step more for K2, K3, K9
    cases = {
        "K1_blur": ((F["blur"] * px, 2 * elem * px), "frames"),
        "K4_warp_filter": ((F["warp_filter"] * px, 3 * elem * px), "frames"),
        "K2_warp": ((F["warp"] * px, 2 * elem * px), "gn_steps"),
        "K3_moments": ((F["moments"] * px, elem * (px + 8 * H * W) + 8 * 128 * 4), "gn_steps"),
        "K9_gn_fused": ((F["gn_fused"] * px, elem * (px + 8 * H * W) + 8 * 128 * 4),
                        "gn_steps"),
    }
    for name, (want, axis) in cases.items():
        got = _per(kernels[name], {**one, axis: 16}, {**one, axis: 8})
        assert got == want, name


def test_ingest_and_pool_kernels(smoke, kernels):
    n_img, px = 8 * 4, H * W
    assert _per(kernels["K6_hot"], {"frames": 8, "cameras": 4}, {"frames": 0, "cameras": 4}) \
        == (smoke.FLOPS["hot"] * n_img * px, 8 * n_img * px)
    assert _per(kernels["K7_unpack12"], {"frames": 8, "cameras": 4},
                {"frames": 0, "cameras": 4}) == (0, n_img * px * 11 // 2)
    f, b = kernels["K8_unpack10"].work(_work(frames=8, cameras=4, video_bits=10))
    assert (f, b) == (0, n_img * px * 21 // 4 + 4096)
    ho, wo = H // K, W // K
    assert _per(kernels["K10_pool"], {"frames": 8, "cameras": 4}, {"frames": 0, "cameras": 4}) \
        == (n_img * ho * wo * smoke.pool_flops(K), n_img * px * 4 + n_img * ho * wo * 4)
    # K5: one call of 8 frames into the 1,048,576-node plan, a read a node
    f, b = kernels["K5_gather"].work(_work(frames=8))
    assert (f, b) == (smoke.FLOPS["gather"] * 8 * NODES, 8 * (NODES * 4 + NODES * 4) + NODES * 12)


def test_peaks_are_chip_smokes(smoke):
    assert (HBM_BYTES_PER_S, F32_FLOPS_PER_S) == (smoke.HBM_BYTES_PER_S, smoke.F32_FLOPS_PER_S)


def test_kernels_a_start_does_not_launch(kernels):
    assert kernels["K10_pool"].work(_work(warm_start="identity")) == (0, 0)
    assert kernels["K8_unpack10"].work(_work()) == (0, 0)
    assert kernels["K7_unpack12"].work(_work(video_bits=10)) == (0, 0)
