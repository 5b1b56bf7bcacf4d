"""K5's tile-by-tile gather against the plain twin, on the CPU.

``gather_kernel`` (upsp_tpu_torch/csrc/gather.cu) does not gather node by
node in model order.  The plan cuts the nodes into tiles of ``GATHER_TILE``
consecutive model-order nodes, each tile's entries sorted by source pixel;
a block owns one tile.  It splits each entry's flat source index into C*H*W
into a camera and a pixel, reads that pixel from the camera's own (B, H, W)
image (or from one (B, C*H*W) stack, a single "camera"), multiplies it by
the entry's weight, puts the value at ``node - tile start`` of a buffer,
and writes the buffer to the tile's contiguous range of out[b].
``gather_tiles`` below is that algorithm in torch, tile by tile (every
entry of a tile at once), so the tests check the plan's tiling, the camera
split and the placement.

Tolerance: exact, NaN at the same entries.  Both sides widen the pixel to
f32 exactly and multiply it once by an f32 weight; the rest selects.  The
twin itself is held against the JAX slab gather in
tests/test_torch_gather.py.
"""

import numpy as np
import pytest
import torch

from upsp_tpu_torch.ops.gather_kernels import (
    GATHER_TILE,
    apply_overlays,
    build_gather_plan,
    gather_plain,
    project_gather,
)

T = GATHER_TILE
H, W = 29, 67


def gather_tiles(cams, plan):
    """The kernel's streaming in torch: (B, N) float32 from the camera
    images ((B, H, W) each, or one (B, C*H*W) stack)."""
    b = cams[0].shape[0]
    hw = cams[0][0].numel()
    n = plan.n_nodes
    out = torch.empty((b, n), dtype=torch.float32)
    for t0 in range(0, n, plan.tile):
        e = slice(t0, min(n, t0 + plan.tile))
        src = plan.src[e].long()
        dst = plan.node[e].long() - t0
        assert ((dst >= 0) & (dst < plan.tile)).all()
        cam, pix = src.clamp_min(0) // hw, src.clamp_min(0) % hw
        buf = torch.empty((b, dst.numel()), dtype=torch.float32)
        for c, img in enumerate(cams):
            sel = (cam == c) & (src >= 0)
            vals = img.reshape(b, -1)[:, pix[sel]].float()
            buf[:, dst[sel]] = vals * plan.weight[e][sel]
        buf[:, dst[src < 0]] = float("nan")
        out[:, e] = buf
    return out


def _case(rng, n_cams, n=2 * T + 333):
    """Sources over C cameras, a 20% share invisible, 3% skipped; tile 1
    all skipped (every primary of its nodes); copies across tiles both
    ways and a copy of a copy."""
    idx = rng.integers(0, n_cams * H * W, n)
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < 0.2] = 0.0
    sup = np.arange(n)
    sup[T - 1] = 2 * T + 17  # tile 0 copies tile 2
    sup[2 * T + 3] = 5  # tile 2 copies tile 0
    sup[10], sup[20] = 20, T + 40  # a copy of a copy; a copy into the NaN tile
    skipped = rng.random(n) < 0.03
    skipped[sup[T:2 * T]] = True
    return idx, w, sup, skipped


def _assert_same(got, want):
    got, want = got.numpy(), want.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    v = ~np.isnan(want)
    np.testing.assert_array_equal(got[v], want[v])  # exact


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_cams", [1, 4])
def test_tiles_match_twin(n_cams, dtype):
    """N not a multiple of the tile, an all-NaN tile, supersession across
    tile boundaries; from the camera images and from the stack."""
    rng = np.random.default_rng(60 + n_cams)
    idx, w, sup, skipped = _case(rng, n_cams)
    plan = build_gather_plan(idx, w, skipped, sup, (), n_cams * H * W)
    x = torch.from_numpy(rng.normal(2000, 300, (3, n_cams, H, W)).astype(np.float32))
    x = x.to(dtype)
    cams = [x[:, c].contiguous() for c in range(n_cams)]
    stacked = x.reshape(3, -1)
    want = gather_plain(stacked, plan)
    assert want.dtype == torch.float32
    assert torch.isnan(want[:, T:2 * T]).all()  # the all-skipped tile
    assert torch.isnan(want[:, 20]).all()  # a copy of a node in that tile
    _assert_same(gather_tiles(cams, plan), want)
    _assert_same(gather_tiles([stacked], plan), want)
    _assert_same(gather_plain(cams, plan), want)
    _assert_same(project_gather(cams, plan), want)  # the CPU twin path
    _assert_same(project_gather(stacked, plan), want)


@pytest.mark.parametrize("n", [1, T - 1, T, 3 * T + 1])
def test_plan_tiles_are_permutations(n):
    """``node`` is a permutation of the model nodes, each tile's entries
    are its own model-order range, sorted by source (skipped first), and
    the entries carry the composed sources and weights."""
    rng = np.random.default_rng(n)
    idx, w, sup, skipped = _case(rng, 2, n=max(n, 3 * T))
    idx, w, skipped = idx[:n], w[:n], skipped[:n]
    sup = np.where(sup[:n] < n, sup[:n], np.arange(n))
    plan = build_gather_plan(idx, w, skipped, sup, (), 2 * H * W)
    node = plan.node.numpy()
    src = plan.src.numpy()
    assert plan.tile == T
    assert np.array_equal(np.sort(node), np.arange(n))
    for t0 in range(0, n, T):
        tile = slice(t0, t0 + T)
        assert np.array_equal(np.sort(node[tile]), np.arange(t0, min(n, t0 + T)))
        assert (np.diff(src[tile]) >= 0).all()
    np.testing.assert_array_equal(src, np.where(skipped[sup], -1, idx[sup])[node])
    np.testing.assert_array_equal(plan.weight.numpy(), w[sup][node])


def test_overlays_after_tiles():
    """The patch overlays go on after the tiled gather as after the twin,
    on the overlaid nodes and their copies in other tiles."""
    rng = np.random.default_rng(70)
    n_cams = 2
    idx, w, sup, skipped = _case(rng, n_cams)
    w[[5, 2 * T + 17]] = 0.7
    skipped[[5, 2 * T + 17]] = False
    ni = np.array([5, 2 * T + 17])
    ns = np.array([3, 8])
    nw = np.array([0.5, 0.25], np.float32)
    plan = build_gather_plan(idx, w, skipped, sup, [None, (ni, ns, nw)],
                             n_cams * H * W)
    assert sorted(plan.overlays[1][0].tolist()) == [5, T - 1, 2 * T + 3, 2 * T + 17]
    x = torch.from_numpy(rng.normal(2000, 300, (2, n_cams, H, W)).astype(np.float32))
    cams = [x[:, c].contiguous() for c in range(n_cams)]
    vals = [(1, torch.from_numpy(rng.normal(1000, 50, (2, 3, 4)).astype(np.float32)))]
    got = apply_overlays(gather_tiles(cams, plan), plan, vals)
    want = apply_overlays(gather_plain(x.reshape(2, -1), plan), plan, vals)
    _assert_same(got, want)
    np.testing.assert_array_equal(got[:, T - 1].numpy(), got[:, 2 * T + 17].numpy())


def test_camera_images_checked():
    rng = np.random.default_rng(71)
    idx, w, sup, skipped = _case(rng, 2)
    plan = build_gather_plan(idx, w, skipped, sup, (), 2 * H * W)
    x = torch.zeros((1, H, W))
    with pytest.raises(ValueError, match="pixels per frame"):
        project_gather([x], plan)
    with pytest.raises(ValueError, match="different shapes"):
        project_gather([x, torch.zeros((1, H, W + 1))], plan)
    with pytest.raises(TypeError):
        project_gather([x, x.to(torch.bfloat16)], plan)
    with pytest.raises(ValueError, match="camera images"):
        project_gather([x] * 9, plan)
    with pytest.raises(TypeError):
        project_gather([x, torch.zeros((1, W, H)).transpose(1, 2)], plan)
