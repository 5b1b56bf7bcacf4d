"""K6's one-pass count and candidate lists, then the repair, against the
plain twin and the JAX kernel, on the CPU.

``hot_scan_kernel`` (upsp_tpu_torch/csrc/ecc.cu) copies each frame to the
output in one pass and counts its pixels >= thresh.  Blocks stride over
the frame's tiles of HOT_TILE pixels; within a tile a thread owns 16
pixels, as four 16-byte vectors when the frame's pixel count is a multiple
of 4 (the vector route) or as 16 pixels a block-width apart (the scalar
route).  A block keeps the first max_hot candidates it meets, in whatever
order its warps reach its shared list, then takes a base slot for them
from the frame's count with one atomic and copies them to the frame's
max_hot slots from there.  ``hot_repair_kernel`` repairs the listed
candidates of each frame whose count is <= max_hot against the ORIGINAL
frame.

``hot_emulated`` below is that algorithm in torch, with the kernel's
pixel-to-thread maps, blocks and warps taking their turns in a random
order (the card's order is not fixed); the tests check that every order
gives the twin's result, that the maps cover each pixel once, and the
count and list bookkeeping at 0, max_hot and max_hot + 1 candidates.

Tolerance: exact.  The repair only selects between a pixel and the median
of its neighbours.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from upsp_tpu.ops.pallas_ecc import fix_hot_pixels_pallas
from upsp_tpu_torch.ops.ecc_kernels import (
    HOT_MAX,
    HOT_MIN_CHANGE,
    HOT_THRESH,
    fix_hot_pixels,
    fix_hot_pixels_kernel,
)

THREADS, UNROLL = 256, 4  # csrc/ecc.cu HOT_THREADS, HOT_UNROLL
TILE = THREADS * UNROLL * 4


def tile_map(t0, hw, vec):
    """(THREADS, 16) pixel of each thread's bit k = 4u + e in the tile at
    t0 (the kernel's formulas); -1 past the frame's end."""
    tid = np.arange(THREADS)[:, None]
    k = np.arange(4 * UNROLL)[None, :]
    u, e = k // 4, k % 4
    px = t0 + (u * THREADS + tid) * 4 + e if vec else t0 + k * THREADS + tid
    return np.where(px < hw, px, -1)


def hot_emulated(frames, n_blocks, rng, max_hot=HOT_MAX):
    """Count, list and repair as the two kernels do, blocks and warps in
    a random order; (B, H, W) float32 -> (out, counts)."""
    b, h, w = frames.shape
    hw = h * w
    vec = hw % 4 == 0
    out = frames.clone()
    counts = np.zeros(b, np.int64)
    for f in range(b):
        flat = frames[f].reshape(-1).numpy()
        slots = np.full(max_hot, -1)
        for blk in rng.permutation(n_blocks):
            s_list, s_n = [], 0
            for t0 in range(blk * TILE, hw, n_blocks * TILE):
                m = tile_map(t0, hw, vec)
                hot = (m >= 0) & (flat[np.maximum(m, 0)] >= HOT_THRESH)
                for warp in rng.permutation(THREADS // 32):
                    lanes = slice(32 * warp, 32 * warp + 32)
                    for px in m[lanes][hot[lanes]]:  # lane, then bit order
                        if s_n < max_hot:
                            s_list.append(int(px))
                        s_n += 1
            first = counts[f]
            counts[f] += s_n
            for j in range(s_n):
                if first + j < max_hot:
                    slots[first + j] = s_list[j]
        if counts[f] > max_hot:
            continue
        big = 3.0e38
        pad = torch.nn.functional.pad(frames[f][None, None], (1, 1, 1, 1), value=big)[0, 0]
        for i in slots[: counts[f]]:
            y, x = divmod(int(i), w)
            nb = torch.stack([pad[y, x + 1], pad[y + 2, x + 1], pad[y + 1, x],
                              pad[y + 1, x + 2]])
            n_valid = 4 - int((nb >= big).sum())
            lo1, hi1 = torch.minimum(nb[0], nb[1]), torch.maximum(nb[0], nb[1])
            lo2, hi2 = torch.minimum(nb[2], nb[3]), torch.maximum(nb[2], nb[3])
            mid_lo, mid_hi = torch.maximum(lo1, lo2), torch.minimum(hi1, hi2)
            median = (torch.maximum if n_valid == 4 else torch.minimum)(mid_lo, mid_hi)
            if frames[f, y, x] - median > HOT_MIN_CHANGE:
                out[f, y, x] = median
    return out, counts


def frames_with(spots_per_frame, h, w, seed):
    """(len, h, w) float32 noise around 2000 with 4095 at the given flat
    pixels (``None``: every pixel)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(2000, 150, (len(spots_per_frame), h, w)).astype(np.float32))
    for f, spots in enumerate(spots_per_frame):
        if spots is None:
            x[f] = 4095.0
        else:
            x[f].view(-1)[torch.tensor(spots, dtype=torch.long)] = 4095.0
    return x


@pytest.mark.parametrize("h,w", [(64, 130), (33, 131)])  # vector / scalar route
def test_maps_cover_each_pixel_once(h, w):
    hw = h * w
    for n_blocks in (1, 2, 5):
        seen = np.concatenate([
            tile_map(t0, hw, hw % 4 == 0).ravel()
            for blk in range(n_blocks) for t0 in range(blk * TILE, hw, n_blocks * TILE)
        ])
        assert np.array_equal(np.sort(seen[seen >= 0]), np.arange(hw))


def _cases(h, w):
    hw = h * w
    corners_edges = [0, w - 1, hw - w, hw - 1, w // 2, (h // 2) * w]
    vectors = [3, 4, 7, 8, TILE - 1, TILE, TILE + 1]  # 16-byte, tile seams
    return [
        [],  # count 0
        corners_edges[:HOT_MAX],  # count max_hot: all listed, repaired
        corners_edges[: HOT_MAX + 1],  # max_hot + 1: left as it is
        None,  # all saturated
        [w + 3, w + 4, 2 * w + 4, 5 * w + 9],  # adjacent
        vectors[:HOT_MAX],  # either side of vector and tile seams
    ]


@pytest.mark.parametrize("h,w", [(64, 130), (33, 131)])
@pytest.mark.parametrize("n_blocks", [1, 3])
def test_emulated_kernel_matches_twin_and_jax(h, w, n_blocks):
    """Every case at once in one batch (each frame counts on its own), in
    three random orders of blocks and warps."""
    cases = _cases(h, w)
    x = frames_with(cases, h, w, seed=h + n_blocks)
    x[4, 9, 9] = 4095.0
    x[4, 9, 10] = float("nan")  # a NaN right neighbour
    want = fix_hot_pixels(x)
    n_hot = [0, HOT_MAX, HOT_MAX + 1, h * w, 5, HOT_MAX]
    for seed in range(3):
        got, counts = hot_emulated(x, n_blocks, np.random.default_rng(seed))
        np.testing.assert_array_equal(counts, n_hot)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    repaired = ((want != x) & ~torch.isnan(x)).sum(dim=(1, 2)).tolist()
    assert repaired[0] == 0 and repaired[1] == HOT_MAX
    assert repaired[2] == 0 and repaired[3] == 0 and repaired[4] > 0
    for f in range(x.shape[0]):
        jw = np.asarray(fix_hot_pixels_pallas(jnp.asarray(x[f].numpy())))
        np.testing.assert_array_equal(want[f].numpy(), jw)
    np.testing.assert_array_equal(fix_hot_pixels_kernel(x).numpy(), want.numpy())


def test_short_list_is_enough():
    """A block that meets more than max_hot candidates keeps only max_hot,
    and then so does the frame: the frame is over the limit and left as it
    is; a frame at max_hot spread over several blocks fills every slot."""
    h, w = 64, 256  # 4 tiles
    spots = [1, TILE + 2, 2 * TILE + 3, 3 * TILE + 4, 3 * TILE + 5]
    x = frames_with([spots, [1, 20, 40, 60, 80, 100]], h, w, seed=5)
    got, counts = hot_emulated(x, 4, np.random.default_rng(0))
    np.testing.assert_array_equal(counts, [HOT_MAX, HOT_MAX + 1])
    np.testing.assert_array_equal(got.numpy(), fix_hot_pixels(x).numpy())
    assert (got[0] != x[0]).sum() == HOT_MAX and torch.equal(got[1], x[1])
