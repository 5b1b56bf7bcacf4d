"""The port's K6 hot-pixel repair (its plain twin on the CPU) against the
JAX Pallas kernel ``fix_hot_pixels_pallas`` (interpret mode on the CPU)
and the JAX ``ops.image.fix_hot_pixels``.

Frames carry 0, 3, 5 and 6 hot pixels (>= 4064; 6 exceeds max_hot = 5, so
that frame is left as it is), at corners, edges and the interior, in the
pattern of tests/test_pallas_ecc.py:329-367.  The repair only selects
between a pixel and the median of its neighbours, so the tolerance is
exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from upsp_tpu.ops.image import fix_hot_pixels as j_fix_hot_pixels
from upsp_tpu.ops.pallas_ecc import fix_hot_pixels_pallas
from upsp_tpu_torch.ops.ecc_kernels import fix_hot_pixels_kernel

H, W = 64, 128
SPOTS = [(0, 0), (5, W - 1), (H - 1, 64), (31, 31), (H - 1, W - 1), (0, 77)]


def _frame(seed, n_hot, value=4090.0):
    rng = np.random.default_rng(seed)
    img = rng.normal(2000, 200, (H, W)).astype(np.float32)
    for y, x in SPOTS[:n_hot]:
        img[y, x] = value
    return img


@pytest.mark.parametrize("n_hot", [0, 3, 5, 6])
def test_matches_pallas_kernel(n_hot):
    img = _frame(n_hot, n_hot)
    got = fix_hot_pixels_kernel(torch.from_numpy(img)).numpy()
    want = np.asarray(fix_hot_pixels_pallas(jnp.asarray(img)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(j_fix_hot_pixels(jnp.asarray(img))))
    repaired = int((got != img).sum())
    assert repaired == (n_hot if n_hot <= 5 else 0)


def test_small_drop_is_kept():
    """A pixel above the threshold but within 512 of its median stays."""
    img = np.full((H, W), 3700.0, np.float32)
    img[10, 10] = 4100.0  # 400 above the median
    img[20, 20] = 4300.0  # 600 above: repaired
    got = fix_hot_pixels_kernel(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(fix_hot_pixels_pallas(jnp.asarray(img))))
    assert got[10, 10] == 4100.0 and got[20, 20] == 3700.0


def test_batched_frames_count_separately():
    """(B, C, H, W) frames as the frame program passes them: each frame's
    count is its own (the JAX kernel under vmap)."""
    import jax

    imgs = np.stack([_frame(i, n) for i, n in enumerate([0, 3, 5, 6, 2, 6])])
    want = np.asarray(jax.vmap(fix_hot_pixels_pallas)(jnp.asarray(imgs)))
    got = fix_hot_pixels_kernel(torch.from_numpy(imgs).reshape(3, 2, H, W))
    assert got.shape == (3, 2, H, W)
    np.testing.assert_array_equal(got.reshape(6, H, W).numpy(), want)


def test_wrapper_checks():
    with pytest.raises(TypeError):
        fix_hot_pixels_kernel(torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        fix_hot_pixels_kernel(torch.zeros((4, 8))[:, ::2])
    with pytest.raises(ValueError):
        fix_hot_pixels_kernel(torch.zeros(4))
