"""The port's K7/K8 unpack (plain twins on the CPU) against the JAX Pallas
kernels ``unpack_12bpp_device`` / ``unpack_10bpp_device`` in interpret mode,
the host decoders of ``upsp_tpu.io.video.util`` and the cine 10->12-bit
LUT.  Unpacking is integer bit arithmetic, and every value below 4096 is
exact in float32, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from upsp_tpu.io.video import util as host
from upsp_tpu.io.video.cine import LUT_10_TO_12
from upsp_tpu.ops.pallas_unpack import unpack_10bpp_device, unpack_12bpp_device
from upsp_tpu_torch.ops.unpack_kernels import (
    make_unpacker,
    unpack_10bpp,
    unpack_10bpp_plain,
    unpack_12bpp,
    unpack_12bpp_plain,
)

BLOCK = 32768  # the Pallas kernels' block of groups


def _bytes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)


@pytest.mark.parametrize("groups,extra", [(7, 0), (BLOCK + 5, 2), (2 * BLOCK, 1)])
def test_unpack12_matches_pallas(groups, extra):
    """Group counts below, off and on the block; trailing bytes that do not
    make a group are dropped."""
    b = _bytes(groups, 3 * groups + extra)
    want = np.asarray(unpack_12bpp_device(jnp.asarray(b), interpret=True))
    got = unpack_12bpp(torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (2 * groups,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), unpack_12bpp_plain(torch.from_numpy(b)).numpy())
    np.testing.assert_array_equal(got.numpy(), host.unpack_12bpp(b).astype(np.float32))


@pytest.mark.parametrize("groups,extra", [(9, 3), (BLOCK + 11, 0)])
@pytest.mark.parametrize("with_lut", [False, True])
def test_unpack10_matches_pallas(groups, extra, with_lut):
    b = _bytes(groups + 1, 5 * groups + extra)
    want = np.asarray(unpack_10bpp_device(jnp.asarray(b), interpret=True))
    lut = None
    if with_lut:  # the JAX driver's LUT gather (phase1.py:557-558)
        want = LUT_10_TO_12[want.astype(np.int32)]
        lut = torch.from_numpy(LUT_10_TO_12.astype(np.float32))
    got = unpack_10bpp(torch.from_numpy(b), lut)
    assert got.dtype == torch.float32 and got.shape == (4 * groups,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), unpack_10bpp_plain(torch.from_numpy(b), lut).numpy())


def test_round_trip_frames():
    """make_unpacker: (F, C, nbytes) packed frames -> (F, C, H, W), the
    host decoders' values, for 12-bit and for LUT'd 10-bit cine bytes."""
    rng = np.random.default_rng(3)
    F, C, H, W = 2, 3, 12, 20
    pix12 = rng.integers(0, 4096, (F, C, H, W)).astype(np.uint16)
    packed = np.stack([[host.pack_12bpp(pix12[f, c]) for c in range(C)] for f in range(F)])
    got = make_unpacker(12, None, (H, W), "cpu")(torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), pix12.astype(np.float32))
    codes = rng.integers(0, 1024, (F, C, H, W)).astype(np.uint16)
    packed = np.stack([[host.pack_10bpp(codes[f, c]) for c in range(C)] for f in range(F)])
    got = make_unpacker(10, LUT_10_TO_12, (H, W), "cpu")(torch.from_numpy(packed))
    decoded = np.stack([[LUT_10_TO_12[host.unpack_10bpp(packed[f, c])].reshape(H, W)
                         for c in range(C)] for f in range(F)])
    np.testing.assert_array_equal(got.numpy(), decoded.astype(np.float32))


def test_wrapper_checks():
    with pytest.raises(TypeError):
        unpack_12bpp(torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError):
        unpack_12bpp(torch.zeros((3, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="LUT"):
        unpack_10bpp(torch.zeros(10, dtype=torch.uint8), torch.zeros(16))
    with pytest.raises(ValueError, match="10-bit"):
        make_unpacker(12, LUT_10_TO_12, (4, 4), "cpu")
    with pytest.raises(ValueError, match="10 or 12"):
        make_unpacker(8, None, (4, 4), "cpu")
