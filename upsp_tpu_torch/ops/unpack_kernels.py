"""Packed-video unpack kernels for the H100 (csrc/unpack.cu) and their
plain twins.

Counterpart of ``upsp_tpu/ops/pallas_unpack.py``: the videos' raw packed
bytes are copied to the card and unpacked there, so the host neither
decodes frames nor ships 16- or 32-bit pixels.

| wrapper | kernel | replaces |
| --- | --- | --- |
| :func:`unpack_12bpp` | K7 ``unpack12_kernel`` | ``unpack_12bpp_device`` (pallas_unpack.py:37) |
| :func:`unpack_10bpp` | K8 ``unpack10_kernel`` (+ LUT) | ``unpack_10bpp_device`` (:76) and the LUT gather of phase1.py:557-558 |

Both return float32 pixels: the frame program converts frames to float32
as its first step, and every pixel value is an integer below 4096, so the
values are exact.  A wrapper runs its plain twin on a CPU tensor and
launches its kernel on a CUDA tensor (counting the launch); there is no
other path.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from upsp_tpu_torch.ops.cuda_lib import (
    CudaLibrary,
    check_rc,
    count_launch,
    register_kernels,
    stream_of,
)

LUT_SIZE = 1024  # 10-bit codes

KERNELS = register_kernels(("unpack12", "unpack10"))


def _bind(lib: ctypes.CDLL) -> None:
    p, q = ctypes.c_void_p, ctypes.c_longlong
    lib.upsp_unpack12.argtypes = [p, p, q, p]
    lib.upsp_unpack10.argtypes = [p, p, p, q, p]
    lib.upsp_unpack12.restype = ctypes.c_int
    lib.upsp_unpack10.restype = ctypes.c_int


LIBRARY = CudaLibrary("unpack", _bind)


def _check_packed(packed: torch.Tensor, name: str) -> None:
    if not isinstance(packed, torch.Tensor) or packed.dim() != 1:
        raise ValueError(f"{name}: packed bytes must be a 1-D tensor")
    if packed.dtype != torch.uint8:
        raise TypeError(f"{name}: packed bytes must be uint8, got {packed.dtype}")
    if not packed.is_contiguous():
        raise ValueError(f"{name}: packed bytes must be contiguous")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {packed.device}")


def _check_lut(lut: Optional[torch.Tensor], packed: torch.Tensor) -> None:
    if lut is None:
        return
    if lut.shape != (LUT_SIZE,) or lut.dtype != torch.float32:
        raise ValueError(f"unpack10: the LUT must be ({LUT_SIZE},) float32")
    if not lut.is_contiguous() or lut.device != packed.device:
        raise ValueError("unpack10: the LUT must be contiguous, on the bytes' device")


# ---------------------------------------------------------------------------
# plain twins (pallas_unpack.py:101-120, in int32, as float32)


def unpack_12bpp_plain(packed: torch.Tensor) -> torch.Tensor:
    """(3G,) uint8 -> (2G,) float32 pixels, MSBits first."""
    g = packed.shape[0] // 3
    b = packed[: 3 * g].reshape(g, 3).to(torch.int32)
    hi = (b[:, 0] << 4) | (b[:, 1] >> 4)
    lo = ((b[:, 1] & 0x0F) << 8) | b[:, 2]
    return torch.stack([hi, lo], dim=1).reshape(2 * g).to(torch.float32)


def unpack_10bpp_plain(packed: torch.Tensor,
                       lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(5G,) uint8 -> (4G,) float32 pixels, MSBits first, then ``lut``
    (a (1024,) table) when given."""
    g = packed.shape[0] // 5
    b = packed[: 5 * g].reshape(g, 5).to(torch.int32)
    p0 = (b[:, 0] << 2) | (b[:, 1] >> 6)
    p1 = ((b[:, 1] & 0x3F) << 4) | (b[:, 2] >> 4)
    p2 = ((b[:, 2] & 0x0F) << 6) | (b[:, 3] >> 2)
    p3 = ((b[:, 3] & 0x03) << 8) | b[:, 4]
    pix = torch.stack([p0, p1, p2, p3], dim=1).reshape(4 * g)
    if lut is not None:
        return lut.to(torch.float32)[pix.long()]
    return pix.to(torch.float32)


# ---------------------------------------------------------------------------
# wrappers


def unpack_12bpp(packed: torch.Tensor) -> torch.Tensor:
    """K7: packed 12-bit bytes (3G,) uint8 -> (2G,) float32 pixels."""
    _check_packed(packed, "unpack12")
    if packed.device.type == "cpu":
        return unpack_12bpp_plain(packed)
    g = packed.shape[0] // 3
    out = torch.empty(2 * g, dtype=torch.float32, device=packed.device)
    if g:
        rc = LIBRARY.lib().upsp_unpack12(packed.data_ptr(), out.data_ptr(), g,
                                         stream_of(packed))
        check_rc(rc, "unpack12")
        count_launch("unpack12")
    return out


def unpack_10bpp(packed: torch.Tensor,
                 lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8: packed 10-bit bytes (5G,) uint8 -> (4G,) float32 pixels, each
    looked up in ``lut`` ((1024,) float32, e.g. the cine 10->12-bit curve)
    when given."""
    _check_packed(packed, "unpack10")
    _check_lut(lut, packed)
    if packed.device.type == "cpu":
        return unpack_10bpp_plain(packed, lut)
    g = packed.shape[0] // 5
    out = torch.empty(4 * g, dtype=torch.float32, device=packed.device)
    if g:
        rc = LIBRARY.lib().upsp_unpack10(
            packed.data_ptr(), None if lut is None else lut.data_ptr(),
            out.data_ptr(), g, stream_of(packed),
        )
        check_rc(rc, "unpack10")
        count_launch("unpack10")
    return out


def make_unpacker(packed_bits: int, lut, image_hw: Tuple[int, int], device):
    """(F, C, nbytes) uint8 packed frames -> (F, C, H, W) float32 pixels,
    on the bytes' device; the counterpart of ``_make_unpacker``
    (upsp_tpu/pipeline/phase1.py:528).  ``lut`` is the optional (1024,)
    10->12-bit table of a 10-bit packed video."""
    if packed_bits not in (10, 12):
        raise ValueError(f"packed_bits must be 10 or 12, got {packed_bits}")
    if lut is not None and packed_bits != 10:
        raise ValueError("a linearisation LUT applies to 10-bit packed video only")
    lut_t = None if lut is None else torch.as_tensor(
        np.asarray(lut, np.float32), device=device)
    h, w = image_hw

    def unpack_chunk(packed: torch.Tensor) -> torch.Tensor:
        n_f, n_c = packed.shape[0], packed.shape[1]
        flat = packed.reshape(-1)
        pix = unpack_12bpp(flat) if packed_bits == 12 else unpack_10bpp(flat, lut_t)
        return pix[: n_f * n_c * h * w].reshape(n_f, n_c, h, w)

    return unpack_chunk
