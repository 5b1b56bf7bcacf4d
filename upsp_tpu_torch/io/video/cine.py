"""Phantom ``.cine`` high-speed video reader.

Layout (Vision Research "Cine File Format" public spec; field offsets
cross-checked against the reference's ctypes structs,
python/upsp/video/cine.py:27-330 and cpp/include/vr_cine.h — studied, not
copied): CINEFILEHEADER (44 B) -> BITMAPINFOHEADER (40 B) -> SETUP (7240 B,
packed) -> tagged blocks -> 64-bit per-image offset table -> per-image
[annotation size u32 | annotation | image size u32 | pixel data].

Pixel data is uncompressed uint16, or packed 10/12-bit MSBit-first; packed
10-bit values pass through the Vision Research log-companding LUT to 12-bit
linear.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from upsp_tpu_torch.io.video.base import VideoReader
from upsp_tpu_torch.io.video.util import unpack_10bpp, unpack_12bpp

_CFH = struct.Struct("<HHHHiIiIIIIII")  # 44 bytes + TIME64(2xu32)
_BIH = struct.Struct("<IiiHHIIiiII")  # 40 bytes

# SETUP field offsets (bytes from SETUP start), from the public spec
_SETUP_SIZE = 7240
_OFF_LENGTH = 142  # u16 — actual setup length in file
_OFF_IM_WIDTH = 737  # u16
_OFF_IM_HEIGHT = 739  # u16
_OFF_FRAME_RATE = 768  # u32 (Hz)
_OFF_SHUTTER_NS = 1568  # u32 exposure (ns)
_OFF_REAL_BPP = 896  # u32 bits/pixel actually used
_OFF_LENS_APERTURE = 5996  # f32


class CineReader(VideoReader):
    """Reader for Phantom .cine files (8/10/12-bit, packed or linear)."""

    def initialize(self):
        hdr = self.fd.read(44)
        (
            self._type,
            self._headersize,
            self._compression,
            self._version,
            self._first_movie_image,
            self._total_image_count,
            self._first_image_no,
            self._image_count,
            self._off_image_header,
            self._off_setup,
            self._off_image_offsets,
            _trig_frac,
            _trig_sec,
        ) = _CFH.unpack(hdr)
        if self._type != 0x4943:  # 'CI'
            raise ValueError("not a cine file (bad magic)")

        self.fd.seek(self._off_image_header)
        bih = _BIH.unpack(self.fd.read(40))
        self._bi_width = bih[1]
        self._bi_height = bih[2]
        self._bi_compression = bih[5]

        self.fd.seek(self._off_setup)
        setup = self.fd.read(_SETUP_SIZE)
        self._setup_length = struct.unpack_from("<H", setup, _OFF_LENGTH)[0]
        self._frame_rate = struct.unpack_from("<I", setup, _OFF_FRAME_RATE)[0]
        self._shutter_ns = struct.unpack_from("<I", setup, _OFF_SHUTTER_NS)[0]
        self._real_bpp = struct.unpack_from("<I", setup, _OFF_REAL_BPP)[0]
        try:
            self._aperture = struct.unpack_from("<f", setup, _OFF_LENS_APERTURE)[0]
        except struct.error:
            self._aperture = 0.0

        if self._real_bpp not in (8, 10, 12):
            raise NotImplementedError(f"{self._real_bpp}-bit cine not supported")

        self.fd.seek(self._off_image_offsets)
        self._img_offsets = np.frombuffer(
            self.fd.read(8 * self._image_count), dtype="<i8"
        )

    @property
    def width(self):
        return self._bi_width

    @property
    def height(self):
        return self._bi_height

    @property
    def frame_count(self):
        return int(self._image_count)

    @property
    def frame_rate(self):
        return int(self._frame_rate)

    @property
    def bit_depth(self):
        # packed 10-bit expands through the companding LUT to 12-bit linear
        return 12 if self._real_bpp == 10 and self._packed else self._real_bpp

    @property
    def raw_bit_depth(self):
        return self._real_bpp

    @property
    def exposure_us(self):
        return self._shutter_ns / 1000.0

    @property
    def aperture(self):
        return self._aperture

    @property
    def _packed(self):
        return self._bi_compression != 0

    @property
    def supports_packed_reads(self):
        # packed 10/12-bit payloads unpack on device (10-bit additionally
        # passes through the companding LUT, shipped to device as a gather)
        return self._packed and self._real_bpp in (10, 12)

    @property
    def packed_bits(self):
        return self._real_bpp

    @property
    def packed_lut(self):
        return LUT_10_TO_12 if self._real_bpp == 10 else None

    def read_packed_frames(self, nframes: int, start: int = 0) -> np.ndarray:
        self._validate_index(start + nframes - 1)
        bpf = self.packed_frame_nbytes
        out = np.empty((nframes, bpf), np.uint8)
        for i in range(nframes):
            self.fd.seek(int(self._img_offsets[start + i]))
            annot_size = struct.unpack("<I", self.fd.read(4))[0]
            self.fd.seek(annot_size - 8, 1)
            self.fd.seek(4, 1)  # img_size field
            out[i] = np.frombuffer(self.fd.read(bpf), np.uint8)
        self.frames_decoded += nframes
        return out

    def read_frame(self, idx: int) -> np.ndarray:
        self._validate_index(idx)
        self.fd.seek(int(self._img_offsets[idx]))
        annot_size = struct.unpack("<I", self.fd.read(4))[0]
        self.fd.seek(annot_size - 8, 1)
        img_size = struct.unpack("<I", self.fd.read(4))[0]
        buf = self.fd.read(img_size)
        if self._packed:
            if self._real_bpp == 12:
                pix = unpack_12bpp(buf)
            else:
                pix = LUT_10_TO_12[unpack_10bpp(buf)]
        else:
            pix = np.frombuffer(buf, dtype=np.uint16)
        return pix[: self.height * self.width].reshape(self.height, self.width)


def _load_lut_10_to_12() -> np.ndarray:
    """Vision Research 10->12 bit linearization curve (exact vendor table).

    The camera stores log-companded 10-bit values; the expansion is a fixed
    1024-entry hardware calibration table published with the camera SDK (and
    embedded in every cine reader, e.g. python/upsp/video/cine.py:436 and the
    public pycine project).  It is vendor *data*, not derivable analytically,
    so it ships as a binary asset: cine_lut10.npy (uint16, 1024 entries,
    lut[0]=2, lut[1014]=4064, lut[1015:]=4095).
    """
    path = os.path.join(os.path.dirname(__file__), "cine_lut10.npy")
    lut = np.load(path)
    assert lut.shape == (1024,) and lut.dtype == np.uint16
    return lut


LUT_10_TO_12 = _load_lut_10_to_12()
