"""Photron ``.mraw`` + ``.cih`` high-speed video reader.

``.mraw`` is headerless packed pixel data; the sidecar ``.cih`` text file
(``Key : Value`` lines) carries dimensions, bit depth, frame rate, count.
Parity: python/upsp/video/mraw.py, cpp/lib/MrawReader.cpp (studied, not
copied).
"""

from __future__ import annotations

import os

import numpy as np

from upsp_tpu_torch.io.video.base import VideoReader
from upsp_tpu_torch.io.video.util import unpack_10bpp, unpack_12bpp


def parse_cih(path: str) -> dict:
    """Parse a .cih: '# comment', 'END', and 'Key : Value' lines."""
    data = {}
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith("END"):
                continue
            if ":" not in line:
                continue
            key, _, val = line.partition(":")
            key = key.strip()
            val = val.strip()
            for cast in (int, float):
                try:
                    val = cast(val)
                    break
                except ValueError:
                    continue
            data[key] = val
    return data


class MrawReader(VideoReader):
    """Reader for Photron .mraw files (10/12-bit packed)."""

    def __init__(self, path, cih_path: str = None):
        super().__init__(path)
        if cih_path is None:
            base, _ = os.path.splitext(path)
            cih_path = base + ".cih"
        self.cih_path = cih_path
        self.cih_info = {}

    def initialize(self):
        self.cih_info = parse_cih(self.cih_path)
        if self.bit_depth not in (10, 12, 16):
            raise NotImplementedError(
                f"{self.bit_depth}-bit mraw not supported"
            )

    @property
    def width(self):
        return int(self.cih_info["Image Width"])

    @property
    def height(self):
        return int(self.cih_info["Image Height"])

    @property
    def bit_depth(self):
        return int(self.cih_info["Color Bit"])

    @property
    def frame_rate(self):
        return int(self.cih_info["Record Rate(fps)"])

    @property
    def frame_count(self):
        return int(self.cih_info["Total Frame"])

    @property
    def exposure_us(self):
        """Exposure from the 'Shutter Speed(s)' line ('1/20000' or seconds)."""
        val = self.cih_info.get("Shutter Speed(s)", 0)
        if isinstance(val, str):
            num, _, den = val.partition("/")
            try:
                val = float(num) / float(den) if den else float(num)
            except ValueError:
                return 0.0
        return float(val) * 1e6

    @property
    def supports_packed_reads(self):
        # headerless contiguous packed data: packed rows are one read
        return self.bit_depth in (10, 12)

    @property
    def packed_bits(self):
        return self.bit_depth

    def read_packed_frames(self, nframes: int, start: int = 0) -> np.ndarray:
        self._validate_index(start + nframes - 1)
        bpf = self.packed_frame_nbytes
        self.fd.seek(start * bpf)
        buf = self.fd.read(nframes * bpf)
        self.frames_decoded += nframes
        return np.frombuffer(buf, np.uint8).reshape(nframes, bpf)

    def read_frame(self, idx: int) -> np.ndarray:
        self._validate_index(idx)
        npix = self.width * self.height
        img_bytes = self.bit_depth * npix // 8
        pos = idx * img_bytes
        if self.fd.tell() != pos:
            self.fd.seek(pos)
        buf = self.fd.read(img_bytes)
        if self.bit_depth == 12:
            pix = unpack_12bpp(buf)
        elif self.bit_depth == 10:
            pix = unpack_10bpp(buf)
        else:
            pix = np.frombuffer(buf, dtype=np.uint16)
        return pix.reshape(self.height, self.width)
