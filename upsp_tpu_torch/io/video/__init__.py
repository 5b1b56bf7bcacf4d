"""High-speed camera video IO: .cine (Phantom) and .mraw/.cih (Photron)."""

import os

from upsp_tpu_torch.io.video.base import (  # noqa: F401
    FramePrefetcher,
    IntervalPrefetcher,
    VideoReader,
)
from upsp_tpu_torch.io.video.cine import CineReader  # noqa: F401
from upsp_tpu_torch.io.video.mraw import MrawReader  # noqa: F401
from upsp_tpu_torch.io.video.util import (  # noqa: F401
    pack_10bpp,
    pack_12bpp,
    unpack_10bpp,
    unpack_12bpp,
)


def video_reader(path: str) -> VideoReader:
    """Dispatch a reader by file extension (.cine / .mraw)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".cine":
        return CineReader(path)
    if ext == ".mraw":
        return MrawReader(path)
    raise ValueError(f"unsupported video format: {ext}")
