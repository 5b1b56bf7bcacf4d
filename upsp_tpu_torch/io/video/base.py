"""Video reader interface + chunked prefetching pipeline.

The interface mirrors the reference's abstractions (cpp/include/PSPVideo.h:31-
160, python/upsp/video/base.py — studied, not copied); the prefetcher is the
TPU-native replacement for the pthread read-ahead in psp_process.cpp:867-908:
a background thread decodes frame chunks into a bounded queue so device
compute overlaps host video decode.
"""

from __future__ import annotations

import abc
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from upsp_tpu_torch.utils import timing


class VideoReader(abc.ABC):
    """File-format-agnostic frame access with context-manager lifetime."""

    dtype = np.uint16

    def __init__(self, path):
        self.path = path
        self.fd = None
        # decode accounting: lets the driver assert per-host ingest really
        # scales (each process of a multi-host run decodes only its slice)
        self.frames_decoded = 0

    def open(self):
        self.fd = open(self.path, "rb")
        self.initialize()

    def close(self):
        if self.fd is not None:
            self.fd.close()
            self.fd = None

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()

    def _validate_index(self, idx: int):
        if idx >= self.frame_count or idx < 0:
            raise ValueError(
                f"invalid frame index {idx}; file has {self.frame_count} frames"
            )

    @property
    @abc.abstractmethod
    def frame_count(self) -> int: ...

    @property
    @abc.abstractmethod
    def frame_rate(self) -> int: ...

    @property
    @abc.abstractmethod
    def width(self) -> int: ...

    @property
    @abc.abstractmethod
    def height(self) -> int: ...

    @property
    @abc.abstractmethod
    def bit_depth(self) -> int: ...

    @property
    def raw_bit_depth(self) -> int:
        return self.bit_depth

    @abc.abstractmethod
    def initialize(self): ...

    @abc.abstractmethod
    def read_frame(self, idx: int) -> np.ndarray: ...

    def read_frames(
        self, nframes: int, start: int = 0, out: Optional[np.ndarray] = None
    ) -> np.ndarray:
        self._validate_index(start + nframes - 1)
        shape = (nframes, self.height, self.width)
        if out is None:
            out = np.empty(shape, dtype=self.dtype)
        elif out.shape != shape:
            raise ValueError(f"expected shape {shape}, got {out.shape}")
        for i in range(nframes):
            out[i] = self.read_frame(start + i)
        self.frames_decoded += nframes
        return out

    def iter_chunks(
        self, nframes: int, start: int = 0, frames_per_chunk: int = 64
    ) -> Iterator[np.ndarray]:
        self._validate_index(start + nframes - 1)
        for s in range(start, start + nframes, frames_per_chunk):
            n = min(frames_per_chunk, start + nframes - s)
            yield self.read_frames(n, start=s)

    # -- packed (device-unpack) path -----------------------------------------

    @property
    def supports_packed_reads(self) -> bool:
        """True when frames can be served as raw packed byte rows for
        on-device unpacking (ops/pallas_unpack.py) — 25-37% less host->device
        traffic than pre-unpacked uint16."""
        return False

    @property
    def packed_bits(self) -> int:
        """Bits per pixel in the packed representation (10 or 12)."""
        return 12

    @property
    def packed_lut(self):
        """Optional (2**packed_bits,) uint16 linearization table applied
        after the bit unpack (e.g. the cine 10->12-bit companding LUT), or
        None for linear formats."""
        return None

    @property
    def packed_frame_nbytes(self) -> int:
        """Bytes per frame in the packed representation."""
        return self.height * self.width * self.packed_bits // 8

    def read_packed_frames(self, nframes: int, start: int = 0) -> np.ndarray:
        """Raw packed bytes, shape (nframes, packed_frame_nbytes) uint8."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support packed reads"
        )

    def iter_chunks_packed(
        self, nframes: int, start: int = 0, frames_per_chunk: int = 64
    ) -> Iterator[np.ndarray]:
        self._validate_index(start + nframes - 1)
        for s in range(start, start + nframes, frames_per_chunk):
            n = min(frames_per_chunk, start + nframes - s)
            yield self.read_packed_frames(n, start=s)


class IntervalPrefetcher:
    """Background-thread decoder over an explicit list of (start, count)
    frame intervals, one yielded array per interval.

    Multi-process ingest reads per-chunk host slices — contiguous within a
    chunk but strided across the video — so the single-range
    :class:`FramePrefetcher` doesn't fit; this generalizes the same
    producer/consumer overlap (the reference's per-rank read-ahead,
    psp_process.cpp:867-908) to any interval plan.  Zero-count intervals
    yield an empty array without touching the reader.
    """

    def __init__(
        self,
        reader: VideoReader,
        intervals,  # sequence of (start, count)
        max_queued_chunks: int = 4,
        packed: bool = False,
    ):
        self.reader = reader
        self.intervals = list(intervals)
        self.packed = packed
        self._q: queue.Queue = queue.Queue(maxsize=max_queued_chunks)
        self._error: Optional[BaseException] = None

    def _empty(self) -> np.ndarray:
        r = self.reader
        if self.packed:
            return np.empty((0, r.packed_frame_nbytes), np.uint8)
        return np.empty((0, r.height, r.width), r.dtype)

    def _produce(self):
        try:
            for start, count in self.intervals:
                if count <= 0:
                    self._q.put(self._empty())
                    continue
                with timing.span("ingest.read"):
                    chunk = (self.reader.read_packed_frames(count, start)
                             if self.packed else
                             self.reader.read_frames(count, start).copy())
                self._q.put(chunk)
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
        finally:
            self._q.put(None)

    def __iter__(self):
        thread = threading.Thread(target=timing.carry(self._produce), daemon=True)
        thread.start()
        while True:
            chunk = self._q.get()
            if chunk is None:
                break
            yield chunk
        if self._error is not None:
            raise self._error
        thread.join()


class FramePrefetcher:
    """Background-thread chunk decoder feeding a bounded queue.

    Replaces the reference's volatile-flag pthread read-ahead with a proper
    producer/consumer handoff; the consumer (device feed) calls
    :meth:`__iter__` and overlaps decode with compute.
    """

    def __init__(
        self,
        reader: VideoReader,
        nframes: int,
        start: int = 0,
        frames_per_chunk: int = 64,
        max_queued_chunks: int = 4,
        packed: bool = False,
    ):
        self.reader = reader
        self.nframes = nframes
        self.start = start
        self.frames_per_chunk = frames_per_chunk
        self.packed = packed
        self._q: queue.Queue = queue.Queue(maxsize=max_queued_chunks)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _produce(self):
        try:
            it = (
                self.reader.iter_chunks_packed
                if self.packed
                else self.reader.iter_chunks
            )
            for chunk in it(self.nframes, self.start, self.frames_per_chunk):
                self._q.put(chunk.copy())
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
        finally:
            self._q.put(None)

    def __iter__(self):
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()
        while True:
            chunk = self._q.get()
            if chunk is None:
                break
            yield chunk
        if self._error is not None:
            raise self._error
        self._thread.join()
