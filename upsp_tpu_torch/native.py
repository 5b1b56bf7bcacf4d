"""ctypes bindings for the native host-runtime library (cpp/upsp_native.cpp).

Every function degrades to the pure-numpy implementation when the shared
library is absent, so the package never *requires* a compiler.  Build with::

    make -C cpp

A copy of ``upsp_tpu/native.py`` (the port imports nothing of the JAX
package).  :func:`native_library` builds the library with make when it is
missing.  The flat-file transpose runs a numpy blocked transpose when the
library is absent (logged), the file has fewer rows than a native block,
or a rank transposes only its columns; without the library the async
writer writes synchronously (logged).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import sys
from typing import Optional

import numpy as np

from upsp_tpu_torch.utils import timing

log = logging.getLogger("upsp_tpu")

_CPP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "cpp")
_LIB_PATHS = (os.path.join(_CPP_DIR, "libupsp_native.so"), "libupsp_native.so")


def _load() -> Optional[ctypes.CDLL]:
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(p)
            break
        except OSError:
            continue
    else:
        return None
    lib.upsp_unpack_12bpp.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p
    ]
    lib.upsp_unpack_10bpp.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p
    ]
    lib.upsp_bvh_max_nodes.argtypes = [ctypes.c_int64]
    lib.upsp_bvh_max_nodes.restype = ctypes.c_int64
    lib.upsp_bvh_build.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int
    ] + [ctypes.c_void_p] * 6
    lib.upsp_bvh_build.restype = ctypes.c_int64
    lib.upsp_bvh_intersect.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
        + [ctypes.c_int64] + [ctypes.c_void_p] * 2
    )
    lib.upsp_transpose_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.upsp_transpose_f32.restype = ctypes.c_int
    lib.upsp_awrite_open.argtypes = [ctypes.c_char_p]
    lib.upsp_awrite_open.restype = ctypes.c_void_p
    lib.upsp_awrite_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64
    ]
    lib.upsp_awrite_submit.restype = ctypes.c_int
    lib.upsp_awrite_close.argtypes = [ctypes.c_void_p]
    lib.upsp_awrite_close.restype = ctypes.c_int
    return lib


_LIB = _load()


def available() -> bool:
    return _LIB is not None


_BUILD_ERROR = None  # why make did not build the library (it is not tried again)


def native_library():
    """This module with its library loaded: builds ``cpp/`` with make when
    the shared library is missing, and raises naming it if that fails (a
    failed build is not tried again)."""
    global _LIB, _BUILD_ERROR
    if _LIB is None and _BUILD_ERROR is None:
        log.info("native BVH library missing; building it with make -C %s", _CPP_DIR)
        proc = subprocess.run(["make", "-C", _CPP_DIR], capture_output=True, text=True)
        _LIB = _load()
        timing.count("kernel_builds")
        if proc.returncode != 0 or _LIB is None:
            _BUILD_ERROR = (
                f"the native BVH library {_CPP_DIR}/libupsp_native.so is missing "
                f"and `make -C {_CPP_DIR}` did not build it:\n{proc.stdout}\n"
                f"{proc.stderr}")
            raise RuntimeError(_BUILD_ERROR)
    if _LIB is None:
        raise RuntimeError(_BUILD_ERROR)
    return sys.modules[__name__]


def native_or_none():
    """:func:`native_library`, or None (the reason logged) when the library
    cannot be built."""
    try:
        return native_library()
    except RuntimeError as e:
        log.warning("%s", e)
        return None


def unpack_12bpp(buf) -> np.ndarray:
    """Native 12-bit unpack; numpy fallback otherwise."""
    data = np.frombuffer(buf, np.uint8)
    if _LIB is None:
        from upsp_tpu_torch.io.video.util import unpack_12bpp as np_unpack

        return np_unpack(data)
    n = data.size // 3 * 2
    out = np.empty(n, np.uint16)
    _LIB.upsp_unpack_12bpp(
        data.ctypes.data_as(ctypes.c_void_p), data.size // 3 * 3,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def unpack_10bpp(buf) -> np.ndarray:
    data = np.frombuffer(buf, np.uint8)
    if _LIB is None:
        from upsp_tpu_torch.io.video.util import unpack_10bpp as np_unpack

        return np_unpack(data)
    n = data.size // 5 * 4
    out = np.empty(n, np.uint16)
    _LIB.upsp_unpack_10bpp(
        data.ctypes.data_as(ctypes.c_void_p), data.size // 5 * 5,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def build_bvh(vertices: np.ndarray, triangles: np.ndarray, leaf_size: int = 4,
              method: str = "median"):
    """Native BVH build returning a FlatBVH (python layout contract).

    ``method``: "median" (fast build — phase-0 default) or "sah" (bucketed
    surface-area-heuristic splits, the reference's pbrt-style choice at
    pspRT.cpp:499-525 — slower build, faster traversal; worth it at
    campaign scale where the visibility ray budget dominates the build)."""
    from upsp_tpu_torch.geometry.bvh import FlatBVH, build_bvh as py_build

    if method not in ("median", "sah"):
        raise ValueError(f"method must be median|sah, got {method!r}")
    if _LIB is None:
        return py_build(vertices, triangles, leaf_size, method=method)
    v = np.ascontiguousarray(vertices, np.float32)
    t = np.ascontiguousarray(triangles, np.int32)
    T = t.shape[0]
    cap = int(_LIB.upsp_bvh_max_nodes(T))
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    escape = np.empty(cap, np.int32)
    leaf_start = np.empty(cap, np.int32)
    leaf_count = np.empty(cap, np.int32)
    order = np.empty(T, np.int64)
    M = int(
        _LIB.upsp_bvh_build(
            v.ctypes.data_as(ctypes.c_void_p),
            t.ctypes.data_as(ctypes.c_void_p),
            T, leaf_size, 1 if method == "sah" else 0,
            bmin.ctypes.data_as(ctypes.c_void_p),
            bmax.ctypes.data_as(ctypes.c_void_p),
            escape.ctypes.data_as(ctypes.c_void_p),
            leaf_start.ctypes.data_as(ctypes.c_void_p),
            leaf_count.ctypes.data_as(ctypes.c_void_p),
            order.ctypes.data_as(ctypes.c_void_p),
        )
    )
    p0 = v[t[order, 0]]
    p1 = v[t[order, 1]]
    p2 = v[t[order, 2]]
    return FlatBVH(
        bbox_min=bmin[:M].copy(),
        bbox_max=bmax[:M].copy(),
        escape=escape[:M].copy(),
        leaf_start=leaf_start[:M].copy(),
        leaf_count=leaf_count[:M].copy(),
        tri_v0=p0,
        tri_e1=p1 - p0,
        tri_e2=p2 - p0,
        tri_id=order.astype(np.int32),
    )


def bvh_intersect(flat, origins: np.ndarray, directions: np.ndarray):
    """Native multithreaded closest-hit traversal over a FlatBVH.

    Returns (t (R,), prim (R,), hit (R,)) with the same semantics as the JAX
    traversal (ops/raycast.py).  Raises when the library is unavailable —
    callers choose the JAX path explicitly in that case.
    """
    if _LIB is None:
        raise RuntimeError("native library unavailable")
    o = np.ascontiguousarray(origins, np.float32)
    d = np.ascontiguousarray(directions, np.float32)
    R = o.shape[0]
    out_t = np.empty(R, np.float32)
    out_prim = np.empty(R, np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    bb_min = np.ascontiguousarray(flat.bbox_min, np.float32)
    bb_max = np.ascontiguousarray(flat.bbox_max, np.float32)
    esc = np.ascontiguousarray(flat.escape, np.int32)
    ls = np.ascontiguousarray(flat.leaf_start, np.int32)
    lc = np.ascontiguousarray(flat.leaf_count, np.int32)
    v0 = np.ascontiguousarray(flat.tri_v0, np.float32)
    e1 = np.ascontiguousarray(flat.tri_e1, np.float32)
    e2 = np.ascontiguousarray(flat.tri_e2, np.float32)
    ti = np.ascontiguousarray(flat.tri_id, np.int32)
    _LIB.upsp_bvh_intersect(
        ptr(bb_min), ptr(bb_max), ptr(esc), ptr(ls), ptr(lc),
        ptr(v0), ptr(e1), ptr(e2), ptr(ti),
        flat.n_nodes, ptr(o), ptr(d), R, ptr(out_t), ptr(out_prim),
    )
    hit = out_prim >= 0
    return out_t, out_prim, hit


def transpose_f32(src: str, dst: str, rows: int, cols: int, block: int = 2048,
                  columns=None):
    """Blocked transpose of a (rows, cols) float32 flat file into a
    (cols, rows) one: native when available and ``rows >= block``, else
    numpy.  The native loop writes each destination row of a block with
    its own call, ``min(rows, block) * 4`` bytes; with fewer rows than a
    block those writes are short and the numpy transpose, which writes
    whole destination rows at once, is the faster (PERF.md section 6).
    ``columns`` = (c0, c1), a rank's block of the source columns, goes to
    :func:`transpose_f32_numpy` unless it is every column."""
    if columns is not None and tuple(columns) != (0, cols):
        transpose_f32_numpy(src, dst, rows, cols, columns=columns)
        return
    if _LIB is None:
        log.info("native library unavailable: numpy flat-file transpose")
    if _LIB is None or rows < block:
        transpose_f32_numpy(src, dst, rows, cols)
    else:
        transpose_f32_native(src, dst, rows, cols, block)


def transpose_f32_native(src: str, dst: str, rows: int, cols: int,
                         block: int = 2048):
    """The native transpose, ``block`` x ``block`` at a time; raises
    without the library."""
    if _LIB is None:
        raise RuntimeError("native library unavailable")
    rc = _LIB.upsp_transpose_f32(src.encode(), dst.encode(), rows, cols, block)
    if rc != 0:
        raise OSError(f"upsp_transpose_f32 failed with code {rc}")


def transpose_f32_numpy(src: str, dst: str, rows: int, cols: int,
                        max_bytes: int = 1 << 30, columns=None):
    """The numpy transpose: as many source columns at a time as fit
    ``max_bytes`` (at least one), each source row's piece of them read
    with one call, then written as whole destination rows with one.
    ``columns`` = (c0, c1) transposes only those source columns, into
    rows [c0, c1) of an existing (cols, rows) ``dst``, which is otherwise
    written anew."""
    lo, hi = (0, cols) if columns is None else columns
    width = max(1, min(hi - lo, max_bytes // max(rows * 4, 1)))
    buf = np.empty(rows * width, "<f4")
    with open(src, "rb", buffering=0) as fin, \
            open(dst, "wb" if columns is None else "r+b") as fout:
        fout.seek(lo * rows * 4)
        for c0 in range(lo, hi, width):
            cw = min(width, hi - c0)
            piece = buf[: rows * cw].reshape(rows, cw)
            for r in range(rows):
                got = os.preadv(fin.fileno(), [piece[r]], (r * cols + c0) * 4)
                if got != cw * 4:
                    raise OSError(f"short read of {src} at row {r}: {got} bytes")
            np.ascontiguousarray(piece.T).tofile(fout)


class AsyncWriter:
    """Write-behind queue over one output file (native when available).

    ``submit`` copies the data before it returns, so the caller may reuse
    its buffer at once."""

    def __init__(self, path: str):
        self.path = path
        self._handle = None
        self._fallback = None
        if _LIB is not None:
            self._handle = _LIB.upsp_awrite_open(path.encode())
        if self._handle is None:
            log.info("native async writer unavailable: synchronous writes to %s",
                     path)
            # O_CREAT without O_TRUNC, like the native path
            fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
            self._fallback = os.fdopen(fd, "wb")

    def submit(self, offset_bytes: int, data: np.ndarray) -> None:
        buf = np.ascontiguousarray(data)
        if self._handle is not None:
            rc = _LIB.upsp_awrite_submit(
                self._handle, offset_bytes,
                buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes,
            )
            if rc != 0:
                raise OSError("awrite_submit failed")
        else:
            self._fallback.seek(offset_bytes)
            self._fallback.write(buf.tobytes())

    def close(self) -> None:
        if self._handle is not None:
            rc = _LIB.upsp_awrite_close(self._handle)
            self._handle = None
            if rc != 0:
                raise OSError("async writes reported errors")
        elif self._fallback is not None:
            self._fallback.close()
            self._fallback = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
