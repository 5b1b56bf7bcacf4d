"""Build, bind and count the port's hand-written CUDA kernels.

Every source under ``upsp_tpu_torch/csrc/`` is a plain C interface over its
kernels.  A :class:`CudaLibrary` compiles one source with ``nvcc`` for
``sm_90a`` at first use, into ``build/torch_kernels/`` at the repository
root (keyed by the hash of the source and the shared ``csrc/*.cuh``
headers, so an edited source or header builds anew), loads
it with ``ctypes`` and sets the argument types.  :func:`build_all` starts
one ``nvcc`` per source, all at once.

Each wrapper adds one to its kernel's launch count where it launches the
kernel, and nowhere else; :func:`launch_counts` reads every kernel's count
and :func:`reset_launch_counts` sets them to zero.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Iterable, List, Optional

import torch

from upsp_tpu_torch.utils import timing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

_launches: Dict[str, int] = {}


def register_kernels(names: Iterable[str]) -> tuple:
    """Declare kernel names (each starts with a count of 0)."""
    names = tuple(names)
    for n in names:
        _launches.setdefault(n, 0)
    return names


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset (CUDA tensors only)."""
    return dict(_launches)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels in "
        f"{CSRC} cannot be built"
    )


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, built and loaded on first use.

    ``bind(lib)`` sets the ``argtypes``/``restype`` of the loaded library's
    functions.
    """

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu")
        self._bind = bind
        self._lock = threading.Lock()
        self._handle: Optional[ctypes.CDLL] = None
        LIBRARIES.append(self)

    def path(self) -> str:
        h = hashlib.sha256()
        # the source and the shared headers it may include
        for p in [self.source] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
            with open(p, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:12]
        return os.path.join(BUILD_DIR, f"libupsp_{self.name}_{digest}.so")

    def _start(self, verbose: bool):
        """(output path, tmp path, running nvcc) or None when built."""
        out = self.path()
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [
            nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, self.source,
        ]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return out, tmp, proc

    def _finish(self, started, verbose: bool) -> None:
        out, tmp, proc = started
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {self.source}:\n"
                f"{stdout}\n{stderr}"
            )
        if verbose and (stdout or stderr):
            print(stdout + stderr)
        os.replace(tmp, out)
        timing.count("kernel_builds")

    def build(self, verbose: bool = False) -> str:
        """Compile the source for sm_90a unless a build of this exact source
        exists; returns the library path."""
        started = self._start(verbose)
        if started is not None:
            self._finish(started, verbose)
        return self.path()

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._handle is None:
                lib = ctypes.CDLL(self.build())
                timing.count("kernel_builds")
                self._bind(lib)
                self._handle = lib
            return self._handle


LIBRARIES: List[CudaLibrary] = []


def build_all(verbose: bool = False) -> List[str]:
    """Build every source at once (one nvcc each), wait for all of them,
    and load them; raises the first failure."""
    # the modules whose wrappers declare the libraries
    from upsp_tpu_torch.ops import (  # noqa: F401
        ecc_kernels, fftreg, gather_kernels, unpack_kernels, walk_kernels)

    started = [(lib, lib._start(verbose)) for lib in LIBRARIES]
    errors = []
    for lib, s in started:
        if s is None:
            continue
        try:
            lib._finish(s, verbose)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    for lib in LIBRARIES:
        lib.lib()
    return [lib.path() for lib in LIBRARIES]
