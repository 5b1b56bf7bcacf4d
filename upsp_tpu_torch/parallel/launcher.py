"""Process-group start-up, local rank launch and per-rank work slicing.

Port of ``upsp_tpu/parallel/launcher.py`` (:21-116) on ``torch.distributed``
with one process per rank.  The reference runs ``mpiexec psp_process`` on
20-50 nodes (docs/md/upsp-swdd.md:307-312); here each rank is a process
that joins one process group, from the CLI's flags or from ``torchrun``'s
environment, and reads only its own frames of each video chunk, as the
reference's per-rank read-ahead does (psp_process.cpp:867-908).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
import subprocess
import time
from typing import List, Optional, Sequence, Tuple

import torch.distributed as dist

log = logging.getLogger("upsp_tpu.launcher")

# every collective waits at most this long, so that a rank that dies makes
# the others fail instead of hang
DEFAULT_TIMEOUT_S = 900


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    require: bool = False,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Tuple[int, int]:
    """Start the default process group; returns (rank, world size).

    Each argument that is None is read from ``torchrun``'s environment:
    ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``.  The group
    is gloo: it carries the ranks' handshake and their host-side
    collectives, and :func:`upsp_tpu_torch.parallel.mesh.make_mesh` makes
    the group of the exchange on the transport its rule picks.  With
    nothing configured this is a no-op returning (0, 1), and with
    ``require`` (``upsp-process-torch --distributed``) it raises.  A group
    already started is kept.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    addr = coordinator_address
    if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = num_processes
    if world is None and env.get("WORLD_SIZE"):
        world = int(env["WORLD_SIZE"])
    rank = process_id
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if addr is None and world is None:
        if require:
            raise RuntimeError(
                "a distributed run needs its coordinator, process count and "
                "process id: --coordinator HOST:PORT --num-processes N "
                "--process-id I, or MASTER_ADDR, MASTER_PORT, WORLD_SIZE and "
                "RANK in the environment")
        return 0, 1
    if addr is None or world is None or rank is None:
        raise ValueError(
            f"incomplete distributed set-up: coordinator {addr}, "
            f"{world} processes, process id {rank}")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("distributed: rank %d of %d, coordinator %s", rank, world, addr)
    return dist.get_rank(), dist.get_world_size()


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local_ranks(cmd: Sequence[str], n: int, timeout_s: Optional[float] = None,
                    env: Optional[dict] = None, **popen_kw) -> List[int]:
    """Run ``cmd`` as ``n`` ranks on this host and wait for all of them;
    returns their exit codes in rank order.

    Each rank gets ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``
    on a free local port) over ``env`` (default: this process's).  When a
    rank fails, the others are terminated; past ``timeout_s`` every rank
    is killed and ``TimeoutError`` raised.  ``popen_kw`` goes to
    ``subprocess.Popen`` (the ranks' output is this process's by default).
    """
    port = free_port()
    base = dict(os.environ if env is None else env)
    procs = []
    try:
        for r in range(n):
            e = dict(base, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port))
            procs.append(subprocess.Popen(list(cmd), env=e, **popen_kw))
        t_end = None if timeout_s is None else time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break  # a rank failed: the others would wait on it
            if t_end is not None and time.monotonic() > t_end:
                raise TimeoutError(f"{n} ranks of {cmd[0]} still running after "
                                   f"{timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    return [p.returncode for p in procs]


@dataclasses.dataclass(frozen=True)
class ChunkSlice:
    """One global frame chunk and this process's contiguous block of it.

    The padded chunk splits into ``process_count`` equal blocks of
    ``local_rows`` frames (rank order), so each rank decodes only its
    block: the reference's per-rank read-ahead slice
    (psp_process.cpp:867-908) applied per chunk.
    """

    start: int  # global first frame of the chunk (0-based, pre-start0)
    valid: int  # valid frames in the chunk
    padded: int  # chunk rows after padding to a device-count multiple
    local_start: int  # global index of this process's first row
    local_valid: int  # valid frames in this process's block
    local_rows: int  # rows this process contributes (incl. padding)


def chunk_plan(
    n_frames: int,
    frames_per_chunk: int,
    n_devices: int,
    process_id: int,
    process_count: int,
) -> List[ChunkSlice]:
    """Per-chunk slices of this process for multi-process video ingest."""
    if n_devices % process_count:
        raise ValueError(
            f"{n_devices} devices do not divide over {process_count} processes"
        )
    plan = []
    for s in range(0, n_frames, frames_per_chunk):
        valid = min(frames_per_chunk, n_frames - s)
        padded = -(-valid // n_devices) * n_devices
        local_rows = padded // process_count
        local_start = s + process_id * local_rows
        local_valid = max(0, min(valid - process_id * local_rows, local_rows))
        plan.append(
            ChunkSlice(s, valid, padded, local_start, local_valid, local_rows)
        )
    return plan


def host_frame_slice(n_frames: int, process_id: int, process_count: int):
    """This host's contiguous frame block (start, count): apportion parity."""
    from upsp_tpu_torch.parallel.mesh import apportion

    return apportion(n_frames, process_count)[process_id]


def host_reads_for_datapoint(cfg, process_id: int, process_count: int):
    """Open this host's video slice: returns (readers, start, count).

    Each host decodes only its own block of frames, so video ingest
    bandwidth scales with hosts like the reference's per-rank read-ahead
    (``upsp_tpu/parallel/launcher.py:106-116``)."""
    from upsp_tpu_torch.pipeline.run import open_videos

    readers, n_frames, start0 = open_videos(cfg)
    start, count = host_frame_slice(n_frames, process_id, process_count)
    return readers, start0 + start, count
