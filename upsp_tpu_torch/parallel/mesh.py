"""Ranks, block ranges and collectives: the substrate of multi-device runs.

Port of ``upsp_tpu/parallel/mesh.py`` (:31-168) on ``torch.distributed``
with one process per rank.  The reference is a frames x nodes block
decomposition over MPI ranks with one global transpose, reductions and
broadcasts (SURVEY.md section 2.3).  Here:

- a :class:`Mesh` is this rank, the world size, the rank's device and the
  process group of the exchange (the JAX package's device mesh);
- phase 1 gives each rank a contiguous block of the frame axis, phase 2
  a contiguous block of the node axis, each of a dimension padded to a
  multiple of the world size (:func:`frame_sharding`,
  :func:`node_sharding`: the JAX shardings as ``[start, stop)`` ranges);
- the frames->nodes transpose (psp_process.cpp:707-771) is one
  ``all_to_all_single`` (:func:`global_transpose`);
- the f64 statistic partials are summed by :func:`all_reduce`, full
  arrays are gathered to every rank by :func:`fetch_global`, or to one
  by :func:`gather`.

The transport is a fixed rule, logged once: NCCL on the device tensors
where every rank of a host has a card of its own; gloo, through pinned
host buffers, where ranks share a card (NCCL refuses two ranks on one
card) or run on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger("upsp_tpu")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank of a run over ``world`` ranks (one process each)."""

    rank: int
    world: int
    device: torch.device  # this rank's device
    group: Optional[object]  # the exchange's process group; None at one rank
    backend: str  # the transport: "nccl", "gloo", or "none" at one rank
    n_hosts: int = 1


def resolve_device(device) -> torch.device:
    """``cuda`` or ``cpu``; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def make_mesh(device="cuda") -> Mesh:
    """The mesh of every rank of the default process group
    (:func:`~upsp_tpu_torch.parallel.launcher.initialize_distributed`);
    one rank on ``device`` when no group is up.

    On CUDA a rank's device is ``cuda:{LOCAL_RANK % device_count}``
    (``LOCAL_RANK`` from the environment, else the rank's place among the
    ranks of its host).  Every rank must call this together: it gathers
    each rank's host and card, picks the transport by the rule above and
    makes the exchange's group.
    """
    device = resolve_device(device)
    if not dist.is_initialized():
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return Mesh(0, 1, device, None, "none")
    rank, world = dist.get_rank(), dist.get_world_size()
    host = socket.gethostname()
    hosts = [None] * world
    dist.all_gather_object(hosts, host)
    if device.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        local = int(local) if local else hosts[:rank].count(host)
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    cards = [None] * world
    dist.all_gather_object(cards, (host, device.type, device.index))
    backend, why = transport(cards)
    group = dist.new_group(backend=backend)
    mesh = Mesh(rank, world, device, group, backend, len(set(hosts)))
    if rank == 0:
        log.info("mesh: %d ranks on %d host(s), transport %s (%s)",
                 world, mesh.n_hosts, backend, why)
    return mesh


def transport(cards) -> Tuple[str, str]:
    """The transport rule: (backend, reason) from every rank's (host,
    device type, device index).  NCCL where every rank is on CUDA and no
    two ranks of a host share a card; gloo otherwise."""
    if any(kind != "cuda" for _, kind, _ in cards):
        return "gloo", "ranks on the CPU"
    if len(set(cards)) < len(cards):
        return "gloo", "ranks share a card"
    return "nccl", "every rank of a host has a card of its own"


def padded(n: int, world: int) -> int:
    """``n`` rounded up to a multiple of ``world``."""
    return -(-n // world) * world


def frame_sharding(mesh: Mesh, n: int) -> Tuple[int, int]:
    """This rank's ``[start, stop)`` of a frame axis of ``n``, padded to a
    multiple of the world size (stop may pass ``n``)."""
    rows = padded(n, mesh.world) // mesh.world
    return mesh.rank * rows, (mesh.rank + 1) * rows


# phase 2 decomposes the node axis over the same ranks, as the reference
# decomposes both phases over one rank space (upsp_tpu/parallel/mesh.py:78)
node_sharding = frame_sharding


def local_block(mesh: Mesh, a):
    """This rank's rows of a full array ``a`` (numpy or tensor): returns
    ``(row_start, a[row_start:stop])``, cut at ``a``'s end."""
    start, stop = frame_sharding(mesh, a.shape[0])
    return start, a[start:min(stop, a.shape[0])]


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the transport takes it: contiguous, and in a pinned host
    buffer when gloo carries a device tensor."""
    t = t.contiguous()
    if mesh.backend == "gloo" and t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def global_transpose(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """This rank's ``(F_pad/D, N_pad)`` frame block -> its ``(N_pad/D,
    F_pad)`` node block, by one ``all_to_all_single``: the reference's
    global_transpose (psp_process.cpp:707-771,
    cpp/exec/upsp_matrix_transpose.cpp).  Rank j's frame rows land in
    columns ``[j * F_pad/D, (j + 1) * F_pad/D)``.  On the block's device."""
    rows, n_pad = block.shape
    if n_pad % mesh.world:
        raise ValueError(f"{n_pad} columns do not divide over {mesh.world} ranks")
    if mesh.group is None:
        return block.T.contiguous()
    n_loc = n_pad // mesh.world
    send = _wire(mesh, block.reshape(rows, mesh.world, n_loc).transpose(0, 1))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    # recv[j] is rank j's (rows, n_loc) piece of this rank's nodes
    return recv.to(block.device).permute(2, 0, 1).reshape(n_loc, mesh.world * rows)


def fetch_global(mesh: Mesh, block: torch.Tensor, device=None) -> torch.Tensor:
    """Every rank's equal-sized block concatenated along axis 0, in rank
    order (the JAX package's allgather of a sharded array), on ``device``
    (default: the block's)."""
    device = block.device if device is None else torch.device(device)
    if mesh.group is None:
        return block.to(device)
    send = _wire(mesh, block)
    parts = [torch.empty_like(send) for _ in range(mesh.world)]
    dist.all_gather(parts, send, group=mesh.group)
    return torch.cat([p.to(device) for p in parts])


def all_reduce(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (the reference's MPI_Reduce(SUM)),
    on ``t``'s device; ``t`` may be overwritten with it."""
    if mesh.group is None:
        return t
    w = _wire(mesh, t)
    dist.all_reduce(w, group=mesh.group)
    return w.to(t.device)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, on ``t``'s device; ``t`` may be
    overwritten with it."""
    if mesh.group is None:
        return t
    w = _wire(mesh, t)
    dist.broadcast(w, src=src, group=mesh.group)
    return w.to(t.device)


def gather(mesh: Mesh, block: torch.Tensor, device=None, dst: int = 0):
    """Every rank's equal-sized block concatenated along axis 0, in rank
    order, on rank ``dst`` alone (on ``device``, default the block's);
    None on the other ranks."""
    device = block.device if device is None else torch.device(device)
    if mesh.group is None:
        return block.to(device)
    send = _wire(mesh, block)
    parts = ([torch.empty_like(send) for _ in range(mesh.world)]
             if mesh.rank == dst else None)
    dist.gather(send, parts, dst=dst, group=mesh.group)
    return None if parts is None else torch.cat([p.to(device) for p in parts])


def barrier(mesh: Mesh) -> None:
    """Wait, on the host, until every rank has reached this point, after
    this rank's device work.  A collective on NCCL only orders the card's
    stream and returns to the host at once; ``dist.barrier`` blocks the
    host on every backend, and the stream sync after it makes sure of it
    on NCCL."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    if mesh.group is None:
        return
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        torch.cuda.synchronize(mesh.device)
    else:
        dist.barrier(group=mesh.group)


def apportion(total: int, ranks: int) -> list:
    """Contiguous block sizes per rank (reference apportion,
    psp_process.cpp:611), kept for host-side IO splitting."""
    base = total // ranks
    rem = total % ranks
    sizes = [base + (1 if r < rem else 0) for r in range(ranks)]
    starts = [sum(sizes[:r]) for r in range(ranks)]
    return list(zip(starts, sizes))


def pad_to_multiple(array: torch.Tensor, axis: int, multiple: int, value=0.0):
    """Pad an axis up to a multiple of ``multiple`` with ``value``; returns
    ``(array, original size)``."""
    array = torch.as_tensor(array)
    size = array.shape[axis]
    target = padded(size, multiple)
    if target == size:
        return array, size
    shape = list(array.shape)
    shape[axis] = target - size
    fill = torch.full(shape, value, dtype=array.dtype, device=array.device)
    return torch.cat([array, fill], dim=axis), size
