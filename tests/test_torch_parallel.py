"""The port's ``parallel`` package on the CPU: its numpy helpers against
``upsp_tpu.parallel``'s, and its collectives with 2 and 3 gloo ranks.

Helpers (``apportion``, ``pad_to_multiple``, ``chunk_plan``,
``host_frame_slice``): equal to the JAX package's, exactly.  Collectives
(``global_transpose``, ``fetch_global``, ``gather``, ``local_block``,
``all_reduce``, ``broadcast``, ``barrier``): each rank is a process of its
own, started on a free local port with torchrun's environment and joined
under a timeout; on uneven frame and node counts (7 x 11) they must give
numpy's transpose, the whole array and the sums (f64, rtol 1e-12).  The
barrier must hold the host even where the collectives do not.  A rank
whose peer dies must fail its collective and exit non-zero by itself.  The
chunk program's ``mesh`` split runs in this process (it needs no
collective): each rank's block of a padded chunk, put together, gives
the program's result on the whole chunk, and in scan mode each block
starts from identity.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from upsp_tpu.parallel import launcher as j_launcher
from upsp_tpu.parallel import mesh as j_mesh
from upsp_tpu_torch.parallel import launcher as t_launcher
from upsp_tpu_torch.parallel import mesh as t_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120

_EXCHANGE = r"""
import faulthandler
import os
import numpy as np
import torch
import torch.distributed as dist
from upsp_tpu_torch.parallel import mesh as M
from upsp_tpu_torch.parallel.launcher import initialize_distributed

faulthandler.dump_traceback_later(100, exit=True)  # a hang shows where
rank, world = initialize_distributed(timeout_s=60)
mesh = M.make_mesh("cpu")
assert (mesh.rank, mesh.world, mesh.backend, mesh.n_hosts) == (rank, world, "gloo", 1)
F, N = 7, 11
a = np.random.default_rng(5).standard_normal((F, N)).astype(np.float32)
full = np.zeros((M.padded(F, world), M.padded(N, world)), np.float32)
full[:F, :N] = a
f0, f1 = M.frame_sharding(mesh, F)
n0, n1 = M.node_sharding(mesh, N)
block = torch.from_numpy(full[f0:f1].copy())
assert np.array_equal(M.global_transpose(mesh, block).numpy(), full.T[n0:n1])
assert np.array_equal(M.fetch_global(mesh, block).numpy(), full)
g = M.gather(mesh, block)
assert (g is None) == (rank != 0)
assert g is None or np.array_equal(g.numpy(), full)
start, rows = M.local_block(mesh, a)
assert start == f0 and np.array_equal(rows, a[f0:min(f1, F)])
s = M.all_reduce(mesh, torch.from_numpy(full[f0:f1].astype(np.float64)).sum(0))
np.testing.assert_allclose(s.numpy(), full.astype(np.float64).sum(0), rtol=1e-12)
assert (M.broadcast(mesh, torch.full((3,), float(rank)), src=0) == 0).all()
M.barrier(mesh)
dist.destroy_process_group()
os.write(1, f"OK {rank}\n".encode())  # one write: the ranks share the log
"""

# rank 1 leaves after the group is up; rank 0's next collective must fail
_PEER_DIES = r"""
import sys
import torch
from upsp_tpu_torch.parallel import mesh as M
from upsp_tpu_torch.parallel.launcher import initialize_distributed

rank, world = initialize_distributed(timeout_s=30)
mesh = M.make_mesh("cpu")
if rank == 1:
    sys.exit(3)
M.global_transpose(mesh, torch.zeros(2, 4))
print("collective returned", flush=True)
"""

# rank 0 sizes a file late; rank 1 must not pass the barrier before it has,
# even when the group's collectives return to the host at once, as NCCL's
# do (they only order the card's stream)
_BARRIER = r"""
import faulthandler
import os
import sys
import time
import torch.distributed as dist
from upsp_tpu_torch.parallel import mesh as M
from upsp_tpu_torch.parallel.launcher import initialize_distributed
from upsp_tpu_torch.pipeline.run import _ensure_file_size

faulthandler.dump_traceback_later(100, exit=True)
rank, world = initialize_distributed(timeout_s=60)
mesh = M.make_mesh("cpu")
for name in ("all_reduce", "all_gather", "broadcast", "all_to_all_single", "gather"):
    real = getattr(dist, name)
    setattr(dist, name, lambda *a, _real=real, **k: _real(*a, **dict(k, async_op=True)))
path = sys.argv[1]
if rank == 0:
    time.sleep(1.0)
    _ensure_file_size(path, 4096)
M.barrier(mesh)
assert os.path.exists(path) and os.path.getsize(path) == 4096, rank
M.barrier(mesh)
dist.destroy_process_group()
os.write(1, f"OK {rank}\n".encode())
"""


def _ranks(src, n, tmp_path, *args):
    """Run ``src`` as ``n`` ranks; returns (exit codes, their output)."""
    log = tmp_path / f"ranks{n}.log"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    with open(log, "a") as fh:  # appends: the ranks' lines stay whole
        rcs = t_launcher.run_local_ranks([sys.executable, "-c", src, *args], n,
                                         timeout_s=RANK_TIMEOUT_S, env=env,
                                         stdout=fh, stderr=subprocess.STDOUT)
    return rcs, log.read_text()


@pytest.mark.parametrize("total,ranks", [(10, 3), (7, 2), (2, 3), (64, 8), (0, 4)])
def test_apportion_matches_jax(total, ranks):
    assert t_mesh.apportion(total, ranks) == j_mesh.apportion(total, ranks)


@pytest.mark.parametrize("size,multiple,value", [(7, 3, 0.0), (9, 3, 0.0),
                                                 (5, 8, -1.0), (1, 2, 7.0)])
def test_pad_to_multiple_matches_jax(size, multiple, value):
    a = np.random.default_rng(size).standard_normal((2, size, 3)).astype(np.float32)
    got, n = t_mesh.pad_to_multiple(torch.from_numpy(a), 1, multiple, value)
    want, m = j_mesh.pad_to_multiple(a, 1, multiple, value)
    assert n == m == size
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (frames, chunk, devices, processes): the last chunk of (11, 5, 3, 3)
# and (9, 4, 4, 4) leaves ranks whose block holds only padding
PLANS = [(11, 5, 3, 3), (11, 5, 2, 2), (9, 4, 4, 4), (64, 64, 2, 2),
         (10, 4, 8, 2), (3, 8, 1, 1)]


@pytest.mark.parametrize("n_frames,chunk,n_dev,n_proc", PLANS)
def test_chunk_plan_matches_jax(n_frames, chunk, n_dev, n_proc):
    for pid in range(n_proc):
        got = t_launcher.chunk_plan(n_frames, chunk, n_dev, pid, n_proc)
        want = j_launcher.chunk_plan(n_frames, chunk, n_dev, pid, n_proc)
        assert [tuple(vars(c).values()) for c in got] == [
            tuple(vars(c).values()) for c in want]
    # every valid frame belongs to exactly one process's block
    seen = np.zeros(n_frames, int)
    for pid in range(n_proc):
        for c in t_launcher.chunk_plan(n_frames, chunk, n_dev, pid, n_proc):
            seen[c.local_start : c.local_start + c.local_valid] += 1
    assert (seen == 1).all()


def test_chunk_plan_has_padding_only_blocks():
    last = t_launcher.chunk_plan(11, 5, 3, 2, 3)[-1]
    assert (last.valid, last.padded, last.local_rows, last.local_valid) == (1, 3, 1, 0)
    with pytest.raises(ValueError):
        t_launcher.chunk_plan(8, 4, 3, 0, 2)


@pytest.mark.parametrize("n_frames,n_proc", [(11, 3), (10, 2), (2, 4), (64, 1)])
def test_host_frame_slice_matches_jax(n_frames, n_proc):
    for pid in range(n_proc):
        assert (t_launcher.host_frame_slice(n_frames, pid, n_proc)
                == j_launcher.host_frame_slice(n_frames, pid, n_proc))


@pytest.mark.parametrize("n,world", [(11, 3), (12, 3), (7, 2), (2, 4)])
def test_block_ranges_tile_the_padded_axis(n, world):
    ranges = [t_mesh.frame_sharding(t_mesh.Mesh(r, world, torch.device("cpu"),
                                                None, "none"), n)
              for r in range(world)]
    assert ranges[0][0] == 0 and ranges[-1][1] == t_mesh.padded(n, world)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert len({b - a for a, b in ranges}) == 1


@pytest.mark.parametrize("world", [2, 3])
def test_exchange_on_gloo_ranks(world, tmp_path):
    rcs, out = _ranks(_EXCHANGE, world, tmp_path)
    assert rcs == [0] * world, out
    assert sorted(line for line in out.splitlines() if line.startswith("OK")) == [
        f"OK {r}" for r in range(world)], out


def test_barrier_blocks_the_host(tmp_path):
    rcs, out = _ranks(_BARRIER, 2, tmp_path, str(tmp_path / "sized"))
    assert rcs == [0, 0], out
    assert sorted(line for line in out.splitlines() if line.startswith("OK")) == [
        "OK 0", "OK 1"], out


def test_collective_fails_when_a_peer_dies(tmp_path):
    """Not through run_local_ranks, which would stop rank 0 itself: rank 0
    must leave its collective with an error, within the group's timeout."""
    port = t_launcher.free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", RANK=str(r),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", _PEER_DIES], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert procs[1].returncode == 3, outs[1]
    assert procs[0].returncode != 0, outs[0]
    assert "collective returned" not in outs[0]


def test_distributed_is_required_when_asked(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert t_launcher.initialize_distributed() == (0, 1)
    with pytest.raises(RuntimeError, match="coordinator"):
        t_launcher.initialize_distributed(require=True)
    with pytest.raises(ValueError, match="incomplete"):
        t_launcher.initialize_distributed(num_processes=2)


@pytest.mark.parametrize("cards,backend", [
    ([("h", "cuda", 0), ("h", "cuda", 1)], "nccl"),
    ([("h", "cuda", 0), ("g", "cuda", 0)], "nccl"),  # one card a host
    ([("h", "cuda", 0)], "nccl"),
    ([("h", "cuda", 0), ("h", "cuda", 0)], "gloo"),  # NCCL refuses this
    ([("h", "cuda", 0), ("h", "cuda", 1), ("g", "cuda", 1), ("g", "cuda", 1)], "gloo"),
    ([("h", "cpu", None), ("h", "cpu", None)], "gloo"),
])
def test_transport_rule(cards, backend):
    assert t_mesh.transport(cards)[0] == backend


def test_single_rank_mesh_without_a_group():
    m = t_mesh.make_mesh("cpu")
    assert (m.rank, m.world, m.group, m.backend) == (0, 1, None, "none")
    x = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(t_mesh.global_transpose(m, x), x.T)
    assert torch.equal(t_mesh.fetch_global(m, x), x)
