"""Multi-rank datapoints on the CPU: the port's ``run_datapoint(mesh=)``
and ``run_datapoint_streaming(mesh=)`` on 2 and 3 gloo ranks (one process
each), and ``upsp-process-torch --distributed`` / ``--mesh auto``,
against JAX ``run_datapoint(mesh="auto")`` on 8 virtual CPU devices (in a
process of its own, configured as tests/conftest.py configures this one)
and against the port's single-process runs, from the same files on disk.

The datapoint: test_torch_slice's (2 cameras, 96x128 12-bit ``.mraw``, a
41x33 grid, jitter under 0.45 px) with 11 frames, in chunks of 5 frames,
so the last chunk holds one frame and, over 3 ranks, two ranks' blocks of
it hold only padding; 1353 nodes pad to 1354 over 2 ranks.  Phase 2 runs
out of core in blocks of 200 nodes.

Tolerances:
- against JAX: tests/test_torch_streaming.py's table (intensities and
  their frame statistics rtol 1e-4, atol 0.2 counts; ratio-derived values
  atol 5e-4; the rest exactly);
- against the port on one process: intensities rtol 1e-6, atol 1e-3
  counts (the ranks batch other frames together, and the patch matmuls
  round by their batch), frame statistics the same, ratio-derived values
  and phase 2 rtol 1e-4, atol 1e-6, the rest exactly;
- out of core, ``intensity_transpose`` is the transpose of the run's own
  ``intensity`` bit for bit, and both equal the in-memory run's on the
  same ranks bit for bit.
"""

import concurrent.futures
import faulthandler
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from upsp_tpu.io.flatfile import FLAT_FILES, read_flat
from upsp_tpu_torch.parallel.launcher import run_local_ranks
from upsp_tpu_torch.parallel.mesh import Mesh
from upsp_tpu_torch.pipeline.config import read_input_deck as t_read_input_deck
from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
from upsp_tpu_torch.pipeline.run import run_datapoint, run_datapoint_streaming
from upsp_tpu_torch.pipeline.synthetic import write_datapoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "upsp-process-torch")
N_FRAMES, CHUNK, BLOCK = 11, 5, 200
WORLDS = (2, 3)
MODES = ("memory", "stream")
RANK_TIMEOUT_S = 240
FIXTURE_TIMEOUT_S = 420  # past every process's timeout
INTENSITY = {"intensity", "intensity_transpose", "intensity_avg", "intensity_rms"}
RATIO = {"intensity_ratio_0", "pressure_transpose", "avg", "rms"}

# one rank: the in-memory run through mesh="auto" (the default group), a
# resumed run from its intensity file, the out-of-core run on the mesh
# object, then run_sharded on the frames (rank 0 saves the whole arrays)
_RANK = r"""
import faulthandler, os, shutil, sys
import numpy as np
import torch.distributed as dist
from upsp_tpu_torch.io.paint import PaintCalibration
from upsp_tpu_torch.io.wtd import read_wtd
from upsp_tpu_torch.parallel.launcher import initialize_distributed
from upsp_tpu_torch.parallel.mesh import barrier, fetch_global, make_mesh
from upsp_tpu_torch.parallel.sharded_run import run_sharded
from upsp_tpu_torch.pipeline.config import read_input_deck
from upsp_tpu_torch.pipeline.run import run_datapoint, run_datapoint_streaming

deck, root, chunk, block = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
faulthandler.dump_traceback_later(200, exit=True)  # a hang shows where
initialize_distributed(timeout_s=120)
mesh = make_mesh("cpu")
cfg = read_input_deck(deck)
cfg.out_dir = os.path.join(root, f"memory{mesh.world}")
out = run_datapoint(cfg, device="cpu", frames_per_chunk=chunk, mesh="auto",
                    registration_telemetry=True)
cfg = read_input_deck(deck)
cfg.out_dir = os.path.join(root, f"resume{mesh.world}")
if mesh.rank == 0:
    os.makedirs(cfg.out_dir)
    shutil.copy(os.path.join(root, f"memory{mesh.world}", "intensity"), cfg.out_dir)
barrier(mesh)
run_datapoint(cfg, device="cpu", frames_per_chunk=chunk, mesh=mesh, resume=True)
cfg = read_input_deck(deck)
cfg.out_dir = os.path.join(root, f"stream{mesh.world}")
run_datapoint_streaming(cfg, device="cpu", frames_per_chunk=chunk,
                        node_block=block, mesh=mesh)
res = run_sharded(out.state, np.load(os.path.join(root, "frames.npy")),
                  read_wtd(cfg.sds), PaintCalibration.read(cfg.paint_cal), mesh)
n = out.state.n_nodes
whole = {k: fetch_global(mesh, getattr(res, k)).numpy()
         for k in ("intensity", "pressure_transpose", "rms", "avg", "gain")}
whole.update(sol_avg=res.sol_avg.numpy(), sol_rms=res.sol_rms.numpy())
whole.update({k: whole[k][:n] for k in ("pressure_transpose", "rms", "avg", "gain")})
if mesh.rank == 0:
    np.savez(os.path.join(root, f"sharded{mesh.world}.npz"), **whole)
dist.destroy_process_group()
"""


def _cfg(deck, out_dir):
    cfg = t_read_input_deck(deck)
    cfg.out_dir = out_dir
    return cfg


def _ranks(cmd, n, log):
    """``cmd`` as ``n`` ranks (None: one plain process, no rank
    environment); returns (exit codes, their output)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    with open(log, "a") as fh:  # appends: the ranks' lines stay whole
        if n is None:
            rcs = [subprocess.run(cmd, env=env, stdout=fh, stderr=subprocess.STDOUT,
                                  timeout=RANK_TIMEOUT_S).returncode]
        else:
            rcs = run_local_ranks(cmd, n, timeout_s=RANK_TIMEOUT_S, env=env,
                                  stdout=fh, stderr=subprocess.STDOUT)
    with open(log) as fh:
        return rcs, fh.read()


def _cli(dp, out_dir, *flags):
    """A copy of the datapoint's deck writing to ``out_dir``, and the CLI's
    command on it."""
    with open(dp["deck"]) as fh:
        text = fh.read()
    assert text.count(dp["out_dir"]) == 1
    path = out_dir + ".inp"
    with open(path, "w") as fh:
        fh.write(text.replace(dp["out_dir"], out_dir))
    return [sys.executable, SCRIPT, "-input_deck", path, "--device", "cpu",
            "--frames-per-chunk", str(CHUNK), "--registration-telemetry"] + list(flags)


# the JAX package's references, in a process of their own under a timeout,
# configured as tests/conftest.py configures this one:
# run_datapoint(mesh="auto") on the 8 virtual CPU devices, and run_sharded
# on 3 of them (its node count, 1353, must divide over the devices; 11
# frames pad to 12 on 2 and 3 alike)
_JAX = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import faulthandler
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py sets it
import numpy as np
from upsp_tpu.io.paint import PaintCalibration
from upsp_tpu.io.wtd import read_wtd
from upsp_tpu.parallel.mesh import make_mesh
from upsp_tpu.parallel.sharded_run import run_sharded
from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu.pipeline.run import run_datapoint

deck, root, chunk = sys.argv[1], sys.argv[2], int(sys.argv[3])
faulthandler.dump_traceback_later(200, exit=True)  # a hang shows where
assert len(jax.devices()) == 8
cfg = read_input_deck(deck)
cfg.out_dir = os.path.join(root, "jax_memory")
out = run_datapoint(cfg, frames_per_chunk=chunk, mesh="auto", device_unpack=False)
res = run_sharded(out.state, np.load(os.path.join(root, "frames.npy")),
                  read_wtd(cfg.sds), PaintCalibration.read(cfg.paint_cal),
                  mesh=make_mesh(jax.devices()[:3]))
np.savez(os.path.join(root, "jax_sharded.npz"),
         **{k: np.asarray(v) for k, v in res._asdict().items()})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank processes (2 and 3 ranks through the library, 2 through the
    CLI, one CLI process with --mesh auto) and the JAX package's process
    run while this process runs the port on one process.  Every process
    is joined under a timeout, and this one is ended, with its threads'
    stacks, should it hang."""
    faulthandler.dump_traceback_later(FIXTURE_TIMEOUT_S, exit=True)
    root = str(tmp_path_factory.mktemp("dist"))
    dp = write_datapoint(root, n_frames=N_FRAMES, n_distinct=N_FRAMES, seed=1,
                         max_shift_px=0.4)
    d = lambda k: os.path.join(root, k)  # noqa: E731
    np.save(d("frames.npy"), dp["frames"])
    jobs = {f"lib{w}": ([sys.executable, "-c", _RANK, dp["deck"], root, str(CHUNK),
                         str(BLOCK)], w) for w in WORLDS}
    jobs["cli2"] = (_cli(dp, d("cli2"), "--distributed"), 2)
    jobs["auto"] = (_cli(dp, d("auto"), "--mesh", "auto"), None)
    jobs["jax"] = ([sys.executable, "-c", _JAX, dp["deck"], root, str(CHUNK)], None)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            futures = {k: pool.submit(_ranks, cmd, n, d(f"{k}.log"))
                       for k, (cmd, n) in jobs.items()}
            port = run_datapoint(_cfg(dp["deck"], d("port_memory")), device="cpu",
                                 frames_per_chunk=CHUNK, registration_telemetry=True)
            run_datapoint_streaming(_cfg(dp["deck"], d("port_stream")), device="cpu",
                                    frames_per_chunk=CHUNK, node_block=BLOCK)
            ranks = {k: f.result() for k, f in futures.items()}
    finally:
        faulthandler.cancel_dump_traceback_later()
    return dict(dp=dp, root=root, state=port.state, ranks=ranks)


def _read(runs, which, name):
    return read_flat(os.path.join(runs["root"], which, name))


def _ran(runs, job):
    rcs, out = runs["ranks"][job]
    assert rcs == [0] * len(rcs), out
    return out


def _jax_tol(name):
    if name in INTENSITY:
        return dict(rtol=1e-4, atol=0.2)
    if name in RATIO:
        return dict(rtol=0, atol=5e-4)
    return dict(rtol=0, atol=0)


def _port_tol(name):
    if name in INTENSITY:
        return dict(rtol=1e-6, atol=1e-3)
    if name in RATIO:
        return dict(rtol=1e-4, atol=1e-6)
    return dict(rtol=0, atol=0)


def _close(got, want, **tol):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    v = np.isfinite(want)
    np.testing.assert_allclose(got[v], want[v], **tol)


@pytest.mark.parametrize("name", FLAT_FILES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_flat_file_matches_jax_mesh(runs, world, mode, name):
    _ran(runs, f"lib{world}")
    _ran(runs, "jax")
    _close(_read(runs, f"{mode}{world}", name), _read(runs, "jax_memory", name),
           **_jax_tol(name))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_matches_one_process(runs, world, mode):
    _ran(runs, f"lib{world}")
    for name in FLAT_FILES:
        _close(_read(runs, f"{mode}{world}", name), _read(runs, f"port_{mode}", name),
               **_port_tol(name))


@pytest.mark.parametrize("world", WORLDS)
def test_streaming_transpose_is_exact(runs, world):
    _ran(runs, f"lib{world}")
    inten = _read(runs, f"stream{world}", "intensity").reshape(N_FRAMES, -1)
    trans = _read(runs, f"stream{world}", "intensity_transpose")
    np.testing.assert_array_equal(trans.reshape(-1, N_FRAMES), inten.T)
    for name in ("intensity", "intensity_transpose"):
        np.testing.assert_array_equal(_read(runs, f"stream{world}", name),
                                      _read(runs, f"memory{world}", name))


@pytest.mark.parametrize("world", WORLDS)
def test_resume_on_ranks(runs, world):
    """resume=True on a mesh: each rank reads its node columns of the
    intensity file, and phase 2 and the files come out as the run's."""
    _ran(runs, f"lib{world}")
    for name in FLAT_FILES:
        np.testing.assert_array_equal(_read(runs, f"resume{world}", name),
                                      _read(runs, f"memory{world}", name))


@pytest.mark.parametrize("world", WORLDS)
def test_registration_matches_one_process(runs, world):
    _ran(runs, f"lib{world}")
    got = _read(runs, f"memory{world}", "registration").reshape(N_FRAMES, 2, 5)
    want = _read(runs, "port_memory", "registration").reshape(N_FRAMES, 2, 5)
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=1e-5)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], atol=1e-4)


def test_hdf5_written_once(runs):
    """Rank 0 writes output.h5, with the frames of pressure_transpose."""
    h5py = pytest.importorskip("h5py")
    _ran(runs, "lib3")
    for mode in MODES:
        with h5py.File(os.path.join(runs["root"], f"{mode}3", "output.h5")) as f:
            press = _read(runs, f"{mode}3", "pressure_transpose").reshape(-1, N_FRAMES)
            np.testing.assert_array_equal(f["frames"][()], press)


def test_cli_distributed_two_ranks(runs):
    out = _ran(runs, "cli2")
    for r in range(2):
        assert f"rank {r} of 2 on cpu, transport gloo" in out, out
    for name in FLAT_FILES + ("registration",):
        _close(_read(runs, "cli2", name), _read(runs, "port_memory", name),
               **_port_tol(name))


def test_cli_mesh_auto_on_cpu_is_one_device(runs):
    out = _ran(runs, "auto")
    assert "on one device (--mesh auto)" in out, out
    for name in FLAT_FILES + ("registration",):
        _close(_read(runs, "auto", name), _read(runs, "port_memory", name),
               **_port_tol(name))


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("warm_start", ["fft", "scan"])
def test_chunk_program_blocks(runs, world, warm_start):
    """make_chunk_processor(mesh=): each rank's block of a padded chunk;
    put together they give the whole chunk's result (fft: within the
    one-process bounds; scan: each block starts from identity, so a block
    equals the program on that block alone, bit for bit)."""
    state = runs["state"]
    frames = runs["dp"]["frames"][:6]
    whole = make_chunk_processor(state, warm_start=warm_start, frame_batch=8)
    blocks = [make_chunk_processor(state, warm_start=warm_start, frame_batch=8,
                                   mesh=Mesh(r, world, torch.device("cpu"), None,
                                             "gloo"))(frames)
              for r in range(world)]
    rows = 6 // world
    assert [b.shape[0] for b in blocks] == [rows] * world
    if warm_start == "scan":
        for r, b in enumerate(blocks):
            torch.testing.assert_close(b, whole(frames[r * rows:(r + 1) * rows]),
                                       rtol=0, atol=0, equal_nan=True)
    else:
        _close(torch.cat(blocks).numpy(), whole(frames).numpy(), rtol=1e-6, atol=1e-3)
    with pytest.raises(ValueError, match="pad it first"):
        make_chunk_processor(state, warm_start="fft", frame_batch=8,
                             mesh=Mesh(0, 4, torch.device("cpu"), None, "gloo"))(frames)


@pytest.mark.parametrize("rcs,code", [([0, 0, 0], 0), ([0, 7, 0], 7)])
def test_cli_mesh_auto_starts_one_rank_a_card(monkeypatch, rcs, code):
    """On a host with G > 1 cards and no process group, ``--mesh auto``
    starts G ranks of the same command with ``--distributed`` (one a
    card), and exits with the first rank's failure."""
    import runpy

    import upsp_tpu_torch.parallel.launcher as launcher

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(rcs))
    monkeypatch.setattr(launcher, "run_local_ranks",
                        lambda cmd, n, **kw: calls.append((cmd, n)) or rcs)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    argv = ["-input_deck", "deck.inp", "--mesh", "auto"]
    monkeypatch.setattr(sys, "argv", [SCRIPT] + argv)
    with pytest.raises(SystemExit) as e:
        runpy.run_path(SCRIPT, run_name="__main__")
    assert e.value.code == code
    assert calls == [([sys.executable, SCRIPT] + argv + ["--distributed"], len(rcs))]


@pytest.mark.parametrize("world", WORLDS)
def test_run_sharded_matches_jax(runs, world):
    """run_sharded on 2 and 3 ranks against the JAX package's on 3
    devices: phase 1 from identity starts, statistics and phase 2 over
    the padded 12 frames (the JAX quirk kept), the test_torch_streaming
    table's bounds."""
    _ran(runs, f"lib{world}")
    _ran(runs, "jax")
    got = np.load(os.path.join(runs["root"], f"sharded{world}.npz"))
    want = np.load(os.path.join(runs["root"], "jax_sharded.npz"))
    for key, name in (("intensity", "intensity"), ("sol_avg", "intensity_avg"),
                      ("sol_rms", "intensity_rms"), ("pressure_transpose",
                                                     "pressure_transpose"),
                      ("avg", "avg"), ("rms", "rms"), ("gain", "gain")):
        assert got[key].shape == want[key].shape, key
        _close(got[key], want[key], **_jax_tol(name))
