"""The port's bundle adjustment across ranks (``bundle_adjust(mesh=)``) on
gloo ranks on the CPU, one process each, against the JAX package's
``shard_map`` solve on the 8 virtual CPU devices of tests/conftest.py,
JAX's one-device solve and the port's ``mesh=None``, all float64.

Two problems, each rank holding its own block of the observations and the
rest replicated:
- "rig": tests/test_ba.py's mesh rig (3 cameras x 40 targets, O = 120,
  translations perturbed, prior 0.005, 15 LM steps), split into
  ``mesh.apportion`` blocks; against JAX's ``shard_map`` over 8 devices;
- "uneven": the same rig less one observation with another weighted out
  (O = 119), the last rank holding none; against JAX's one-device solve
  (``shard_map`` needs O divisible by the device count).

Poses and points within 1e-8, rms within 1e-9; every rank returns the same
result bit for bit; one rank of a gloo group equals ``mesh=None`` bit for
bit.  The rank processes run under a timeout, with a ``faulthandler``
watchdog in each and on the fixture, as tests/test_torch_distributed.py
runs them.
"""

import faulthandler
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsp_tpu.camera import ba as JB
from upsp_tpu.camera import model as JM
from upsp_tpu_torch.camera import ba as TB
from upsp_tpu_torch.parallel.launcher import run_local_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 3)
PROBLEMS = ("rig", "uneven")
N_ITERS = 15
RANK_TIMEOUT_S = 180
FIXTURE_TIMEOUT_S = 300  # past every process's timeout
POSE_TOL, RMS_TOL = 1e-8, 1e-9

# one rank: each problem's block of observations (the "blocks" row of the
# npz: block sizes in rank order), bundle_adjust over the gloo mesh, the
# result saved by every rank
_RANK = r"""
import faulthandler, sys
import numpy as np
import torch
import torch.distributed as dist
from upsp_tpu_torch.camera.ba import BAProblem, bundle_adjust
from upsp_tpu_torch.parallel.launcher import initialize_distributed
from upsp_tpu_torch.parallel.mesh import make_mesh

root, n_iters = sys.argv[1], int(sys.argv[2])
faulthandler.dump_traceback_later(150, exit=True)  # a hang shows where
initialize_distributed(timeout_s=60)
mesh = make_mesh("cpu")
for name in sys.argv[3:]:
    z = np.load(f"{root}/{name}.npz")
    sizes = z[f"blocks{mesh.world}"]
    a = int(sizes[:mesh.rank].sum())
    b = a + int(sizes[mesh.rank])
    prob = BAProblem(**{k: torch.from_numpy(z[k][a:b] if k in
                        ("cam_idx", "pt_idx", "uv", "weight") else z[k])
                        for k in BAProblem._fields})
    res = bundle_adjust(prob, n_iters=n_iters, mesh=mesh)
    np.savez(f"{root}/{name}.world{mesh.world}.rank{mesh.rank}.npz",
             poses=res.poses.numpy(), points=res.points.numpy(), rms=res.rms.numpy())
dist.destroy_process_group()
"""


def make_rig(rng, n_cams=3, n_pts=40, noise_px=0.05):
    """tests/test_ba.py's rig: cameras around a plate of targets; returns
    the truth and noisy observations."""
    K = np.array([[1200.0, 0, 512], [0, 1200.0, 400], [0, 0, 1]])
    dist = np.array([-0.05, 0.0, 0.0, 0.0, 0.0])
    pts = rng.uniform(-5, 5, size=(n_pts, 3)) * [1, 0.8, 0.15]
    cams, obs = [], []
    for c in range(n_cams):
        rmat = JM.rot(8.0 * (c - 1), "y") @ JM.rot(4.0, "x") @ np.diag([1.0, -1.0, -1.0])
        tvec = np.array([0.3 * c - 0.3, 0.1, 16.0 + 0.5 * c])
        p = JM.make_camera_params(rmat, tvec, K, dist)
        cams.append(p)
        uv = np.array(JM.project_points(p, jnp.asarray(pts)))
        uv = uv + rng.normal(0, noise_px, uv.shape)
        for k in range(n_pts):
            obs.append((c, k, uv[k]))
    return cams, pts, obs


def _blocks(n_obs, world, empty_last):
    """Block sizes in rank order: ``mesh.apportion``'s, or with the last
    rank holding none."""
    from upsp_tpu_torch.parallel.mesh import apportion

    if not empty_last or world == 1:
        return np.array([n for _, n in apportion(n_obs, world)])
    return np.array([n for _, n in apportion(n_obs, world - 1)] + [0])


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """Every problem through the JAX package (``shard_map`` on 8 devices,
    one device) and the port (``mesh=None``; 1, 2 and 3 gloo ranks)."""
    faulthandler.dump_traceback_later(FIXTURE_TIMEOUT_S, exit=True)
    root = str(tmp_path_factory.mktemp("ba_mesh"))
    try:
        cams, pts, obs = make_rig(np.random.default_rng(20260817))
        perturbed = [p._replace(tvec=p.tvec + jnp.asarray([0.03, -0.02, 0.05]))
                     for p in cams]
        jprobs = {"rig": JB.build_problem(perturbed, pts, obs, prior_sigma=0.005)}
        u = JB.build_problem(perturbed, pts, obs[:-1], prior_sigma=0.005)
        jprobs["uneven"] = u._replace(weight=u.weight.at[17].set(0.0))
        out = {}
        for name, jp in jprobs.items():
            z = {k: np.array(getattr(jp, k)) for k in JB.BAProblem._fields}
            z["cam_idx"], z["pt_idx"] = (z[k].astype(np.int64) for k in ("cam_idx", "pt_idx"))
            n_obs = z["uv"].shape[0]
            for w in WORLDS:
                z[f"blocks{w}"] = _blocks(n_obs, w, name == "uneven")
            np.savez(os.path.join(root, f"{name}.npz"), **z)
            tp = TB.BAProblem(**{k: torch.from_numpy(z[k]) for k in TB.BAProblem._fields})
            out[name] = {"port": TB.bundle_adjust(tp, n_iters=N_ITERS),
                         "jax_single": JB.bundle_adjust(jp, n_iters=N_ITERS),
                         "blocks": {w: z[f"blocks{w}"] for w in WORLDS}}
        out["rig"]["jax_mesh"] = _jax_shard_map(jprobs["rig"])
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        cmd = [sys.executable, "-c", _RANK, root, str(N_ITERS), *PROBLEMS]
        rcs = {}
        for w in WORLDS:
            with open(os.path.join(root, f"world{w}.log"), "w") as fh:
                rcs[w] = run_local_ranks(cmd, w, timeout_s=RANK_TIMEOUT_S, env=env,
                                         stdout=fh, stderr=subprocess.STDOUT)
    finally:
        faulthandler.cancel_dump_traceback_later()
    return dict(root=root, rcs=rcs, **out)


def _jax_shard_map(prob):
    """tests/test_ba.py's ``shard_map`` solve over every device."""
    from jax.sharding import Mesh, PartitionSpec as P

    assert len(jax.devices()) == 8 and prob.uv.shape[0] % 8 == 0
    spec = JB.BAProblem(poses=P(), points=P(), points0=P(), intrinsics=P(),
                        cam_idx=P("obs"), pt_idx=P("obs"), uv=P("obs"), weight=P("obs"),
                        prior_sigma=P())
    fn = jax.shard_map(lambda pr: JB.bundle_adjust(pr, n_iters=N_ITERS, axis_name="obs"),
                       mesh=Mesh(np.array(jax.devices()), ("obs",)), in_specs=(spec,),
                       out_specs=JB.BAResult(poses=P(), points=P(), rms=P(), n_iters=P()),
                       check_vma=False)
    return fn(prob)


def _ranks(solves, name, world):
    rc = solves["rcs"][world]
    log = open(os.path.join(solves["root"], f"world{world}.log")).read()
    assert rc == [0] * world, log[-4000:]
    return [dict(np.load(os.path.join(solves["root"],
                                      f"{name}.world{world}.rank{r}.npz")))
            for r in range(world)]


def _close(got, want):
    np.testing.assert_allclose(got["poses"], np.asarray(want.poses), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got["points"], np.asarray(want.points), rtol=0,
                               atol=POSE_TOL)
    assert abs(float(got["rms"]) - float(want.rms)) <= RMS_TOL


@pytest.mark.parametrize("name", PROBLEMS)
def test_one_rank_equals_mesh_none(solves, name):
    (got,) = _ranks(solves, name, 1)
    want = solves[name]["port"]
    for k in ("poses", "points", "rms"):
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy(), err_msg=k)


@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("world", WORLDS[1:])
def test_matches_mesh_none(solves, world, name):
    blocks = solves[name]["blocks"][world]
    assert blocks.sum() == (120 if name == "rig" else 119)
    if name == "uneven":
        assert blocks[-1] == 0  # the last rank holds no observations
    _close(_ranks(solves, name, world)[0], solves[name]["port"])


@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("world", WORLDS[1:])
def test_matches_jax(solves, world, name):
    """The rig against JAX's 8-device ``shard_map`` solve; the uneven
    problem (O = 119) against JAX's one-device solve."""
    want = solves[name]["jax_mesh" if name == "rig" else "jax_single"]
    _close(_ranks(solves, name, world)[0], want)


@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("world", WORLDS[1:])
def test_ranks_agree(solves, world, name):
    """The replicated solve keeps the ranks in lockstep: every rank's
    result equals rank 0's bit for bit."""
    ranks = _ranks(solves, name, world)
    for r, got in enumerate(ranks[1:], 1):
        for k in ("poses", "points", "rms"):
            np.testing.assert_array_equal(got[k], ranks[0][k], err_msg=f"rank {r} {k}")


def test_port_single_matches_jax(solves):
    """The port's ``mesh=None`` against JAX's one device and its
    ``shard_map`` solve on the rig, so both references agree here."""
    _close({k: getattr(solves["rig"]["port"], k).numpy() for k in ("poses", "points", "rms")},
           solves["rig"]["jax_single"])
    _close({k: np.asarray(getattr(solves["rig"]["jax_mesh"], k))
            for k in ("poses", "points", "rms")}, solves["rig"]["jax_single"])
