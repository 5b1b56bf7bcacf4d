"""The port's device BVH walk (``upsp_tpu_torch/ops/raycast.py``) against
``upsp_tpu.ops.raycast`` on the CPU.

Scene: a 33 x 33-node plate (2,048 triangles) under a box occluder whose
faces are split into 6 x 6 quads (432 triangles), one BVH built by the
JAX package's builder and copied to both.  Rays: from three camera centres
to random plate points, to every grid node of a patch (vertex grazing),
through the midpoints of shared edges and the box's face diagonals, along
an edge's own line, and in random directions (misses included).

The JAX functions run in a subprocess whose XLA may not use FMA
instructions (``--xla_cpu_max_isa=AVX``): with them, XLA contracts a
multiply and an add into one rounding inside the jitted walk (the JAX
package's comment at ``upsp_tpu/ops/raycast.py:118-129``), so a ray
through a vertex or an edge takes another of the triangles there, or
leaks through Möller–Trumbore's edge tests; without them each multiply and
add rounds on its own, as torch's ops do.  Against that reference
``bvh_intersect`` with both intersectors gives the same ``prim``, ``hit``
and ``t`` (the stated bounds: prim and hit exact, t rtol 1e-6; it is exact
here), whatever the walk's look interval, and ``node_visibility`` (primary
rays and the jittered retries) the same visibility and prims.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from upsp_tpu.geometry.bvh import build_bvh as j_build_bvh
from upsp_tpu_torch.geometry.bvh import build_bvh as t_build_bvh
from upsp_tpu_torch.ops import raycast as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX side: every reference result of this file, written to an npz
_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from upsp_tpu.geometry.bvh import build_bvh
from upsp_tpu.ops import raycast as J

s = dict(np.load(sys.argv[1]))
flat = build_bvh(s["verts"], s["tris"], 4)
bvh = J.bvh_to_device(flat)
o = jnp.asarray(s["o"], jnp.float32)
d = jnp.asarray(s["d"], jnp.float32)
out = {}
for inter in ("watertight", "mt"):
    t, p, h = J.bvh_intersect(bvh, o, d, max_leaf=flat.max_leaf_count,
                              intersector=inter)
    out.update({f"{inter}_t": t, f"{inter}_prim": p, f"{inter}_hit": h})
n = 400
out["bf_t"], out["bf_prim"], out["bf_hit"] = J.brute_force_intersect(
    jnp.asarray(flat.tri_v0), jnp.asarray(flat.tri_e1), jnp.asarray(flat.tri_e2),
    o[:n], d[:n])
out["any_hit"] = J.bvh_any_hit_before(bvh, o[:n], d[:n],
                                      jnp.asarray(s["t_max"], jnp.float32),
                                      max_leaf=flat.max_leaf_count)
out["oblique"] = J.oblique_cos_filter(jnp.asarray(s["normals"]), d[:n], 70.0)
for k, cam in enumerate(s["cams"]):
    v, p = J.node_visibility(bvh, jnp.asarray(s["tris"]), jnp.asarray(s["verts"]),
                             jnp.asarray(s["nodes"]), jnp.asarray(cam, jnp.float32),
                             max_leaf=flat.max_leaf_count)
    out[f"vis{k}"], out[f"visprim{k}"] = v, p
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


CAMS = np.array([[2.0, 2.0, 6.0], [-1.5, 1.0, 4.0], [5.0, 4.5, 3.0]])


def _grid(n=33, size=4.0):
    ys, xs = np.meshgrid(np.linspace(0, size, n), np.linspace(0, size, n),
                         indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(), np.zeros(n * n)], 1)
    k = np.arange(n * n).reshape(n, n)
    a, b, c, d = k[:-1, :-1], k[:-1, 1:], k[1:, :-1], k[1:, 1:]
    tris = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                           np.stack([a, d, c], -1).reshape(-1, 3)])
    return verts, tris


def _box(lo, hi, m=6):
    """Closed box split into m x m quads a face (12 m^2 triangles)."""
    verts, tris = [], []
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        for side in (lo[axis], hi[axis]):
            gu, gv = np.meshgrid(np.linspace(lo[u], hi[u], m + 1),
                                 np.linspace(lo[v], hi[v], m + 1), indexing="ij")
            p = np.zeros(((m + 1) ** 2, 3))
            p[:, axis], p[:, u], p[:, v] = side, gu.ravel(), gv.ravel()
            k = np.arange((m + 1) ** 2).reshape(m + 1, m + 1) + sum(len(q) for q in verts)
            a, b, c, d = k[:-1, :-1], k[:-1, 1:], k[1:, :-1], k[1:, 1:]
            tris += [np.stack([a, b, d], -1).reshape(-1, 3),
                     np.stack([a, d, c], -1).reshape(-1, 3)]
            verts.append(p)
    return np.concatenate(verts), np.concatenate(tris)


@pytest.fixture(scope="module")
def scene():
    gv, gt = _grid()
    bv, bt = _box([1.2, 1.0, 0.5], [2.4, 2.2, 1.1])
    verts = np.concatenate([gv, bv]).astype(np.float32)
    tris = np.concatenate([gt, bt + len(gv)]).astype(np.int32)
    flat = j_build_bvh(verts, tris, 4)
    assert 400 <= len(bt) <= 500
    rng = np.random.default_rng(31)
    o, d = [], []

    def aim(cam, pts):
        o.append(np.broadcast_to(cam, pts.shape))
        d.append(pts - cam)

    for cam in CAMS:
        aim(cam, np.c_[rng.uniform(0, 4, (300, 2)), np.zeros(300)])
        aim(cam, gv[(gv[:, 0] > 0.9) & (gv[:, 0] < 2.6) & (gv[:, 1] > 0.9)
                    & (gv[:, 1] < 2.6)])  # every node of a patch: vertex grazing
        e = gt[rng.integers(0, len(gt), 200)]
        aim(cam, (gv[e[:, 0]] + gv[e[:, 1]]) / 2)  # midpoints of shared edges
        aim(cam, (bv[bt[:40, 0]] + bv[bt[:40, 2]]) / 2)  # box diagonals
    # along the line of an edge: the ray lies in both triangles' planes
    start = gv[gt[:50, 0]] + np.array([0, 0, 0.0])
    o.append(start - 0.5 * (gv[gt[:50, 1]] - gv[gt[:50, 0]]))
    d.append(gv[gt[:50, 1]] - gv[gt[:50, 0]])
    o.append(rng.uniform([-1, -1, 0.2], [5, 5, 3], (200, 3)))
    d.append(rng.normal(0, 1, (200, 3)))
    o = np.concatenate(o)
    d = np.concatenate(d)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return dict(verts=verts, tris=tris, flat=flat, o=o, d=d,
                t_max=np.random.default_rng(3).uniform(0.5, 8.0, 400),
                normals=np.random.default_rng(4).normal(0, 1, (400, 3)).astype(np.float32),
                nodes=np.arange(33 * 33), cams=CAMS,
                t_bvh=T.bvh_to_device(t_build_bvh(verts, tris, 4), device="cpu"))


@pytest.fixture(scope="module")
def ref(scene, tmp_path_factory):
    """The JAX package's results on the scene, from a subprocess with no FMA."""
    tmp = tmp_path_factory.mktemp("raycast")
    keys = ("verts", "tris", "o", "d", "t_max", "normals", "nodes", "cams")
    np.savez(tmp / "scene.npz", **{k: scene[k] for k in keys})
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "scene.npz"),
                        str(tmp / "ref.npz")], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("intersector", ["watertight", "mt"])
def test_bvh_intersect_matches_jax(scene, ref, intersector):
    jt, jp, jh = (ref[f"{intersector}_{k}"] for k in ("t", "prim", "hit"))
    results = []
    for every in (1, T.CHECK_EVERY):
        tt, tp, th = T.bvh_intersect(scene["t_bvh"], torch.from_numpy(scene["o"]),
                                     torch.from_numpy(scene["d"]),
                                     intersector=intersector, check_every=every)
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_array_equal(th.numpy(), jh)
        h = th.numpy()
        np.testing.assert_allclose(tt.numpy()[h], jt[h], rtol=1e-6)
        assert np.isinf(tt.numpy()[~h]).all()
        results.append((tt, tp))
    assert all(torch.equal(a[0], results[0][0]) and torch.equal(a[1], results[0][1])
               for a in results)
    assert 0.3 < jh.mean() < 0.95, jh.mean()  # hits and misses both occur
    box = jp[jh] >= 2048
    assert box.any() and (~box).any()  # the occluder takes some rays


def test_flat_intersector_is_the_whole_mesh_watertight_test(scene):
    """The host query over the flat BVH gives every ray the nearest hit of
    the watertight test over all the triangles (the lowest slot on a tie),
    t, prim and hit exactly; and node_visibility through it sees the nodes
    the device walk sees (the walk, pruning its boxes in f32, may take
    another triangle an ulp farther at a shared vertex)."""
    flat = t_build_bvh(scene["verts"], scene["tris"], 4)
    o, d = torch.from_numpy(scene["o"]).float(), torch.from_numpy(scene["d"]).float()
    rows = (torch.from_numpy(a)[None].expand(len(o), flat.n_tris, 3)
            for a in (flat.tri_v0, flat.tri_e1, flat.tri_e2))
    t, ok = T.watertight_intersect(o, d, *rows)
    t = torch.where(ok, t, torch.full_like(t, float("inf")))
    j = t.argmin(1)
    want_t = t.gather(1, j[:, None])[:, 0]
    want_hit = torch.isfinite(want_t)
    want_prim = torch.where(want_hit, torch.from_numpy(flat.tri_id)[j], -1)
    got_t, got_prim, got_hit = T.flat_intersector(flat)(o, d)
    assert torch.equal(got_t, want_t) and torch.equal(got_hit, want_hit)
    assert torch.equal(got_prim, want_prim.int())
    assert 0.3 < float(got_hit.float().mean()) < 0.95
    verts, tris, nodes = (torch.from_numpy(scene[k]) for k in ("verts", "tris", "nodes"))
    for cam in CAMS:
        cam = torch.from_numpy(cam).float()
        v, _ = T.node_visibility(None, tris, verts, nodes, cam,
                                 intersect=T.flat_intersector(flat))
        wv, _ = T.node_visibility(scene["t_bvh"], tris, verts, nodes, cam)
        assert torch.equal(v, wv) and 0 < int(v.sum()) < len(nodes)


def test_oracles_and_any_hit(scene, ref):
    """brute_force_intersect, bvh_any_hit_before and oblique_cos_filter
    against the JAX functions."""
    flat, n = scene["flat"], 400
    o, d = (torch.from_numpy(scene[k][:n]).float() for k in ("o", "d"))
    tt, tp, th = T.brute_force_intersect(
        torch.from_numpy(flat.tri_v0), torch.from_numpy(flat.tri_e1),
        torch.from_numpy(flat.tri_e2), o, d)
    np.testing.assert_array_equal(tp.numpy(), ref["bf_prim"])
    np.testing.assert_array_equal(th.numpy(), ref["bf_hit"])
    np.testing.assert_allclose(tt.numpy()[th.numpy()], ref["bf_t"][ref["bf_hit"]],
                               rtol=1e-6)
    got = T.bvh_any_hit_before(scene["t_bvh"], o, d,
                               torch.from_numpy(scene["t_max"]).float())
    np.testing.assert_array_equal(got.numpy(), ref["any_hit"])
    assert ref["any_hit"].any() and not ref["any_hit"].all()
    np.testing.assert_array_equal(
        T.oblique_cos_filter(torch.from_numpy(scene["normals"]), d, 70.0).numpy(),
        ref["oblique"])


def test_node_visibility_matches_jax(scene, ref):
    verts, tris, nodes = (torch.from_numpy(scene[k]) for k in ("verts", "tris", "nodes"))
    for k, cam in enumerate(CAMS):
        stats = {}
        cam = torch.from_numpy(cam).float()
        tv, tp = T.node_visibility(scene["t_bvh"], tris, verts, nodes, cam, stats=stats)
        np.testing.assert_array_equal(tv.numpy(), ref[f"vis{k}"])
        np.testing.assert_array_equal(tp.numpy(), ref[f"visprim{k}"])
        assert 0 < tv.sum() < len(nodes)  # the box hides some nodes
        primary = stats["primary"]
        assert (tv | ~primary).all()  # a retry only adds nodes
        assert len(nodes) + int((~primary).sum()) <= stats["rays"]
        # the native host walk (Möller–Trumbore, FMA) through the same
        # function: they may differ only on nodes whose unjittered ray grazed
        # in one walk or both, and on no more nodes than the retries
        # recovered in either walk (chip_smoke.py's bound on the card)
        nstats = {}
        nv, _ = T.node_visibility(None, tris, verts, nodes, cam, stats=nstats,
                                  intersect=T.native_intersector(scene["flat"]))
        differ = nv != tv
        assert not (differ & primary & nstats["primary"]).any()
        recovered = min(int((tv & ~primary).sum()), int((nv & ~nstats["primary"]).sum()))
        assert int(differ.sum()) <= recovered
