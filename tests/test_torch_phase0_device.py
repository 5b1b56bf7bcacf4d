"""Phase 0 on the device walk: ``projection.build_node_projection`` and
``run_phase0`` without the native library against the JAX package's
device route, and against the port's native route.

The JAX functions run in a subprocess whose XLA may not use FMA
instructions (``--xla_cpu_max_isa=AVX``), as tests/test_torch_raycast.py
explains: with them the jitted walk contracts multiply-adds and vertex
rays take another triangle.  The JAX package takes its device route when
its native library is absent, so the subprocess unloads it
(``upsp_tpu.native._LIB = None``); the port is given the same state by
making its library unbuildable, and must then take the device walk and
log that.  Both sides build the BVH with the numpy builder there.

Bounds: ``pixel_index`` and ``weight`` exact and ``u``/``v`` within rtol
1e-6 (both project in f32) where both sides see a node; the patch
operators' indices exact and their matrices within 1e-6.  ``visible`` (and
with it ``skipped``) may differ on at most 1% of the nodes, and only on
nodes whose unjittered ray did not see them on the port's walk: XLA's f32
``sqrt`` on the CPU is not correctly rounded (1,307 of 200,000 random
norms differ from the rounded root by an ulp), so a ray through a vertex
or an edge can leave in a direction an ulp away from the port's and take
another triangle.  Against the port's native route (the
native walk, f64 projection): ``visible`` may differ on at most 1% of the
nodes, and only on nodes whose unjittered ray did not see them on one of
the walks, and
``pixel_index`` only where the f32 and f64 projections round to other
pixels (the f64 position within 1e-3 px of a half pixel); the positions
``u``/``v`` agree within 1e-4 px.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from upsp_tpu_torch import native as t_native
from upsp_tpu_torch.camera.model import make_camera_params
from upsp_tpu_torch.geometry.bvh import build_bvh
from upsp_tpu_torch.geometry.grids import from_tri_mesh
from upsp_tpu_torch.io.cart3d import TriMesh
from upsp_tpu_torch.ops import projection as TP
from upsp_tpu_torch.ops import raycast as TR
from upsp_tpu_torch.pipeline import phase0 as P0
from upsp_tpu_torch.pipeline.config import read_input_deck
from upsp_tpu_torch.pipeline.synthetic import write_datapoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, OBLIQUE = 96, 128, 70.0

_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from upsp_tpu import native
native._LIB = None  # the JAX package's device route
from upsp_tpu.camera.model import make_camera_params
from upsp_tpu.geometry.bvh import build_bvh
from upsp_tpu.ops.projection import build_node_projection
from upsp_tpu.ops.raycast import bvh_to_device
from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu.pipeline.phase0 import run_phase0

s = dict(np.load(sys.argv[1]))
out = {}
bvh = bvh_to_device(build_bvh(s["verts"], s["tris"], 4))
for c in range(len(s["rmats"])):
    p = make_camera_params(s["rmats"][c], s["tvecs"][c], s["Ks"][c], s["dists"][c],
                           dtype=jnp.float32)
    proj = build_node_projection(p, bvh, jnp.asarray(s["tris"]), jnp.asarray(s["verts"]),
                                 jnp.asarray(s["normals"]), jnp.asarray(s["datanode"]),
                                 float(s["oblique"]), int(s["hw"][0]), int(s["hw"][1]))
    for k, v in proj._asdict().items():
        out[f"proj{c}_{k}"] = v
st = run_phase0(read_input_deck(str(s["deck"])), list(s["first"]), [12] * len(s["first"]))
assert st.bvh_dev is not None
for c, p in enumerate(st.projections):
    for k, v in p._asdict().items():
        out[f"p0_{c}_{k}"] = v
    op = st.patch_ops[c]
    if op is not None:
        out[f"p0_{c}_M"], out[f"p0_{c}_bidx"], out[f"p0_{c}_iidx"] = op.M, op.boundary_idx, op.internal_idx
out["p0_skipped"] = st.skipped
out["p0_ref_frames"] = st.ref_frames
out["p0_superseded_by"] = st.superseded_by
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(autouse=True)
def _one_thread():
    """The lockstep walk is many small ops; on a loaded host torch's
    intra-op threads turn each into a wait (this file's walks took 131 s
    against 25 s with one thread, next to six busy processes, on the
    CPU).  One thread per test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _look_at(center, target):
    """(rmat, tvec) of a camera at ``center`` looking at ``target``."""
    z = np.asarray(target, float) - center
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ np.asarray(center, float)


def _mesh():
    """A 33 x 33-node plate under a box occluder (tests/test_torch_raycast.py)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_raycast import _box, _grid

    gv, gt = _grid()
    bv, bt = _box([1.2, 1.0, 0.5], [2.4, 2.2, 1.1])
    verts = np.concatenate([gv, bv]).astype(np.float32)
    tris = np.concatenate([gt, bt + len(gv)]).astype(np.int32)
    return from_tri_mesh(TriMesh(vertices=verts, triangles=tris))


CAMERAS = (  # (centre, target, focal length): overhead, oblique, low
    ([2.0, 2.0, 6.0], [2.0, 2.0, 0.0], 50.0),
    ([-1.5, 1.0, 4.0], [2.0, 2.0, 0.3], 90.0),
    ([5.0, 4.5, 3.0], [1.0, 1.0, 0.0], 70.0),
)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("phase0_device")
    model = _mesh()
    datanode = np.ones(model.size, bool)
    datanode[::11] = False
    rmats, tvecs, Ks = [], [], []
    for centre, target, f in CAMERAS:
        R, t = _look_at(centre, target)
        rmats.append(R)
        tvecs.append(t)
        Ks.append(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]]))
    dists = np.array([[0.01, -0.002, 0.0005, -0.0003, 0.0]] * len(CAMERAS))
    dp = write_datapoint(str(tmp / "dp"), image_hw=(64, 96), n_frames=2,
                         n_distinct=2, grid_shape=(21, 17), n_targets=3, seed=5)
    first = np.stack([dp["frames"][0, c] for c in range(dp["frames"].shape[1])])
    s = dict(verts=model.vertices, tris=model.triangles, normals=model.normals,
             datanode=datanode, rmats=np.stack(rmats), tvecs=np.stack(tvecs),
             Ks=np.stack(Ks), dists=dists, oblique=OBLIQUE, hw=np.array([H, W]),
             deck=dp["deck"], first=first)
    np.savez(tmp / "scene.npz", **s)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "scene.npz"),
                        str(tmp / "ref.npz")], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    s["ref"] = dict(np.load(tmp / "ref.npz"))
    s["model"] = model
    return s


@pytest.fixture(scope="module")
def device_projections(scene):
    """``build_node_projection`` of each camera, on the CPU, one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return [_device_projection(scene, c) for c in range(len(CAMERAS))]
    finally:
        torch.set_num_threads(n)


def _params(s, c, dtype=torch.float32):
    return make_camera_params(s["rmats"][c], s["tvecs"][c], s["Ks"][c], s["dists"][c],
                              dtype=dtype)


def _device_projection(s, c, **kw):
    bvh = TR.bvh_to_device(build_bvh(s["verts"], s["tris"], 4), device="cpu")
    t = {k: torch.from_numpy(np.asarray(s[k])) for k in ("verts", "normals", "datanode")}
    return TP.build_node_projection(
        _params(s, c), bvh, torch.from_numpy(s["tris"].astype(np.int64)), t["verts"],
        t["normals"], t["datanode"], OBLIQUE, H, W, **kw)


def _primary(bvh, tris, verts, center):
    """(N,) bool: the nodes whose unjittered ray sees them on the port's walk."""
    stats = {}
    TR.node_visibility(bvh, tris, verts, torch.arange(verts.shape[0]), center,
                       stats=stats)
    return stats["primary"].numpy()


def _same_projection(got, ref, prefix, primary):
    """The bounds of the module docstring (``primary()``: the port's
    unjittered visibility, walked only when a node differs); returns the
    nodes that differ."""
    vis, want = got.visible.numpy(), ref[f"{prefix}visible"]
    differ = vis != want
    assert differ.sum() <= 0.01 * differ.size, (prefix, int(differ.sum()))
    if differ.any():
        seen = primary()
        assert not (differ & seen).any(), (prefix, np.nonzero(differ & seen))
    both = vis & want
    for k in ("pixel_index", "weight"):
        np.testing.assert_array_equal(getattr(got, k).numpy()[both],
                                      ref[f"{prefix}{k}"][both], err_msg=f"{prefix}{k}")
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[both],
                                   ref[f"{prefix}{k}"][both], rtol=1e-6, atol=0,
                                   err_msg=f"{prefix}{k}")
    return differ


def _scene_primary(s, cam):
    bvh = TR.bvh_to_device(build_bvh(s["verts"], s["tris"], 4), device="cpu")
    center = TP.cam_center(_params(s, cam))
    return _primary(bvh, torch.from_numpy(s["tris"].astype(np.int64)),
                    torch.from_numpy(s["verts"]), center)


@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_build_node_projection_matches_jax(scene, device_projections, cam):
    got = device_projections[cam]
    differ = _same_projection(got, scene["ref"], f"proj{cam}_",
                              lambda: _scene_primary(scene, cam))
    print(f"camera {cam}: visible differs from JAX's on {int(differ.sum())} nodes")
    vis = got.visible.numpy()
    # every mask takes part: some nodes seen, some culled, some occluded
    assert 0.2 < vis.mean() < 0.95, vis.mean()


def test_build_node_projection_against_native_walk(scene, device_projections):
    """The device route against ``build_node_projection_host`` (native
    walk, f64 projection) on the same scene."""
    native = t_native.native_library()
    flat = native.build_bvh(scene["verts"], scene["tris"])
    model = scene["model"]
    for cam in range(len(CAMERAS)):
        dev = device_projections[cam]
        host = TP.build_node_projection_host(
            _params(scene, cam), flat, model.triangles, model.vertices, model.normals,
            scene["datanode"], OBLIQUE, H, W).projection
        differ = (dev.visible != host.visible).numpy()
        assert differ.sum() <= 0.01 * differ.size, (cam, int(differ.sum()))
        if differ.any():
            stats = {}
            TR.node_visibility(None, torch.from_numpy(model.triangles.astype(np.int64)),
                               torch.from_numpy(model.vertices),
                               torch.arange(model.size),
                               TP.cam_center(_params(scene, cam)),
                               intersect=TR.native_intersector(flat), stats=stats)
            grazed = ~(_scene_primary(scene, cam) & stats["primary"].numpy())
            assert not (differ & ~grazed).any(), cam
        both = (dev.visible & host.visible).numpy()
        pix = TP.project_points(_params(scene, cam, torch.float64),
                                torch.from_numpy(model.vertices.astype(np.float64))).numpy()
        moved = both & (dev.pixel_index != host.pixel_index).numpy()
        frac = np.abs(pix - np.floor(pix) - 0.5)
        assert (frac[moved].min(axis=1) < 1e-3).all() if moved.any() else True
        for k, n in (("u", W), ("v", H)):  # in pixels
            np.testing.assert_allclose(getattr(dev, k).numpy()[both] * n,
                                       getattr(host, k).numpy()[both] * n, atol=1e-4,
                                       rtol=0, err_msg=k)


def test_multicam_helpers(scene):
    """``project_frames_multicam`` and ``projections_to_arrays`` against the
    JAX functions on the JAX projections, exactly."""
    import jax.numpy as jnp

    from upsp_tpu.ops import projection as JP

    ref = scene["ref"]
    n_cams = len(CAMERAS)
    fields = ("pixel_index", "weight", "u", "v", "visible")
    j_projs = [JP.NodeProjection(*(jnp.asarray(ref[f"proj{c}_{k}"]) for k in fields))
               for c in range(n_cams)]
    t_projs = [TP.NodeProjection(*(torch.from_numpy(ref[f"proj{c}_{k}"]) for k in fields))
               for c in range(n_cams)]
    t_projs = [p._replace(pixel_index=p.pixel_index.long()) for p in t_projs]
    frames = np.random.default_rng(7).uniform(0, 4095, (n_cams, H, W)).astype(np.float32)
    j_skip = JP.identify_skipped_nodes(j_projs)
    want = np.asarray(JP.project_frames_multicam(jnp.asarray(frames), j_projs, j_skip))
    got = TP.project_frames_multicam(torch.from_numpy(frames), t_projs,
                                     TP.identify_skipped_nodes(t_projs))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want).any() and np.isfinite(want).any()
    batch = TP.project_frames_multicam(torch.from_numpy(np.stack([frames, frames + 1])),
                                       t_projs, TP.identify_skipped_nodes(t_projs))
    np.testing.assert_array_equal(batch[0].numpy(), want)
    j_arr = JP.projections_to_arrays(j_projs)
    t_arr = TP.projections_to_arrays(t_projs)
    for k in fields:
        np.testing.assert_array_equal(getattr(t_arr, k).numpy(),
                                      np.asarray(getattr(j_arr, k)).astype(
                                          getattr(t_arr, k).numpy().dtype), err_msg=k)


def _unbuildable(monkeypatch):
    """The port with no native library and none to be built."""
    def fail():
        raise RuntimeError("the native BVH library is missing and cannot be built")

    monkeypatch.setattr(t_native, "native_library", fail)
    monkeypatch.setattr(t_native, "_LIB", None)


def test_run_phase0_device_route_matches_jax(scene, monkeypatch, caplog):
    """Without the library, "auto" takes the device walk, logs it, and
    gives the JAX package's device-route state."""
    _unbuildable(monkeypatch)
    cfg = read_input_deck(str(scene["deck"]))
    first = list(scene["first"])
    with caplog.at_level(logging.WARNING, logger="upsp_tpu"):
        st = P0.run_phase0(cfg, first, [12] * len(first), device="cpu")
    assert "take the device walk on cpu" in caplog.text
    assert st.bvh_dev is not None and st.bvh_dev.leaf_v0.device.type == "cpu"
    ref = scene["ref"]
    tris = torch.from_numpy(st.model.triangles.astype(np.int64))
    verts = torch.from_numpy(st.model.vertices)
    differ = np.zeros(st.n_nodes, bool)
    for c, p in enumerate(st.projections):
        center = TP.cam_center(st.cam_params[c])
        differ |= _same_projection(p, ref, f"p0_{c}_",
                                   lambda: _primary(st.bvh_dev, tris, verts, center))
        op = st.patch_ops[c]
        if op is None:
            assert f"p0_{c}_M" not in ref
            continue
        np.testing.assert_array_equal(op.boundary_idx.numpy(), ref[f"p0_{c}_bidx"])
        np.testing.assert_array_equal(op.internal_idx.numpy(), ref[f"p0_{c}_iidx"])
        np.testing.assert_allclose(op.M.numpy(), ref[f"p0_{c}_M"], atol=1e-6, rtol=0)
    assert any(op is not None for op in st.patch_ops)
    np.testing.assert_array_equal(st.skipped.numpy()[~differ], ref["p0_skipped"][~differ])
    np.testing.assert_array_equal(st.superseded_by.numpy(), ref["p0_superseded_by"])
    np.testing.assert_array_equal(st.ref_frames.numpy(), ref["p0_ref_frames"])
    # the state moves with its device BVH
    moved = st.to("cpu")
    assert moved.bvh_dev is not None and torch.equal(moved.bvh_dev.escape, st.bvh_dev.escape)


def test_run_phase0_device_walk_against_native(scene, monkeypatch):
    """The device walk (the library unbuildable) against the native walk
    (the library present) on the same datapoint."""
    cfg = read_input_deck(str(scene["deck"]))
    first = list(scene["first"])
    with monkeypatch.context() as mp:
        _unbuildable(mp)
        dev = P0.run_phase0(cfg, first, [12] * len(first), device="cpu")
    nat = P0.run_phase0(cfg, first, [12] * len(first), device="cpu")
    assert dev.bvh_dev is not None and nat.bvh_dev is None
    for d, n in zip(dev.projections, nat.projections):
        differ = (d.visible != n.visible).numpy()
        assert differ.sum() <= 0.01 * differ.size, int(differ.sum())
        both = (d.visible & n.visible).numpy()
        same = (d.pixel_index == n.pixel_index).numpy()[both]
        assert same.mean() > 0.99, same.mean()
        h, w = dev.image_hw
        np.testing.assert_allclose(d.u.numpy()[both] * w, n.u.numpy()[both] * w,
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(d.v.numpy()[both] * h, n.v.numpy()[both] * h,
                                   atol=1e-4, rtol=0)
    for a, b in zip(dev.patch_ops, nat.patch_ops):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.boundary_idx.numpy(), b.boundary_idx.numpy())
            np.testing.assert_array_equal(a.M.numpy(), b.M.numpy())
    np.testing.assert_array_equal(dev.ref_frames.numpy(), nat.ref_frames.numpy())


@pytest.mark.parametrize("overlap", ["best_view", "average_views"])
def test_weights_stay_on_the_projections_device(overlap):
    """``adjust_projection_for_weights`` works where its tensors are: the
    device walk weighs the cameras on the card.  The "meta" device stands in
    for the card here (it refuses to mix with CPU tensors as CUDA does);
    best view once built its camera index on the CPU and failed there."""
    dev, n = "meta", 5
    projs = [TP.NodeProjection(torch.zeros(n, dtype=torch.int64, device=dev),
                               torch.ones(n, device=dev), torch.zeros(n, device=dev),
                               torch.zeros(n, device=dev),
                               torch.ones(n, dtype=torch.bool, device=dev))
             for _ in range(2)]
    out = TP.adjust_projection_for_weights(
        projs, [torch.zeros(3, device=dev), torch.ones(3, device=dev)],
        torch.zeros(n, 3, device=dev), torch.ones(n, 3, device=dev), overlap=overlap)
    assert all(p.weight.device.type == dev and p.weight.shape == (n,) for p in out)
    assert TP.identify_skipped_nodes(out).device.type == dev
