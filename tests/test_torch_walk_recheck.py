"""The native walk's recheck (``ops/projection.build_node_projection_host``),
on the CPU, against the port alone.

The rig is the benchmark's four-camera one (``benchmark/datapoint.py``:
overhead pinhole cameras over a flat 10 x 8 plate, 1200x1800 frames) at
320 x 256 nodes; its two-camera 1024x1024 one must agree with the device
walk as well.  There none of the seven native rays to node (166, 255), on
the plate's far edge, hits anything from camera 4 (f32 Moller-Trumbore
with no tolerance fails on both sides of an edge): the native rule leaves
it unseen, and the device walk sees it.  The repaired route must recast
that node alone, see it, keep the f64 projection's pixels, and give every
camera the device walk's ``visible`` and best-view ``weight``.

On the occluded scene of tests/test_torch_phase0_device.py (a plate under
a box, three cameras) no node that a native ray showed occluded is
recast, and the recheck adds only nodes that the device walk sees.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from benchmark import datapoint as D
from upsp_tpu_torch import native as t_native
from upsp_tpu_torch.camera.model import cam_center, make_camera_params
from upsp_tpu_torch.geometry.grids import load_model
from upsp_tpu_torch.io.camera_json import read_camera_json
from upsp_tpu_torch.ops import projection as TP
from upsp_tpu_torch.ops import raycast as TR
from upsp_tpu_torch.pipeline import phase0 as P0
from upsp_tpu_torch.utils import timing

HW, GRID, OBLIQUE = (1200, 1800), (320, 256), 70.0
CINE_HW = (1024, 1024)  # the two-camera cine rig's frames
MISSED = (4, 166, 255)  # camera, i, j


@pytest.fixture(autouse=True)
def _one_thread():
    """The device walk is many small ops: one thread, as
    tests/test_torch_phase0_device.py runs it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera(root, c, hw=HW):
    """Camera ``c`` (0-based) of ``benchmark/datapoint.py``'s rig of
    ``hw`` frames, through the camera JSON it writes."""
    fx = D.camera_focal(hw)
    cal = {"uPSP_cameraMatrix": [[fx, 0.0, 0.0], [0.0, fx, 0.0], [0.0, 0.0, 1.0]],
           "distCoeffs": [[0.0, 0.0, 0.0, 0.0, 0.0]],
           "rmat": [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
           "tvec": [-D.CAM_X[c], D.CAM_Y, D.CAM_Z]}
    path = os.path.join(root, f"cam{c + 1:02d}.json")
    with open(path, "w") as fh:
        json.dump(cal, fh)
    cal = read_camera_json(path, dims_hw=hw)
    return make_camera_params(cal.rmat, cal.tvec, cal.camera_matrix, cal.dist_coeffs,
                              dtype=torch.float32)


def _build_rig(root, hw, n_cameras):
    D.write_plate_grid(os.path.join(root, "plate.grid"), GRID)
    model = load_model(os.path.join(root, "plate.grid"))
    t_native.native_library()
    flat = P0._build_bvh(model, 4)
    params = [_camera(root, c, hw) for c in range(n_cameras)]
    mesh = dict(triangles=model.triangles, vertices=model.vertices,
                normals=model.normals, is_datanode=model.is_datanode)

    def native(**kw):
        return [TP.build_node_projection_host(p, flat, oblique_angle_deg=OBLIQUE,
                                              height=hw[0], width=hw[1], **mesh, **kw)
                for p in params]

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bvh = TR.bvh_to_device(flat, device="cpu")
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in mesh.items()}
        device = [TP.build_node_projection(
            p, bvh, t["triangles"].long(), t["vertices"], t["normals"],
            t["is_datanode"].bool(), OBLIQUE, hw[0], hw[1]) for p in params]
    finally:
        torch.set_num_threads(n)
    return dict(model=model, flat=flat, params=params, native=native, walks=native(),
                device=device)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    return _build_rig(str(tmp_path_factory.mktemp("rig")), HW, len(D.CAM_X))


def _node(i, j):
    return j * GRID[0] + i


def _weighted(projs, rig):
    m = rig["model"]
    return TP.adjust_projection_for_weights(
        projs, [cam_center(p) for p in rig["params"]], torch.from_numpy(m.vertices),
        torch.from_numpy(m.normals), overlap="best_view")


def test_native_rays_miss_the_plate_edge_node(rig):
    """The cause: all seven native rays to the node, unjittered and
    jittered, hit nothing; the device walk sees the node."""
    cam, i, j = MISSED
    node = _node(i, j)
    center = cam_center(rig["params"][cam - 1]).numpy().astype(np.float64)
    offsets = np.vstack([np.zeros(3), 1e-4 * np.vstack([-np.eye(3), np.eye(3)])[
        [0, 3, 1, 4, 2, 5]]])
    d = rig["model"].vertices[node].astype(np.float64) + offsets - center
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    _, prim, hit = t_native.native_library().bvh_intersect(
        rig["flat"], np.broadcast_to(center.astype(np.float32), d.shape), d)
    assert not hit.any() and (prim == -1).all()
    assert bool(rig["device"][cam - 1].visible[node])


def test_repaired_route_sees_it_and_agrees_with_the_device_walk(rig):
    cam, i, j = MISSED
    walks = rig["walks"]
    assert bool(walks[cam - 1].projection.visible[_node(i, j)])
    assert [w.rechecked for w in walks] == [0, 0, 0, 1]
    assert [w.recovered for w in walks] == [0, 0, 0, 1]
    fixed = [w.projection for w in walks]
    for got, want in zip(_weighted(fixed, rig), _weighted(rig["device"], rig)):
        assert torch.equal(got.visible, want.visible)
        assert torch.equal(got.weight, want.weight)
    verts64 = torch.from_numpy(rig["model"].vertices.astype(np.float64))
    for got, params in zip(fixed, rig["params"]):  # the f64 projection's pixels
        seen = got.visible.numpy()
        pix = TP.project_points(params, verts64).numpy()[seen]
        col = np.clip(np.rint(pix[:, 0]), 0, HW[1] - 1).astype(np.int64)
        row = np.clip(np.rint(pix[:, 1]), 0, HW[0] - 1).astype(np.int64)
        assert np.array_equal(got.pixel_index.numpy()[seen], row * HW[1] + col)
        assert np.array_equal(got.u.numpy()[seen], (pix[:, 0] / HW[1]).astype(np.float32))
        assert np.array_equal(got.v.numpy()[seen], (pix[:, 1] / HW[0]).astype(np.float32))


def test_cine_rig_agrees_with_the_device_walk(tmp_path):
    """The two-camera 1024x1024 rig: the repaired route's ``visible`` and
    best-view ``weight`` are the device walk's."""
    cine = _build_rig(str(tmp_path), CINE_HW, 2)
    fixed = [w.projection for w in cine["walks"]]
    for got, want in zip(_weighted(fixed, cine), _weighted(cine["device"], cine)):
        assert torch.equal(got.visible, want.visible)
        assert torch.equal(got.weight, want.weight)


def test_recheck_span_counters_and_readings(rig):
    """One clock for the span and the result's seconds; the counters a
    datapoint are the result's counts."""
    with timing.recording() as rec:
        with timing.span("phase0.walk"):
            walks = rig["native"]()
    walk = rec.of(None, "phase0.walk")
    rechecks = rec.of(None, "phase0.walk.recheck")
    assert len(walk) == 1 and len(rechecks) == len(rig["params"])
    assert all(s.parent == walk[0].id for s in rechecks)
    for w, s in zip(walks, rechecks):
        assert w.recheck_s == (s.end_ns - s.start_ns) / 1e9
    assert rec.counter("walk.rechecked", None) == sum(w.rechecked for w in walks) == 1
    assert rec.counter("walk.recovered", None) == sum(w.recovered for w in walks) == 1


@pytest.fixture(scope="module")
def occluded():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_phase0_device import CAMERAS, H, W, _look_at, _mesh

    model = _mesh()
    datanode = np.ones(model.size, bool)
    datanode[::11] = False
    cams = []
    for centre, target, f in CAMERAS:
        R, t = _look_at(centre, target)
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
        cams.append(make_camera_params(R, t, K, np.array([0.01, -0.002, 0.0005, -0.0003, 0.0]),
                                       dtype=torch.float32))
    return dict(model=model, datanode=datanode, cams=cams, hw=(H, W),
                flat=t_native.native_library().build_bvh(model.vertices, model.triangles))


def _shown_occluded(flat, model, params, jitter=1e-4):
    """(N,) bool: some native ray of the node, unjittered or jittered, hits
    a triangle nearer than (1 - SETTLED_REL) of its target's distance."""
    native = t_native.native_library()
    center = cam_center(params).numpy().astype(np.float64)
    out = np.zeros(model.size, bool)
    for off in np.vstack([np.zeros(3), jitter * np.vstack([-np.eye(3), np.eye(3)])[
            [0, 3, 1, 4, 2, 5]]]):
        d = model.vertices.astype(np.float64) + off - center
        norm = np.linalg.norm(d, axis=1)
        t, _, hit = native.bvh_intersect(
            flat, np.broadcast_to(center.astype(np.float32), d.shape),
            (d / norm[:, None]).astype(np.float32))
        out |= hit & (t < (1 - TP.SETTLED_REL) * norm)
    return out


def test_recheck_leaves_occluded_nodes(occluded, monkeypatch):
    """No node a native ray showed occluded is recast, the box hides nodes
    from every camera all the same, and the recheck only adds nodes that
    the device walk sees too (camera 3's rays graze the box's top corner
    and an edge, where the native test fails as on the plate's edge)."""
    m, (h, w) = occluded["model"], occluded["hw"]
    recast = []
    real = TP._recast

    def spy(cand, *a, **kw):  # the nodes recast and what the recast saw
        seen = real(cand, *a, **kw)
        recast.append((cand.copy(), seen))
        return seen

    monkeypatch.setattr(TP, "_recast", spy)
    bvh = TR.bvh_to_device(occluded["flat"], device="cpu")
    added = []
    for params in occluded["cams"]:
        recast.clear()
        got = TP.build_node_projection_host(
            params, occluded["flat"], m.triangles, m.vertices, m.normals,
            occluded["datanode"], oblique_angle_deg=OBLIQUE, height=h, width=w)
        fixed = got.projection.visible.numpy()
        device = TP.build_node_projection(
            params, bvh, torch.from_numpy(m.triangles.astype(np.int64)),
            torch.from_numpy(m.vertices), torch.from_numpy(m.normals),
            torch.from_numpy(occluded["datanode"]), OBLIQUE, h, w).visible.numpy()
        shown = _shown_occluded(occluded["flat"], m, params)
        cand = np.concatenate([c for c, _ in recast]) if recast else np.zeros(0, np.int64)
        made = cand[np.concatenate([s for _, s in recast])] if recast else cand
        assert not shown[cand].any()
        assert (shown & ~fixed).any()  # occluded nodes stay unseen
        assert fixed[made].all() and device[made].all()
        assert got.rechecked == len(cand) and got.recovered == len(made)
        added.append(len(made))
    assert added == [0, 0, 2]
