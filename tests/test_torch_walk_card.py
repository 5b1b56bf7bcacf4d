"""Phase 0's visibility walk on the card (K11, ``ops/walk_kernels.py``) and
its plain twin, against the native route's rays
(``ops/projection.py`` ``_native_rays``: numpy around the native library).

The twin walks the same flat BVH with torch, rounding every operation as
the native build does (its Moller-Trumbore test fused into multiply-adds
by GCC; :func:`walk_kernels._fma32` rounds a fused one once).  On the CPU
it must equal the native rays bit for bit on every node: the last ray's
``t`` and ``prim``, ``own``, ``settled``, the oblique test and the retries
a node took, on the plate rig of tests/test_torch_walk_recheck.py (four
cameras over 320 x 256 nodes; camera 4 loses every ray to node (166,
255)), its two-camera cine rig and the occluded scene of
tests/test_torch_phase0_device.py.  ``build_node_projection_card`` on the
twin's scene must give ``build_node_projection_host``'s projection and
recheck, and ``run_phase0`` on the CPU must cast on the native library.

The ``cuda`` cases run K11 on the card (it has no CPU mode; they skip
where torch has no CUDA device):

    python -m pytest --noconftest -m cuda tests/test_torch_walk_card.py

K11 against the native rays at 320 x 256 and 1024 x 1024 nodes on both
rigs (the benchmark's ``full4cam`` plate is the plate rig at 1024 x 1024)
and on the occluded scene; ``run_phase0`` on the card against the CPU,
every ``NodeProjection`` field on every node, K11's rays counted as the
host's, and no kernel built inside a warm phase 0.
"""

import os
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchmark import datapoint as D  # noqa: E402
from test_torch_phase0_device import CAMERAS, H, W, _look_at, _mesh  # noqa: E402
from test_torch_walk_recheck import CINE_HW, GRID, HW, MISSED, OBLIQUE, _camera  # noqa: E402
from upsp_tpu_torch import native as t_native  # noqa: E402
from upsp_tpu_torch.camera.model import cam_center, make_camera_params  # noqa: E402
from upsp_tpu_torch.geometry.grids import load_model  # noqa: E402
from upsp_tpu_torch.ops import cuda_lib  # noqa: E402
from upsp_tpu_torch.ops import projection as TP  # noqa: E402
from upsp_tpu_torch.ops import walk_kernels as WK  # noqa: E402
from upsp_tpu_torch.pipeline import phase0 as P0  # noqa: E402
from upsp_tpu_torch.pipeline.config import read_input_deck  # noqa: E402
from upsp_tpu_torch.utils import timing  # noqa: E402

JITTER, N_JITTER = 1e-4, 6


@pytest.fixture(autouse=True)
def _one_thread():
    """The twin's lockstep walk is many small ops: one thread, as the
    other walk tests run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K11 has no CPU mode)")
    return torch.device("cuda")


def plate_rig(root, hw, n_cameras, grid=GRID):
    """benchmark/datapoint.py's plate under ``n_cameras`` cameras of
    ``hw`` frames, the flat BVH as ``run_phase0`` builds it."""
    D.write_plate_grid(os.path.join(root, "plate.grid"), grid)
    model = load_model(os.path.join(root, "plate.grid"))
    t_native.native_library()
    return dict(model=model, flat=P0._build_bvh(model, 4),
                params=[_camera(root, c, hw) for c in range(n_cameras)], hw=hw,
                datanode=model.is_datanode)


def occluded_rig():
    model = _mesh()
    datanode = np.ones(model.size, bool)
    datanode[::11] = False
    params = []
    for centre, target, f in CAMERAS:
        R, t = _look_at(centre, target)
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
        params.append(make_camera_params(
            R, t, K, np.array([0.01, -0.002, 0.0005, -0.0003, 0.0]), dtype=torch.float32))
    return dict(model=model, params=params, hw=(H, W), datanode=datanode,
                flat=t_native.native_library().build_bvh(model.vertices, model.triangles))


RIGS = {"plate": lambda root: plate_rig(root, HW, len(D.CAM_X)),
        "cine": lambda root: plate_rig(root, CINE_HW, 2),
        "occluded": lambda root: occluded_rig()}
CASES = [("plate", c) for c in range(4)] + [("cine", c) for c in range(2)] + [
    ("occluded", c) for c in range(3)]


@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            made[name] = RIGS[name](str(tmp_path_factory.mktemp(name)))
        return made[name]

    return get


def native_rays(rig, c):
    m = rig["model"]
    center = cam_center(rig["params"][c]).numpy().astype(np.float64)
    return TP._native_rays(rig["flat"], m.triangles, m.vertices, m.normals, center,
                           TP._oblique_threshold(OBLIQUE), N_JITTER, JITTER)


def scene_of(rig, device):
    m = rig["model"]
    return WK.upload_scene(rig["flat"], m.triangles, m.vertices, m.normals, device)


def card_rays(rig, c, scene):
    return WK.walk_nodes(scene, cam_center(rig["params"][c]),
                         TP._oblique_threshold(OBLIQUE), N_JITTER, JITTER,
                         TP.SETTLED_REL, detail=True)


def assert_rays_equal(got, want):
    for k in WK.NodeRays._fields:
        a, b = getattr(got, k).cpu(), getattr(want, k).cpu()
        bad = torch.nonzero(a != b)[:, 0]
        assert not bad.numel(), (k, bad.numel(), bad[:5].tolist(), a[bad[:5]].tolist(),
                                 b[bad[:5]].tolist())


# ---------------------------------------------------------------------------
# CPU: the twin's arithmetic

def _round_f32(x: Fraction) -> float:
    """``x`` rounded once to the nearest f32, ties to even (normal range)."""
    if x == 0:
        return 0.0
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    scaled = x / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    q, r = divmod(scaled.numerator, scaled.denominator)
    if 2 * r > scaled.denominator or (2 * r == scaled.denominator and q % 2):
        q += 1
    return sign * float(Fraction(q) * Fraction(2) ** (e - 23))


def test_fma32_rounds_once():
    """f32 ``a*b + c`` rounded once, also where the sum rounded to f64
    first lands on an f32 tie (1 + 2^-24 + 2^-80 must round up)."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 10.0 ** rng.integers(-8, 3, 2000)).astype(np.float32)
    tie = np.float32(1 + 2.0 ** -12)  # tie * tie = 1 + 2^-11 + 2^-24
    a = np.concatenate([a, [tie, tie, np.float32(1.0)]]).astype(np.float32)
    b = np.concatenate([b, [tie, tie, np.float32(1.0)]]).astype(np.float32)
    c = np.concatenate([c, [np.float32(2.0 ** -60), np.float32(-2.0 ** -60),
                            np.float32(2.0 ** -24)]]).astype(np.float32)
    got = WK._fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)  # rounded twice
    assert not np.array_equal(naive[-3:], want[-3:])


def test_forward_threshold_is_numpys_comparison():
    """f32 sums compared in f64 with :func:`forward_threshold` as numpy
    compares them with the f64 threshold, around the threshold's f32
    neighbours."""
    th = TP._oblique_threshold(OBLIQUE)
    sums = np.array([th], np.float32)
    for _ in range(4):
        sums = np.concatenate([sums, np.nextafter(sums, np.float32(np.inf)),
                               np.nextafter(sums, np.float32(-np.inf))])
    eff = WK.forward_threshold(th)
    assert np.array_equal(sums.astype(np.float64) < eff, sums < th)


def test_walk_nodes_checks_its_retries(rigs):
    scene = scene_of(rigs("occluded"), "cpu")
    with pytest.raises(ValueError, match="n_jitter"):
        WK.walk_nodes(scene, cam_center(rigs("occluded")["params"][0]), 0.0, n_jitter=7)


# ---------------------------------------------------------------------------
# CPU: the twin against the native rays, and the routes

@pytest.mark.parametrize("rig,cam", CASES)
def test_twin_equals_native_rays(rigs, rig, cam):
    r = rigs(rig)
    want = native_rays(r, cam)
    got = card_rays(r, cam, scene_of(r, "cpu"))
    assert_rays_equal(got, want)
    assert int(want.retries.sum()) > 0  # the retries are exercised
    if (rig, cam + 1) == ("plate", MISSED[0]):
        node = MISSED[2] * GRID[0] + MISSED[1]
        assert not bool(got.own[node]) and int(got.retries[node]) == N_JITTER
        assert int(got.prim[node]) == -1


@pytest.mark.parametrize("rig,cam", [("plate", 3)] + [("occluded", c) for c in range(3)])
def test_card_route_on_the_twin_equals_host_route(rigs, rig, cam):
    """``build_node_projection_card`` on the twin's CPU scene: the host
    route's projection on every node, and its recheck."""
    r = rigs(rig)
    m, (h, w) = r["model"], r["hw"]
    p = r["params"][cam]
    with timing.recording() as rec:
        host = TP.build_node_projection_host(
            p, r["flat"], m.triangles, m.vertices, m.normals, r["datanode"],
            oblique_angle_deg=OBLIQUE, height=h, width=w)
    with timing.recording() as rec_card:
        card = TP.build_node_projection_card(
            p, scene_of(r, "cpu"), r["flat"], m.triangles, m.vertices, r["datanode"],
            oblique_angle_deg=OBLIQUE, height=h, width=w)
    for a, b in zip(card.projection, host.projection):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (card.rechecked, card.recovered) == (host.rechecked, host.recovered)
    assert rec_card.counter("walk.rays.card", None) == rec.counter("walk.rays.host", None)
    assert rec_card.counter("walk.rays.host", None) == 0
    assert rec.counter("walk.rays.card", None) == 0
    if rig == "plate":
        assert card.rechecked == card.recovered == 1


def test_cpu_route_casts_on_the_native_library(tmp_path):
    """``run_phase0`` on the CPU: the native library casts every node's
    rays (``walk.rays.host``), K11 none."""
    from upsp_tpu_torch.pipeline.synthetic import write_datapoint

    dp = write_datapoint(str(tmp_path / "dp"), image_hw=(64, 96), n_frames=2,
                         n_distinct=2, grid_shape=(21, 17), n_targets=3, seed=5)
    cfg = read_input_deck(dp["deck"])
    first = [dp["frames"][0, c] for c in range(dp["frames"].shape[1])]
    before = cuda_lib.launch_counts()["walk"]
    with timing.recording() as rec:
        st = P0.run_phase0(cfg, first, [12] * len(first), device="cpu")
    n, cams = st.n_nodes, st.n_cameras
    rays = rec.counter("walk.rays.host", None)
    assert n * cams <= rays <= n * cams * (1 + N_JITTER)
    assert rec.counter("walk.rays.card", None) == 0
    assert cuda_lib.launch_counts()["walk"] == before


# ---------------------------------------------------------------------------
# the card

CARD_CASES = [("plate", GRID), ("cine", GRID), ("plate", (1024, 1024)),
              ("cine", (1024, 1024)), ("occluded", None)]


@pytest.mark.cuda
@pytest.mark.parametrize("rig,grid", CARD_CASES)
def test_k11_matches_native_rays_on_card(cuda, tmp_path, rig, grid):
    if rig == "occluded":
        r = occluded_rig()
    else:
        hw, n_cam = (HW, len(D.CAM_X)) if rig == "plate" else (CINE_HW, 2)
        r = plate_rig(str(tmp_path), hw, n_cam, grid)
    scene = scene_of(r, cuda)
    for c in range(len(r["params"])):
        want = native_rays(r, c)
        got = card_rays(r, c, scene)
        assert_rays_equal(got, want)
        flags = WK.walk_nodes(scene, cam_center(r["params"][c]),
                              TP._oblique_threshold(OBLIQUE), N_JITTER, JITTER,
                              TP.SETTLED_REL)
        assert torch.equal(flags.cpu(), WK.encode(want))


@pytest.fixture(scope="module")
def full4cam_deck(tmp_path_factory):
    """benchmark/configs/full4cam.json's datapoint, 4 frames (phase 0
    reads the first)."""
    root = str(tmp_path_factory.mktemp("full4cam"))
    dp = D.write_datapoint(root, seed=3, n_cameras=4, image_hw=(1200, 1800),
                           grid_shape=(1024, 1024), n_frames=4, n_distinct=4,
                           n_targets=12, max_shift_px=2.0, video_format="mraw12",
                           device="cuda" if torch.cuda.is_available() else "cpu",
                           options={"target_patcher": "polynomial",
                                    "registration": "pixel", "filter": "gaussian",
                                    "filter_size": 3, "overlap": "best_view"})
    first = [dp["contents"][D.content_index(0, 4), c] for c in range(4)]
    return read_input_deck(dp["deck"]), first


@pytest.mark.cuda
def test_run_phase0_on_card_equals_cpu(cuda, full4cam_deck):
    cfg, first = full4cam_deck
    P0.run_phase0(cfg, first, device=cuda)  # builds K11's library
    cuda_lib.reset_launch_counts()
    with timing.recording() as rec_card:
        card = P0.run_phase0(cfg, first, device=cuda)
    launches = cuda_lib.launch_counts()["walk"]
    with timing.recording() as rec_host:
        host = P0.run_phase0(cfg, first, device="cpu")
    assert launches == len(first)
    assert rec_card.counter("kernel_builds", None) == 0
    assert rec_card.counter("walk.rays.host", None) == 0
    assert rec_card.counter("walk.rays.card", None) == rec_host.counter("walk.rays.host",
                                                                         None) > 0
    assert rec_card.counter("walk.rechecked", None) == rec_host.counter("walk.rechecked",
                                                                         None)
    for pc, ph in zip(card.projections, host.projections):
        for a, b in zip(pc, ph):
            assert a.is_cuda and torch.equal(a.cpu(), b)
    assert torch.equal(card.skipped.cpu(), host.skipped)
    for a, b in zip(card.patch_ops, host.patch_ops):
        assert (a is None) == (b is None)
        assert a is None or all(torch.equal(x.cpu(), y) for x, y in zip(a[:3], b[:3]))
