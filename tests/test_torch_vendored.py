"""The port's copies of the JAX package's numpy modules against the originals.

``upsp_tpu_torch`` imports nothing of ``upsp_tpu``, so the modules it needs
that need no jax (``io``, ``geometry``, ``native``, ``pipeline.config``,
``pipeline.interpolate``, ``processing.context``, ``camera.tunnel``,
``camera.matching``, ``camera.internal``, ``ops.detection``,
``ops.panels`` and ``ops.image.scale_image{,_max_inlier}``, the numpy
parts of ``ops.integration`` and ``pipeline.synthetic``, and the host-side
tools: ``geometry.primitives``, ``ops.{pointset,blob}``,
``processing.{tree,kulites,kulite_selection,p3d_export}``, the numpy
helpers of ``ops.{polyfit,patching}``, ``FramePrefetcher``,
``host_reads_for_datapoint`` and ``BlockTimer``) are copied into it.  Each
case feeds one seeded input to a copy and to its original and requires the
same result: equal arrays (NaN at the same places), equal fields, equal
bytes on disk.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

from upsp_tpu import native as j_native
from upsp_tpu.geometry import bvh as j_bvh
from upsp_tpu.geometry import grids as j_grids
from upsp_tpu.io import camera_json as j_camera_json
from upsp_tpu.io import cart3d as j_cart3d
from upsp_tpu.io import comps as j_comps
from upsp_tpu.io import flatfile as j_flatfile
from upsp_tpu.io import paint as j_paint
from upsp_tpu.io import tgts as j_tgts
from upsp_tpu.io import video as j_video
from upsp_tpu.io import wtd as j_wtd
from upsp_tpu.io.video import util as j_util
from upsp_tpu.pipeline import config as j_config
from upsp_tpu.pipeline import interpolate as j_interpolate
from upsp_tpu.processing import context as j_context
from upsp_tpu_torch.geometry import bvh as t_bvh
from upsp_tpu_torch.geometry import grids as t_grids
from upsp_tpu_torch.io import camera_json as t_camera_json
from upsp_tpu_torch.io import cart3d as t_cart3d
from upsp_tpu_torch.io import comps as t_comps
from upsp_tpu_torch.io import flatfile as t_flatfile
from upsp_tpu_torch.io import paint as t_paint
from upsp_tpu_torch.io import tgts as t_tgts
from upsp_tpu_torch.io import video as t_video
from upsp_tpu_torch.io import wtd as t_wtd
from upsp_tpu_torch.io.video import util as t_util
from upsp_tpu_torch.pipeline import config as t_config
from upsp_tpu_torch.pipeline import interpolate as t_interpolate
from upsp_tpu_torch.pipeline.synthetic import write_datapoint
from upsp_tpu_torch.processing import context as t_context


def write_kulite_info(d, run, seq):
    """A kulite datapoint's ``.info``/``.fast``/``.slow`` files, as
    tests/test_psd_kulites.py writes them: two channels K01, K02."""
    name = f"wtT{run}p{seq}t1"
    lines = ["\t".join(["0", "3", "File Name"])]
    lines += ["\t".join([str(k + 1), str(k), name + ext])
              for k, ext in enumerate((".info", ".fast", ".slow"))]
    lines.append("\t".join(["0", "2", "Sampling Rate", "Number Channels",
                            "Samples Acquired"]))
    lines.append("\t".join(["1", "0", "40000", "2", "32"]))
    lines.append("\t".join(["2", "1", "1000", "2", "8"]))
    lines.append("\t".join(["0", "1", "Device"]))
    lines.append("\t".join(["1", "0", "PXI"]))
    lines.append("\t".join(["0", "2", "User Name", "User Channel", "Coeff k1",
                            "Coeff k0", "Sensitivity", "Offset"]))
    for ch in (1, 2):
        lines.append("\t".join([str(ch), str(ch - 1), f"K{ch:02d}", str(ch), "0.001",
                                "0.05", "2.0", "0.1"]))
    (d / (name + ".info")).write_text("\n".join(lines) + "\n")
    rng = np.random.default_rng(7)
    rng.integers(-1000, 1000, size=(32, 2)).astype("<i4").tofile(d / (name + ".fast"))
    rng.integers(-1000, 1000, size=(8, 2)).astype("<i4").tofile(d / (name + ".slow"))
    return name


def assert_same(a, b, where="value"):
    """Recursive equality of results: dataclasses field by field (private
    caches skipped), arrays exactly with NaN where NaN, containers item by
    item."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            if not f.name.startswith("_"):
                assert_same(getattr(a, f.name), getattr(b, f.name),
                            f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{k}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert a == b or (a != a and b != b), (where, a, b)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """One 12-bit mraw and one 10-bit cine datapoint, hot pixels included."""
    root = tmp_path_factory.mktemp("vendored")
    kw = dict(image_hw=(40, 64), n_frames=4, n_distinct=4, grid_shape=(21, 17),
              n_targets=3, seed=11, hot_pixels=True)
    return {fmt: write_datapoint(str(root / fmt), video_format=fmt, **kw)
            for fmt in ("mraw12", "cine10")}


def _deck(dp, _tmp):
    for d in dp.values():
        assert_same(t_config.read_input_deck(d["deck"]),
                    j_config.read_input_deck(d["deck"]))


def _flat_files(dp, tmp):
    model = j_grids.load_model(j_config.read_input_deck(dp["mraw12"]["deck"]).grid)
    rng = np.random.default_rng(1)
    n = model.size
    inten = rng.normal(2000, 50, (3, n)).astype(np.float32)
    inten[:, ::7] = np.nan
    p1 = dict(intensity=inten, intensity_avg=inten.mean(0),
              intensity_rms=inten.std(0), intensity_ratio_0=inten[0] / inten[1],
              coverage=rng.integers(0, 3, n).astype(np.float32))
    p2 = dict(pressure_transpose=inten.T.copy(), avg=inten[0], rms=inten[1],
              gain=inten[2], steady_state=inten[0] * 0.1, model_temp=inten[1])
    t_flatfile.FlatFileSet(str(tmp / "t")).write_standard_outputs(model, p1, p2)
    j_flatfile.FlatFileSet(str(tmp / "j")).write_standard_outputs(model, p1, p2)
    names = sorted(os.listdir(tmp / "j"))
    assert names == sorted(os.listdir(tmp / "t"))
    assert set(j_flatfile.FLAT_FILES) <= set(names)
    assert t_flatfile.FLAT_FILES == j_flatfile.FLAT_FILES
    for name in names:
        assert (tmp / "t" / name).read_bytes() == (tmp / "j" / name).read_bytes(), name


def _read_flat(_dp, tmp):
    x = np.random.default_rng(2).normal(0, 1, 1000).astype(np.float32)
    path = str(tmp / "flat")
    j_flatfile.write_flat(path, x)
    for kw in (dict(), dict(count=100, offset_values=37)):
        assert_same(t_flatfile.read_flat(path, **kw), j_flatfile.read_flat(path, **kw))
    assert_same(t_flatfile.vv_subsample(x, 99), j_flatfile.vv_subsample(x, 99))


def _pack_unpack(_dp, _tmp):
    rng = np.random.default_rng(3)
    p12 = rng.integers(0, 4096, 3 * 4 * 64).astype(np.uint16)
    p10 = rng.integers(0, 1024, 5 * 4 * 64).astype(np.uint16)
    assert_same(t_util.pack_12bpp(p12), j_util.pack_12bpp(p12))
    assert_same(t_util.pack_10bpp(p10), j_util.pack_10bpp(p10))
    raw = rng.integers(0, 256, 15 * 41).astype(np.uint8)
    assert_same(t_util.unpack_12bpp(raw), j_util.unpack_12bpp(raw))
    assert_same(t_util.unpack_10bpp(raw), j_util.unpack_10bpp(raw))


def _videos(dp, _tmp):
    from upsp_tpu.io.video.cine import LUT_10_TO_12 as j_lut
    from upsp_tpu_torch.io.video.cine import LUT_10_TO_12 as t_lut

    assert_same(t_lut, j_lut)
    for d in dp.values():
        for cam in t_config.read_input_deck(d["deck"]).cameras:
            t, j = t_video.video_reader(cam.video), j_video.video_reader(cam.video)
            assert type(t).__name__ == type(j).__name__
            t.open()
            j.open()
            try:
                for attr in ("frame_count", "frame_rate", "width", "height",
                             "bit_depth", "raw_bit_depth", "exposure_us",
                             "supports_packed_reads", "packed_bits", "packed_lut"):
                    assert_same(getattr(t, attr), getattr(j, attr), attr)
                for f in range(t.frame_count):
                    assert_same(t.read_frame(f), j.read_frame(f))
                assert_same(t.read_packed_frames(3, start=1), j.read_packed_frames(3, start=1))
            finally:
                t.close()
                j.close()


def _load_model(dp, tmp):
    grid = t_config.read_input_deck(dp["mraw12"]["deck"]).grid
    for tol in (0.0, 1e-3):
        assert_same(t_grids.load_model(grid, tolerance=tol),
                    j_grids.load_model(grid, tolerance=tol))
    # a Cart3D triangulation (io/cart3d.py) through both loaders
    m = j_grids.load_model(grid)
    mesh = j_cart3d.TriMesh(vertices=m.vertices, triangles=m.triangles,
                            components=np.ones(m.triangles.shape[0], np.int32))
    path = str(tmp / "plate.tri")
    j_cart3d.write_tri(path, mesh)
    assert_same(t_cart3d.read_tri(path), j_cart3d.read_tri(path))
    assert_same(t_grids.load_model(path), j_grids.load_model(path))


def _idw(_dp, _tmp):
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 1, (300, 3))
    dst = np.concatenate([rng.uniform(0, 1, (50, 3)), src[:5]])  # exact hits
    vals = rng.normal(0, 1, 300)
    assert_same(t_interpolate.idw_interpolate(src, vals, dst),
                j_interpolate.idw_interpolate(src, vals, dst))


def _targets_cameras_conditions(dp, _tmp):
    cfg = t_config.read_input_deck(dp["mraw12"]["deck"])
    for cam in cfg.cameras:
        assert_same(t_tgts.read_tgts(cam.targets), j_tgts.read_tgts(cam.targets))
        assert_same(t_tgts.targets_as_arrays(t_tgts.read_tgts(cam.targets)),
                    j_tgts.targets_as_arrays(j_tgts.read_tgts(cam.targets)))
        assert_same(t_tgts.read_tgts_header(cam.targets),
                    j_tgts.read_tgts_header(cam.targets))
        assert_same(t_camera_json.read_camera_json(cam.calibration, (40, 64)),
                    j_camera_json.read_camera_json(cam.calibration, (40, 64)))
    assert_same(t_wtd.read_wtd(cfg.sds), j_wtd.read_wtd(cfg.sds))
    assert_same(t_paint.PaintCalibration.read(cfg.paint_cal),
                j_paint.PaintCalibration.read(cfg.paint_cal))


def _comps(_dp, tmp):
    path = str(tmp / "comps.csv")
    with open(path, "w") as fh:
        fh.write("comp,active\n1,1\n2,0\n3,-2\n\n")
    assert_same(t_comps.read_active_comp_file(path), j_comps.read_active_comp_file(path))


def _native_bvh(dp, _tmp):
    from upsp_tpu_torch.native import native_library

    t_native = native_library()  # builds cpp/ with make when missing
    jn = importlib.reload(j_native)
    assert jn.available()
    m = j_grids.load_model(t_config.read_input_deck(dp["mraw12"]["deck"]).grid)
    for method in ("median", "sah"):
        tb = t_native.build_bvh(m.vertices, m.triangles, method=method)
        jb = jn.build_bvh(m.vertices, m.triangles, method=method)
        assert_same(tb, jb)
    rng = np.random.default_rng(5)
    o = np.concatenate([rng.uniform(0, 10, (200, 2)), np.full((200, 1), 5.0)], 1)
    d = np.tile([0.0, 0.0, -1.0], (200, 1)) + rng.normal(0, 0.05, (200, 3))
    assert_same(t_native.bvh_intersect(tb, o, d), jn.bvh_intersect(jb, o, d))
    raw = rng.integers(0, 256, 15 * 40).astype(np.uint8).tobytes()
    assert_same(t_native.unpack_12bpp(raw), jn.unpack_12bpp(raw))
    assert_same(t_native.unpack_10bpp(raw), jn.unpack_10bpp(raw))


def _transpose(_dp, tmp):
    """The flat-file transpose, native and numpy, on a shape that its blocks
    do not divide, against the original, byte for byte."""
    from upsp_tpu_torch import native as t_native
    from upsp_tpu_torch.native import native_library

    native_library()
    jn = importlib.reload(j_native)
    rows, cols, block = 37, 53, 16
    src = str(tmp / "src")
    np.random.default_rng(8).normal(0, 1, (rows, cols)).astype("<f4").tofile(src)
    jn.transpose_f32(src, str(tmp / "j"), rows, cols, block)
    want = (tmp / "j").read_bytes()
    assert want == np.fromfile(src, "<f4").reshape(rows, cols).T.tobytes()
    t_native.transpose_f32_native(src, str(tmp / "native"), rows, cols, block)
    assert (tmp / "native").read_bytes() == want
    # the dispatch: native with rows >= block, numpy with fewer
    for b in (block, rows + 1):
        t_native.transpose_f32(src, str(tmp / "dispatch"), rows, cols, b)
        assert (tmp / "dispatch").read_bytes() == want, b
    # numpy: 16 columns at a time, and all at once
    for max_bytes in (rows * 4 * block, 1 << 30):
        t_native.transpose_f32_numpy(src, str(tmp / "numpy"), rows, cols, max_bytes)
        assert (tmp / "numpy").read_bytes() == want, max_bytes


def _async_writer(_dp, tmp):
    """Writes at offsets out of order, from one buffer reused at once after
    each submit, give the original writer's file; so does the synchronous
    writer the port uses without the library."""
    from upsp_tpu_torch import native as t_native
    from upsp_tpu_torch.native import native_library

    native_library()
    jn = importlib.reload(j_native)
    parts = np.random.default_rng(9).normal(0, 1, (7, 33)).astype("<f4")
    with jn.AsyncWriter(str(tmp / "j")) as w:
        for k, part in enumerate(parts):
            w.submit(k * part.nbytes, part)
    want = (tmp / "j").read_bytes()
    assert want == parts.tobytes()
    lib = t_native._LIB
    try:
        for name in ("native", "sync"):
            t_native._LIB = lib if name == "native" else None
            buf = np.empty(33, "<f4")
            with t_native.AsyncWriter(str(tmp / name)) as w:
                assert (w._handle is None) == (name == "sync")
                for k in (4, 0, 6, 2, 5, 1, 3):
                    buf[:] = parts[k]
                    w.submit(k * buf.nbytes, buf)
                    buf[:] = np.nan
            assert (tmp / name).read_bytes() == want, name
    finally:
        t_native._LIB = lib


def _python_bvh(dp, _tmp):
    m = j_grids.load_model(t_config.read_input_deck(dp["mraw12"]["deck"]).grid)
    assert_same(t_bvh.build_bvh(m.vertices, m.triangles, 4),
                j_bvh.build_bvh(m.vertices, m.triangles, 4))


def _tree_context(_dp, tmp):
    root = tmp / "tree"
    root.mkdir()
    (root / "context.json").write_text(json.dumps(
        {"datapoints": {"301": {"grid": "g"}}, "processing": {"301": {"x": 1}}}))
    t, j = t_context.Pipeline(str(root)), j_context.Pipeline(str(root))
    for a, b in zip(t.datapoints, j.datapoints):
        assert_same((a.name, a.inputs, a.processing, a.input_deck_path(),
                     a.pressure_transpose_path(), a.output_path("s", "f")),
                    (b.name, b.inputs, b.processing, b.input_deck_path(),
                     b.pressure_transpose_path(), b.output_path("s", "f")))


def _hdf5(dp, tmp):
    h5py = pytest.importorskip("h5py")
    from upsp_tpu.io import hdf5io as j_hdf5io
    from upsp_tpu_torch.io import hdf5io as t_hdf5io

    cfg = t_config.read_input_deck(dp["mraw12"]["deck"])
    model = j_grids.load_model(cfg.grid)
    cond = j_wtd.read_wtd(cfg.sds)
    block = np.random.default_rng(6).normal(0, 1, (model.size, 3)).astype(np.float32)
    out = {}
    for name, mod in (("t", t_hdf5io), ("j", j_hdf5io)):
        path = str(tmp / f"{name}.h5")
        with mod.PSPWriter(path, model, n_frames=3, transposed=True,
                           chunk_nodes=64) as w:
            w.write_grid("in")
            w.write_tunnel_conditions(cond)
            w.write_camera_settings(focal_lengths=[100.0, 110.0], cam_nums=[1, 2],
                                    framerate=10000, fstop=2.8, exposure=50.0)
            w.write_frames_block(block)
            w.write_new_dataset("rms", block[:, 0], "delta Cp")
        vals = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda k, v: vals.__setitem__(
                k, v[()] if isinstance(v, h5py.Dataset) else None))
            vals["attrs"] = {k: f.attrs[k] for k in f.attrs}
        out[name] = vals
    assert_same(out["t"], out["j"])


def _tunnel(_dp, _tmp):
    from upsp_tpu.camera import tunnel as j_tunnel
    from upsp_tpu_torch.camera import tunnel as t_tunnel

    rng = np.random.default_rng(12)
    wtd = {"ALPHA": 3.5, "BETA": -1.25, "PHI": 12.0, "STRUTZ": 0.75}
    cfg = {"tunnel-cor_to_tgts_tvec": rng.normal(0, 1, (3, 1))}
    rmat = j_tunnel.rot(7.0, "x") @ j_tunnel.rot(-3.0, "z")
    tvec = rng.normal(0, 5, (3, 1))
    assert_same(t_tunnel.tf_camera_tgts_thru_tunnel(rmat, tvec, wtd, cfg),
                j_tunnel.tf_camera_tgts_thru_tunnel(rmat, tvec, wtd, cfg))
    assert_same(t_tunnel.tunnel_transform(1.0, 2.0, 3.0, 4.0, [1.0, 2.0, 3.0]),
                j_tunnel.tunnel_transform(1.0, 2.0, 3.0, 4.0, [1.0, 2.0, 3.0]))


def _matching(_dp, _tmp):
    from upsp_tpu.camera import matching as j_matching
    from upsp_tpu_torch.camera import matching as t_matching

    rng = np.random.default_rng(13)
    xyz = rng.uniform(0, 10, (30, 3))
    xyz[7] = xyz[6] + 0.05  # a crowded pair

    def project(p):
        return np.asarray(p)[:, :2] * 20.0

    kinds = ("dot", "kulite")
    tgts = [{"tvec": x.reshape(3, 1), "target_type": kinds[k % 2]}
            for k, x in enumerate(xyz)]
    imgs = [{"center": project(x[None])[0] + rng.normal(0, 1.5, 2),
             "target_type": kinds[k % 2]} for k, x in enumerate(xyz[:25])]
    cfg = {"max_dist": 4.0, "min_dist": 6.0}
    def run(mod):
        return (mod.project_targets(project, tgts),
                mod.match_obj_and_img_pts(project, tgts, imgs, 4.0),
                mod.match_targets(project, tgts, imgs, 4.0),
                mod.filter_dist_filter(project, tgts, imgs[:20], 20, 3.0, 5.0),
                mod.filter_matches(project, tgts[:25], imgs, 25, cfg))

    got = run(t_matching)
    assert 0 < got[3][2] < 20  # the filters keep some pairs and drop some
    assert_same(got, run(j_matching))


def _internal(_dp, tmp):
    from upsp_tpu.camera import internal as j_internal
    from upsp_tpu_torch.camera import internal as t_internal

    rng = np.random.default_rng(14)
    par = {k: {"val": float(v)} for k, v in
           dict(f=1500.0, cx=640.5, cy=400.25, k1=-0.1, k2=0.02, p1=1e-3, p2=-2e-3,
                k3=0.004).items()}
    board = rng.uniform([100, 80], [1100, 700], (200, 2))
    calibio = {"calibration": {"cameras": [{"model": {"ptr_wrapper": {"data": {
        "CameraModelCRT": {"CameraModelBase": {"imageSize": {"height": 800,
                                                             "width": 1280}}},
        "parameters": par}}}}]},
        "detections": [{"featurePoints": {"data": [
            {"imagePoint": {"x": float(x), "y": float(y)}} for x, y in board]}}]}
    path = str(tmp / "calibio.json")
    with open(path, "w") as fh:
        json.dump(calibio, fh)
    assert_same(t_internal.incal_from_calibio(path), j_internal.incal_from_calibio(path))
    assert_same(t_internal.calibio_board_points(path),
                j_internal.calibio_board_points(path))
    for mod, d in ((t_internal, "t"), (j_internal, "j")):
        (tmp / d).mkdir()
        mod.write_incal_from_calibio(path, "cam01", [10.0, 6.4], str(tmp / d))
    assert (tmp / "t" / "cam01.json").read_bytes() == (tmp / "j" / "cam01.json").read_bytes()
    q = rng.uniform([-50, -50], [1330, 850], (500, 2))
    for alpha in (0.01, 0.005):
        tb = t_internal.incal_calibration_bounds(board, alpha)
        jb = j_internal.incal_calibration_bounds(board, alpha)
        assert_same(tb.keep, jb.keep)
        assert_same(t_internal.points_inside_incal(tb, q, (800, 1280)),
                    j_internal.points_inside_incal(jb, q, (800, 1280)))
    assert_same(t_internal.points_inside_incal(None, q, (800, 1280)),
                j_internal.points_inside_incal(None, q, (800, 1280)))


def _detection(_dp, _tmp):
    from upsp_tpu.ops import detection as j_detection
    from upsp_tpu_torch.ops import detection as t_detection

    rng = np.random.default_rng(15)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.full((h, w), 200.0) + rng.normal(0, 3, (h, w))
    tgts = []
    for k, (x, y) in enumerate([(40.3, 30.7), (100.6, 60.2), (130.1, 95.5),
                                (4.0, 60.0)]):
        img -= 150 * ((xx - x) ** 2 + (yy - y) ** 2 < 3.5**2)
        tgts.append({"tvec": np.array([[x / 20], [y / 20], [0.0]]),
                     "norm": np.array([[0.0], [0.1 * k], [1.0]]), "size": 0.35,
                     "target_type": "dot"})
    img = np.clip(img, 0, 255).astype(np.uint8)

    def project(p):
        return np.asarray(p)[:, :2] * 20.0 + 0.3

    cfg = {"max_dist": 6, "dot_pad": 4, "crosscorr_coeff": 0.6}
    got = t_detection.detect_targets(img, tgts, project, cfg)
    assert got[2] == 3  # the dot at the image edge is not detected
    assert_same(got, j_detection.detect_targets(img, tgts, project, cfg))
    poly = t_detection.circle_polygon_3d(tgts[1]["tvec"], tgts[1]["norm"], 0.35)
    assert_same(poly, j_detection.circle_polygon_3d(tgts[1]["tvec"], tgts[1]["norm"], 0.35))
    assert_same(t_detection.rasterize_template(project(poly)),
                j_detection.rasterize_template(project(poly)))
    crop = img[20:45, 28:55]
    tmpl = t_detection.rasterize_template(project(poly))[0]
    assert_same(t_detection.ncc_scores(crop, tmpl), j_detection.ncc_scores(crop, tmpl))


def _panels(dp, tmp):
    """ops/panels.py on a surface panel grid and a two-layer volume one, and
    integration_matrices on the node map, by component and by panel."""
    from upsp_tpu.io.plot3d import StructGrid
    from upsp_tpu.ops import integration as j_integration
    from upsp_tpu.ops import panels as j_panels
    from upsp_tpu_torch.ops import integration as t_integration
    from upsp_tpu_torch.ops import panels as t_panels
    from upsp_tpu_torch.pipeline.synthetic import make_plate_grid

    model = j_grids.load_model(j_config.read_input_deck(dp["mraw12"]["deck"]).grid)
    surf = make_plate_grid(4, 3)
    vol = StructGrid()
    vol.sz = [np.array([4, 3, 2], np.int32)]
    vol.x = np.tile(surf.x, 2)
    vol.y = np.tile(surf.y, 2)
    vol.z = np.concatenate([surf.z - 0.2, surf.z + 0.3]).astype(np.float32)
    vol.zones = np.zeros(24, np.int32)
    for grid in (surf, vol):
        tp, jp = t_panels.panels_from_grid(grid, 1.5), j_panels.panels_from_grid(grid, 1.5)
        assert_same(tp, jp)
        pn = t_panels.panel_node_map(model, tp)
        assert_same(pn, j_panels.panel_node_map(model, jp))
        assert (pn >= 0).mean() > 0.5
        mask = np.arange(model.size) % 5 != 0
        assert_same(t_panels.panel_coverage(model, pn, tp.size, mask),
                    j_panels.panel_coverage(model, pn, jp.size, mask))
        assert_same(t_panels.assign_triangles_to_panels(model, tp),
                    j_panels.assign_triangles_to_panels(model, jp))
        assert_same(t_panels.split_model(model, tp), j_panels.split_model(model, jp))
        assert_same(t_integration.integration_matrices(model, pn, (1.0, 2.0, 0.0), tp.size),
                    j_integration.integration_matrices(model, pn, (1.0, 2.0, 0.0), jp.size))
    assert_same(t_integration.integration_matrices(model),
                j_integration.integration_matrices(model))


def _synthetic_builders(_dp, _tmp):
    """make_plate_grid, make_synthetic_state, make_reference_frame and
    make_frame_batch give the JAX package's arrays, in both overlap modes."""
    from upsp_tpu.pipeline import synthetic as j_syn
    from upsp_tpu_torch.pipeline import synthetic as t_syn

    assert_same(t_syn.make_plate_grid(7, 5, 3.0, 2.0), j_syn.make_plate_grid(7, 5, 3.0, 2.0))
    assert_same(t_syn.make_reference_frame((40, 56), 3), j_syn.make_reference_frame((40, 56), 3))
    assert_same(t_syn._subpixel_shift(np.arange(48.0).reshape(6, 8), -1.3, 0.6),
                j_syn._subpixel_shift(np.arange(48.0).reshape(6, 8), -1.3, 0.6))
    for kw in (dict(n_cameras=3, overlap="best_view", seed=2),
               dict(n_cameras=2, overlap="average_view", registration="none")):
        kw.update(image_hw=(48, 64), grid_shape=(14, 11), n_patch_dots=4)
        t, j = t_syn.make_synthetic_state(device="cpu", **kw), j_syn.make_synthetic_state(**kw)
        assert_same(t.model, j.model)
        assert_same(t.config, j.config)
        assert t.image_hw == j.image_hw and t.bvh is None and t.bvh_dev is None
        for name in ("skipped", "ref_frames", "superseded_by"):
            assert_same(getattr(t, name).numpy(),
                        np.asarray(getattr(j, name)).astype(getattr(t, name).numpy().dtype))
        for tp, jp in zip(t.projections, j.projections):
            for a, b in zip(tp, jp):
                assert_same(a.numpy(), np.asarray(b).astype(a.numpy().dtype))
        for top, jop in zip(t.patch_ops, j.patch_ops):
            for a, b in zip(top[:3], jop[:3]):
                assert_same(a.numpy(), np.asarray(b).astype(a.numpy().dtype))
            assert top.n_clusters == jop.n_clusters
        for tc, jc in zip(t.cam_params, j.cam_params):
            for a, b in zip(tc, jc):
                assert_same(a.numpy(), np.asarray(b))
        assert_same(t_syn.make_frame_batch(t, 3, seed=4), j_syn.make_frame_batch(j, 3, seed=4))


def _scale_image(_dp, _tmp):
    from upsp_tpu.ops import image as j_image
    from upsp_tpu_torch.ops import image as t_image

    img = np.random.default_rng(16).integers(0, 3000, (50, 70)).astype(np.uint16)
    img[3, 4] = img[10, 11] = 4095  # saturated outliers
    assert_same(t_image.scale_image(img, 2500.0), j_image.scale_image(img, 2500.0))
    assert_same(t_image.scale_image_max_inlier(img), j_image.scale_image_max_inlier(img))


def _primitives(dp, _tmp):
    from upsp_tpu.geometry import primitives as j_prim
    from upsp_tpu_torch.geometry import primitives as t_prim

    rng = np.random.default_rng(17)
    a, b, c = rng.normal(0, 1, (3, 3))
    o, d = rng.normal(0, 1, 3), rng.normal(0, 1, 3)
    lo, hi = np.array([-1.0, -0.5, -2.0]), np.array([1.0, 1.5, 0.5])
    pts = rng.uniform(-2, 2, (200, 3))
    model = j_grids.load_model(t_config.read_input_deck(dp["mraw12"]["deck"]).grid)

    def run(m):
        plane = m.plane_from_points(a, b, c)
        poly = m.box_polyhedron(lo, hi)
        inset = np.array([0.5, 0.5, -0.1])  # a flat plate: the box is thicker
        box = m.box_polyhedron(model.vertices.min(0) + inset,
                               model.vertices.max(0) - inset)
        return (plane, plane.offset, m.ray_plane_intersect(o, d, plane),
                m.ray_box_intersect(o, d, lo, hi),
                m.ray_box_intersect(np.zeros(3), np.array([0.0, 0.0, 1.0]), lo, hi),
                m.ray_triangle_intersect(np.array([0.1, 0.1, 1.0]),
                                         np.array([0.0, 0.0, -1.0]), *np.eye(3)),
                m.ray_triangle_intersect(o, d, a, b, c), poly,
                m.points_in_polyhedron(pts, poly), m.points_in_polyhedron(pts, poly, 0.1),
                m.ray_polyhedron_intersect(np.array([0.0, 0.0, 5.0]),
                                           np.array([0.0, 0.0, -1.0]), poly),
                m.nodes_in_polyhedron(model, box), m.triangle_area_normal(a, b, c),
                [m.get_perpendicular(v) for v in (a, np.array([0.0, 0.0, 1.0]))])

    got = run(t_prim)
    assert 0 < got[8].sum() < 200 and got[11].size > 0
    assert_same(got, run(j_prim))


def _pointset(_dp, _tmp):
    from upsp_tpu.ops import pointset as j_ps
    from upsp_tpu_torch.ops import pointset as t_ps

    rng = np.random.default_rng(18)
    ref = rng.uniform(0, 10, (40, 2))
    th = np.deg2rad(4.0)
    rmat = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    pts = ref[5:] @ rmat.T + [0.3, -0.2] + rng.normal(0, 0.01, (35, 2))
    pts3 = np.concatenate([pts, rng.normal(0, 0.1, (35, 1))], 1)
    ref3 = np.concatenate([ref, np.zeros((40, 1))], 1)

    def run(m):
        match = m.closest_point(ref, pts, 0.5)
        return (match, m.closest_point(ref, pts), m.closest_point(ref, pts[:0]),
                m.closest_point_unique(ref, pts, 0.5),
                m.iterative_closest_point(ref, pts), m.iterative_closest_point(ref3, pts3),
                m.coherent_point_drift(ref, pts, mode="rigid"),
                m.coherent_point_drift(ref, pts, mode="affine", w=0.1),
                m.unmatch_outliers(ref, pts, match, 2.0))

    assert_same(run(t_ps), run(j_ps))


def _blob(_dp, _tmp):
    from upsp_tpu.ops import blob as j_blob
    from upsp_tpu_torch.ops import blob as t_blob

    rng = np.random.default_rng(19)
    img = np.full((64, 96), 3000.0)
    yy, xx = np.mgrid[0:64, 0:96]
    for cx, cy, r2 in ((20, 30, 9), (70, 40, 12), (50, 10, 2), (85, 55, 40)):
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r2] = 500.0
    img += rng.normal(0, 10, img.shape)
    for kw in (dict(min_diameter=3, max_diameter=12), dict(), dict(min_circularity=0.9)):
        got = t_blob.find_targets(img, **kw)
        assert_same(got, j_blob.find_targets(img, **kw))
    assert len(t_blob.find_targets(img, min_diameter=3, max_diameter=12)) >= 2
    assert_same(t_blob.find_targets(np.ones((8, 8))), j_blob.find_targets(np.ones((8, 8))))


def _processing_tree(_dp, tmp):
    """resolve_parameter_overlays equal; create() writes the same tree but
    for the launchers' scripts, the generator strings and the date (the
    whole trees are compared in tests/test_torch_tools.py)."""
    from upsp_tpu.processing import tree as j_tree
    from upsp_tpu_torch.processing import tree as t_tree

    dps = {"3000101": {"run": 1, "grid": "/g/a.grid"}, "3000201": {"grid": "/g/b_fine.grid"}}
    proc = {"psp_process": {"filter_size": 3, "__overlays__": [
                {"__regex__": {"grid": "fine"}, "filter_size": 5},
                {"__regex__": {"name": "^30001"}, "degree": 4}]},
            "__meta__": {}, "other": {"a": 1}}
    assert_same(t_tree.resolve_parameter_overlays(proc, dps),
                j_tree.resolve_parameter_overlays(proc, dps))
    assert t_tree.STEPS == j_tree.STEPS
    for step in t_tree.STEPS:
        assert_same(t_tree._input_deck("3000101", dps["3000101"], {"degree": 4, "x": 1},
                                       "/o"),
                    j_tree._input_deck("3000101", dps["3000101"], {"degree": 4, "x": 1},
                                       "/o"))


def _kulites(_dp, tmp):
    """The .info/.fast/.slow readers (tests/test_psd_kulites.py's fixture
    layout), the kulite positions from a tgts file, the analysis helpers."""
    pytest.importorskip("pandas")
    from upsp_tpu.processing import kulites as j_kul
    from upsp_tpu_torch.processing import kulites as t_kul

    write_kulite_info(tmp, 123, 4)
    (tmp / "wtT999p9t1.info").write_text("")
    (tmp / "xr0123s004t1_S1C1.info").write_text("")
    assert_same(t_kul.find_info_files(str(tmp), 123, 4),
                j_kul.find_info_files(str(tmp), 123, 4))
    (tmp / "xr0123s004t1_S1C1.info").unlink()
    info = str(tmp / "wtT123p4t1.info")
    ti, ji = t_kul.read_info(info), j_kul.read_info(info)
    for a, b in zip(ti[1:], ji[1:]):
        assert a.equals(b)
    for kw in (dict(f_type="slow"), dict(f_type="fast", psf=True), dict(kulites=["K02"])):
        tk, jk = t_kul.Kulites(str(tmp), 123, 4, **kw), j_kul.Kulites(str(tmp), 123, 4, **kw)
        assert_same((tk.data, tk.raw, tk.sample_rate), (jk.data, jk.raw, jk.sample_rate))
    rng = np.random.default_rng(20)
    data = {"K01": rng.normal(0, 1, 4096), "K02": rng.normal(0, 2, 4096)}
    psd = t_kul.compute_psd(data, 1000.0, 256)
    assert_same(psd, j_kul.compute_psd(data, 1000.0, 256))
    from scipy import signal

    sos = signal.butter(4, 100.0, fs=1000.0, output="sos")
    for f in (None, sos):
        assert_same(t_kul.compute_delta_rms(data, f), j_kul.compute_delta_rms(data, f))
    for f0 in (None, 50.0):
        assert_same(t_kul.compute_rms_from_psd(psd, f0), j_kul.compute_rms_from_psd(psd, f0))
    tgts = tmp / "k.tgts"
    tgts.write_text("*Targets\n1 1.0 2.0 3.0 0.0 0.0 1.0 0.1 1 1 1 K01\n"
                    "2 4.0 5.0 6.0 0.0 0.0 1.0 0.1 1 1 1 st02\n"
                    "*Kulites\n3 7.0 8.0 9.0 0.0 0.0 1.0 0.1 1 1 1 K03\n")
    got = t_kul.read_kulite_positions(str(tgts))
    assert_same(got, j_kul.read_kulite_positions(str(tgts)))
    frames = rng.normal(0, 1, (5, 20, 30)).astype(np.float32)
    uv = np.array([[3.2, 4.7], [0.0, 0.0], [29.6, 19.4]])
    assert_same(t_kul.virtual_kulite_histories(frames, uv, 2),
                j_kul.virtual_kulite_histories(frames, uv, 2))


def _kulite_selection(dp, tmp):
    from upsp_tpu.processing import kulite_selection as j_ks
    from upsp_tpu_torch.processing import kulite_selection as t_ks

    model = j_grids.load_model(t_config.read_input_deck(dp["mraw12"]["deck"]).grid)
    p0 = model.vertices[150]
    for direction in ("up", "down", "port", "starboard"):
        assert_same(t_ks.selection_area_center(p0, direction, 0.3),
                    j_ks.selection_area_center(p0, direction, 0.3))
    kul = {"K01": p0, "K02": model.vertices[40]}
    ts, js = t_ks.KuliteNeighborhoodSearch(model, kul), j_ks.KuliteNeighborhoodSearch(model, kul)
    recs = []
    for name, direction, tol in (("K01", "up", 2e-2), ("K02", "port", None),
                                 ("K01", "starboard", 0.3)):
        got = ts.query(name, direction, 0.4, 6, tol)
        assert_same(got, js.query(name, direction, 0.4, 6, tol))
        recs.append({"Kulite Name": name, "Kulite Nearest Vertex": got["Kulite Nearest Vertex"],
                     "Selection Vertices": str(got["Selection Vertices"])})
    idx = list(range(0, 60, 3))
    assert_same(ts.filter_duplicates(idx, 0.5), js.filter_duplicates(idx, 0.5))
    img = np.zeros((10, 12, 3), np.uint8)
    assert_same(t_ks.highlight_pixels(img.copy(), [(1, 2), (9, 11), (20, 3)], (1, 2, 3)),
                j_ks.highlight_pixels(img.copy(), [(1, 2), (9, 11), (20, 3)], (1, 2, 3)))
    pytest.importorskip("cv2")
    diag = tmp / "diag"
    diag.mkdir()
    import cv2

    rng = np.random.default_rng(21)
    for c in (1, 2):
        cv2.imwrite(str(diag / f"cam{c:02d}-8bit-raw.png"),
                    rng.integers(0, 255, (40, 64, 3)).astype(np.uint8))
        rng.uniform(0, 1, (model.size, 2)).astype("<f4").tofile(diag / f"cam{c:02d}-uv")
    tp = t_ks.make_selection_area_images(recs, str(diag), str(tmp / "t"))
    jp = j_ks.make_selection_area_images(recs, str(diag), str(tmp / "j"))
    assert [os.path.basename(x) for x in tp] == [os.path.basename(x) for x in jp]
    assert len(tp) == 2
    for a, b in zip(tp, jp):
        assert open(a, "rb").read() == open(b, "rb").read()


def _p3d_export(dp, tmp):
    from upsp_tpu.io.plot3d import read_p3d_grid
    from upsp_tpu.processing import p3d_export as j_p3d
    from upsp_tpu_torch.processing import p3d_export as t_p3d

    grid = read_p3d_grid(t_config.read_input_deck(dp["mraw12"]["deck"]).grid)
    for fn in ("p3d_to_obj", "p3d_to_gltf", "write_zones_mapping"):
        getattr(t_p3d, fn)(grid, str(tmp / "t"))
        getattr(j_p3d, fn)(grid, str(tmp / "j"))
        assert (tmp / "t").read_bytes() == (tmp / "j").read_bytes(), fn


def _polyfit_host(_dp, tmp):
    """The numpy helpers of ops/polyfit.py and ops/patching.py."""
    from upsp_tpu.ops import patching as j_patch
    from upsp_tpu.ops import polyfit as j_poly
    from upsp_tpu_torch.ops import patching as t_patch
    from upsp_tpu_torch.ops import polyfit as t_poly

    rng = np.random.default_rng(22)
    x, y = rng.uniform(-1, 1, 50), rng.uniform(-1, 1, 50)
    z = 1 + x - 2 * y + 0.5 * x * y + rng.normal(0, 0.01, 50)
    for deg in (1, 3, 6):
        c = t_poly.polyfit_1d(x, z, deg)
        assert_same(c, j_poly.polyfit_1d(x, z, deg))
        assert_same(t_poly.polyval_1d(y, c), j_poly.polyval_1d(y, c))
    for deg in (2, 3):
        c = t_patch.polyfit2d(x, y, z, deg)
        assert_same(c, j_patch.polyfit2d(x, y, z, deg))
        assert_same(t_patch.polyval2d(y, x, c, deg), j_patch.polyval2d(y, x, c, deg))
    coeffs = rng.normal(0, 1, (7, 33)).astype(np.float32)
    t_poly.write_coeffs(str(tmp / "t"), coeffs)
    j_poly.write_coeffs(str(tmp / "j"), coeffs)
    assert (tmp / "t").read_bytes() == (tmp / "j").read_bytes()
    assert_same(t_poly.read_coeffs(str(tmp / "j")), j_poly.read_coeffs(str(tmp / "t")))
    (tmp / "bad").write_bytes(np.array([2, 4, 1, 1], np.int32).tobytes())
    for mod in (t_poly, j_poly):
        with pytest.raises(ValueError, match="header"):
            mod.read_coeffs(str(tmp / "bad"))


def _frame_prefetcher(dp, _tmp):
    """FramePrefetcher's chunks, decoded and packed, and the same for the
    port's host_reads_for_datapoint against the JAX package's."""
    from upsp_tpu.parallel import launcher as j_launcher
    from upsp_tpu_torch.parallel import launcher as t_launcher

    for d in dp.values():
        cfg = t_config.read_input_deck(d["deck"])
        for packed in (False, True):
            t, j = t_video.video_reader(cfg.cameras[0].video), j_video.video_reader(
                cfg.cameras[0].video)
            with t, j:
                assert_same(list(t_video.FramePrefetcher(t, 3, 1, 2, packed=packed)),
                            list(j_video.FramePrefetcher(j, 3, 1, 2, packed=packed)))
        for pid, count in ((0, 2), (1, 2), (2, 3)):
            tr, ts, tc = t_launcher.host_reads_for_datapoint(cfg, pid, count)
            jr, js, jc = j_launcher.host_reads_for_datapoint(
                j_config.read_input_deck(d["deck"]), pid, count)
            try:
                assert (ts, tc) == (js, jc)
                assert_same([r.read_frames(tc, ts) for r in tr],
                            [r.read_frames(jc, js) for r in jr])
            finally:
                for r in tr + jr:
                    r.close()


def _timing_and_outputs(_dp, _tmp):
    """BlockTimer, and Phase1Outputs' fields."""
    from upsp_tpu.pipeline import phase1 as j_phase1
    from upsp_tpu.utils import timing as j_timing
    from upsp_tpu_torch.pipeline import phase1 as t_phase1
    from upsp_tpu_torch.utils import timing as t_timing

    assert t_phase1.Phase1Outputs._fields == j_phase1.Phase1Outputs._fields
    for mod in (t_timing, j_timing):
        with mod.BlockTimer("x", enabled=False) as bt:
            assert bt.elapsed == 0.0
        assert bt.elapsed > 0 and bt.label == "x"


CASES = {f.__name__[1:]: f for f in (
    _deck, _flat_files, _read_flat, _pack_unpack, _videos, _load_model, _idw,
    _targets_cameras_conditions, _comps, _native_bvh, _python_bvh,
    _tree_context, _hdf5, _transpose, _async_writer, _tunnel, _matching,
    _internal, _detection, _scale_image, _panels, _synthetic_builders,
    _primitives, _pointset, _blob, _processing_tree, _kulites, _kulite_selection,
    _p3d_export, _polyfit_host, _frame_prefetcher, _timing_and_outputs,
)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_original(case, dp, tmp_path):
    CASES[case](dp, tmp_path)
