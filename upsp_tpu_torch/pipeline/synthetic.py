"""Synthetic datapoints on disk: the inputs of one ``upsp-process`` run.

Writes, from a seed, everything an input deck names: a flat-plate PLOT3D
grid, per-camera videos (12-bit packed ``.mraw`` with ``.cih`` headers, or
10-bit packed Phantom ``.cine``) and camera JSON calibrations, a ``.tgts``
target file, a ``.wtd`` tunnel-conditions file, a paint calibration and
the deck itself.

The cameras look straight down on the plate from offset positions, so
they overlap and best-view decides each node.  Each frame is a
band-limited random texture (broadband, so the FFT phase correlation has
real content in every spectral bin) with darkened fiducial dots, shifted
by a sub-pixel translation through a Fourier phase ramp; ``n_distinct``
frames are synthesised and tiled to ``n_frames``.  Optionally a few
frames carry hot pixels (see :func:`_add_hot_pixels`).

It also holds the JAX package's in-memory builders
(``upsp_tpu/pipeline/synthetic.py:29-210``): :func:`make_synthetic_state`,
a phase-0 state with analytic projections and no file or BVH work, its
:func:`make_reference_frame` templates and :func:`make_frame_batch`'s
sub-pixel-shifted frames.  They are numpy, seeded as there, and give the
same arrays; the state's tensors are on ``device``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

PLATE = (10.0, 8.0)  # plate extent in x, y (grid units)
CAM_Z = 20.0  # camera height above the plate
CAM_X = (3.9, 6.3, 5.0, 5.2)  # camera centres along x (up to 4 cameras)
CAM_Y = 4.0


def camera_focal(image_hw: Tuple[int, int]) -> float:
    """Focal length (px) that keeps the whole plate inside every frame."""
    h, w = image_hw
    m = max(6.0, w / 32.0)
    half_x = max(max(CAM_X) - 0.0, PLATE[0] - min(CAM_X)) + 0.2
    half_y = PLATE[1] / 2 + 0.2
    return float(min((w / 2 - m) * CAM_Z / half_x, (h / 2 - m) * CAM_Z / half_y))


def _texture(rng, image_hw, corr_px: float) -> np.ndarray:
    """Spectrum of a zero-mean random field with a Gaussian correlation of
    ``corr_px`` pixels, normalised to unit standard deviation."""
    h, w = image_hw
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    env = np.exp(-2.0 * (np.pi * corr_px) ** 2 * (fx**2 + fy**2))
    spec = np.fft.rfft2(rng.standard_normal((h, w))) * env
    field = np.fft.irfft2(spec, s=(h, w))
    return spec / field.std()


def scene_spectrum(rng, image_hw) -> np.ndarray:
    """Two scales: a smooth field (4 px) gives ECC a wide basin, a fine one
    (1 px) keeps every spectral bin of the phase correlation populated."""
    return (300.0 * _texture(rng, image_hw, 4.0)
            + 60.0 * _texture(rng, image_hw, 1.0))


def shift_field(spec, image_hw, dx: float, dy: float) -> np.ndarray:
    """The field sampled at (x - dx, y - dy): a periodic sub-pixel shift."""
    h, w = image_hw
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    ramp = np.exp(-2j * np.pi * (fx * dx + fy * dy))
    return np.fft.irfft2(spec * ramp, s=(h, w))


def _dots(image_hw, centers_px, radius_px) -> np.ndarray:
    """Multiplicative darkening mask of soft fiducial dots."""
    h, w = image_hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    mask = np.ones((h, w))
    for (u, v) in centers_px:
        r2 = (xx - u) ** 2 + (yy - v) ** 2
        mask *= 1.0 - 0.55 * np.exp(-r2 / (2.0 * (0.6 * radius_px) ** 2))
    return mask


def make_plate_grid(imax: int, jmax: int, lx: float = PLATE[0],
                    ly: float = PLATE[1]):
    """An imax x jmax flat-plate PLOT3D surface grid over [0, lx] x [0, ly]
    at z = 0."""
    from upsp_tpu_torch.io.plot3d import StructGrid

    gy, gx = np.meshgrid(np.linspace(0, ly, jmax), np.linspace(0, lx, imax),
                         indexing="ij")
    g = StructGrid()
    g.sz = [np.array([imax, jmax, 1], np.int32)]
    g.x = gx.ravel().astype(np.float32)
    g.y = gy.ravel().astype(np.float32)
    g.z = np.zeros(imax * jmax, np.float32)
    g.zones = np.zeros(imax * jmax, np.int32)
    return g


def target_positions(n_targets: int, seed: int) -> np.ndarray:
    """(n, 2) plate positions of the fiducial targets, well apart."""
    rng = np.random.default_rng(seed + 101)
    pts: list = []
    while len(pts) < n_targets:
        p = rng.uniform([1.0, 1.0], [PLATE[0] - 1.0, PLATE[1] - 1.0])
        if all(np.hypot(*(p - q)) > 1.2 for q in pts):
            pts.append(p)
    return np.array(pts)


HOT = 4095  # a saturated 12-bit pixel


def _add_hot_pixels(stack: np.ndarray, seed: int) -> None:
    """Saturate pixels of frames 1-3 of an (F, C, H, W) stack in place, per
    camera: 3 on frame 1 (a corner, an edge, the interior) and 5 on frame 2
    (all four corners and an edge) — both repaired, at most 5 candidates —
    and 8 interior ones on frame 3, a frame the repair leaves as it is
    (more than 5 candidates).  Frame 0, the ECC template, stays clean."""
    rng = np.random.default_rng(seed + 202)
    n_f, n_c, h, w = stack.shape
    for c in range(n_c):
        x, y = int(rng.integers(1, w - 1)), int(rng.integers(1, h - 1))
        pattern = {
            1: [(0, 0), (y, w - 1), (y, x)],
            2: [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (0, x)],
            3: [(int(rng.integers(1, h - 1)), int(rng.integers(1, w - 1)))
                for _ in range(8)],
        }
        for f, pts in pattern.items():
            if f < n_f:
                for py, px in pts:
                    stack[f, c, py, px] = HOT


def _inverse_lut(lut: np.ndarray) -> np.ndarray:
    """(4096,) 10-bit code whose entry in the monotone 10->12-bit ``lut``
    lies nearest each 12-bit value (the lowest such code on ties)."""
    v = np.arange(4096)
    hi = np.clip(np.searchsorted(lut, v), 0, lut.size - 1)
    lo = np.clip(hi - 1, 0, lut.size - 1)
    lo_nearer = np.abs(lut[lo].astype(np.int64) - v) <= np.abs(
        lut[hi].astype(np.int64) - v)
    return np.where(lo_nearer, lo, hi)


def _write_cine10(path: str, codes: np.ndarray, frame_rate: int = 10000,
                 shutter_ns: int = 50000) -> None:
    """A packed 10-bit Phantom ``.cine`` of (F, H, W) 10-bit codes, in the
    header layout ``upsp_tpu_torch.io.video.cine`` reads (CINEFILEHEADER,
    BITMAPINFOHEADER with biCompression 1, SETUP with RealBPP 10, the image
    offset table, then per image an 8-byte annotation and the payload)."""
    from upsp_tpu_torch.io.video.util import pack_10bpp

    n_f, h, w = codes.shape
    if (h * w) % 4:
        raise ValueError("a 10-bit packed frame needs H*W divisible by 4")
    setup_size = 7240
    off_bih = 44
    off_setup = off_bih + 40
    off_offsets = off_setup + setup_size
    data_start = off_offsets + 8 * n_f
    img_bytes = h * w * 10 // 8
    setup = bytearray(setup_size)
    struct.pack_into("<H", setup, 142, setup_size)
    struct.pack_into("<H", setup, 737, w)
    struct.pack_into("<H", setup, 739, h)
    struct.pack_into("<I", setup, 768, frame_rate)
    struct.pack_into("<I", setup, 1568, shutter_ns)
    struct.pack_into("<I", setup, 896, 10)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<HHHHiIiIIIIII", 0x4943, 44, 0, 1, 0, n_f, 0, n_f,
                             off_bih, off_setup, off_offsets, 0, 0))
        fh.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 10, 1, img_bytes,
                             0, 0, 0, 0))
        fh.write(setup)
        fh.write(struct.pack(f"<{n_f}q", *(data_start + i * (8 + img_bytes)
                                           for i in range(n_f))))
        for i in range(n_f):
            fh.write(struct.pack("<II", 8, img_bytes))
            fh.write(pack_10bpp(codes[i]).tobytes())


def write_datapoint(
    root: str,
    n_cameras: int = 2,
    image_hw: Tuple[int, int] = (96, 128),
    n_frames: int = 12,
    n_distinct: int = 12,
    grid_shape: Tuple[int, int] = (41, 33),
    n_targets: int = 6,
    max_shift_px: float = 2.0,
    seed: int = 0,
    options: Sequence[str] = (),
    shifts: Optional[np.ndarray] = None,
    video_format: str = "mraw12",
    hot_pixels: bool = False,
    texture_scale: float = 1.0,
) -> dict:
    """Write a datapoint under ``root``; returns {"deck", "shifts", "frames"
    (the (F, C, H, W) uint16 stack as the videos decode), "out_dir"}.

    ``video_format``: "mraw12" (12-bit packed ``.mraw`` + ``.cih``) or
    "cine10" (10-bit packed ``.cine``: each frame is quantised to the
    10-bit code whose cine 10->12-bit LUT value is nearest, so ``frames``
    holds the LUT values).  ``hot_pixels`` saturates pixels of frames 1-3
    (:func:`_add_hot_pixels`).  ``texture_scale`` scales the texture's
    contrast (the same seed draws the same texture): calibration frames
    take a faint one, since at full contrast the texture under a dot moves
    the super-Gaussian fit of its centre by about 1 px (0.9-2.7 px rms at
    pads 4-8, measured on the CPU).

    ``shifts`` (n_distinct, 2) gives the per-frame (dx, dy) jitter
    explicitly; by default it is uniform in +-``max_shift_px`` with frame 0
    unshifted.  ``options`` are extra ``key = value`` lines for the deck's
    @options (defaults: polynomial patcher, gaussian 3, best_view, pixel
    registration).
    """
    from upsp_tpu_torch.io.plot3d import write_p3d_grid
    from upsp_tpu_torch.io.video.util import pack_12bpp

    if video_format not in ("mraw12", "cine10"):
        raise ValueError(f"video_format must be mraw12 or cine10, got {video_format!r}")
    os.makedirs(root, exist_ok=True)
    h, w = image_hw
    rng = np.random.default_rng(seed)
    fx = camera_focal(image_hw)
    write_p3d_grid(os.path.join(root, "plate.grid"), make_plate_grid(*grid_shape))

    targets = target_positions(n_targets, seed)
    diam = 7.0 * CAM_Z / fx  # ~7 px in the image
    with open(os.path.join(root, "plate.tgts"), "w") as fh:
        fh.write("*Targets\n")
        for k, (x, y) in enumerate(targets):
            fh.write(f"{k + 1:4d} {x:10.4f} {y:10.4f} {0.0:10.4f}   0.0  0.0  1.0"
                     f" {diam:8.4f}   1  1  1 st{k + 1:02d}\n")
    with open(os.path.join(root, "t.wtd"), "w") as fh:
        fh.write("RUN 1 1\n#\tMACH\tALPHA\tBETA\tPHI\tQ\tPS\tTTF\tSTRUTZ\n")
        fh.write("0.80\t0.00\t0.00\t0.00\t144.00\t500.00\t80.00\t0.00\n")
    with open(os.path.join(root, "paint.cal"), "w") as fh:
        fh.write("a = 1.0\nb = 0.0\nc = 0\nd = 0\ne = 0\nf = 0\n")

    if shifts is None:
        n_distinct = max(1, min(n_distinct, n_frames))
        shifts = rng.uniform(-max_shift_px, max_shift_px, size=(n_distinct, 2))
        shifts[0] = 0.0
    n_distinct = len(shifts)
    stack = np.empty((n_frames, n_cameras, h, w), np.uint16)
    cams = []
    for c in range(n_cameras):
        cx = CAM_X[c]
        cal = {
            "uPSP_cameraMatrix": [[fx, 0.0, 0.0], [0.0, fx, 0.0], [0.0, 0.0, 1.0]],
            "distCoeffs": [[0.0, 0.0, 0.0, 0.0, 0.0]],
            "rmat": [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
            "tvec": [-cx, CAM_Y, CAM_Z],
        }
        cam_path = os.path.join(root, f"cam{c + 1:02d}.json")
        with open(cam_path, "w") as fh:
            json.dump(cal, fh)
        # overhead pinhole: u = W/2 + fx (x - cx)/Z, v = H/2 - fx (y - cy)/Z
        dots_px = [(w / 2 + fx * (x - cx) / CAM_Z, h / 2 - fx * (y - CAM_Y) / CAM_Z)
                   for x, y in targets]
        spec = texture_scale * scene_spectrum(rng, image_hw)
        spec_dots = np.fft.rfft2(_dots(image_hw, dots_px, 0.5 * diam * fx / CAM_Z))
        distinct = np.empty((n_distinct, h, w), np.uint16)
        for f, (dx, dy) in enumerate(shifts):
            tex = 2000.0 + shift_field(spec, image_hw, dx, dy)
            dots = shift_field(spec_dots, image_hw, dx, dy)
            lamp = 1.0 + 0.01 * np.sin(2 * np.pi * f / 7)
            distinct[f] = np.clip(np.rint(tex * dots * lamp), 0, 4000)
        for f in range(n_frames):
            stack[f, c] = distinct[f % n_distinct]
        cams.append(cam_path)
    if hot_pixels:
        _add_hot_pixels(stack, seed)

    videos = []
    for c in range(n_cameras):
        if video_format == "cine10":
            from upsp_tpu_torch.io.video.cine import LUT_10_TO_12

            codes = _inverse_lut(LUT_10_TO_12)[stack[:, c]]
            stack[:, c] = LUT_10_TO_12[codes]
            video = os.path.join(root, f"cam{c + 1:02d}.cine")
            _write_cine10(video, codes)
        else:
            video = os.path.join(root, f"cam{c + 1:02d}.mraw")
            with open(video, "wb") as fh:
                for f in range(n_frames):
                    fh.write(pack_12bpp(stack[f, c]).tobytes())
            with open(os.path.join(root, f"cam{c + 1:02d}.cih"), "w") as fh:
                fh.write(
                    "Record Rate(fps) : 10000\nShutter Speed(s) : 1/20000\n"
                    f"Total Frame : {n_frames}\nImage Width : {w}\n"
                    f"Image Height : {h}\nColor Bit : 12\nEffectiveBit Depth : 12\n"
                    "EffectiveBit Side : Lower\nFile Format : Mraw\n"
                )
        videos.append(video)

    out_dir = os.path.join(root, "out")
    lines = [
        "@general", "\ttest = synth", "\trun = 1", "\tsequence = 1",
        "@all", f"\tsds = {root}/t.wtd", f"\tgrid = {root}/plate.grid",
        f"\ttargets = {root}/plate.tgts",
        f"\tpaint_calibration = {root}/paint.cal",
    ]
    for c, (video, cam_path) in enumerate(zip(videos, cams)):
        lines += ["@camera", f"\tnumber = {c + 1}", f"\tcine = {video}",
                  f"\tcalibration = {cam_path}"]
    lines += ["@options", "\ttarget_patcher = polynomial",
              "\tregistration = pixel", "\tfilter = gaussian",
              "\tfilter_size = 3", "\toverlap = best_view",
              f"\tnumber_frames = {n_frames}"]
    lines += [f"\t{o}" for o in options]
    lines += ["@output", f"\tdir = {out_dir}"]
    deck = os.path.join(root, "deck.inp")
    with open(deck, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return {"deck": deck, "shifts": shifts, "frames": stack, "out_dir": out_dir}


# the wind-off poses of a calibration case: the true pose turned about x
# (deg), then moved, as tests/test_external_calibrate.py:65-67 perturbs it
CAL_ROT_DEG = 0.25
CAL_SHIFT = (0.02, -0.01, 0.02)
CAL_DOT_PAD = 5  # px, the test config's dot_pad (dots are ~7 px across)


def write_calibration_inputs(root: str, frames: np.ndarray) -> dict:
    """The inputs of ``upsp-external-calibration`` for a datapoint that
    :func:`write_datapoint` wrote under ``root``: each camera's first frame
    of ``frames`` (its (F, C, H, W) stack) as a 16-bit PNG, a test config
    and a camera-tunnel directory.

    The camera-tunnel poses are the camera JSONs' poses turned by
    ``CAL_ROT_DEG`` about x, then moved by ``CAL_SHIFT``; the datapoint's wtd has zero
    angles and STRUTZ and the config a zero centre of rotation, so the
    wind-on starting pose is that perturbed pose, and a calibration should
    recover the camera JSONs'.  ``max_dist`` (px) covers 1.5x the largest
    shift of a target's projection that the perturbation makes, plus 4.
    Returns {"cfg", "cal_dir", "imgs", "cams": the true camera JSON paths,
    "max_dist"}.
    """
    import cv2
    import torch

    from upsp_tpu_torch.camera.model import make_camera_params, project_points, rot
    from upsp_tpu_torch.io.camera_json import read_camera_json
    from upsp_tpu_torch.io.tgts import read_tgts

    n_cameras, h, w = frames.shape[1:]
    xyz = torch.from_numpy(np.stack([t.xyz for t in read_tgts(
        os.path.join(root, "plate.tgts"))]).astype(np.float64))
    shift = 0.0
    for c in range(n_cameras):
        cal = read_camera_json(os.path.join(root, f"cam{c + 1:02d}.json"), (h, w))
        uv = [project_points(make_camera_params(r, t, cal.camera_matrix,
                                                cal.dist_coeffs), xyz)
              for r, t in ((cal.rmat, cal.tvec), (rot(CAL_ROT_DEG, "x") @ cal.rmat,
                                                  cal.tvec + np.asarray(CAL_SHIFT)))]
        shift = max(shift, float(torch.linalg.norm(uv[1] - uv[0], dim=1).max()))
    max_dist = int(np.ceil(1.5 * shift)) + 4
    cfg = {"max_dist": max_dist, "min_dist": max_dist, "dot_pad": CAL_DOT_PAD,
           "kulite_pad": CAL_DOT_PAD, "oblique_angle": 70.0, "crosscorr_coeff": 0.7,
           "tunnel-cor_to_tgts_tvec": [0.0, 0.0, 0.0]}
    cfg_path = os.path.join(root, "test_config.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh, indent=1)
    cal_dir = os.path.join(root, "camera-tunnel")
    os.makedirs(cal_dir, exist_ok=True)
    imgs, cams = [], []
    for c in range(n_cameras):
        cam_path = os.path.join(root, f"cam{c + 1:02d}.json")
        with open(cam_path) as fh:
            cal = json.load(fh)
        cal["rmat"] = (rot(CAL_ROT_DEG, "x") @ np.asarray(cal["rmat"])).tolist()
        cal["tvec"] = (np.asarray(cal["tvec"]) + np.asarray(CAL_SHIFT)).tolist()
        with open(os.path.join(cal_dir, f"camera{c + 1:02d}.json"), "w") as fh:
            json.dump(cal, fh)
        img = os.path.join(root, f"cam{c + 1:02d}_first_frame.png")
        cv2.imwrite(img, frames[0, c])
        imgs.append(img)
        cams.append(cam_path)
    return {"cfg": cfg_path, "cal_dir": cal_dir, "imgs": imgs, "cams": cams,
            "max_dist": max_dist}


# ---------------------------------------------------------------------------
# in-memory scenes (upsp_tpu/pipeline/synthetic.py)


def make_synthetic_state(
    n_cameras: int = 1,
    image_hw: Tuple[int, int] = (1024, 1024),
    grid_shape: Tuple[int, int] = (160, 128),
    n_patch_dots: int = 12,
    registration: str = "pixel",
    filter_type: str = "gaussian",
    seed: int = 0,
    overlap: str = "best_view",
    device="cuda",
):
    """A deterministic phase-0 state without file IO or BVH work: the
    flat plate under ``n_cameras`` overhead pinhole cameras, offset 0.4
    apart in x, with analytic node->pixel projections, ``n_patch_dots``
    random patch clusters a camera and :func:`make_reference_frame`
    templates.  ``overlap`` "best_view" gives each node to the camera whose
    projection lands nearest its image centre (one positive weight a node:
    phase 1's combined gather); "average_view" keeps every seeing camera's
    weight at 1 / n_cameras.  Tensors on ``device``."""
    import torch

    from upsp_tpu_torch.camera.model import make_camera_params
    from upsp_tpu_torch.geometry.grids import from_struct_grid
    from upsp_tpu_torch.ops.patching import build_patch_clusters, build_patch_operator
    from upsp_tpu_torch.ops.projection import NodeProjection, identify_skipped_nodes
    from upsp_tpu_torch.pipeline.config import CameraInputs, ProcessingConfig
    from upsp_tpu_torch.pipeline.phase0 import Phase0State

    H, W = image_hw
    imax, jmax = grid_shape
    rng = np.random.default_rng(seed)
    grid = make_plate_grid(imax, jmax)
    model = from_struct_grid(grid, tolerance=0.0)
    cam_z = 20.0
    fx = min(W, H) * cam_z / 12.0 * 0.86
    cfg = ProcessingConfig(
        test_id="synthetic-bench",
        cameras=[CameraInputs(number=c + 1) for c in range(n_cameras)],
        registration=registration,
        filter=filter_type,
        filter_size=3,
        target_patcher="polynomial",
    )
    cam_params, patch_ops, ref_frames = [], [], []
    proj = []  # per camera: (pixel_index, weight, u, v, visible), numpy
    for c in range(n_cameras):
        cx_world = 5.0 + 0.4 * c
        rmat = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
        tvec = np.array([-cx_world, 4.0, cam_z])
        K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
        cam_params.append(make_camera_params(rmat, tvec, K, np.zeros(5),
                                             dtype=torch.float32))
        u = W / 2 + fx * (grid.x - cx_world) / cam_z
        v = H / 2 - fx * (grid.y - 4.0) / cam_z
        visible = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        col = np.clip(np.rint(u), 0, W - 1).astype(np.int32)
        row = np.clip(np.rint(v), 0, H - 1).astype(np.int32)
        proj.append([np.where(visible, row * W + col, 0).astype(np.int64),
                     (visible / max(n_cameras, 1)).astype(np.float32),
                     (u / W).astype(np.float32), (v / H).astype(np.float32),
                     visible])
        dots = rng.uniform([0.08 * W, 0.08 * H], [0.92 * W, 0.92 * H],
                           size=(n_patch_dots, 2))
        diam = rng.uniform(4.0, 8.0, n_patch_dots)
        patch_ops.append(build_patch_operator(
            build_patch_clusters(dots, diam, image_hw, 3, 2), image_hw))
        ref_frames.append(make_reference_frame(image_hw, seed=seed + c))
    if overlap == "best_view" and n_cameras > 1:
        uu = np.stack([p[2] for p in proj])
        vv = np.stack([p[3] for p in proj])
        vis = np.stack([p[4] for p in proj])
        offc = np.hypot(uu - 0.5, vv - 0.5)
        offc[~vis] = np.inf
        best = offc.argmin(axis=0)
        any_vis = vis.any(axis=0)
        for c in range(n_cameras):
            proj[c][1] = ((best == c) & any_vis).astype(np.float32)
    cfg.overlap = overlap
    device = torch.device(device)
    projections = [
        NodeProjection(*(torch.from_numpy(np.asarray(a)).to(device) for a in p))
        for p in proj
    ]
    return Phase0State(
        model=model,
        bvh=None,
        cam_params=cam_params,
        projections=projections,
        skipped=identify_skipped_nodes(projections),
        patch_ops=[None if op is None else op.to(device) for op in patch_ops],
        ref_frames=torch.from_numpy(np.stack(ref_frames)).to(device),
        superseded_by=torch.as_tensor(np.asarray(model.superseded_by),
                                      dtype=torch.int64, device=device),
        image_hw=image_hw,
        config=cfg,
        device=device,
    )


def make_reference_frame(image_hw: Tuple[int, int], seed: int = 0) -> np.ndarray:
    """A textured, well-lit 12-bit frame: a ramp, 24 Gaussian blobs and
    noise (ECC needs gradients everywhere)."""
    H, W = image_hw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 1800 + 0.9 * xx + 0.7 * yy
    for _ in range(24):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        s = rng.uniform(W / 40, W / 8)
        img += rng.uniform(120, 600) * np.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)
        )
    img += rng.normal(0, 6.0, (H, W))
    return np.clip(img, 0, 4095).astype(np.float32)


def _subpixel_shift(img: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Bilinear sub-pixel translation with edge replication (host numpy)."""
    H, W = img.shape
    ix, fx = int(np.floor(dx)), dx - np.floor(dx)
    iy, fy = int(np.floor(dy)), dy - np.floor(dy)
    pad = max(abs(ix) + 1, abs(iy) + 1)
    p = np.pad(img, pad, mode="edge")
    y0 = pad + iy
    x0 = pad + ix
    a = p[y0 : y0 + H, x0 : x0 + W]
    b = p[y0 : y0 + H, x0 + 1 : x0 + 1 + W]
    c = p[y0 + 1 : y0 + 1 + H, x0 : x0 + W]
    d = p[y0 + 1 : y0 + 1 + H, x0 + 1 : x0 + 1 + W]
    return (
        a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx)
        + d * fy * fx
    ).astype(np.float32)


def make_frame_batch(state, n_frames: int, jitter_px: float = 0.6,
                     seed: int = 1) -> np.ndarray:
    """(F, C, H, W) float32: each camera's reference frame under a random
    sub-pixel translation (bilinear, so registration has real work) and a
    slow gain wobble."""
    H, W = state.image_hw
    rng = np.random.default_rng(seed)
    ref = state.ref_frames.cpu().numpy()  # (C, H, W)
    frames = np.empty((n_frames, ref.shape[0], H, W), np.float32)
    for f in range(n_frames):
        for c in range(ref.shape[0]):
            dx, dy = rng.normal(0, jitter_px, 2)
            shifted = _subpixel_shift(ref[c], dx, dy)
            frames[f, c] = shifted * (1.0 + 0.01 * np.sin(2 * np.pi * f / 37))
    return frames
