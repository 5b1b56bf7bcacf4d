"""The benchmark's datapoints: every input of one ``upsp-process`` run,
written from a seed.

A self-contained copy of ``upsp_tpu_torch/pipeline/synthetic.py``'s
``write_datapoint`` (it imports nothing of the program): a flat-plate
PLOT3D grid, per-camera videos (12-bit packed Photron ``.mraw`` with a
``.cih`` header, or 10-bit packed Phantom ``.cine`` read through the
10->12-bit LUT), camera JSONs of overhead pinhole cameras, a ``.tgts``
file, a ``.wtd`` file, a paint calibration and the input deck.

Each frame is a band-limited random texture with darkened fiducial dots,
shifted by a sub-pixel translation through a Fourier phase ramp.
``n_distinct`` frames are synthesised per camera and tiled to
``n_frames``; frames 1-3 carry hot pixels.  The textures are drawn on
``device`` from a ``torch.Generator`` seeded by the seed, in a few large
calls; the shifts, the targets and the hot pixels come from numpy
generators of the seed.  The same seed on the same kind of device gives
the same bytes.

The shifts are stratified so that every seed asks for the same work: the
``n_distinct - 1`` shifted frames take the magnitudes
``max_shift_px * sqrt(k / (n_distinct - 1))``, k = 1 .. n_distinct - 1,
in directions and an order drawn from the seed (frame 0, the template,
is unshifted).  The identity start's Gauss-Newton loop runs longer on a
larger shift, so uniform draws would make the work follow the seed.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Tuple

import numpy as np
import torch

PLATE = (10.0, 8.0)  # plate extent in x, y (grid units)
CAM_Z = 20.0  # camera height above the plate
CAM_X = (3.9, 6.3, 5.0, 5.2)  # camera centres along x (up to 4 cameras)
CAM_Y = 4.0
HOT = 4095  # a saturated 12-bit pixel
LUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cine_lut10.npy")


def cine_lut() -> np.ndarray:
    """The Vision Research 10->12-bit linearisation table (uint16, 1024)."""
    return np.load(LUT_PATH)


def camera_focal(image_hw: Tuple[int, int]) -> float:
    """Focal length (px) that keeps the whole plate inside every frame."""
    h, w = image_hw
    m = max(6.0, w / 32.0)
    half_x = max(max(CAM_X), PLATE[0] - min(CAM_X)) + 0.2
    half_y = PLATE[1] / 2 + 0.2
    return float(min((w / 2 - m) * CAM_Z / half_x, (h / 2 - m) * CAM_Z / half_y))


def plate_xy(grid_shape: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) float32 of the imax x jmax plate's nodes, i fastest."""
    imax, jmax = grid_shape
    gy, gx = np.meshgrid(np.linspace(0, PLATE[1], jmax),
                         np.linspace(0, PLATE[0], imax), indexing="ij")
    return gx.ravel().astype(np.float32), gy.ravel().astype(np.float32)


def _record(fh, arr: np.ndarray) -> None:
    """One Fortran unformatted record."""
    marker = np.array([arr.nbytes], np.int32)
    marker.tofile(fh)
    arr.tofile(fh)
    marker.tofile(fh)


def write_plate_grid(path: str, grid_shape: Tuple[int, int]) -> None:
    """A one-zone unformatted PLOT3D surface grid of the plate at z = 0."""
    imax, jmax = grid_shape
    x, y = plate_xy(grid_shape)
    with open(path, "wb") as fh:
        _record(fh, np.array([1], np.int32))
        _record(fh, np.array([imax, jmax, 1], np.int32))
        _record(fh, np.concatenate([x, y, np.zeros_like(x)]).astype(np.float32))


def target_positions(n_targets: int, seed: int) -> np.ndarray:
    """(n, 2) plate positions of the fiducial targets, well apart."""
    rng = np.random.default_rng(seed + 101)
    pts: list = []
    while len(pts) < n_targets:
        p = rng.uniform([1.0, 1.0], [PLATE[0] - 1.0, PLATE[1] - 1.0])
        if all(np.hypot(*(p - q)) > 1.2 for q in pts):
            pts.append(p)
    return np.array(pts)


def stratified_shifts(n_distinct: int, max_shift_px: float, seed: int) -> np.ndarray:
    """(n_distinct, 2) (dx, dy): frame 0 unshifted, the others the fixed
    magnitudes of the module docstring in seeded directions and order."""
    rng = np.random.default_rng(seed + 303)
    n = n_distinct - 1
    shifts = np.zeros((n_distinct, 2))
    if n > 0:
        r = max_shift_px * np.sqrt(np.arange(1, n + 1) / n)
        ang = rng.uniform(0.0, 2.0 * np.pi, n)
        order = rng.permutation(n)
        shifts[1:] = np.stack([r * np.cos(ang), r * np.sin(ang)], 1)[order]
    return shifts


def _freqs(image_hw, device):
    h, w = image_hw
    fy = torch.fft.fftfreq(h, dtype=torch.float64, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, dtype=torch.float64, device=device)[None, :]
    return fy, fx


def _texture(gen, image_hw, corr_px: float, device) -> torch.Tensor:
    """Spectrum of a zero-mean field with a Gaussian correlation of
    ``corr_px`` pixels, normalised to unit standard deviation."""
    h, w = image_hw
    fy, fx = _freqs(image_hw, device)
    env = torch.exp(-2.0 * (np.pi * corr_px) ** 2 * (fx ** 2 + fy ** 2))
    noise = torch.randn((h, w), generator=gen, dtype=torch.float64, device=device)
    spec = torch.fft.rfft2(noise) * env
    return spec / torch.fft.irfft2(spec, s=(h, w)).std()


def _shifted(spec, image_hw, shifts: torch.Tensor) -> torch.Tensor:
    """(n, H, W): the field of ``spec`` sampled at (x - dx, y - dy)."""
    fy, fx = _freqs(image_hw, spec.device)
    ramp = torch.exp(-2j * np.pi * (fx[None] * shifts[:, 0, None, None]
                                    + fy[None] * shifts[:, 1, None, None]))
    return torch.fft.irfft2(spec[None] * ramp, s=image_hw)


def _dots(image_hw, centers_px, radius_px, device) -> torch.Tensor:
    """Multiplicative darkening mask of soft fiducial dots."""
    h, w = image_hw
    yy = torch.arange(h, dtype=torch.float64, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    mask = torch.ones((h, w), dtype=torch.float64, device=device)
    for (u, v) in centers_px:
        r2 = (xx - u) ** 2 + (yy - v) ** 2
        mask *= 1.0 - 0.55 * torch.exp(-r2 / (2.0 * (0.6 * radius_px) ** 2))
    return mask


def hot_pixel_frames(distinct: np.ndarray, seed: int) -> np.ndarray:
    """(3, C, H, W): frames 1-3 of ``distinct`` with saturated pixels, per
    camera 3 on frame 1 (a corner, an edge, the interior) and 5 on frame 2
    (four corners and an edge), both repaired (at most 5 candidates), and 8
    interior ones on frame 3, which the repair leaves as it is."""
    rng = np.random.default_rng(seed + 202)
    out = distinct[1:4].copy()
    _, n_c, h, w = distinct.shape
    for c in range(n_c):
        x, y = int(rng.integers(1, w - 1)), int(rng.integers(1, h - 1))
        pattern = {
            1: [(0, 0), (y, w - 1), (y, x)],
            2: [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (0, x)],
            3: [(int(rng.integers(1, h - 1)), int(rng.integers(1, w - 1)))
                for _ in range(8)],
        }
        for f, pts in pattern.items():
            for py, px in pts:
                out[f - 1, c, py, px] = HOT
    return out


def pack_12bpp(pix: torch.Tensor) -> torch.Tensor:
    """(..., n) values -> (..., 3n/2) uint8, two pixels in three bytes,
    high nibble first (the .mraw layout); n even."""
    p = pix.to(torch.int32).clamp(0, 4095)
    a, b = p[..., 0::2], p[..., 1::2]
    out = torch.stack([a >> 4, ((a & 0xF) << 4) | (b >> 8), b & 0xFF], -1)
    return out.reshape(p.shape[:-1] + (-1,)).to(torch.uint8)


def pack_10bpp(pix: torch.Tensor) -> torch.Tensor:
    """(..., n) 10-bit codes -> (..., 5n/4) uint8, four in five bytes,
    most significant first (the packed .cine layout); n divisible by 4."""
    p = pix.to(torch.int32).clamp(0, 1023)
    a, b, c, d = (p[..., k::4] for k in range(4))
    out = torch.stack([a >> 2, ((a & 0x3) << 6) | (b >> 4), ((b & 0xF) << 4) | (c >> 6),
                       ((c & 0x3F) << 2) | (d >> 8), d & 0xFF], -1)
    return out.reshape(p.shape[:-1] + (-1,)).to(torch.uint8)


def inverse_lut(lut: np.ndarray) -> np.ndarray:
    """(4096,) the 10-bit code whose LUT value lies nearest each 12-bit
    value (the lowest such code on ties)."""
    v = np.arange(4096)
    hi = np.clip(np.searchsorted(lut, v), 0, lut.size - 1)
    lo = np.clip(hi - 1, 0, lut.size - 1)
    lo_nearer = np.abs(lut[lo].astype(np.int64) - v) <= np.abs(lut[hi].astype(np.int64) - v)
    return np.where(lo_nearer, lo, hi)


def _cine_header(n_f: int, h: int, w: int, frame_rate: int = 10000,
                 shutter_ns: int = 50000) -> Tuple[bytes, int]:
    """(CINEFILEHEADER + BITMAPINFOHEADER + SETUP + offset table, bytes of
    one image record) of a packed 10-bit cine of ``n_f`` (h, w) images."""
    setup_size = 7240
    off_bih, off_setup = 44, 84
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
    head = (struct.pack("<HHHHiIiIIIIII", 0x4943, 44, 0, 1, 0, n_f, 0, n_f,
                        off_bih, off_setup, off_offsets, 0, 0)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 10, 1, img_bytes, 0, 0, 0, 0)
            + bytes(setup)
            + struct.pack(f"<{n_f}q", *(data_start + i * (8 + img_bytes)
                                        for i in range(n_f))))
    return head, img_bytes


def content_index(f: int, n_distinct: int) -> int:
    """Row of :func:`write_datapoint`'s ``contents`` that frame ``f`` shows."""
    return n_distinct + f - 1 if 1 <= f <= 3 else f % n_distinct


def write_datapoint(root: str, seed: int, n_cameras: int, image_hw, grid_shape,
                    n_frames: int, n_distinct: int, n_targets: int,
                    max_shift_px: float, video_format: str, device,
                    options: dict) -> dict:
    """Write a datapoint under ``root``.  Returns {"deck", "contents"
    ((n_distinct + 3, C, H, W) uint16, the frames as the videos decode:
    the distinct frames, then frames 1-3 with their hot pixels; frame f
    shows row :func:`content_index`), "targets" ((n, 2) plate x, y),
    "focal", "image_hw", "grid_shape", "n_frames", "n_distinct", "options"
    (the deck's @options), "paint" (a..f), "qbar", "root"}."""
    if video_format not in ("mraw12", "cine10"):
        raise ValueError(f"video_format must be mraw12 or cine10, got {video_format!r}")
    if n_distinct < 4 or n_frames < 4:
        raise ValueError("a datapoint needs at least 4 distinct frames (hot pixels on 1-3)")
    h, w = image_hw
    if (h * w) % 4:
        raise ValueError("packed frames need H*W divisible by 4")
    os.makedirs(root, exist_ok=True)
    device = torch.device(device)
    fx = camera_focal(image_hw)
    write_plate_grid(os.path.join(root, "plate.grid"), grid_shape)
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

    shifts = torch.tensor(stratified_shifts(n_distinct, max_shift_px, seed),
                          dtype=torch.float64, device=device)
    lamp = 1.0 + 0.01 * torch.sin(2 * np.pi * torch.arange(
        n_distinct, dtype=torch.float64, device=device) / 7)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    distinct = torch.empty((n_distinct, n_cameras, h, w), dtype=torch.int32,
                           device=device)
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
        cams.append(cam_path)
        dots_px = [(w / 2 + fx * (x - cx) / CAM_Z, h / 2 - fx * (y - CAM_Y) / CAM_Z)
                   for x, y in targets]
        spec = (300.0 * _texture(gen, image_hw, 4.0, device)
                + 60.0 * _texture(gen, image_hw, 1.0, device))
        spec_dots = torch.fft.rfft2(_dots(image_hw, dots_px, 0.5 * diam * fx / CAM_Z,
                                          device))
        for s in range(0, n_distinct, 4):  # four frames a call bounds the memory
            sh = shifts[s : s + 4]
            img = ((2000.0 + _shifted(spec, image_hw, sh)) * _shifted(spec_dots, image_hw, sh)
                   * lamp[s : s + 4, None, None])
            distinct[s : s + 4, c] = torch.round(img).clamp(0, 4000).to(torch.int32)
    contents = distinct.cpu().numpy().astype(np.uint16)
    contents = np.concatenate([contents, hot_pixel_frames(contents, seed)])
    if video_format == "cine10":
        lut = cine_lut()
        codes = inverse_lut(lut)[contents]
        contents = lut[codes]

    videos = []
    for c in range(n_cameras):
        if video_format == "cine10":
            packed = pack_10bpp(torch.from_numpy(codes[:, c].reshape(len(codes), -1))
                                .to(device)).cpu().numpy()
            video = os.path.join(root, f"cam{c + 1:02d}.cine")
            head, img_bytes = _cine_header(n_frames, h, w)
            annot = struct.pack("<II", 8, img_bytes)
            with open(video, "wb") as fh:
                fh.write(head)
                for f in range(n_frames):
                    fh.write(annot)
                    fh.write(packed[content_index(f, n_distinct)].tobytes())
        else:
            packed = pack_12bpp(torch.from_numpy(
                contents[:, c].reshape(len(contents), -1).astype(np.int32))
                .to(device)).cpu().numpy()
            video = os.path.join(root, f"cam{c + 1:02d}.mraw")
            with open(video, "wb") as fh:
                for f in range(n_frames):
                    fh.write(packed[content_index(f, n_distinct)].tobytes())
            with open(os.path.join(root, f"cam{c + 1:02d}.cih"), "w") as fh:
                fh.write(
                    "Record Rate(fps) : 10000\nShutter Speed(s) : 1/20000\n"
                    f"Total Frame : {n_frames}\nImage Width : {w}\n"
                    f"Image Height : {h}\nColor Bit : 12\nEffectiveBit Depth : 12\n"
                    "EffectiveBit Side : Lower\nFile Format : Mraw\n")
        videos.append(video)

    lines = ["@general", "\ttest = synth", "\trun = 1", "\tsequence = 1",
             "@all", f"\tsds = {root}/t.wtd", f"\tgrid = {root}/plate.grid",
             f"\ttargets = {root}/plate.tgts", f"\tpaint_calibration = {root}/paint.cal"]
    for c, (video, cam_path) in enumerate(zip(videos, cams)):
        lines += ["@camera", f"\tnumber = {c + 1}", f"\tcine = {video}",
                  f"\tcalibration = {cam_path}"]
    lines += ["@options"] + [f"\t{k} = {v}" for k, v in options.items()]
    lines += [f"\tnumber_frames = {n_frames}", "@output", f"\tdir = {root}/out"]
    deck = os.path.join(root, "deck.inp")
    with open(deck, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return {"deck": deck, "contents": contents, "targets": targets, "focal": fx,
            "image_hw": (h, w), "grid_shape": tuple(grid_shape), "n_frames": n_frames,
            "n_distinct": n_distinct, "options": dict(options), "paint": (1.0, 0.0, 0.0, 0.0, 0.0, 0.0),
            "qbar": 144.0, "root": root}
