"""Processing configuration: the psp_process input-deck equivalent.

A plain dataclass carries what cpp/include/upsp_inputs.h:41-159 parses from the
``@general/@vars/@all/@camera/@options/@output`` deck.  :func:`read_input_deck`
parses that exact format ($var substitution included) so reference decks work
unchanged; programmatic construction is the primary TPU-native interface.

A copy of ``upsp_tpu/pipeline/config.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional


@dataclasses.dataclass
class CameraInputs:
    number: int
    video: str = ""
    calibration: str = ""
    targets: str = ""


@dataclasses.dataclass
class ProcessingConfig:
    """Everything needed to run phase 0/1/2 for one datapoint."""

    # @general
    test_id: str = ""
    tunnel: str = "ames_unitary"
    run: int = 0
    sequence: int = 0
    frames: int = 0  # number of frames to process (0 = all)
    start_frame: int = 1
    # @all / per-camera files
    cameras: List[CameraInputs] = dataclasses.field(default_factory=list)
    grid: str = ""
    sds: str = ""  # wtd file
    paint_cal: str = ""
    steady_psp: str = ""
    steady_grid: str = ""
    model_temp_p3d: str = ""
    normals: str = ""
    active_comps: str = ""
    # @options
    target_patcher: str = "polynomial"  # none | polynomial
    registration: str = "pixel"  # none | pixel
    pixel_interpolation: str = "linear"  # linear | nearest
    filter: str = "gaussian"  # none | gaussian | box
    filter_size: int = 3
    oblique_angle: float = 70.0
    number_frames: int = 0
    grid_units: str = "in"
    overlap: str = "best_view"  # best_view | average_view
    grid_tol: float = 0.0
    x_max: Optional[float] = None
    wind_off: bool = False
    degree: int = 6  # detrend polynomial degree
    # patching phase-0 knobs (psp_process.cpp:1208-1210 CLI defaults:
    # bound_pts=2, buffer_pts=1, target_diam_sf=1.2)
    bound_thickness: int = 2
    buffer_thickness: int = 1
    target_diam_sf: float = 1.2
    # physics constants
    gamma: float = 1.4
    recovery_factor: float = 0.896
    f_to_r: float = 459.67
    # @output
    out_dir: str = ""
    add_out_dir: str = ""  # extra/debug files (diagnostics); default out_dir
    out_name: str = ""
    h5_out: str = ""  # explicit HDF5 path (psp_process -h5_out); default
    #                   <out_dir>/<out_name or 'output'>.h5
    # phase-2 node-block chunk size (psp_process -trans_nodes, default 250)
    trans_nodes: int = 250
    code_version: str = ""

    @property
    def n_cameras(self) -> int:
        return len(self.cameras)


_SECTION_RE = re.compile(r"^@(\w+)")


def read_input_deck(path: str) -> ProcessingConfig:
    """Parse a reference-format input deck (upsp_inputs.h:41-159 format).

    Sections: ``@general``, ``@vars`` (defines ``$name`` substitutions),
    ``@all`` (file patterns with ``%d``/``$var``), ``@camera`` (per camera),
    ``@options``, ``@output``.  Values are ``key = value`` lines.
    """
    cfg = ProcessingConfig()
    variables: Dict[str, str] = {}
    section = None
    current_cam: Optional[CameraInputs] = None
    all_items: Dict[str, str] = {}

    def subst(val: str) -> str:
        for name, v in sorted(variables.items(), key=lambda kv: -len(kv[0])):
            val = val.replace(f"${name}", v)
        return val

    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].strip()
            if not line:
                continue
            m = _SECTION_RE.match(line)
            if m:
                section = m.group(1).lower()
                if section == "camera":
                    current_cam = CameraInputs(number=len(cfg.cameras) + 1)
                    cfg.cameras.append(current_cam)
                continue
            if "=" not in line:
                continue
            key, _, val = line.partition("=")
            key = key.strip().lower()
            val = subst(val.strip())
            if section == "vars":
                variables[key] = val
            elif section == "general":
                if key == "test":
                    cfg.test_id = val
                elif key == "run":
                    cfg.run = int(val)
                elif key == "sequence":
                    cfg.sequence = int(val)
                elif key == "frames":
                    cfg.frames = int(val)
                elif key == "tunnel":
                    cfg.tunnel = val
                else:
                    all_items[key] = val
            elif section == "all":
                _assign_file(cfg, key, val)
                if key == "targets":
                    all_items["targets"] = val
            elif section == "camera" and current_cam is not None:
                if key == "number":
                    current_cam.number = int(val)
                elif key in ("cine", "video", "mraw", "filename"):
                    current_cam.video = val
                elif key == "aedc":
                    pass  # AEDC cine variant flag (format autodetected here)
                elif key in ("calibration", "cal"):
                    current_cam.calibration = val
                elif key == "targets":
                    current_cam.targets = val
                else:
                    _assign_file(cfg, key, val)
            elif section == "options":
                _assign_option(cfg, key, val)
            elif section == "output":
                if key in ("dir", "out_dir"):
                    cfg.out_dir = val
                elif key in ("add_dir", "add_out_dir"):
                    cfg.add_out_dir = val
                elif key == "name":
                    cfg.out_name = val
    # @all targets appears before the @camera blocks in the documented deck
    # layout; propagate it to any camera that didn't set its own
    if "targets" in all_items:
        for cam in cfg.cameras:
            if not cam.targets:
                cam.targets = all_items["targets"]
    # @options number_frames is the documented frame-count control
    if cfg.number_frames and not cfg.frames:
        cfg.frames = cfg.number_frames
    return cfg


def _assign_file(cfg: ProcessingConfig, key: str, val: str) -> None:
    mapping = {
        "grid": "grid",
        "sds": "sds",
        "wtd": "sds",
        "paint_calibration": "paint_cal",
        "paintcal": "paint_cal",
        "paint_cal": "paint_cal",
        "steady_psp": "steady_psp",
        "steady_p3d": "steady_psp",
        "steady_grid": "steady_grid",
        "model_temp": "model_temp_p3d",
        "normals": "normals",
        "active_comps": "active_comps",
        "targets": None,
    }
    attr = mapping.get(key)
    if attr:
        setattr(cfg, attr, val)


def _assign_option(cfg: ProcessingConfig, key: str, val: str) -> None:
    ints = {"filter_size", "number_frames", "degree", "bound_thickness",
            "buffer_thickness", "start_frame"}
    floats = {"oblique_angle", "grid_tol", "x_max", "target_diam_sf"}
    if key in ints:
        setattr(cfg, key, int(val))
    elif key in floats:
        setattr(cfg, key, float(val))
    elif key == "wind_off":
        cfg.wind_off = val.lower() in ("1", "true", "yes")
    elif hasattr(cfg, key):
        setattr(cfg, key, val.lower())
