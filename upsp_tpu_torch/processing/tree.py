"""Batch processing-tree generation: directories, launchers, input decks.

Functional parity with python/upsp/processing/tree.py:120-827 (studied, not
copied): given data/user/proc config JSONs, build the processing hierarchy

    <root>/
      01_configuration/            copies of the input configs
      03_launchers/                per-step launcher scripts
      04_processing/<step>/<dp>/   scratch + input decks per datapoint
      05_products/00_data/<step>/<dp>/   output artifacts
      context.json                 resolved configuration index

with per-datapoint ``psp_process`` input decks and regex *parameter overlays*
("__regex__" blocks select datapoints by name/attribute patterns and override
step parameters).  Launchers are plain shell scripts; a PBS/qsub wrapper is
emitted when the user config carries NAS settings (charge group, queue, ...).

A copy of ``upsp_tpu/processing/tree.py``: the port imports nothing of the
JAX package.  Its launchers call the port's scripts
(``upsp-extract-frames-torch``, ``upsp-external-calibration-torch``,
``upsp-process-torch``) and its generator strings name ``upsp_tpu_torch``;
everything else is what the JAX package writes.  As there, only the
``psp_process`` launcher runs: the other two pass ``--datapoint/--root``,
which neither script takes (a reference fault kept for parity, ROADMAP
queue 3).
"""

from __future__ import annotations

import datetime
import json
import os
import re
import shutil
import stat
from typing import Dict, List, Optional

STEPS = (
    "extract-first-frame",
    "external-calibration",
    "psp_process",
)
# the script each step's launcher runs
LAUNCHER_SCRIPTS = {
    "extract-first-frame": "upsp-extract-frames-torch",
    "external-calibration": "upsp-external-calibration-torch",
    "psp_process": "upsp-process-torch",
}


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve_parameter_overlays(processing: dict, datapoints: dict) -> dict:
    """Per-datapoint parameter resolution with regex overlays.

    ``processing[step]`` holds defaults plus an optional ``__overlays__`` list
    of {"__regex__": {attr: pattern, ...}, <param overrides...>}; an overlay
    applies to datapoints whose attribute values match every pattern ("name"
    matches the datapoint key itself).
    """
    out: Dict[str, dict] = {}
    for dp_name, dp_attrs in datapoints.items():
        dp_cfg: Dict[str, dict] = {}
        for step, params in processing.items():
            if step.startswith("__"):
                continue
            resolved = {
                k: v for k, v in params.items() if k != "__overlays__"
            }
            for overlay in params.get("__overlays__", []):
                patterns = overlay.get("__regex__", {})
                applies = True
                for attr, pattern in patterns.items():
                    value = (
                        dp_name if attr == "name" else str(dp_attrs.get(attr, ""))
                    )
                    if not re.search(pattern, str(value)):
                        applies = False
                        break
                if applies:
                    resolved.update(
                        {k: v for k, v in overlay.items() if k != "__regex__"}
                    )
            dp_cfg[step] = resolved
        out[dp_name] = dp_cfg
    return out


def _write_executable(path: str, content: str) -> None:
    with open(path, "w") as f:
        f.write(content)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP)


def _input_deck(dp_name: str, dp: dict, params: dict, out_dir: str) -> str:
    """Render a reference-format psp_process input deck for one datapoint."""
    lines = ["@general"]
    lines.append(f"  test = {params.get('test_id', dp.get('test_id', ''))}")
    lines.append(f"  run = {dp.get('run', 0)}")
    lines.append(f"  sequence = {dp.get('sequence', 0)}")
    lines.append("@all")
    for key in ("grid", "sds", "wtd", "paint_calibration", "steady_psp",
                "steady_grid", "targets", "normals", "active_comps"):
        if key in dp:
            lines.append(f"  {key} = {dp[key]}")
    for i, video in enumerate(dp.get("camera_videos", [])):
        lines.append("@camera")
        lines.append(f"  number = {i + 1}")
        lines.append(f"  video = {video}")
        cals = dp.get("camera_calibrations", [])
        if i < len(cals):
            lines.append(f"  calibration = {cals[i]}")
        if "targets" in dp:
            lines.append(f"  targets = {dp['targets']}")
    lines.append("@options")
    for key in ("registration", "filter", "filter_size", "oblique_angle",
                "target_patcher", "grid_tol", "degree", "overlap"):
        if key in params:
            lines.append(f"  {key} = {params[key]}")
    lines.append("@output")
    lines.append(f"  dir = {out_dir}")
    lines.append(f"  name = {dp_name}")
    return "\n".join(lines) + "\n"


def create(
    output_dir: str,
    data_config_filename: str,
    user_config_filename: str,
    proc_config_filename: str,
    plot_config_filename: Optional[str] = None,
) -> str:
    """Build the full processing tree; returns the root directory."""
    dat = _load(data_config_filename)
    usr = _load(user_config_filename)
    swr = _load(proc_config_filename)
    plt = _load(plot_config_filename) if plot_config_filename else {"plotting": {}}

    proc = resolve_parameter_overlays(swr.get("processing", {}), dat["datapoints"])
    cfg = {
        "datapoints": dat["datapoints"],
        "nas": usr.get("nas", {}),
        "root": output_dir,
        "processing": proc,
        "plotting": plt.get("plotting", {}),
        "__meta__": {
            "__date__": datetime.date.today().strftime("%b-%d-%Y"),
            "generator": "upsp_tpu_torch",
        },
    }

    root = output_dir
    cfg_dir = os.path.join(root, "01_configuration")
    launch_dir = os.path.join(root, "03_launchers")
    work_dir = os.path.join(root, "04_processing")
    prod_dir = os.path.join(root, "05_products", "00_data")
    for d in (cfg_dir, launch_dir, work_dir, prod_dir):
        os.makedirs(d, exist_ok=True)

    for prefix, src in (
        ("data-", data_config_filename),
        ("user-", user_config_filename),
        ("proc-", proc_config_filename),
    ):
        shutil.copy(src, os.path.join(cfg_dir, prefix + os.path.basename(src)))

    for dp_name, dp in dat["datapoints"].items():
        for step in STEPS:
            step_work = os.path.join(work_dir, step, dp_name)
            step_prod = os.path.join(prod_dir, step, dp_name)
            os.makedirs(step_work, exist_ok=True)
            os.makedirs(step_prod, exist_ok=True)
            if step == "psp_process":
                deck = _input_deck(
                    dp_name, dp, proc[dp_name].get(step, {}), step_prod
                )
                with open(os.path.join(step_work, "input_deck.inp"), "w") as f:
                    f.write(deck)

    # step launchers: run every datapoint (or the ones passed as arguments)
    for step in STEPS:
        exe = LAUNCHER_SCRIPTS[step]
        script = "\n".join(
            [
                "#!/bin/sh",
                "# launcher generated by upsp_tpu_torch",
                f'ROOT="{root}"',
                'DPS="$@"',
                f'[ -z "$DPS" ] && DPS="{" ".join(dat["datapoints"].keys())}"',
                "for dp in $DPS; do",
                f'  echo "=== {step}: $dp"',
                f'  {exe} --datapoint "$dp" --root "$ROOT" || exit 1',
                "done",
                "",
            ]
        )
        _write_executable(os.path.join(launch_dir, f"step+{step}"), script)

    nas = cfg.get("nas", {})
    if nas:
        qsub = "\n".join(
            [
                "#!/bin/sh",
                "# qsub wrapper generated by upsp_tpu_torch",
                'STEP="$1"; shift',
                "qsub "
                + " ".join(
                    f"-{k} {v}" for k, v in nas.get("qsub_args", {}).items()
                )
                + ' -- "$PWD/03_launchers/$STEP" "$@"',
                "",
            ]
        )
        _write_executable(os.path.join(root, "qsub-step"), qsub)

    with open(os.path.join(root, "context.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    return root
