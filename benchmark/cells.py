"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell
(``workloads``), its configuration and its traffic mix.  Each part is a
file of its own, found by name, so a later change adds a cell, a mix, a
metric or a kernel bound by adding files:

- ``benchmark/configs/<config>.json``: the deployment (cameras, frames,
  grid, processing options), as its ``configs`` entry names the file;
- ``benchmark/traffic/<traffic>.json``: the datapoint the window repeats
  (its length, the ECC start, the shifts), read by the one generator in
  ``benchmark/datapoint.py``;
- ``benchmark/limits/<workload>.json``: the limit of each number the
  correctness check compares;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx) -> float | None``;
- ``benchmark/kernels/<kernel>.py``: a hand-written kernel's names in a
  device trace and the operations and bytes a datapoint needs of it.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return _json(path)


def cell(name: str, bench: dict, root: str = ROOT) -> dict:
    """{"name", "config" (the file's dict), "traffic" (dict), "limits"
    (dict), "end_to_end" and "per_layer" (the metric entries this cell
    reports)} of the workload ``name``."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    here = os.path.join(root, "benchmark")
    return {
        "name": name,
        "chips": w["chips"],
        "config": _json(os.path.join(root, conf["file"])),
        "traffic": _json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        "limits": _json(os.path.join(here, "limits", name + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def metric_reader(name: str, root: str = ROOT):
    """The ``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    return _module(path, "benchmark_metric_" + name.replace(".", "_")).read


def kernel_bounds(root: str = ROOT) -> Dict[str, object]:
    """Every ``benchmark/kernels/*.py`` but those named ``_*``, by file name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "benchmark", "kernels", "*.py"))):
        name = os.path.basename(path)[:-3]
        if not name.startswith("_"):
            out[name] = _module(path, "benchmark_kernel_" + name)
    return out


def names(kind: str, root: str = ROOT) -> List[str]:
    """The names of the files of ``kind`` (configs, traffic, limits,
    metrics, kernels)."""
    ext = ".py" if kind in ("metrics", "kernels") else ".json"
    return sorted(os.path.basename(p)[: -len(ext)]
                  for p in glob.glob(os.path.join(root, "benchmark", kind, "*" + ext))
                  if not os.path.basename(p).startswith("_"))
