"""The benchmark finds its cells, configurations, traffic mixes, limits,
metric readers and kernel bounds by name, and BENCHMARK.json keeps to
the shape its readers take."""

import json
import math
import os
import re
import shutil

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        c = cells.cell(w["name"], bench)
        # the tiling period shares no factor with a 64-frame chunk, so a
        # chunk's halves and its 8-frame batches show different frames
        assert math.gcd(c["traffic"]["n_distinct"], 64) == 1
        assert set(c["limits"]) == {"intensity_gap", "stats_gap", "dcp_gap"}
        assert {m["name"] for m in c["end_to_end"]} >= {"datapoint_s", "setup_s"}
        assert c["per_layer"]


def test_every_metric_and_kernel_has_its_file(bench):
    have = set(cells.names("metrics"))
    for m in bench["per_layer"]:
        assert m["name"] in have
        assert callable(cells.metric_reader(m["name"]))
    for mod in cells.kernel_bounds().values():
        assert mod.NAMES and callable(mod.work)


def test_readers_find_nothing_to_read():
    ctx = {"stages": [], "frames": 8, "trace": None, "traced_frames": 0, "kernels": {}}
    for name in cells.names("metrics"):
        assert cells.metric_reader(name)(ctx) is None


def test_a_cell_added_as_files(bench, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(cells.ROOT + "/benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "cine2cam.fft.dp32", "config": "cine2cam",
                           "traffic": "fft.dp32", "chips": 1, "why": "short datapoints"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = json.loads((root / "benchmark/traffic/fft.dp512.json").read_text())
    traffic["n_frames"] = 32
    (root / "benchmark/traffic/fft.dp32.json").write_text(json.dumps(traffic))
    shutil.copy(root / "benchmark/limits/cine2cam.fft.dp512.json",
                root / "benchmark/limits/cine2cam.fft.dp32.json")
    (root / "benchmark/metrics/phase0_share.py").write_text(
        "def read(ctx):\n    return None\n")
    c = cells.cell("cine2cam.fft.dp32", cells.load_benchmark(str(root)), str(root))
    assert c["traffic"]["n_frames"] == 32
    assert "phase0_share" in cells.names("metrics", str(root))
    assert cells.metric_reader("phase0_share", str(root))({}) is None


def test_benchmark_json_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
    assert len(json.dumps(bench)) < 64 * 1024
