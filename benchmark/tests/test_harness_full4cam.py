"""The production grid's cell, ``full4cam.fft.dp128``, and its three
readers of phase 0's walk, found by name like every other cell."""

import json
import math
import os

import pytest

from benchmark import cells

CELL = "full4cam.fft.dp128"
WALK = {"phase0.walk_s": "phase0.walk",
        "phase0.walk_recheck_s": "phase0.walk_recheck",
        "phase0.walk_rechecked": "phase0.walk_rechecked"}


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def test_the_cell_resolves(bench):
    c = cells.cell(CELL, bench)
    conf, traffic = c["config"], c["traffic"]
    assert c["chips"] == 1
    assert conf["n_cameras"] == 4 and conf["video_format"] == "mraw12"
    assert conf["image_hw"] == [1200, 1800]
    assert conf["n_nodes"] == math.prod(conf["grid_shape"]) == 1024 * 1024
    assert conf["compute_dtype"] == "float32" and conf["write_outputs"] is False
    assert traffic["n_frames"] == 128 and traffic["warm_start"] == "fft"
    # the tiling period shares no factor with a 64-frame chunk
    assert math.gcd(traffic["n_distinct"], 64) == 1
    assert {m["name"] for m in c["per_layer"]} == set(WALK)
    assert {m["name"] for m in c["end_to_end"]} == {"datapoint_s", "setup_s"}


def test_the_config_cuts_only_what_it_lists(bench):
    entry = {c["name"]: c for c in bench["configs"]}["full4cam"]
    with open(os.path.join(cells.ROOT, entry["file"])) as fh:
        conf = json.load(fh)
    with open(os.path.join(cells.ROOT, "benchmark/configs/cine2cam.json")) as fh:
        other = json.load(fh)
    assert sorted(conf["reduced"]) == sorted(entry["reduced"]) == sorted(conf["in_source"])
    for key, value in conf["in_source"].items():
        assert conf[key] != value
    assert conf["deck_options"] == other["deck_options"]


def test_the_older_metrics_keep_their_cells(bench):
    for m in bench["per_layer"]:
        if m["name"] not in WALK:
            assert CELL not in m["workloads"]


@pytest.mark.parametrize("name", sorted(WALK))
def test_walk_readers_take_the_mean_of_their_key(name):
    read = cells.metric_reader(name)
    key = WALK[name]
    stages = [{key: 2.0, "phase0": 9.0}, {key: 3.0, "phase0": 9.5}, {key: 7.0}]
    assert read({"stages": stages}) == pytest.approx(4.0)
    assert read({"stages": [{"phase0": 9.0}]}) is None
    assert read({"stages": []}) is None
