"""Cells of the benchmark cut to a size the CPU runs in seconds: the
cell's own configuration and traffic with 2 cameras of 96 x 128, a
41 x 33 plate, 6 targets and 12-frame datapoints of 8 distinct frames, and
the cell's own limits."""

import copy

from benchmark import cells

TINY_CONFIG = {"n_cameras": 2, "image_hw": [96, 128], "grid_shape": [41, 33],
               "n_targets": 6}
TINY_TRAFFIC = {"n_frames": 12, "n_distinct": 8}


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(cells.cell(name, cells.load_benchmark()))
    cell["config"].update(TINY_CONFIG)
    cell["traffic"].update(TINY_TRAFFIC)
    return cell


def workload_names() -> list:
    return [w["name"] for w in cells.load_benchmark()["workloads"]]
