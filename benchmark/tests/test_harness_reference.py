"""The plain reference accepts the program in float32 and refuses it in
bfloat16, the control, at a tiny size on the CPU, under each cell's own
limits; and it imports nothing of the program."""

import ast
import glob
import os

import pytest

from benchmark import cells
from benchmark.harness import run_cell
from benchmark.tests.tiny import tiny_cell, workload_names

SEED = 2**31 + 21


@pytest.mark.parametrize("name", workload_names())
def test_accepts_float32_refuses_bfloat16(name):
    cell = tiny_cell(name)
    good = run_cell(cell, SEED, 0.0, False, device="cpu", warm=False)
    assert good["correct"], good["checks"]
    bad = run_cell(cell, SEED, 0.0, False, device="cpu", warm=False,
                   compute_dtype="bfloat16")
    assert not bad["correct"], bad["checks"]


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(cells.ROOT, "benchmark", "reference", "*.py")) + [
        os.path.join(cells.ROOT, "benchmark", f) for f in ("check.py", "datapoint.py")]
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("upsp_tpu_torch", "upsp_tpu", "jax"), (
                    path, m)
