"""On the card: the program at each cell's widths (its cameras, frame
size, grid and ECC start) on 16-frame datapoints is correct on three
seeds in float32, and the control (bfloat16) is not.  Skips without a
card; run on the card with
``python -m pytest --noconftest -m cuda -q benchmark/tests/test_harness_card.py``."""

import copy

import pytest

from benchmark import cells
from benchmark.harness import run_cell
from benchmark.tests.tiny import workload_names

SEEDS = (2**31 + 41, 2**31 + 42, 2**31 + 43)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", workload_names())
def test_float32_correct_bfloat16_not(card, name):
    cell = copy.deepcopy(cells.cell(name, cells.load_benchmark()))
    cell["traffic"]["n_frames"] = 16
    for seed in SEEDS:
        good = run_cell(cell, seed, 0.0, False, device=card, warm=False)
        assert good["correct"], (seed, good["checks"])
        bad = run_cell(cell, seed, 0.0, False, device=card, warm=False,
                       compute_dtype="bfloat16")
        assert not bad["correct"], (seed, bad["checks"])
