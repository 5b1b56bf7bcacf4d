"""A run whose timed path is broken underneath comes out not correct: the
harness without its look for a card, at a tiny size on the CPU, with each
fault of ``benchmark/faults.py`` planted in the program."""

import pytest

from benchmark.faults import FAULTS
from benchmark.harness import run_cell
from benchmark.tests.tiny import tiny_cell, workload_names

SEED = 2**31 + 31


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", workload_names())
def test_fault_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch.setattr)
    r = run_cell(tiny_cell(name), SEED, 0.0, False, device="cpu", warm=False)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_patched_takes_the_fault_out_again(fault):
    from upsp_tpu_torch.ops import registration
    from upsp_tpu_torch.pipeline import run

    from benchmark.faults import patched

    before = (registration._gn_step, run.make_chunk_processor)
    with patched(fault):
        assert (registration._gn_step, run.make_chunk_processor) != before
    assert (registration._gn_step, run.make_chunk_processor) == before
