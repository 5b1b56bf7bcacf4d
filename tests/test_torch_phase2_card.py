"""Phase 2 from phase 1's rows kept on the card, on the card.

A ``cine2cam``-size datapoint (the benchmark's generator: two 1024 x 1024
packed 10-bit cameras, 81,920 nodes, 512 frames in eight 64-frame chunks,
the fft start) through ``run_datapoint`` on the card must take its
statistics on the card (``phase2.stats``), keep phase 1's chunk loop free
of blocking fetches (one ``host_syncs.fetch`` a datapoint: the telemetry
after the loop), move neither the (F, N) intensity nor the (N, F)
delta-Cp through pageable memory (``bytes.d2h.pageable`` under one
matrix, both matrices under ``bytes.d2h.pinned``) and upload no matrix;
and it must equal the host reference on the card (the f64 statistics in
numpy, the matrix transposed on the host, ``run_phase2`` on the card):
the statistics within one f32 ulp, delta-Cp, its ``avg`` and ``rms`` and
the ``gain`` bit for bit on every node whose ``intensity_avg`` agrees
(and, on the others, bit for bit with ``run_phase2`` given the card's
``intensity_avg``), ``coverage``, ``steady_state`` and ``model_temp``
equal.  A second datapoint leaves the first one's arrays as they were.
These cases skip where torch has no CUDA device:

    python -m pytest --noconftest -m cuda tests/test_torch_phase2_card.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchmark import cells  # noqa: E402
from benchmark.datapoint import write_datapoint  # noqa: E402
from test_torch_phase2_on_card import (  # noqa: E402
    _arrays, _arrays_copy, host_reference, within_ulp)
from upsp_tpu_torch.pipeline import run as R  # noqa: E402
from upsp_tpu_torch.pipeline.config import read_input_deck  # noqa: E402
from upsp_tpu_torch.pipeline.phase2 import run_phase2  # noqa: E402
from upsp_tpu_torch.utils import timing  # noqa: E402

CELL = "cine2cam.fft.dp512"
SEED = 3_000_000_019


@pytest.fixture(scope="module")
def card_runs(tmp_path_factory):
    """(cfg, [(DatapointOutputs, its arrays copied, recording)] x 2) of two
    datapoints on the card after a warm one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the route keeps rows on a card)")
    from upsp_tpu_torch.ops import cuda_lib

    cuda_lib.build_all()
    cell = cells.cell(CELL, cells.load_benchmark())
    conf, traffic = cell["config"], cell["traffic"]
    dp = write_datapoint(
        str(tmp_path_factory.mktemp("card")), seed=SEED, n_cameras=conf["n_cameras"],
        image_hw=tuple(conf["image_hw"]), grid_shape=tuple(conf["grid_shape"]),
        n_frames=traffic["n_frames"], n_distinct=traffic["n_distinct"],
        n_targets=conf["n_targets"], max_shift_px=traffic["max_shift_px"],
        video_format=conf["video_format"], device="cuda", options=conf["deck_options"])
    cfg = read_input_deck(dp["deck"])

    def run():
        return R.run_datapoint(cfg, device="cuda", write_outputs=False,
                               warm_start=traffic["warm_start"])

    run()  # builds, plans, the page cache
    runs = []
    for _ in range(2):
        with timing.recording() as rec:
            out = run()
        runs.append((out, _arrays_copy(out), rec))
    return cfg, runs


@pytest.mark.cuda
def test_card_route_counters(card_runs):
    _, runs = card_runs
    for out, _, rec in runs:
        dp, = rec.datapoints()
        f, n = out.intensity.shape
        matrix = 4 * f * n
        assert (f, n) == (512, 81920)
        assert rec.counter("host_syncs.fetch", dp) == 1  # the telemetry, after the loop
        assert len(rec.of(dp, "phase1.store")) == 8  # a chunk each, no fetch among them
        assert rec.counter("bytes.d2h.pageable", dp) < matrix
        assert rec.counter("bytes.d2h.pinned", dp) >= 2 * matrix
        assert rec.counter("bytes.h2d.pageable", dp) < matrix
        names = {s.name for s in rec.of(dp)}
        assert "phase2.stats" in names
        assert not {"phase2.host_stats", "phase2.upload"} & names


@pytest.mark.cuda
def test_card_route_equals_host_route(card_runs):
    cfg, runs = card_runs
    card = runs[0][0]
    host = host_reference(cfg, card.state, card.intensity.copy())
    within_ulp(card.intensity_avg, host["intensity_avg"])
    within_ulp(card.intensity_rms, host["intensity_rms"])
    np.testing.assert_array_equal(card.coverage, host["coverage"])
    for field in ("steady_state", "model_temp", "gain"):
        np.testing.assert_array_equal(getattr(card.phase2, field),
                                      getattr(host["phase2"], field))
    agree = (card.intensity_avg == host["intensity_avg"]) | (
        np.isnan(card.intensity_avg) & np.isnan(host["intensity_avg"]))
    print(f"intensity_avg agrees on {int(agree.sum())} of {agree.size} nodes")
    assert agree.mean() > 0.99
    for field in ("pressure_transpose", "avg", "rms"):
        np.testing.assert_array_equal(getattr(card.phase2, field)[agree],
                                      getattr(host["phase2"], field)[agree])
    # elsewhere delta-Cp is the reference's, given the card's average
    dev = torch.device("cuda")
    again = run_phase2(cfg, torch.as_tensor(np.ascontiguousarray(card.intensity.T),
                                            device=dev),
                       torch.as_tensor(card.intensity_avg, device=dev),
                       torch.as_tensor(card.coverage, device=dev),
                       *R._phase2_conditions(cfg), model=card.state.model)
    for field in ("pressure_transpose", "avg", "rms"):
        np.testing.assert_array_equal(getattr(card.phase2, field),
                                      getattr(again, field).cpu().numpy())


@pytest.mark.cuda
def test_card_route_keeps_each_datapoint(card_runs):
    _, runs = card_runs
    (first, kept, _), (second, _, _) = runs
    for k, v in _arrays(first).items():
        np.testing.assert_array_equal(v, kept[k])
        assert not np.shares_memory(v, _arrays(second)[k]), k
