"""A run's result line and its refusals: the keys the driver reads, the
compared numbers last, no result without CUDA, and the check for JAX by
whole top-level names."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import cells
from benchmark.harness import forbidden_modules, run_cell
from benchmark.tests.tiny import tiny_cell


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    r = run_cell(tiny_cell("cine2cam.fft.dp512"), 2**31 + 3, 0.0, trace, device="cpu")
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == {"intensity_gap", "stats_gap", "dcp_gap"}
    for v in r["checks"].values():
        assert set(v) == {"value", "limit"}
    json.loads(json.dumps(r))
    bench = cells.load_benchmark()
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(r["breakdown"][k]) <= 10 for k in r["breakdown"])
        assert set(r["metrics"]) <= {m["name"] for m in bench["per_layer"]}
        assert {"phase0_s", "phase1.setup_s", "phase1.frames_per_s", "phase2_s"} <= set(
            r["metrics"])
    else:
        assert set(r["metrics"]) == {m["name"] for m in bench["end_to_end"]}
        assert all(v["value"] > 0 for v in r["metrics"].values())


def test_no_result_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for a machine without it")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "cine2cam.fft.dp512", "--seed", str(2**31 + 1), "--seconds", "1",
                        "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": cells.ROOT}, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_jax_by_whole_names():
    assert forbidden_modules({"upsp_tpu_torch": 0, "upsp_tpu_torch.ops": 0,
                              "numpy": 0, "jaxtyping": 0}) == []
    assert forbidden_modules({"upsp_tpu": 0}) == ["upsp_tpu"]
    assert forbidden_modules({"upsp_tpu.ops.fftreg": 0, "jax.numpy": 0,
                              "jaxlib.xla_client": 0}) == ["jax", "jaxlib", "upsp_tpu"]
