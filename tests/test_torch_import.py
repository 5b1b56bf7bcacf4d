"""The port imports torch and never jax, and its CLI drives a datapoint.

Each case runs in a fresh interpreter, since this pytest process has jax
loaded already.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SLICE = r"""
import os, sys, tempfile
import numpy as np
import upsp_tpu_torch
from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu_torch.pipeline.run import run_datapoint
from upsp_tpu_torch.pipeline.synthetic import write_datapoint
from upsp_tpu.io.flatfile import FLAT_FILES
dp = write_datapoint(tempfile.mkdtemp(), image_hw=(64, 96), n_frames=4,
                     n_distinct=4, grid_shape=(21, 17), n_targets=3, seed=3)
out = run_datapoint(read_input_deck(dp["deck"]), device="cpu",
                    registration_telemetry=True)
assert out.intensity.shape == (4, 21 * 17)
assert np.isfinite(out.intensity).any()
missing = [n for n in FLAT_FILES if not os.path.exists(os.path.join(dp["out_dir"], n))]
assert not missing, missing
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)[:5]
print("OK")
"""


_PACKED = r"""
import os, sys, tempfile
import numpy as np
import upsp_tpu_torch
from upsp_tpu.io.video import video_reader
from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu_torch.ops import cuda_lib
from upsp_tpu_torch.pipeline.run import packed_ingest_config, run_datapoint
from upsp_tpu_torch.pipeline.synthetic import write_datapoint
for fmt, bits in (("mraw12", 12), ("cine10", 10)):
    dp = write_datapoint(tempfile.mkdtemp(), image_hw=(64, 96), n_frames=4,
                         n_distinct=4, grid_shape=(21, 17), n_targets=3, seed=3,
                         video_format=fmt, hot_pixels=True)
    cfg = read_input_deck(dp["deck"])
    readers = [video_reader(c.video) for c in cfg.cameras]
    for r in readers:
        r.open()
    use, kw = packed_ingest_config(readers, None, "auto")
    assert use and kw["packed_bits"] == bits, (fmt, use, kw)
    out = run_datapoint(cfg, device="cpu")
    assert np.isfinite(out.intensity).all()
assert set(cuda_lib.launch_counts()) >= {"gather", "hot", "unpack12", "unpack10"}
assert not any(cuda_lib.launch_counts().values())  # no card: plain twins only
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)[:5]
print("OK")
"""


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(args, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=timeout)


def test_slice_runs_without_jax():
    r = _run([sys.executable, "-c", _SLICE])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


def test_packed_path_runs_without_jax():
    """Packed 12-bit mraw and 10-bit cine ingest (K7/K8's plain twins), hot
    pixels (K6) and the gather plan (K5), with no jax imported."""
    r = _run([sys.executable, "-c", _PACKED])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the JAX package's jax-free formats only through
    the port's re-exports, and never imports jax."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "upsp_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "upsp_tpu"}, roots


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    from upsp_tpu_torch.pipeline.synthetic import write_datapoint

    dp = write_datapoint(str(tmp_path_factory.mktemp("cli")), image_hw=(64, 96),
                         n_frames=3, n_distinct=3, grid_shape=(21, 17),
                         n_targets=3, seed=4)
    return dp


def test_cli_on_cpu(deck):
    script = os.path.join(REPO, "scripts", "upsp-process-torch")
    r = _run([sys.executable, script, "-input_deck", deck["deck"], "--device",
              "cpu", "--registration-telemetry"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "processed 3 frames, 357 nodes" in r.stdout
    for name in ("intensity", "pressure_transpose", "registration",
                 "registration.json", "output.h5"):
        assert os.path.exists(os.path.join(deck["out_dir"], name)), name


@pytest.mark.parametrize("flags,needle", [
    (["--streaming"], "M9"),
    (["--mesh", "auto"], "M10"),
    (["--no-warm-start"], "M4/M6"),
    (["--ecc-init", "scan"], "M4/M6"),
    (["--compute-dtype", "bfloat16"], "bf16"),
])
def test_cli_refuses_unported_paths(deck, flags, needle):
    script = os.path.join(REPO, "scripts", "upsp-process-torch")
    r = _run([sys.executable, script, "-input_deck", deck["deck"], "--device",
              "cpu"] + flags)
    assert r.returncode != 0
    assert "NotImplementedError" in r.stderr and needle in r.stderr


def test_cuda_requested_without_cuda_raises():
    import torch

    from upsp_tpu_torch.pipeline.run import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
