"""The port's bfloat16 path (``compute_dtype="bfloat16"``) against the JAX
package's.

Kernels: each wrapper on a CPU tensor runs its plain twin, which widens
bf16 to f32, computes as for f32 and rounds once.  The Pallas kernels of
``upsp_tpu/ops/pallas_ecc.py`` (interpret mode off-TPU) do the same, so K1,
K2 and K4 (both outputs) agree to 1 bf16 ulp of the output: the two sides
sum in different orders in f32, which can move a value across one
rounding boundary.  Where a sample straddles the zero border the position
rounds differently on the two sides (tests/test_torch_ecc_kernels.py); the
f32 position-rounding bound is added there.  K3 on bf16 images and
template holds its f32 bound, 2e-4 relative per statistic group.  K5
widens each bf16 pixel exactly and multiplies once, so it matches the
slab gather exactly.

Pipeline: the bf16 chunk processor and datapoint against the JAX bf16
path (``ecc_impl="pallas"``), and against the port's own f32 path, with
the bounds of tests/test_bf16.py: intensities' mean |diff| < 2e-3 and
99.9% quantile < 2e-2 of full scale; translations within 0.05 px.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from upsp_tpu.ops import pallas_ecc as P
from upsp_tpu.ops.pallas_gather import build_slab_gather, finalize_host, slab_gather_apply
from upsp_tpu_torch.ops import ecc_kernels as K
from upsp_tpu_torch.ops.gather_kernels import build_gather_plan, project_gather

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_cuda import (  # noqa: E402
    BOX5,
    GAUSS,
    SHAPES,
    assert_within_ulp,
    images,
    warps,
)

BF16 = torch.bfloat16


def _pair(seed, shape):
    x = images(seed, *shape)
    return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(BF16)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("taps", [GAUSS[3], GAUSS[5], GAUSS[7], BOX5])
def test_blur_bf16_matches_make_blur(shape, taps):
    xj, xt = _pair(1, shape)
    want = jax.vmap(P.make_blur(taps))(xj)
    got = K.blur(xt, taps)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert_within_ulp(got.float(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_warp_bf16_matches_banded_kernel(shape):
    xj, xt = _pair(2, shape)
    w = warps(2, shape[0])
    want = jax.vmap(P.warp_affine_banded)(xj, jnp.asarray(w))
    got = K.warp_affine_banded(xt, torch.tensor(w))
    assert got.dtype == BF16
    assert_within_ulp(got.float(), want, w)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_warped", [False, True])
@pytest.mark.parametrize("taps", [GAUSS[3], GAUSS[7]])
def test_warp_filter_bf16_matches_kernel(shape, with_warped, taps):
    """The filter runs on the f32 warped image (it is not rounded first);
    both outputs round once."""
    xj, xt = _pair(3, shape)
    w = warps(3, shape[0])
    want = jax.vmap(P.make_warp_filter(taps, with_warped))(xj, jnp.asarray(w))
    got = K.warp_filter(xt, torch.tensor(w), taps, with_warped)
    if not with_warped:
        want, got = (want,), (got,)
    for k, (g, wa) in enumerate(zip(got, want)):
        assert g.dtype == BF16
        assert_within_ulp(g.float(), wa, w, halo=len(taps) // 2 if k == 0 else 0)


@pytest.mark.parametrize("shape", SHAPES)
def test_moments_bf16_matches_kernel(shape):
    xj, xt = _pair(4, shape)
    tm = images(104, 1, *shape[1:])[0]
    w = warps(4, shape[0])
    mw = w.copy()
    mw[:, :, 2] += np.array([1.0, -2.0], np.float32)
    want = np.asarray(jax.vmap(P.ecc_gn_moments, in_axes=(0, None, 0, 0))(
        xj, jnp.asarray(tm, jnp.bfloat16), jnp.asarray(w), jnp.asarray(mw)))
    got = K.ecc_gn_moments(xt, torch.tensor(tm).to(BF16), torch.tensor(w),
                           torch.tensor(mw))
    assert got.dtype == torch.float32
    got = got.numpy()
    for lo, hi in [(0, 18), (18, 24), (24, 30), (30, 36), (36, 37),
                   (37, 39), (39, 42)]:
        scale = np.abs(want[:, lo:hi]).max(axis=1, keepdims=True)
        err = np.abs(got[:, lo:hi] - want[:, lo:hi])
        assert (err <= 2e-4 * np.abs(want[:, lo:hi]) + 2e-4 * scale).all(), (lo, hi)


def test_moments_rejects_mixed_dtypes():
    x = torch.zeros((1, 16, 16), dtype=BF16)
    w = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]])
    with pytest.raises(ValueError, match="dtype"):
        K.ecc_gn_moments(x, torch.zeros((16, 16)), w, w)
    with pytest.raises(TypeError):
        K.blur(x.half(), GAUSS[3])


@pytest.mark.parametrize("frames", [1, 3])
def test_gather_bf16_matches_slab_gather(frames):
    rng = np.random.default_rng(30 + frames)
    C, H, W, N = 3, 37, 200, 4000
    idx = rng.integers(0, C * H * W, N)
    w = rng.random(N).astype(np.float32)
    w[rng.random(N) < 0.3] = 0.0
    sup = np.arange(N)
    sup[5], sup[100], sup[10], sup[20] = 17, 3, 20, 30
    skipped = rng.random(N) < 0.05
    imgs = rng.normal(2000, 300, (frames, C * H * W)).astype(np.float32)
    xj = jnp.asarray(imgs, jnp.bfloat16)
    plan = build_slab_gather(idx, w, sup, (H, W), C)
    want = finalize_host(plan, np.array(slab_gather_apply(plan, xj)), skipped[sup])
    got = project_gather(torch.tensor(imgs).to(BF16),
                         build_gather_plan(idx, w, skipped, sup, (), C * H * W))
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    v = ~np.isnan(want)
    np.testing.assert_array_equal(got[v], want[v])


# ---------------------------------------------------------------------------
# the chunk processor and whole datapoints


def _full_scale(frames):
    return float(np.max(frames))


def assert_bf16_close(got, want, scale, what):
    """tests/test_bf16.py's bounds: NaN where NaN, mean |diff| < 2e-3 and
    the 99.9% quantile < 2e-2 of full scale."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    v = np.isfinite(want)
    d = np.abs(got[v] - want[v])
    assert d.mean() < 2e-3 * scale, (what, d.mean() / scale)
    assert np.quantile(d, 0.999) < 2e-2 * scale, (what, np.quantile(d, 0.999) / scale)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """tests/test_torch_phase1.py's scene: two cameras, patches, jitter up
    to 2 px; the JAX phase-0 state carried over."""
    from upsp_tpu.pipeline.config import read_input_deck
    from upsp_tpu.pipeline.phase0 import run_phase0 as j_run_phase0
    from upsp_tpu.pipeline.phase1 import phase1_params as j_phase1_params
    from upsp_tpu_torch.pipeline.synthetic import write_datapoint
    from upsp_tpu_torch.state import from_jax_state

    dp = write_datapoint(str(tmp_path_factory.mktemp("bf16")), n_frames=8,
                         n_distinct=8, seed=0, max_shift_px=2.0)
    cfg = read_input_deck(dp["deck"])
    frames = dp["frames"]
    js = j_run_phase0(cfg, [frames[0, c] for c in range(frames.shape[1])], [12, 12])
    jp = j_phase1_params(js)
    return frames, js, from_jax_state(js, "cpu", jp)


@pytest.fixture(scope="module")
def port_runs(scene):
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor

    frames, _, ts = scene
    return {dt: [a.numpy() for a in make_chunk_processor(
        ts, with_telemetry=True, compute_dtype=dt, warm_start="fft",
        frame_batch=8)(frames)]
        for dt in ("float32", "bfloat16")}


def test_chunk_bf16_matches_jax_bf16(scene, port_runs):
    from upsp_tpu.pipeline.phase1 import make_chunk_processor as j_make

    frames, js, _ = scene
    j_sols, j_teles = (np.asarray(a) for a in j_make(
        js, warm_start="fft", ecc_impl="pallas", pre_shift=True,
        slab_gather=False, with_telemetry=True, compute_dtype="bfloat16",
    )(jnp.asarray(frames)))
    sols, teles = port_runs["bfloat16"]
    assert sols.dtype == np.float32 and teles.dtype == np.float32
    assert_bf16_close(sols, j_sols, _full_scale(frames), "intensity")
    np.testing.assert_allclose(teles[..., 2:4], j_teles[..., 2:4], atol=0.05)
    np.testing.assert_allclose(teles[..., 0], j_teles[..., 0], atol=1e-3)


def test_chunk_bf16_matches_port_f32(scene, port_runs):
    frames = scene[0]
    (a, ta), (b, tb) = port_runs["float32"], port_runs["bfloat16"]
    assert_bf16_close(b, a, _full_scale(frames), "intensity")
    np.testing.assert_allclose(tb[..., 2:4], ta[..., 2:4], atol=0.05)
    assert not np.array_equal(a, b)  # the bf16 path really rounded


@pytest.mark.parametrize("bad", ["float16", torch.float16, "f32"])
def test_rejects_unknown_compute_dtype(scene, bad):
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor

    with pytest.raises(ValueError, match="compute_dtype"):
        make_chunk_processor(scene[2], compute_dtype=bad)


@pytest.fixture(scope="module")
def mraw_datapoint(tmp_path_factory):
    from upsp_tpu_torch.pipeline.synthetic import write_datapoint

    """Jitter under 0.45 px: the JAX driver on the CPU runs its dense ECC
    path without the integer pre-shift (tests/test_torch_slice.py)."""
    return write_datapoint(str(tmp_path_factory.mktemp("dp")), image_hw=(64, 96),
                           n_frames=4, n_distinct=4, grid_shape=(21, 17),
                           n_targets=4, seed=3, hot_pixels=True, max_shift_px=0.4)


def test_datapoint_bf16_matches_jax(mraw_datapoint, tmp_path):
    """``run_datapoint(compute_dtype="bfloat16")`` on a 12-bit mraw
    datapoint (packed ingest, hot pixels) against the JAX driver's bf16
    run on the same files, and against the port's f32 run."""
    from upsp_tpu.pipeline.config import read_input_deck as j_read_deck
    from upsp_tpu.pipeline.run import run_datapoint as j_run_datapoint
    from upsp_tpu_torch.pipeline.config import read_input_deck
    from upsp_tpu_torch.pipeline.run import run_datapoint

    dp = mraw_datapoint
    jcfg = j_read_deck(dp["deck"])
    jcfg.out_dir = str(tmp_path)
    want = j_run_datapoint(jcfg, compute_dtype="bfloat16")
    cfg = read_input_deck(dp["deck"])
    cfg.out_dir = ""
    got = run_datapoint(cfg, device="cpu", compute_dtype="bfloat16")
    scale = _full_scale(dp["frames"])
    assert_bf16_close(got.intensity, np.asarray(want.intensity), scale, "intensity")
    f32 = run_datapoint(cfg, device="cpu")
    assert_bf16_close(got.intensity, f32.intensity, scale, "against f32")


def test_cli_bf16_writes_every_flat_file(mraw_datapoint, tmp_path):
    """``--compute-dtype bfloat16 --device cpu`` through the CLI: every flat
    file, the registration record, finite intensities."""
    import subprocess

    from upsp_tpu_torch.io.flatfile import FLAT_FILES, read_flat

    repo = Path(__file__).resolve().parents[1]
    r = subprocess.run(
        [sys.executable, str(repo / "scripts" / "upsp-process-torch"),
         "-input_deck", mraw_datapoint["deck"], "--device", "cpu",
         "--compute-dtype", "bfloat16", "--registration-telemetry"],
        capture_output=True, text=True, cwd=repo, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(repo)))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "processed 4 frames, 357 nodes" in r.stdout
    out = mraw_datapoint["out_dir"]
    for name in FLAT_FILES + ("registration", "registration.json"):
        assert os.path.exists(os.path.join(out, name)), name
    inten = read_flat(os.path.join(out, "intensity")).reshape(4, 357)
    cov = read_flat(os.path.join(out, "coverage"))
    assert np.isfinite(inten[:, cov > 0]).all()
