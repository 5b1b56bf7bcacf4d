"""The port's phase-1 chunk processor in its other ECC modes, against the
JAX package's.

Identity starts (``warm_start=False``, the while loop: reference parity),
scan starts, fft without the integer pre-shift, the coarse stage, and
``pixel_interpolation = nearest`` in fft and identity modes.  Both
packages get one phase-0 state (the JAX ``run_phase0`` result, carried
over by ``from_jax_state``) and the same frames: two cameras, fiducial
patches, sub-pixel jitter up to 2 px (tests/test_torch_phase1.py's
datapoint).  The JAX side runs on the CPU with ``slab_gather=False`` and
its own CPU defaults (the dense ``jnp`` step); the port runs its kernels'
plain twins.

Tolerances follow tests/test_pallas_ecc.py:514-520: intensities rtol
1e-4, atol 0.2; rho atol 1e-3; translations atol 0.05 px; iteration
counts within one on every frame and equal on most (printed).  bfloat16
against the JAX package's bfloat16 with tests/test_bf16.py's bounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from upsp_tpu.pipeline import phase1 as JP1
from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu.pipeline.phase0 import run_phase0 as j_run_phase0
from upsp_tpu_torch.pipeline import phase1 as P1
from upsp_tpu_torch.pipeline.synthetic import write_datapoint
from upsp_tpu_torch.state import from_jax_state


def _setup(root, options=()):
    dp = write_datapoint(root, n_frames=8, n_distinct=8, seed=0, max_shift_px=2.0,
                         options=list(options))
    cfg = read_input_deck(dp["deck"])
    frames = dp["frames"]
    js = j_run_phase0(cfg, [frames[0, c] for c in range(frames.shape[1])], [12, 12])
    return frames, js, from_jax_state(js, "cpu", JP1.phase1_params(js))


@pytest.fixture(scope="module")
def linear(tmp_path_factory):
    return _setup(str(tmp_path_factory.mktemp("lin")))


@pytest.fixture(scope="module")
def nearest(tmp_path_factory):
    frames, js, ts = _setup(str(tmp_path_factory.mktemp("near")),
                            ["pixel_interpolation = nearest"])
    assert ts.config.pixel_interpolation == "nearest"
    return frames, js, ts


def _port(ts, frames, warm_start="fft", frame_batch=8, **kw):
    sols, teles = P1.make_chunk_processor(ts, with_telemetry=True,
                                          warm_start=warm_start,
                                          frame_batch=frame_batch, **kw)(frames)
    return sols.numpy(), teles.numpy()


def _jax(js, frames, **kw):
    out = JP1.make_chunk_processor(js, with_telemetry=True, slab_gather=False,
                                   **kw)(jnp.asarray(frames))
    return tuple(np.asarray(a) for a in out)


def _compare(got, want, iters=False):
    (sols, teles), (j_sols, j_teles) = got, want
    assert sols.shape == j_sols.shape and teles.shape == j_teles.shape
    np.testing.assert_array_equal(np.isnan(sols), np.isnan(j_sols))
    v = np.isfinite(j_sols)
    np.testing.assert_allclose(sols[v], j_sols[v], rtol=1e-4, atol=0.2)
    np.testing.assert_allclose(teles[..., 0], j_teles[..., 0], atol=1e-3)
    np.testing.assert_allclose(teles[..., 2:4], j_teles[..., 2:4], atol=0.05)
    if iters:
        n, jn = teles[..., 1], j_teles[..., 1]
        differ = int((n != jn).sum())
        print(f"iteration counts differ on {differ} of {n.size} frame-cameras "
              f"(port {n.ravel().tolist()}, JAX {jn.ravel().tolist()})")
        assert (n == np.rint(n)).all() and n.min() >= 1 and n.max() <= 50
        assert np.abs(n - jn).max() <= 1 and differ <= n.size // 4
        assert (teles[..., 4] == 0).all() and (j_teles[..., 4] == 0).all()


@pytest.fixture
def no_tail(monkeypatch):
    """K4 (the fused warp+filter tail) must not run."""
    def refuse(*a, **k):
        raise AssertionError("warp_filter called on a nearest path")
    monkeypatch.setattr(P1, "warp_filter", refuse)


def test_identity(linear):
    frames, js, ts = linear
    got = _port(ts, frames, warm_start=False)
    _compare(got, _jax(js, frames, warm_start=False), iters=True)
    # the solve moved: the frames are shifted by up to 2 px
    assert np.abs(got[1][..., 2:4]).max() > 1.0


def test_identity_dense_step(linear):
    """``ecc_impl="jnp"``: the port's dense step, as the JAX package runs."""
    frames, js, ts = linear
    _compare(_port(ts, frames, warm_start=False, ecc_impl="jnp"),
             _jax(js, frames, warm_start=False, ecc_impl="jnp"), iters=True)


def test_identity_batch_does_not_change_results(linear):
    """Lanes are independent: frame batches of 3 (the last one short)
    give the batch of 8's ECC results (rho, counts, translations) and
    intensities bit for bit (each frame's patch sums are independent of
    the batch).  A frame at a time: ``test_frame_programs_and_statistics``."""
    frames, _, ts = linear
    s8, t8 = _port(ts, frames, warm_start=False)
    s, t = _port(ts, frames, warm_start=False, frame_batch=3)
    np.testing.assert_array_equal(t, t8)
    np.testing.assert_array_equal(s, s8)


def test_scan(linear):
    frames, js, ts = linear
    _compare(_port(ts, frames, warm_start="scan"),
             _jax(js, frames, warm_start="scan"), iters=True)


def test_scan_restarts_at_chunk_boundaries(linear):
    """A chunk's first frame starts from identity: chunks of 4 give the
    identity solve's result on frame 4, and the JAX package's scan of the
    same chunk."""
    frames, js, ts = linear
    proc = P1.make_chunk_processor(ts, with_telemetry=True, warm_start=True)
    s1, t1 = (a.numpy() for a in proc(frames[:4]))
    s2, t2 = (a.numpy() for a in proc(frames[4:]))
    whole, _ = _port(ts, frames, warm_start="scan")
    np.testing.assert_array_equal(s1, whole[:4])
    ident = _port(ts, frames[4:5], warm_start=False)
    np.testing.assert_array_equal(s2[:1], ident[0])
    np.testing.assert_array_equal(t2[:1], ident[1])
    _compare((s2, t2), _jax(js, frames[4:], warm_start="scan"), iters=True)


def test_fft_without_pre_shift(linear):
    """The whole phase-correlation estimate starts the solve on the raw
    frame (hot pixels repaired inside the frame program)."""
    frames, js, ts = linear
    got = _port(ts, frames, warm_start="fft", pre_shift=False)
    _compare(got, _jax(js, frames, warm_start="fft", pre_shift=False))
    with_shift = _port(ts, frames, warm_start="fft")
    assert not np.array_equal(got[1][..., 2:4], with_shift[1][..., 2:4])


def test_fft_coarse_stage(linear):
    frames, js, ts = linear
    _compare(_port(ts, frames, warm_start="fft", ecc_coarse_iters=1),
             _jax(js, frames, warm_start="fft", ecc_impl="jnp", pre_shift=True,
                  ecc_coarse_iters=1))


def test_nearest_identity(nearest, no_tail):
    frames, js, ts = nearest
    _compare(_port(ts, frames, warm_start=False),
             _jax(js, frames, warm_start=False), iters=True)


def test_nearest_fft(nearest, no_tail):
    """fft mode with the pre-shift, then the nearest final warp, patches
    and the filter; column 4 is 0 as on the JAX package's dense path."""
    frames, js, ts = nearest
    got = _port(ts, frames)
    _compare(got, _jax(js, frames, warm_start="fft", ecc_impl="jnp", pre_shift=True))
    assert (got[1][..., 4] == 0).all()


def test_identity_bf16(linear):
    """bfloat16 images in the while loop, against the JAX package's
    bfloat16 run: tests/test_bf16.py's bounds on intensities (mean |d| <
    2e-3, 99.9% < 2e-2 of full scale), translations within 0.1 px."""
    frames, js, ts = linear
    sols, teles = _port(ts, frames, warm_start=False, compute_dtype="bfloat16")
    j_sols, j_teles = _jax(js, frames, warm_start=False, compute_dtype="bfloat16")
    np.testing.assert_array_equal(np.isnan(sols), np.isnan(j_sols))
    v = np.isfinite(j_sols)
    d = np.abs(sols[v] - j_sols[v])
    scale = float(frames.max())
    assert d.mean() < 2e-3 * scale and np.quantile(d, 0.999) < 2e-2 * scale
    np.testing.assert_allclose(teles[..., 2:4], j_teles[..., 2:4], atol=0.1)


@pytest.mark.parametrize("warm_start", [False, "scan"])
def test_no_registration_ignores_the_start(warm_start, tmp_path):
    """registration = none: the ECC start changes nothing."""
    frames, _, ts = _setup(str(tmp_path), ["registration = none"])
    want = _port(ts, frames)
    got = _port(ts, frames, warm_start=warm_start)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_frame_programs_and_statistics(linear):
    """``process_frames`` (batched and a frame at a time: the same bit for
    bit, see above), ``make_frame_processor`` and ``phase1_statistics``
    against the JAX package's."""
    frames, js, ts = linear
    x = frames[:3]
    batched = P1.process_frames(ts, x).numpy()
    single = P1.process_frames(ts, x, batched=False).numpy()
    np.testing.assert_array_equal(batched, single)
    want = np.asarray(JP1.process_frames(js, jnp.asarray(x)))
    v = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(batched), ~v)
    np.testing.assert_allclose(batched[v], want[v], rtol=1e-4, atol=0.2)
    sol, tele = P1.make_frame_processor(ts, with_telemetry=True)(x[1])
    j_sol, j_tele = JP1.make_frame_processor(js, with_telemetry=True)(jnp.asarray(x[1]))
    np.testing.assert_array_equal(sol.numpy(), single[1])
    np.testing.assert_allclose(tele.numpy()[:, [0, 2, 3]],
                               np.asarray(j_tele)[:, [0, 2, 3]], atol=1e-3)
    avg, rms = (a.numpy() for a in P1.phase1_statistics(torch.tensor(batched)))
    j_avg, j_rms = (np.asarray(a) for a in JP1.phase1_statistics(jnp.asarray(batched)))
    np.testing.assert_allclose(avg, j_avg, rtol=1e-6)
    np.testing.assert_allclose(rms, j_rms, rtol=1e-6)


@pytest.mark.parametrize("kw,reason", [
    (dict(ecc_band=3), r"not ported, by design: it is MXU and banded-warp machinery"
                       r".*ROADMAP.md queue 1, item 2"),
    # the camera-batched path runs (tests/test_torch_phase1_cams.py); what it
    # refuses is the kernel route, whose K3 takes one template (the id is
    # the case's name from before that path was ported)
    pytest.param(dict(vmap_cameras=True, ecc_impl="kernels"),
                 r"dense 'jnp' Gauss-Newton step: K3 takes one template.*"
                 r"upsp_tpu/ops/pallas_ecc.py:633-634",
                 id="kw1-dense 'jnp' Gauss-Newton step without the pre-shift "
                    r"\(upsp_tpu/pipeline/phase1.py:751-758\).*ROADMAP.md queue 1, "
                    "item 2"),
])
def test_refusal_reasons(linear, kw, reason):
    """Each refusal names its real reason and where it comes from."""
    with pytest.raises(NotImplementedError, match=reason):
        P1.make_chunk_processor(linear[2], warm_start="fft", frame_batch=8, **kw)


def test_unported_options_raise(linear):
    _, _, ts = linear
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P1.make_chunk_processor(ts, warm_start="fft", frame_batch=8, ecc_band=3)
    with pytest.raises(NotImplementedError, match="one template"):
        P1.make_chunk_processor(ts, warm_start="fft", frame_batch=8,
                                vmap_cameras=True, ecc_impl="kernels")
    with pytest.raises(ValueError, match="warm_start"):
        P1.make_chunk_processor(ts, warm_start="coarse")
