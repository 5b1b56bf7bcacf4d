"""The port's K5 gather plan and plain gather against the JAX slab gather.

The JAX side is ``build_slab_gather`` + ``slab_gather_apply`` (the Pallas
kernel in interpret mode on the CPU) + ``finalize_host``, with the skip mask
the JAX driver passes (``skipped[superseded_by]``) and the overlay slots of
``expand_overlay_slots``.  The port's side is ``build_gather_plan`` with
``project_gather`` (its plain twin on a CPU tensor) and ``apply_overlays``,
in model order.  Both multiply one float32 pixel by one float32 weight per
node and otherwise only select, so the tolerance is exact equality (NaN at
the same entries).

The chunk-processor case holds the port's whole frame program against
``make_chunk_processor(..., slab_gather=True)`` + ``finalize_host`` with
rtol 1e-4, atol 0.2 counts (tests/test_torch_phase1.py's tolerance: the
ECC solve differs by float rounding).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from upsp_tpu.ops.pallas_gather import (
    build_slab_gather,
    expand_overlay_slots,
    finalize_host,
    slab_gather_apply,
)
from upsp_tpu_torch.ops.gather_kernels import (
    GATHER_TILE,
    apply_overlays,
    build_gather_plan,
    gather_plain,
    project_gather,
)

import torch


def _case(rng, C=2, H=23, W=150, N=3000, invis=0.3, skip=0.0, chain=False):
    """Random sources, weights with an ``invis`` share of zeros, a few
    superseded copies, a ``skip`` share of skipped nodes."""
    idx = rng.integers(0, C * H * W, N)
    w = rng.random(N).astype(np.float32)
    w[rng.random(N) < invis] = 0.0
    sup = np.arange(N)
    sup[5], sup[100] = 17, 3  # superseded copies
    if chain:
        sup[10], sup[20] = 20, 30  # a copy of a copy
    skipped = rng.random(N) < skip
    return idx, w, sup, skipped, (H, W), C


def _jax_model_order(idx, w, sup, skipped, hw, C, imgs, overlay=None):
    plan = build_slab_gather(idx, w, sup, hw, C)
    out = np.array(slab_gather_apply(plan, jnp.asarray(imgs)))
    if overlay is not None:
        ni, vals_ns, nw, vals = overlay
        slots, sel = expand_overlay_slots(plan, ni, sup)
        out[:, slots] = vals[:, vals_ns[sel]] * nw[sel]
    return finalize_host(plan, out, skipped[sup])


def _assert_same(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    v = ~np.isnan(want)
    np.testing.assert_array_equal(got[v], want[v])  # exact


@pytest.mark.parametrize("kw,frames", [
    (dict(), 3),  # superseded copies, 30% invisible
    (dict(N=1000, skip=0.2), 1),  # skip mask, a single frame
    (dict(N=500, invis=0.9), 2),  # mostly invisible
    (dict(C=3, H=37, W=200, N=4000, chain=True, skip=0.05), 2),  # W % 128 != 0
    (dict(C=1, H=8, W=128, N=2000, invis=0.0), 4),  # one slab, full rows
])
def test_plain_gather_matches_slab_gather(kw, frames):
    rng = np.random.default_rng(17)
    idx, w, sup, skipped, hw, C = _case(rng, **kw)
    imgs = rng.normal(2000, 300, (frames, C * hw[0] * hw[1])).astype(np.float32)
    want = _jax_model_order(idx, w, sup, skipped, hw, C, imgs)
    plan = build_gather_plan(idx, w, skipped, sup, (), C * hw[0] * hw[1])
    got = project_gather(torch.from_numpy(imgs), plan).numpy()
    _assert_same(got, want)


def test_overlays_reach_superseded_copies():
    """Node 5 is a copy of node 17; 17's overlay value must show on both
    (expand_overlay_slots' contract), node 200's only on itself."""
    rng = np.random.default_rng(18)
    idx, w, sup, skipped, hw, C = _case(rng)
    w[[17, 200]] = 0.7
    ni = np.array([17, 200])
    ns = np.array([4, 9])
    nw = np.array([0.5, 0.25], np.float32)
    imgs = rng.normal(2000, 300, (2, C * hw[0] * hw[1])).astype(np.float32)
    vals = rng.normal(1000, 50, (2, 12)).astype(np.float32)
    want = _jax_model_order(idx, w, sup, skipped, hw, C, imgs,
                            overlay=(ni, ns, nw, vals))
    plan = build_gather_plan(idx, w, skipped, sup, [None, (ni, ns, nw)],
                             C * hw[0] * hw[1])
    assert sorted(plan.overlays[1][0].tolist()) == [5, 17, 200]
    got = apply_overlays(project_gather(torch.from_numpy(imgs), plan), plan,
                         [(1, torch.from_numpy(vals).reshape(2, 3, 4))]).numpy()
    _assert_same(got, want)
    np.testing.assert_array_equal(got[:, 5], vals[:, 4] * np.float32(0.5))


def test_all_invisible_plan():
    """Zero visible nodes: ``build_slab_gather`` raises (pallas_gather.py:125,
    ROADMAP queue 3); the port's plan gives the numpy formula."""
    rng = np.random.default_rng(19)
    idx, w, sup, skipped, hw, C = _case(rng, N=300, invis=1.0, skip=0.3)
    assert not (w > 0).any()
    with pytest.raises(ValueError):
        build_slab_gather(idx, w, sup, hw, C)
    imgs = rng.normal(2000, 300, (2, C * hw[0] * hw[1])).astype(np.float32)
    want = np.where(skipped[sup], np.nan, imgs[:, idx[sup]] * w[sup])
    plan = build_gather_plan(idx, w, skipped, sup, (), C * hw[0] * hw[1])
    _assert_same(project_gather(torch.from_numpy(imgs), plan).numpy(), want)


def test_plan_layout():
    """Kernel order: tiles of GATHER_TILE model-order nodes, in order, each
    with its sources ascending (skipped first, as -1); every node written
    once; the plain twin ignores the order."""
    rng = np.random.default_rng(20)
    n = 2 * GATHER_TILE + 500
    idx, w, sup, skipped, hw, C = _case(rng, N=n, skip=0.1)
    plan = build_gather_plan(idx, w, skipped, sup, (), C * hw[0] * hw[1])
    src = plan.src.numpy()
    node = plan.node.numpy()
    for t0 in range(0, n, GATHER_TILE):
        tile = slice(t0, t0 + GATHER_TILE)
        assert (np.diff(src[tile]) >= 0).all()
        assert sorted(node[tile].tolist()) == list(range(t0, min(n, t0 + GATHER_TILE)))
    np.testing.assert_array_equal(src, np.where(skipped[sup], -1, idx[sup])[node])
    np.testing.assert_array_equal(plan.weight.numpy(), w[sup][node])
    imgs = torch.from_numpy(rng.normal(0, 1, (1, C * hw[0] * hw[1])).astype(np.float32))
    _assert_same(gather_plain(imgs, plan).numpy(),
                 project_gather(imgs, plan).numpy())


def test_wrapper_checks():
    rng = np.random.default_rng(21)
    idx, w, sup, skipped, hw, C = _case(rng, N=200)
    plan = build_gather_plan(idx, w, skipped, sup, (), C * hw[0] * hw[1])
    with pytest.raises(ValueError, match="pixels per frame"):
        project_gather(torch.zeros((1, 10)), plan)
    with pytest.raises(TypeError):
        project_gather(torch.zeros((1, C * hw[0] * hw[1]), dtype=torch.float64), plan)
    with pytest.raises(ValueError, match="int32"):
        build_gather_plan(idx, w, skipped, sup, (), 2**31)


def test_chunk_processor_matches_slab_mode(tmp_path):
    """The port's chunk program (K5 plan, overlays in model order) against
    the JAX slab mode with the fused tail (overlays in slot space) and the
    host finalize; three overlaid nodes get superseded copies."""
    from upsp_tpu.ops.pallas_gather import finalize_host
    from upsp_tpu.pipeline.config import read_input_deck
    from upsp_tpu.pipeline.phase0 import run_phase0 as j_run_phase0
    from upsp_tpu.pipeline.phase1 import make_chunk_processor as j_make
    from upsp_tpu.pipeline.phase1 import phase1_params as j_phase1_params
    from upsp_tpu_torch.pipeline.phase1 import make_chunk_processor
    from upsp_tpu_torch.pipeline.synthetic import write_datapoint
    from upsp_tpu_torch.state import from_jax_state

    dp = write_datapoint(str(tmp_path), image_hw=(64, 96), n_frames=4,
                         n_distinct=4, grid_shape=(31, 25), n_targets=4,
                         seed=2, max_shift_px=1.5)
    cfg = read_input_deck(dp["deck"])
    frames = dp["frames"]
    js = j_run_phase0(cfg, [frames[0, c] for c in range(2)], [12, 12])
    jp = j_phase1_params(js)
    overlaid = np.concatenate([np.asarray(cn[0]) for cn in jp.corr_nodes
                               if cn is not None])
    assert overlaid.size >= 3
    sup = np.arange(js.model.size, dtype=np.int32)
    others = np.setdiff1d(np.nonzero(~np.asarray(js.skipped))[0], overlaid)
    sup[others[:3]] = overlaid[:3]  # copies of overlaid nodes
    js = dataclasses.replace(js, superseded_by=jnp.asarray(sup))
    jp = j_phase1_params(js)

    slab = j_make(js, warm_start="fft", ecc_impl="pallas", pre_shift=True,
                  slab_gather=True, with_telemetry=True)
    j_sol, j_tele = slab(jnp.asarray(frames))
    j_sol = finalize_host(slab.slab_plan, np.asarray(j_sol), slab.skipped_eff)
    sol, tele = make_chunk_processor(from_jax_state(js, "cpu", jp),
                                     with_telemetry=True, warm_start="fft",
                                     frame_batch=8)(frames)
    sol = sol.numpy()
    np.testing.assert_array_equal(np.isnan(sol), np.isnan(j_sol))
    v = np.isfinite(j_sol)
    np.testing.assert_allclose(sol[v], j_sol[v], rtol=1e-4, atol=0.2)
    np.testing.assert_allclose(tele.numpy()[..., 0], np.asarray(j_tele)[..., 0],
                               atol=1e-3)
    # the copies display their primaries' overlaid values
    np.testing.assert_array_equal(sol[:, others[:3]], sol[:, overlaid[:3]])
