"""The port's phase 0 against ``upsp_tpu.pipeline.phase0.run_phase0``.

Two plate scenes: the one-camera plate with two dot targets of
tests/test_pipeline.py, and a two-camera synthetic datapoint
(upsp_tpu_torch/pipeline/synthetic.py) whose cameras overlap so best view
decides.  Integer and boolean arrays must be equal; float arrays equal
within 1e-6 (both sides compute the same f32/f64 host arithmetic).  Also
checks that ``from_jax_state`` carries the JAX state over unchanged and
that the port derives the same phase-1 parameters.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from upsp_tpu.pipeline.config import read_input_deck
from upsp_tpu.pipeline.phase0 import run_phase0 as j_run_phase0
from upsp_tpu.pipeline.phase1 import phase1_params as j_phase1_params
from upsp_tpu_torch.pipeline.phase0 import run_phase0
from upsp_tpu_torch.pipeline.phase1 import phase1_params
from upsp_tpu_torch.pipeline.synthetic import write_datapoint
from upsp_tpu_torch.state import from_jax_state


def _pipeline_scene(tmp):
    from test_pipeline import base_image, camera_json_dict, make_plate_grid

    from upsp_tpu.io.plot3d import write_p3d_grid
    from upsp_tpu.pipeline.config import CameraInputs, ProcessingConfig

    write_p3d_grid(str(tmp / "plate.grid"), make_plate_grid())
    with open(tmp / "cam01.json", "w") as f:
        json.dump(camera_json_dict(), f)
    with open(tmp / "plate.tgts", "w") as f:
        f.write("*Targets\n")
        f.write("   1    3.0000   2.0000    0.0000   0.0  0.0  1.0   0.30   1  1  1 st01\n")
        f.write("   2    7.0000   5.0000    0.0000   0.0  0.0  1.0   0.30   1  1  1 st02\n")
    cfg = ProcessingConfig(
        test_id="synthetic",
        cameras=[CameraInputs(number=1, calibration=str(tmp / "cam01.json"),
                              targets=str(tmp / "plate.tgts"))],
        grid=str(tmp / "plate.grid"), oblique_angle=70.0, registration="none",
        filter="gaussian", filter_size=3, grid_tol=0.0,
    )
    return cfg, [base_image()]


def _synthetic_scene(tmp):
    dp = write_datapoint(str(tmp), n_frames=2, n_distinct=2, seed=2)
    frames = dp["frames"]
    return read_input_deck(dp["deck"]), [frames[0, c] for c in range(frames.shape[1])]


def _eq(got, want, tol=0.0):
    want = np.asarray(want)
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    assert got.shape == want.shape
    if tol:
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("scene", ["pipeline", "synthetic"])
def test_run_phase0_matches(tmp_path, scene):
    cfg, first = (_pipeline_scene if scene == "pipeline" else _synthetic_scene)(tmp_path)
    js = j_run_phase0(cfg, first, [12] * len(first))
    ts = run_phase0(cfg, first, [12] * len(first), device="cpu")
    assert ts.image_hw == js.image_hw
    for c in range(len(first)):
        jp, tp = js.projections[c], ts.projections[c]
        _eq(tp.pixel_index, jp.pixel_index)
        _eq(tp.visible, jp.visible)
        _eq(tp.weight, jp.weight)
        _eq(tp.u, jp.u, 1e-6)
        _eq(tp.v, jp.v, 1e-6)
        jo, to = js.patch_ops[c], ts.patch_ops[c]
        assert (jo is None) == (to is None)
        if jo is not None:
            assert to.n_clusters == jo.n_clusters
            _eq(to.boundary_idx, jo.boundary_idx)
            _eq(to.internal_idx, jo.internal_idx)
            _eq(to.M, jo.M, 1e-6)
    assert any(op is not None for op in ts.patch_ops)
    _eq(ts.skipped, js.skipped)
    _eq(ts.superseded_by, js.superseded_by)
    _eq(ts.ref_frames, js.ref_frames)
    if scene == "synthetic":  # both cameras contribute under best view
        w = np.stack([p.weight.numpy() for p in ts.projections])
        assert (w[0] > 0).any() and (w[1] > 0).any()
        assert ((w > 0).sum(axis=0) <= 1).all()

    # the port derives the phase-1 parameters the JAX package derives
    jp1 = j_phase1_params(js)
    tp1 = phase1_params(ts)
    _eq(tp1.gather.combined_index, jp1.combined_index)
    _eq(tp1.gather.combined_weight, jp1.combined_weight)
    assert tp1.corr_filter == jp1.corr_filter
    for jc, tc in zip(jp1.patch_corr, tp1.patch_corr):
        assert (jc is None) == (tc is None)
        if jc is not None:
            _eq(tc.pix_idx, jc.pix_idx)
            _eq(tc.src_flat, jc.src_flat)
            _eq(tc.C, jc.C, 1e-6)

    # from_jax_state: the same state, as port tensors; its gather plan is
    # built from the JAX overlay nodes, so equal plans mean equal nodes
    fs = from_jax_state(js, "cpu", jp1)
    _eq(fs.ref_frames, js.ref_frames)
    _eq(fs.projections[0].pixel_index, js.projections[0].pixel_index)
    _eq(fs.params.gather.combined_index, jp1.combined_index)
    for field in ("src", "weight", "node", "combined_weight"):
        _eq(getattr(tp1.gather, field), getattr(fs.params.gather, field))
    assert len(tp1.gather.overlays) == len(jp1.corr_nodes)
    for jn, to, fo in zip(jp1.corr_nodes, tp1.gather.overlays,
                          fs.params.gather.overlays):
        assert (jn is None) == (to is None) == (fo is None)
        if jn is not None:
            for a, b in zip(to, fo):
                _eq(a, b)
