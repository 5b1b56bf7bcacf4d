"""Panel forces and moments: the port's ``ops/integration.py`` and
``scripts/upsp-integrate-forces-torch`` against the JAX package's
``ops/integration.py`` and ``scripts/upsp-integrate-forces``.

Model: a 21 x 17-node plate; panels: a 4 x 3-node PLOT3D surface grid over
it (6 panels), the JAX package's ``panels_from_grid`` / ``panel_node_map``.
Delta-Cp is seeded noise about -0.4 with every 13th node NaN (the phase
1/2 convention for skipped nodes), so the sums do not cancel.  Bounds:
forces and moments within rtol 1e-5 (f32 products summed in another
order) and atol 1e-6 (a flat plate's fx, fy and mz are 0);
``panels.csv`` byte for byte (numpy on both sides).  The CLIs run
in this process (``runpy``), on a flat ``pressure_transpose`` and, where
h5py is installed, on node-major and frame-major ``.h5`` outputs.
"""

import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsp_tpu.geometry.grids import from_struct_grid
from upsp_tpu.ops import integration as J
from upsp_tpu.ops.panels import panel_node_map, panels_from_grid
from upsp_tpu_torch.ops import integration as T
from upsp_tpu_torch.io.plot3d import write_p3d_grid
from upsp_tpu_torch.pipeline.synthetic import make_plate_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 10


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("forces")
    write_p3d_grid(str(root / "plate.grid"), make_plate_grid(21, 17))
    write_p3d_grid(str(root / "panels.g"), make_plate_grid(4, 3))
    model = from_struct_grid(make_plate_grid(21, 17))
    panels = panels_from_grid(make_plate_grid(4, 3))
    p_of_n = panel_node_map(model, panels)
    op = J.integration_matrices(model, p_of_n, moment_center=(1.0, 2.0, 0.5),
                                n_panels=panels.size)
    rng = np.random.default_rng(23)
    cp = rng.normal(-0.4, 0.2, (model.size, F)).astype(np.float32)
    cp[::13] = np.nan
    cp.astype("<f4").tofile(root / "pressure_transpose")
    return dict(root=root, model=model, op=op, cp=cp)


def test_integrate_matches_jax(case):
    op, cp = case["op"], case["cp"]
    got = T.integrate_panels(torch.from_numpy(op), torch.from_numpy(cp.T))
    want = J.integrate_panels(jnp.asarray(op), jnp.asarray(cp.T))
    for k in J.FoMo._fields:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got.stack().numpy(), np.asarray(want.stack()),
                               rtol=1e-5, atol=1e-6)
    hist = T.integrate_time_history(op, cp)
    j_hist = np.asarray(J.integrate_time_history(jnp.asarray(op), jnp.asarray(cp)))
    assert hist.shape == (op.shape[0], 6, F)
    np.testing.assert_allclose(hist.numpy(), j_hist, rtol=1e-5, atol=1e-6)
    assert np.abs(j_hist[:, 2]).min() > 0.1  # fz does not cancel
    np.testing.assert_array_equal(T.coverage_mask_from_pressure(cp[:, 0]),
                                  J.coverage_mask_from_pressure(cp[:, 0]))


def _cli(script, argv):
    saved = sys.argv
    sys.argv = [script] + argv
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), e.code
    finally:
        sys.argv = saved


def _pressure_input(case, layout):
    root = case["root"]
    if layout == "flat":
        return str(root / "pressure_transpose")
    pytest.importorskip("h5py")
    from upsp_tpu_torch.io.hdf5io import PSPWriter

    path = str(root / f"{layout}.h5")
    with PSPWriter(path, case["model"], n_frames=F,
                   transposed=layout == "node_major") as w:
        w.write_grid()
        w.write_frames_block(case["cp"])
    return path


@pytest.mark.parametrize("layout", ["flat", "node_major", "frame_major"])
def test_forces_cli_matches_jax_cli(case, layout):
    root = case["root"]
    args = ["--grid", str(root / "plate.grid"), "--panel-grid", str(root / "panels.g"),
            "--pressure", _pressure_input(case, layout), "--moment-center", "1", "2",
            "0.5", "--chunk", "4"]
    _cli(os.path.join(REPO, "scripts", "upsp-integrate-forces"),
         args + ["--out", str(root / f"j_{layout}")])
    _cli(os.path.join(REPO, "scripts", "upsp-integrate-forces-torch"),
         args + ["--out", str(root / f"t_{layout}"), "--device", "cpu"])
    want = np.fromfile(root / f"j_{layout}" / "fomo", "<f4")
    got = np.fromfile(root / f"t_{layout}" / "fomo", "<f4")
    assert got.shape == want.shape == (6 * 6 * F,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.reshape(6, 6, F),
                               np.asarray(J.integrate_time_history(case["op"], case["cp"])),
                               rtol=1e-5, atol=1e-6)
    csv = [(root / f"{p}_{layout}" / "panels.csv").read_bytes() for p in "jt"]
    assert csv[0] == csv[1] and csv[0].count(b"\n") == 7
