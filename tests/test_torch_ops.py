"""The port's per-frame ops against their ``upsp_tpu`` counterparts.

Inputs are made from a seed with numpy and fed to both sides; JAX values
are cast to float32 (tests/conftest.py turns JAX's x64 on).  Tolerances:
exact where both sides do the same integer/select work (hot pixels,
integer shift, validity masks); 1e-3 counts for f32 filters on ~2000-count
images; the phase-correlation estimate and the ECC solve to the stated
sub-pixel bounds (FFT rounding differs between pocketfft builds).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from upsp_tpu.ops import fftreg as JF
from upsp_tpu.ops import image as JI
from upsp_tpu.ops import patching as JP
from upsp_tpu.ops import polyfit as JPF
from upsp_tpu.ops.registration import ecc_affine as j_ecc_affine
from upsp_tpu.ops.warp import integer_shift as j_integer_shift
from upsp_tpu.ops.warp import warp_validity_mask as j_validity
from upsp_tpu_torch.ops import fftreg as TF
from upsp_tpu_torch.ops import image as TI
from upsp_tpu_torch.ops import patching as TP
from upsp_tpu_torch.ops import polyfit as TPF
from upsp_tpu_torch.ops.registration import ecc_affine
from upsp_tpu_torch.ops.warp import integer_shift, warp_validity_mask
from upsp_tpu_torch.pipeline.synthetic import scene_spectrum, shift_field

H, W = 96, 128


def scene(seed, shifts):
    """(F, H, W) float32 frames of one broadband texture, shifted."""
    rng = np.random.default_rng(seed)
    spec = scene_spectrum(rng, (H, W))
    return np.stack([
        np.rint(2000.0 + shift_field(spec, (H, W), dx, dy)) for dx, dy in shifts
    ]).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("n_hot", [3, 9])
def test_fix_hot_pixels(dtype, n_hot):
    rng = np.random.default_rng(n_hot)
    img = rng.integers(1500, 2500, size=(3, 48, 64)).astype(dtype)
    for b in range(3):
        ys = rng.integers(0, 48, n_hot)
        xs = rng.integers(0, 64, n_hot)
        img[b, ys, xs] = 4090
        img[b, 0, 0] = 4095  # corner (2 neighbours)
    want = np.stack([np.asarray(JI.fix_hot_pixels(jnp.asarray(im))) for im in img])
    got = TI.fix_hot_pixels(torch.from_numpy(img)).numpy()
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, want)
    assert (got != img).any() == (n_hot + 1 <= 5)


@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_gaussian_and_box_blur(ksize):
    import cv2

    x = scene(1, [(0.0, 0.0), (0.3, -0.7)])
    g = TI.gaussian_blur(torch.tensor(x), ksize).numpy()
    b = TI.box_blur(torch.tensor(x), ksize).numpy()
    for i in range(2):
        np.testing.assert_allclose(
            g[i], np.asarray(JI.gaussian_blur(jnp.asarray(x[i]), ksize)), atol=1e-3, rtol=0)
        np.testing.assert_allclose(
            b[i], np.asarray(JI.box_blur(jnp.asarray(x[i]), ksize)), atol=1e-3, rtol=0)
        np.testing.assert_allclose(
            g[i], cv2.GaussianBlur(x[i], (ksize, ksize), 0), atol=2e-3, rtol=0)
        np.testing.assert_allclose(
            b[i], cv2.blur(x[i], (ksize, ksize)), atol=2e-3, rtol=0)


def test_integer_shift_and_validity_mask():
    x = scene(2, [(0, 0)] * 4)
    t = np.array([[2, -1], [0, 3], [-70, 5], [64, -64]], np.float32)
    got = integer_shift(torch.tensor(x), torch.tensor(t)).numpy()
    for i in range(4):
        want = np.asarray(j_integer_shift(jnp.asarray(x[i]), jnp.asarray(t[i])))
        np.testing.assert_array_equal(got[i], want)
    w = np.array([[[1.002, 0.001, 1.5], [-0.002, 0.998, -2.25]]], np.float32)
    np.testing.assert_array_equal(
        warp_validity_mask((H, W), torch.tensor(w))[0].numpy(),
        np.asarray(j_validity((H, W), jnp.asarray(w[0]))),
    )


def test_correlate_matches():
    shifts = [(0.0, 0.0), (1.3, -0.6), (-1.8, 1.1), (0.4, 1.9)]
    x = scene(3, shifts)
    d = JF.default_decimate(H, W)
    jt = JF.prepare_template(jnp.asarray(x[0]), d)
    want = np.stack([np.asarray(JF.correlate(jt, jnp.asarray(f))) for f in x])
    got = TF.correlate(TF.prepare_template(torch.tensor(x[0]), d), torch.tensor(x)).numpy()
    # both estimates of the same surface: FFT rounding only
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    # and they find the shift (frame content moves by +shift)
    np.testing.assert_allclose(got, np.array(shifts, np.float32), atol=0.35)
    np.testing.assert_allclose(
        TF.translation_warp(torch.tensor(want)).numpy(),
        np.stack([np.asarray(JF.translation_warp(jnp.asarray(v))) for v in want]),
    )


@pytest.mark.parametrize("t_int", [(0.0, 0.0), (1.0, -2.0)])
def test_ecc_fixed_iterations_with_valid_shift(t_int):
    """The kernel-form ECC solve (two GN steps, valid_shift composed into
    the mask) against ``ecc_affine(impl="pallas", unroll=True)``."""
    x = scene(4, [(0.0, 0.0), (0.45, -0.3), (1.2, -1.7)])
    ti = np.array(t_int, np.float32)
    inp = np.stack([np.asarray(j_integer_shift(jnp.asarray(f), jnp.asarray(ti)))
                    for f in x[1:]])
    init = np.array([[1.0, 0.0, 0.1], [0.0, 1.0, -0.05]], np.float32)
    got_w, got_rho, got_drho = ecc_affine(
        torch.tensor(x[0]), torch.tensor(inp),
        warp_init=torch.tensor(np.stack([init, init])), max_iters=2, unroll=True,
        valid_shift=torch.tensor(np.stack([ti, ti])), return_iters=True,
    )
    for i in range(2):
        w, rho, drho = j_ecc_affine(
            jnp.asarray(x[0]), jnp.asarray(inp[i]), warp_init=jnp.asarray(init),
            max_iters=2, unroll=True, impl="pallas", valid_shift=jnp.asarray(ti),
            return_iters=True,
        )
        np.testing.assert_allclose(got_w[i].numpy(), np.asarray(w, np.float32),
                                   atol=2e-3)
        np.testing.assert_allclose(float(got_rho[i]), float(rho), atol=1e-4)
        np.testing.assert_allclose(float(got_drho[i]), float(drho), atol=1e-4)


def _patch_op(rng):
    dots = rng.uniform(20, 70, size=(5, 2))
    diam = rng.uniform(4.0, 7.0, 5)
    jop = JP.build_patch_operator(JP.build_patch_clusters(dots, diam, (H, W), 3, 2), (H, W))
    top = TP.build_patch_operator(TP.build_patch_clusters(dots, diam, (H, W), 3, 2), (H, W))
    return jop, top


def test_patch_operator_and_apply():
    rng = np.random.default_rng(5)
    jop, top = _patch_op(rng)
    np.testing.assert_array_equal(top.M.numpy(), np.asarray(jop.M))
    np.testing.assert_array_equal(top.boundary_idx.numpy(), np.asarray(jop.boundary_idx))
    np.testing.assert_array_equal(top.internal_idx.numpy(), np.asarray(jop.internal_idx))
    x = scene(5, [(0, 0), (0.5, 0.5)])
    got = TP.apply_patches(torch.tensor(x), top).numpy()
    for i in range(2):
        np.testing.assert_allclose(got[i], np.asarray(JP.apply_patches(jnp.asarray(x[i]), jop)),
                                   atol=1e-3, rtol=0)


@pytest.mark.parametrize("ft,ks", [("gaussian", 3), ("gaussian", 7), ("box", 5),
                                   ("none", 1)])
def test_patch_node_correction(ft, ks):
    rng = np.random.default_rng(6)
    jop, top = _patch_op(rng)
    jc = JP.build_patch_node_correction(jop, (H, W), ft, ks)
    tc = TP.build_patch_node_correction(top, (H, W), ft, ks)
    np.testing.assert_array_equal(tc.pix_idx.numpy(), np.asarray(jc.pix_idx))
    np.testing.assert_array_equal(tc.src_flat.numpy(), np.asarray(jc.src_flat))
    assert tc.C.dtype == torch.float64  # rounded once, it is the JAX package's
    np.testing.assert_array_equal(tc.C.numpy().astype(np.float32), np.asarray(jc.C))
    x = scene(6, [(0, 0), (0.2, 0.9)])
    got = TP.patch_correction_values(torch.tensor(x), tc).numpy()
    for i in range(2):
        want = np.asarray(JP.patch_correction_values(jnp.asarray(x[i]), jc))
        np.testing.assert_allclose(got[i], want, atol=2e-3, rtol=0)


def test_patch_node_correction_interacting_clusters():
    """A 7-tap filter window that reaches another cluster's interior: both
    packages give no correction (the sequential tail takes over)."""
    jop, top = _patch_op(np.random.default_rng(7))
    assert JP.build_patch_node_correction(jop, (H, W), "gaussian", 7) is None
    assert TP.build_patch_node_correction(top, (H, W), "gaussian", 7) is None


def test_detrend_matches():
    rng = np.random.default_rng(7)
    series = (1.0 + 0.01 * rng.standard_normal((50, 40))).astype(np.float32)
    jd = JPF.make_detrender(40, 6)
    td = TPF.make_detrender(40, 6)
    np.testing.assert_array_equal(td.basis.numpy(), np.asarray(jd.basis))
    want = np.asarray(JPF.detrend(jd, jnp.asarray(series)))
    np.testing.assert_allclose(TPF.detrend(td, torch.tensor(series)).numpy(), want,
                               atol=1e-6, rtol=0)


def test_patch_threshold_helpers():
    rng = np.random.default_rng(8)
    img = np.concatenate([rng.integers(200, 400, 3000), rng.integers(1800, 2600, 9000)])
    assert TI.patch_threshold_from_frame(img) == JI.patch_threshold_from_frame(img)
