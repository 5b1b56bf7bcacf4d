"""The port's registration against the JAX package's, on the CPU.

``upsp_tpu_torch/ops/registration.py`` (the gather warp, the while-loop
ECC, the dense step, the coarse stage, the pyramid, ``register_frame``)
and ``ops/warp.py``'s pyramid helpers, fed the same seeded numpy inputs
as ``upsp_tpu``'s functions.  The port runs its kernels' plain twins
(K1-K3 on a CPU tensor); the JAX package runs as its own tests run it on
the CPU (``impl="auto"``: the dense ``body``).

Scenes are broadband textures (``pipeline/synthetic.scene_spectrum``)
resampled by a cubic spline at a small rotation and a shift of up to
+-3 px.  Tolerances follow tests/test_pallas_ecc.py:514-520: rho atol
1e-3, translations atol 0.05 px, linear warp entries atol 1e-3,
intensities rtol 1e-4 / atol 0.2; iteration counts equal on most frames
and within one on every frame (the JAX step sums its statistics in f32,
K3 in f64, so |drho| can fall on the other side of the stop rule).
bfloat16 solves use tests/test_bf16.py's bounds: warps within 0.1 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import map_coordinates

from upsp_tpu.ops import registration as J
from upsp_tpu.ops import warp as JW
from upsp_tpu_torch.ops import registration as R
from upsp_tpu_torch.ops import warp as TW
from upsp_tpu_torch.pipeline.synthetic import scene_spectrum, shift_field

H, W = 96, 128
# (rotation rad, dx, dy) of each frame; the template is the first
CASES = [(0.0, 0.0, 0.0), (0.003, 1.0, -0.5), (-0.004, 3.0, 2.0),
         (0.002, -2.5, 3.0), (0.005, -3.0, -3.0), (-0.002, 0.4, 0.3),
         (0.0, -1.7, 0.9), (0.004, 2.2, -2.6)]


def _scenes(seed=7, cases=CASES):
    """(template (H, W), frames (F, H, W)) f32: one periodic broadband
    field sampled at rotated, shifted positions."""
    rng = np.random.default_rng(seed)
    base = 2000.0 + shift_field(scene_spectrum(rng, (H, W)), (H, W), 0.0, 0.0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    cy, cx = (H - 1) / 2, (W - 1) / 2
    out = []
    for ang, dx, dy in cases:
        c, s = np.cos(ang), np.sin(ang)
        x = c * (xx - cx) - s * (yy - cy) + cx + dx
        y = s * (xx - cx) + c * (yy - cy) + cy + dy
        out.append(map_coordinates(base, [y, x], order=3, mode="grid-wrap"))
    frames = np.stack(out).astype(np.float32)
    return frames[0], frames


def _warps(seed, n):
    rng = np.random.default_rng(seed)
    w = np.zeros((n, 2, 3), np.float32)
    w[:, 0, 0] = 1 + rng.uniform(-3e-3, 3e-3, n)
    w[:, 1, 1] = 1 + rng.uniform(-3e-3, 3e-3, n)
    w[:, 0, 1] = rng.uniform(-4e-3, 4e-3, n)
    w[:, 1, 0] = rng.uniform(-4e-3, 4e-3, n)
    w[:, :, 2] = rng.uniform(-6.0, 6.0, (n, 2))  # zero strips on every side
    return w


def _j_solve(ref, frames, **kw):
    """The JAX while loop, a frame at a time: (warps, rho, iterations)."""
    out = [J.ecc_affine(jnp.asarray(ref), jnp.asarray(f), return_iters=True, **kw)
           for f in frames]
    return (np.stack([np.asarray(o[0]) for o in out]),
            np.array([float(o[1]) for o in out]),
            np.array([int(o[2]) for o in out]))


def _hold(warp, rho, j_warp, j_rho, t_tol=0.05, a_tol=1e-3, rho_tol=1e-3):
    np.testing.assert_allclose(warp[:, :, 2], j_warp[:, :, 2], atol=t_tol, rtol=0)
    np.testing.assert_allclose(warp[:, :, :2], j_warp[:, :, :2], atol=a_tol, rtol=0)
    np.testing.assert_allclose(rho, j_rho, atol=rho_tol, rtol=0)


def _hold_counts(iters, j_iters, what):
    differ = int((iters != j_iters).sum())
    print(f"{what}: iteration counts differ on {differ} of {iters.size} frames "
          f"(port {iters.tolist()}, JAX {j_iters.tolist()})")
    assert np.abs(iters - j_iters).max() <= 1
    assert differ <= iters.size // 4


@pytest.mark.parametrize("interpolation", ["linear", "nearest"])
def test_warp_affine(interpolation):
    """Nearest exactly, linear within 1e-5 of full scale, zero borders
    included (translations up to 6 px)."""
    _, frames = _scenes()
    w = _warps(1, len(frames))
    got = R.warp_affine(torch.tensor(frames), torch.tensor(w), interpolation).numpy()
    want = np.stack([np.asarray(J.warp_affine(jnp.asarray(f), jnp.asarray(v),
                                              interpolation))
                     for f, v in zip(frames, w)])
    assert (want == 0).any(axis=(1, 2)).all()  # every frame has a zero strip
    if interpolation == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_warp_affine_bf16_nearest_is_f32_rounded():
    """bfloat16 nearest warps sample at f32 coordinates: the f32 warp's
    pixels rounded to bfloat16, at a width (1800) where bfloat16 cannot
    hold the column index (the JAX package's grid there is off by up to
    4 px; ROADMAP.md queue 3)."""
    rng = np.random.default_rng(4)
    imgs = torch.tensor(rng.normal(2000, 300, (2, 8, 1800)).astype(np.float32))
    w = torch.tensor(_warps(2, 2))
    got = R.warp_affine(imgs.to(torch.bfloat16), w, "nearest")
    assert got.dtype == torch.bfloat16
    want = R.warp_affine(imgs, w, "nearest").to(torch.bfloat16)
    assert torch.equal(got, want)
    cols = np.asarray(jnp.arange(1800, dtype=jnp.bfloat16).astype(jnp.float32))
    assert (cols != np.arange(1800)).sum() > 1000


def test_downsample2_and_scale_warp():
    rng = np.random.default_rng(5)
    x = rng.normal(2000, 300, (3, 97, 131)).astype(np.float32)  # odd: dropped
    got = TW.downsample2(torch.tensor(x)).numpy()
    want = np.stack([np.asarray(JW.downsample2(jnp.asarray(v))) for v in x])
    assert got.shape == want.shape == (3, 48, 65)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    w = _warps(3, 3)
    for f in (0.5, 2.0):
        got = TW.scale_warp(torch.tensor(w), f).numpy()
        want = np.stack([np.asarray(JW.scale_warp(jnp.asarray(v), f)) for v in w])
        np.testing.assert_array_equal(got, want)


def test_while_loop_from_identity():
    ref, frames = _scenes()
    warp, rho, iters = (t.numpy() for t in R.ecc_affine(
        torch.tensor(ref), torch.tensor(frames), return_iters=True))
    assert iters.dtype == np.int32 and (iters >= 1).all() and (iters <= 50).all()
    j_warp, j_rho, j_iters = _j_solve(ref, frames)
    _hold(warp, rho, j_warp, j_rho)
    _hold_counts(iters, j_iters, "identity starts")
    # the solve found the motion: shifts of up to 3 px, rho near 1
    assert np.abs(warp[:, :, 2]).max() > 2.5 and (rho > 0.99).all()


def test_while_loop_from_warm_start():
    """From the JAX solution of a neighbouring frame, as scan starts."""
    ref, frames = _scenes()
    j_warp0, _, _ = _j_solve(ref, frames)
    init = np.roll(j_warp0, 1, axis=0)  # frame k starts from frame k-1's warp
    warp, rho, iters = (t.numpy() for t in R.ecc_affine(
        torch.tensor(ref), torch.tensor(frames), warp_init=torch.tensor(init),
        return_iters=True))
    j_warp, j_rho, j_iters = zip(*[
        (np.asarray(a), float(b), int(c)) for a, b, c in (
            J.ecc_affine(jnp.asarray(ref), jnp.asarray(f), warp_init=jnp.asarray(i),
                         return_iters=True) for f, i in zip(frames, init))])
    _hold(warp, rho, np.stack(j_warp), np.array(j_rho))
    _hold_counts(iters, np.array(j_iters), "warm starts")


def test_while_loop_bf16():
    """bfloat16 images (blurred and warped in bf16; the port rounds each
    image once, the JAX package op by op): warps within 0.1 px of the JAX
    bf16 solve and of the port's f32 one."""
    ref, frames = _scenes()
    bf = torch.bfloat16
    warp, rho, iters = (t.numpy() for t in R.ecc_affine(
        torch.tensor(ref).to(bf), torch.tensor(frames).to(bf), return_iters=True))
    j_out = [J.ecc_affine(jnp.asarray(ref, jnp.bfloat16), jnp.asarray(f, jnp.bfloat16),
                          return_iters=True) for f in frames]
    j_warp = np.stack([np.asarray(o[0]) for o in j_out])
    _hold(warp, rho, j_warp, np.array([float(o[1]) for o in j_out]), t_tol=0.1,
          a_tol=5e-3)
    _hold_counts(iters, np.array([int(o[2]) for o in j_out]), "bfloat16")
    f32 = R.ecc_affine(torch.tensor(ref), torch.tensor(frames))[0].numpy()
    np.testing.assert_allclose(warp[:, :, 2], f32[:, :, 2], atol=0.1, rtol=0)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("shift", [None, (1.0, -2.0)])
def test_dense_step_matches_body(steps, shift):
    """``impl="jnp"`` steps against the JAX package's ``body`` (its
    ``_ecc_core`` with ``impl="jnp"``, unrolled), with and without a
    pre-shift composed into the mask; and the kernel route against both."""
    ref, frames = _scenes()
    frames = frames[1:4]
    init = np.array([[1.001, 0.002, 0.4], [-0.001, 0.999, -0.3]], np.float32)
    inits = torch.tensor(np.stack([init] * len(frames)))
    vs = None if shift is None else torch.tensor([shift] * len(frames))
    got = [t.numpy() for t in R.ecc_affine(
        torch.tensor(ref), torch.tensor(frames), warp_init=inits, max_iters=steps,
        unroll=True, valid_shift=vs, impl="jnp", return_iters=True)]
    kern = [t.numpy() for t in R.ecc_affine(
        torch.tensor(ref), torch.tensor(frames), warp_init=inits, max_iters=steps,
        unroll=True, valid_shift=vs)]
    want = [J._ecc_core(jnp.asarray(ref), jnp.asarray(f), jnp.asarray(init),
                        max_iters=steps, unroll=True, impl="jnp",
                        valid_shift=None if shift is None else jnp.asarray(shift))
            for f in frames]
    j_warp = np.stack([np.asarray(w[0]) for w in want])
    j_rho = np.array([float(w[1]) for w in want])
    _hold(got[0], got[1], j_warp, j_rho)
    np.testing.assert_allclose(got[2], [float(w[2]) for w in want], atol=1e-3)
    _hold(kern[0], kern[1], got[0], got[1])


def test_coarse_stage():
    """Fixed steps after one on the 2x decimated pair (``coarse_iters=1``),
    from a sub-pixel start, against the JAX package's."""
    ref, frames = _scenes()
    init = np.array([[1.0, 0.0, 0.3], [0.0, 1.0, -0.2]], np.float32)
    inits = np.stack([init] * len(frames))
    warp, rho, drho = (t.numpy() for t in R.ecc_affine(
        torch.tensor(ref), torch.tensor(frames), warp_init=torch.tensor(inits),
        max_iters=2, unroll=True, coarse_iters=1, return_iters=True))
    out = [J.ecc_affine(jnp.asarray(ref), jnp.asarray(f), warp_init=jnp.asarray(init),
                        max_iters=2, unroll=True, coarse_iters=1, return_iters=True)
           for f in frames]
    _hold(warp, rho, np.stack([np.asarray(o[0]) for o in out]),
          np.array([float(o[1]) for o in out]))
    np.testing.assert_allclose(drho, [float(o[2]) for o in out], atol=1e-3)
    # the coarse step moved the start: not the two full steps alone
    full = R.ecc_affine(torch.tensor(ref), torch.tensor(frames),
                        warp_init=torch.tensor(inits), max_iters=2,
                        unroll=True)[0].numpy()
    assert np.abs(full - warp).max() > 1e-4


def test_pyramid():
    ref, frames = _scenes()
    warp, rho = (t.numpy() for t in R.ecc_affine_pyramid(torch.tensor(ref),
                                                         torch.tensor(frames)))
    out = [J.ecc_affine_pyramid(jnp.asarray(ref), jnp.asarray(f)) for f in frames]
    _hold(warp, rho, np.stack([np.asarray(o[0]) for o in out]),
          np.array([float(o[1]) for o in out]))


@pytest.mark.parametrize("interpolation", ["linear", "nearest"])
def test_register_frame(interpolation):
    ref, frames = _scenes()
    aligned, warp, rho = (t.numpy() for t in R.register_frame(
        torch.tensor(ref), torch.tensor(frames), interpolation=interpolation))
    out = [J.register_frame(jnp.asarray(ref), jnp.asarray(f),
                            interpolation=interpolation) for f in frames]
    _hold(warp, rho, np.stack([np.asarray(o[1]) for o in out]),
          np.array([float(o[2]) for o in out]))
    np.testing.assert_allclose(aligned, np.stack([np.asarray(o[0]) for o in out]),
                               rtol=1e-4, atol=0.2)


def test_batch_independence():
    """A lane's solve does not depend on its batch: eight lanes that stop
    at different iterations (epsilon 3e-6 spreads them from 2 to 24), one
    (noise) at the cap of 50, each equal bit for bit to its single-frame
    solve."""
    ref, frames = _scenes()
    frames[7] = np.random.default_rng(10).normal(2000, 300, (H, W))
    kw = dict(epsilon=3e-6, return_iters=True)
    warp, rho, iters = R.ecc_affine(torch.tensor(ref), torch.tensor(frames), **kw)
    assert int(iters.max()) == 50 and len(set(iters.tolist())) >= 4, iters.tolist()
    for i in range(len(frames)):
        w1, r1, n1 = R.ecc_affine(torch.tensor(ref), torch.tensor(frames[i : i + 1]),
                                  **kw)
        assert torch.equal(w1[0], warp[i]) and torch.equal(r1[0], rho[i])
        assert int(n1[0]) == int(iters[i])


def test_unknown_impl_raises():
    ref, frames = _scenes()
    with pytest.raises(ValueError, match="impl"):
        R.ecc_affine(torch.tensor(ref), torch.tensor(frames[:1]), impl="xla")
