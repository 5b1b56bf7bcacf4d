"""The port's target localization (``upsp_tpu_torch/ops/localization.py``)
and pose solve (``camera/pnp.py``) against the JAX package on the CPU.

Localization is f32 in both packages: an LM step's accept/reject test can
flip between XLA and torch, so fitted centres are held to 1e-3 px and the
accept flags exactly, on dots of each target type and pad, some of whose
crops clamp at each image edge, one out of bounds and one on an empty
crop (rejected in both; its centre is not compared).  Pose math is f64: ``refine_pose`` within 1e-9; RANSAC fed the JAX
package's own minimal subsets (rebuilt with ``jax.random`` as
``upsp_tpu/camera/pnp.py:99-101,110`` draws them) within 1e-8 with the
same inliers; the port's own seeded draw recovers the pose with the same
inliers as ``upsp_tpu.camera.pnp.solve_pnp`` on outlier-laden data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsp_tpu.camera import model as JM
from upsp_tpu.camera import pnp as JP
from upsp_tpu.ops import localization as JL
from upsp_tpu_torch.camera import model as TM
from upsp_tpu_torch.camera import pnp as TP
from upsp_tpu_torch.ops import localization as TL

H, W = 64, 80


def _dots_image(rng):
    """Dark super-Gaussian dots on 2000 counts with noise; (centres, codes,
    pads) of every target, crops clamping at all four edges included."""
    centers = np.array([
        [40.3, 30.6], [20.7, 15.2], [60.1, 45.8],  # interior
        [4.4, 30.2], [75.2, 20.3], [35.2, 4.3], [50.5, 59.0],  # clamp at an edge
        [4.2, 4.6],  # a corner
        [1.5, 14.0],  # out of bounds
        [10.0, 50.0],  # no dot under it
    ])
    codes = np.array([0, 1, 2, 0, 1, 2, 0, 1, 0, 0])
    pads = np.array([4, 3, 4, 4, 3, 4, 3, 4, 4, 3])
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.full((H, W), 2000.0)
    for cx, cy in centers[:-1] + rng.uniform(-0.45, 0.45, (len(centers) - 1, 2)):
        quad = ((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 1.5**2)
        img -= 900.0 * np.exp(-np.power(quad, 2.5))
    img += rng.normal(0, 5.0, (H, W))
    return img.astype(np.float32), centers, codes, pads


@pytest.mark.parametrize("delta", [None, 1.5])
def test_localize_targets_matches_jax(delta):
    img, centers, codes, pads = _dots_image(np.random.default_rng(41))
    n = len(centers)
    jd = None if delta is None else jnp.full(n, delta, jnp.float32)
    td = None if delta is None else torch.full((n,), delta)
    want = JL.localize_targets(jnp.asarray(img), jnp.asarray(centers),
                               jnp.asarray(codes), jnp.asarray(pads), crop_size=11,
                               max_localize_delta=jd)
    got = TL.localize_targets(torch.from_numpy(img), torch.from_numpy(centers),
                              torch.from_numpy(codes), torch.from_numpy(pads),
                              crop_size=11, max_localize_delta=td)
    assert got.centers.dtype == torch.float32 and want.centers.dtype == jnp.float32
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid[:8].all() and not got.valid[8]  # clamped crops fit; OOB not
    # an accepted fit's centre (a rejected one, on an empty crop, wanders)
    ok = got.valid.numpy()
    np.testing.assert_allclose(got.centers.numpy()[ok], np.asarray(want.centers)[ok],
                               atol=1e-3)
    np.testing.assert_allclose(got.rms.numpy()[ok], np.asarray(want.rms)[ok], rtol=1e-3)


def test_fit_pieces_match_jax():
    """super_gaussian, default_init and one crop's fit, unbatched."""
    img, centers, codes, _ = _dots_image(np.random.default_rng(42))
    patch = -img[25:36, 35:46]
    p = np.array([np.log(800.0), 5.2, 5.4, np.log(1.4), np.log(1.6), 0.3, -2000.0,
                  np.log(2.0)], np.float32)
    xg, yg = TL._grid(11, "cpu")
    jy, jx = jnp.meshgrid(jnp.arange(11.0, dtype=jnp.float32),
                          jnp.arange(11.0, dtype=jnp.float32), indexing="ij")
    np.testing.assert_allclose(TL.super_gaussian(torch.from_numpy(p), xg, yg).numpy(),
                               np.asarray(JL.super_gaussian(jnp.asarray(p), jx, jy)),
                               rtol=1e-5)
    init_j = JL.default_init(jnp.asarray(patch), jnp.asarray([5.3, 5.6], jnp.float32),
                             jnp.asarray(codes[1]))
    init_t = TL.default_init(torch.from_numpy(patch)[None],
                             torch.tensor([[5.3, 5.6]]), torch.tensor([codes[1]]))[0]
    np.testing.assert_allclose(init_t.numpy(), np.asarray(init_j), rtol=1e-6)
    mask = np.ones((11, 11), np.float32)
    pj, rj = JL.fit_super_gaussian(jnp.asarray(patch), init_j, jnp.asarray(mask))
    pt, rt = TL.fit_super_gaussian(torch.from_numpy(patch), init_t, torch.from_numpy(mask))
    np.testing.assert_allclose(pt[1:3].numpy(), np.asarray(pj)[1:3], atol=1e-3)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-3)
    assert TL.type_code("dot") == 0 and TL.type_code("kulite") == 1
    assert TL.type_code("painted_kulite") == JL.type_code("painted_kulite") == 2


@pytest.fixture(scope="module")
def pose():
    rng = np.random.default_rng(43)
    K = np.array([[900.0, 0, 512], [0, 900.0, 256], [0, 0, 1]])
    dist = np.array([-0.08, 0.01, 0.0, 0.0, 0.0])
    rmat = JM.rot(12.0, "x") @ JM.rot(-8.0, "y") @ np.diag([1.0, -1.0, -1.0])
    tvec = np.array([0.5, -0.2, 14.0])
    obj = rng.uniform(-4, 4, size=(40, 3)) * np.array([1, 1, 0.2])
    pix = np.asarray(JM.project_points(JM.make_camera_params(rmat, tvec, K, dist),
                                       jnp.asarray(obj)))
    pix = pix + rng.normal(0, 0.2, pix.shape)
    bad = rng.choice(40, size=8, replace=False)
    pix_bad = pix.copy()
    pix_bad[bad] += rng.uniform(20, 60, size=(8, 2))
    rmat0 = JM.rot(0.3, "x") @ rmat
    tvec0 = tvec + np.array([0.04, 0.02, -0.06])
    return dict(K=K, dist=dist, rmat=rmat, tvec=tvec, obj=obj, pix=pix,
                pix_bad=pix_bad, bad=bad, rmat0=rmat0, tvec0=tvec0)


def _params(pose, pkg):
    return pkg.make_camera_params(pose["rmat0"], pose["tvec0"], pose["K"], pose["dist"])


def test_refine_pose_matches_jax(pose):
    rng = np.random.default_rng(44)
    weights = (rng.uniform(size=(3, 40)) > 0.3).astype(np.float64)
    weights[0] = 1.0
    tp = _params(pose, TM)
    obj, pix = torch.from_numpy(pose["obj"]), torch.from_numpy(pose["pix"])
    rv_b, tv_b = TP.refine_pose(tp, obj, pix, torch.from_numpy(weights))  # batched
    for b, w in enumerate(weights):
        rj, tj = JP.refine_pose(_params(pose, JM), jnp.asarray(pose["obj"]),
                                jnp.asarray(pose["pix"]), jnp.asarray(w))
        rt, tt = TP.refine_pose(tp, obj, pix, torch.from_numpy(w))
        for got in ((rt, tt), (rv_b[b], tv_b[b])):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(rj), rtol=0, atol=1e-9)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(tj), rtol=0, atol=1e-9)
    assert rt.dtype == torch.float64


def _jax_subsets(key, valid, n_hypotheses=64, sample_size=4):
    """upsp_tpu/camera/pnp.py:99-101,110: the subsets its vmapped draw takes."""
    def one(k):
        scores = jax.random.uniform(k, (valid.shape[0],)) + (~valid) * 10.0
        return jnp.argsort(scores)[:sample_size]

    return np.array(jax.vmap(one)(jax.random.split(key, n_hypotheses)))


@pytest.mark.parametrize("seed", [0, 5])
def test_ransac_on_jax_subsets_matches_jax(pose, seed):
    valid = np.ones(40, bool)
    valid[[3, 17]] = False  # padded entries
    key = jax.random.PRNGKey(seed)
    want = JP.solve_pnp_ransac(_params(pose, JM), jnp.asarray(pose["obj"]),
                               jnp.asarray(pose["pix_bad"]), jnp.asarray(valid), key,
                               reproj_threshold=3.0)
    got = TP.ransac_from_subsets(
        _params(pose, TM), torch.from_numpy(pose["obj"]),
        torch.from_numpy(pose["pix_bad"]), torch.from_numpy(valid),
        torch.from_numpy(_jax_subsets(key, jnp.asarray(valid))), reproj_threshold=3.0)
    np.testing.assert_allclose(got.rvec.numpy(), np.asarray(want.rvec), atol=1e-8)
    np.testing.assert_allclose(got.tvec.numpy(), np.asarray(want.tvec), atol=1e-8)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(float(got.rms), float(want.rms), rtol=1e-8)
    assert not got.inliers.numpy()[pose["bad"]].any()


def test_solve_pnp_recovers_pose(pose):
    """The port's own seeded draw: the pose within the JAX test's bounds
    and the same inliers as the JAX package's solve."""
    args = (pose["rmat0"], pose["tvec0"], pose["K"], pose["dist"], pose["obj"],
            pose["pix_bad"])
    rmat, tvec, inl, rms = TP.solve_pnp(*args, reproj_threshold=3.0, device="cpu")
    jr, jt, jinl, jrms = JP.solve_pnp(*args, reproj_threshold=3.0)
    np.testing.assert_allclose(rmat, pose["rmat"], atol=1e-3)
    np.testing.assert_allclose(tvec.reshape(3), pose["tvec"], atol=1e-2)
    np.testing.assert_array_equal(inl, jinl)
    np.testing.assert_allclose(rmat, jr, atol=1e-9)
    assert not set(pose["bad"].tolist()) & set(inl.tolist())
    assert rms == pytest.approx(jrms, rel=1e-6) and rms < 0.5
    gen = torch.Generator().manual_seed(3)
    sub = TP.draw_subsets(torch.tensor([True] * 5 + [False] * 3), 64, 4, gen)
    assert sub.shape == (64, 4) and int(sub.max()) < 5  # valid points only
