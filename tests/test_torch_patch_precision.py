"""The patch fills of a cluster whose boundary the threshold has cut to a
short strip on one side: the degree-3 fit extrapolates across the target,
the operator's rows sum to thousands in absolute value, and the fill is the
difference of terms far larger than itself.  Both routes of the port
(:func:`apply_patches` and the fused tail's :func:`patch_correction_values`)
give the exact product of the float32 operator and pixels, rounded once to
float32; rounded or summed in float32 they moved by a tenth of a count and
more here, and by tens of counts on clusters a four-camera datapoint
builds."""

import numpy as np
import pytest
import torch

from upsp_tpu_torch.ops import patching as P
from upsp_tpu_torch.ops.ecc_kernels import filter_taps

H = W = 64


def _one_sided_cluster():
    """(PatchOperator, (1, H, W) float32 image): a 9 x 9 interior with a
    2 x 6 boundary strip to its left, and a 12-bit texture."""
    ix, iy = np.meshgrid(np.arange(28, 37), np.arange(28, 37), indexing="ij")
    gx, gy = np.meshgrid([24, 25], np.arange(26, 32), indexing="ij")
    cluster = P.PatchCluster(bounds_xy=np.stack([gx.ravel(), gy.ravel()], 1),
                             internal_xy=np.stack([ix.ravel(), iy.ravel()], 1))
    op = P.build_patch_operator([cluster], (H, W))
    rng = np.random.default_rng(0)
    img = np.round(2000 + 300 * rng.standard_normal((1, H, W))).astype(np.float32)
    return op, torch.from_numpy(img)


def _ulp(values: np.ndarray) -> float:
    return float(np.spacing(np.float32(np.abs(values).max())))


def test_the_fixture_extrapolates():
    op, img = _one_sided_cluster()
    m = op.M[0].double()
    assert float(m.abs().sum(1).max()) > 1000
    fill = m @ img.reshape(-1)[op.boundary_idx[0]].double()
    assert float(fill.min()) < 0  # far below any count the camera gives
    # the float32 sum of the same products misses by more than 0.05 counts
    f32 = (op.M[0] * img.reshape(-1)[op.boundary_idx[0]][None]).sum(-1)
    assert float((f32.double() - fill).abs().max()) > 0.05


def test_apply_patches_is_the_exact_product_rounded_once():
    op, img = _one_sided_cluster()
    got = P.apply_patches(img, op).reshape(-1)
    z = img.reshape(-1)[op.boundary_idx[0]].numpy().astype(np.float64)
    want = op.M[0].numpy().astype(np.float64) @ z
    idx = op.internal_idx[0].numpy()
    np.testing.assert_allclose(got[idx].numpy(), want, rtol=0, atol=_ulp(want))
    rest = np.ones(H * W, bool)
    rest[idx] = False
    assert torch.equal(got[rest], img.reshape(-1)[rest])


@pytest.mark.parametrize("batch", [1, 3])
def test_node_correction_is_the_exact_filtered_fill(batch):
    op, img = _one_sided_cluster()
    imgs = img.expand(batch, H, W).clone()
    imgs[1:] += 7.0  # frames that differ
    corr = P.build_patch_node_correction(op, (H, W), "gaussian", 3)
    assert corr.C.dtype == torch.float64
    got = P.patch_correction_values(imgs, corr)[:, 0]
    taps = np.asarray(filter_taps("gaussian", 3), np.float64)
    m = op.M[0].numpy().astype(np.float64)
    idx = op.internal_idx[0].numpy()
    pix = corr.pix_idx[0].numpy()
    pix = pix[pix < H * W]
    for f in range(batch):
        flat = imgs[f].reshape(-1).numpy().astype(np.float64)
        patched = flat.copy()
        patched[idx] = m @ flat[op.boundary_idx[0].numpy()]  # exact, not rounded
        ext = np.pad(patched.reshape(H, W), 1, mode="reflect")
        filt = sum(taps[dy] * taps[dx] * ext[dy : dy + H, dx : dx + W]
                   for dy in range(3) for dx in range(3)).reshape(-1)
        want = filt[pix]
        np.testing.assert_allclose(got[f, : pix.size].numpy(), want, rtol=0,
                                   atol=2 * _ulp(want))
