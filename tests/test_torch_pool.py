"""K10's plain twin (``ops/fftreg.decimate_plain``) against the JAX
package's ``decimate_image`` on the CPU, and the phase correlation's
independence of the frame batch.

The JAX package pools as ``P_h @ img @ P_w^T`` with dense pooling
matrices; the port sums each k x k block in the order those products sum
on the CPU (per source column its k rows, each times 1/k, then the k
column sums, each times 1/k) from strided slices, so it equals them bit
for bit where XLA's CPU dot sums in that order, and every pooled pixel is
one fixed sequence of f32 operations whatever the batch.  K10 itself
(csrc/fftreg.cu) is held to this twin on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from upsp_tpu.ops import fftreg as JF
from upsp_tpu_torch.ops import cuda_lib
from upsp_tpu_torch.ops import fftreg as TF
from upsp_tpu_torch.pipeline.synthetic import scene_spectrum, shift_field


def frames(seed, shape):
    """Integer counts in [0, 4095] (12-bit camera pixels), float32."""
    rng = np.random.default_rng(seed)
    return np.rint(rng.uniform(0, 4095, shape)).astype(np.float32)


def jax_pool(x, k, dtype):
    return np.asarray(JF.decimate_image(jnp.asarray(x).astype(dtype), k))


def port_pool(x, k, dtype):
    return TF.decimate_image(torch.from_numpy(x).to(getattr(torch, dtype)), k).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,k", [(96, 128, 2), (130, 197, 2), (97, 131, 4),
                                   (1024, 1024, 8)])
def test_pool_equals_jax_bit_for_bit(h, w, k, dtype):
    """Cropped to a multiple of k first where H or W is not one (130x197,
    97x131); bf16 frames widened exactly, as JAX promotes them."""
    x = frames(h + w + k, (h, w))
    got, want = port_pool(x, k, dtype), jax_pool(x, k, dtype)
    assert got.dtype == np.float32 and got.shape == (h // k, w // k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_within_one_ulp_of_jax_full_size(dtype):
    """At the full configuration's 1200x1800 (k = 4) XLA's CPU dot blocks
    its 1200- and 1800-long sums and adds the zero products in another
    grouping, so a few pooled pixels round once the other way: 1 ulp
    (0.00049 counts near 2000, rtol 2.4e-7), which the port's earlier
    matmul form also showed there; rtol 5e-7 holds one ulp, not two."""
    x = frames(7, (1200, 1800))
    np.testing.assert_allclose(port_pool(x, 4, dtype), jax_pool(x, 4, dtype),
                               rtol=5e-7, atol=0)


def test_pool_k1_and_other_dtypes():
    """k = 1 is the frame in float32; integer frames are cast to float32
    first, as JAX casts them."""
    x = frames(3, (2, 12, 10))
    bf = torch.from_numpy(x).to(torch.bfloat16)
    one = TF.decimate_image(bf, 1)
    assert one.dtype == torch.float32 and torch.equal(one, bf.float())
    ints = torch.from_numpy(x).to(torch.int32)
    assert torch.equal(TF.decimate_image(ints, 2), TF.decimate_image(ints.float(), 2))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_twin_uses_slices_and_elementwise_ops_only(dtype):
    """No GEMM and no reduction whose order torch picks: strided slices,
    the widening copy (an alias for f32), and elementwise products and
    sums."""
    x = torch.from_numpy(frames(4, (3, 2, 40, 52))).to(dtype)
    with _Ops() as mode:
        TF.decimate_plain(x, 4)
    assert mode.ops <= {"slice", "_to_copy", "alias", "mul", "add"}, mode.ops


def test_wrapper_takes_the_twin_on_the_cpu_only():
    """CPU tensors run the plain twin (no launch counted); a device that
    is neither the CPU nor CUDA is refused, never sent to the twin."""
    x = torch.from_numpy(frames(5, (2, 64, 96)))
    before = cuda_lib.launch_counts()
    assert torch.equal(TF.decimate_image(x, 4), TF.decimate_plain(x, 4))
    assert cuda_lib.launch_counts() == before
    with pytest.raises(ValueError, match="unsupported device"):
        TF.decimate_image(torch.empty((2, 64, 96), device="meta"), 4)


def _scene(n, h, w):
    rng = np.random.default_rng(11)
    spec = scene_spectrum(rng, (h, w))
    sh = rng.uniform(-2.5, 2.5, (n, 2))
    return np.stack([np.rint(2000.0 + shift_field(spec, (h, w), dx, dy))
                     for dx, dy in sh]).astype(np.float32)


@pytest.mark.parametrize("k", [2, 4])
def test_pool_and_correlate_do_not_depend_on_the_batch(k):
    """A frame's pooled image and phase-correlation estimate are the same
    bit for bit in a batch of 16, of 8 and alone; also for one camera's
    strided slice of a (B, C, H, W) chunk and the cameras' stacked
    template."""
    h, w = 128, 160
    x = torch.from_numpy(_scene(16, h, w))
    tmpl = TF.prepare_template(x[0], k)
    pooled, est = TF.decimate_image(x, k), TF.correlate(tmpl, x)
    for lo, n in ((0, 8), (8, 8), (3, 1), (15, 1)):
        assert torch.equal(TF.decimate_image(x[lo : lo + n], k), pooled[lo : lo + n])
        assert torch.equal(TF.correlate(tmpl, x[lo : lo + n]), est[lo : lo + n])
    chunk = torch.stack([x, x.flip(0)], dim=1)  # (16, 2, H, W)
    assert torch.equal(TF.correlate(tmpl, chunk[:, 0]), est)
    stack = tmpl._replace(spectrum=torch.stack([tmpl.spectrum, tmpl.spectrum]))
    assert torch.equal(TF.correlate(stack, chunk), torch.stack([est, est.flip(0)], 1))
    jt = JF.prepare_template(jnp.asarray(x[0].numpy()), k)
    want = np.stack([np.asarray(JF.correlate(jt, jnp.asarray(f))) for f in x[:4].numpy()])
    np.testing.assert_allclose(est[:4].numpy(), want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("n", [1, 8, 13, 16])
def test_correlate_transforms_in_fixed_groups(n):
    """correlate's FFTs see exactly FFT_GROUP frames a call whatever the
    batch (cuFFT picks its algorithm by the batch size), leading axes
    kept, the filled-up frames dropped; the values those of one call over
    the batch (the CPU's FFT transforms each frame on its own)."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(n, 2, 16, 24)).astype(np.float32))
    sizes = []

    def spy(t):
        sizes.append(t.shape[0])
        return torch.fft.rfft2(t)

    got = TF._in_groups(spy, x)
    assert sizes == [TF.FFT_GROUP] * -(-2 * n // TF.FFT_GROUP)
    assert torch.equal(got, torch.fft.rfft2(x))
