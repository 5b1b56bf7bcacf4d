"""The port's Welch PSD (``ops/psd.py``) against ``upsp_tpu.ops.psd`` and
``scipy.signal.welch`` (float64), in float32: both detrends, odd and even
``nperseg``, NaN rows, and the node blocks the port splits a large call
into.  Bounds: rtol 1e-4 against both (the f32 spectra agree to a few
1e-6 relative); frequencies within 1e-4 Hz; NaN rows all NaN."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from upsp_tpu.ops import psd as J
from upsp_tpu_torch.ops import psd as T


@pytest.fixture(scope="module")
def series():
    rng = np.random.default_rng(17)
    t = np.arange(300) / 2000.0
    x = (rng.normal(0, 1, (60, 300)) + np.linspace(0, 3, 300)
         + 2.0 * np.sin(2 * np.pi * 250.0 * t)).astype(np.float32)
    x[[4, 31]] = np.nan
    return x


@pytest.mark.parametrize("detrend", ["linear", "constant"])
@pytest.mark.parametrize("nperseg", [64, 33])
def test_welch_matches_jax_and_scipy(series, detrend, nperseg, monkeypatch):
    ok = np.isfinite(series).all(axis=1)
    monkeypatch.setattr(T, "MAX_ELEMENTS", 4 * nperseg * 7)  # blocks of 4 nodes
    f, p = T.welch_psd(torch.from_numpy(series), 2000.0, nperseg=nperseg,
                       detrend=detrend)
    jf, jp = J.welch_psd(jnp.asarray(series), 2000.0, nperseg=nperseg, detrend=detrend)
    sf, sp = scipy.signal.welch(series[ok].astype(np.float64), fs=2000.0,
                                nperseg=nperseg, detrend=detrend, window="hann")
    p = p.numpy()
    assert p.dtype == np.float32 and p.shape == np.asarray(jp).shape
    np.testing.assert_allclose(f.numpy(), sf, atol=1e-4, rtol=0)
    np.testing.assert_allclose(p[ok], np.asarray(jp)[ok], rtol=1e-4)
    np.testing.assert_allclose(p[ok], sp, rtol=1e-4)
    assert np.isnan(p[~ok]).all() and np.isnan(np.asarray(jp)[~ok]).all()


def test_surface_psd(series, monkeypatch):
    """(nodes, frames) -> (freqs, (nodes, nfreq)), one block or many, and
    the default overlap with nperseg past the series length."""
    ok = np.isfinite(series).all(axis=1)
    f1, p1 = T.surface_psd(torch.from_numpy(series), 2000.0, nperseg=32)
    monkeypatch.setattr(T, "MAX_ELEMENTS", 100)  # a node a block
    f2, p2 = T.surface_psd(torch.from_numpy(series), 2000.0, nperseg=32)
    jf, jp = J.surface_psd(jnp.asarray(series), 2000.0, nperseg=32)
    np.testing.assert_array_equal(p1.numpy()[ok], p2.numpy()[ok])
    np.testing.assert_allclose(p1.numpy()[ok], np.asarray(jp)[ok], rtol=1e-4)
    _, long = T.welch_psd(torch.from_numpy(series[:3]), 2000.0, nperseg=1024)
    assert long.shape == (3, 300 // 2 + 1)
