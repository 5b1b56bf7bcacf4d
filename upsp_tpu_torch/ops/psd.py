"""Batched Welch PSD over grid nodes: surface spectra.

Port of ``upsp_tpu/ops/psd.py``.  The reference computes PSDs only for a
handful of kulite channels with scipy.signal.welch
(kulite_utilities.py:451-490); here a (nodes, frames) block maps to
(nodes, freqs) on its device, one ``torch.fft.rfft`` over every node and
Welch segment at once.  Matches scipy.signal.welch(window='hann',
detrend='linear'|'constant', scaling='density', onesided) within float
tolerance; NaN nodes stay NaN.  The JAX function takes the whole block at
once; this one runs blocks of nodes whose segments stay within
``MAX_ELEMENTS`` values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

MAX_ELEMENTS = 1 << 28  # segment values held at once (1 GiB in f32)


def _hann(n: int) -> np.ndarray:
    # the periodic Hann window, scipy.signal.get_window('hann', n)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _welch_block(series, fs, nperseg, step, detrend, win, win_norm):
    segs = series.unfold(-1, nperseg, step)  # (..., n_seg, nperseg), a view
    if detrend == "linear":
        x = torch.arange(nperseg, dtype=series.dtype, device=series.device)
        xc = x - x.mean()
        slope = (segs * xc).sum(-1, keepdim=True) / (xc * xc).sum()
        segs = segs - (segs.mean(-1, keepdim=True) + slope * xc)
    elif detrend == "constant":
        segs = segs - segs.mean(-1, keepdim=True)
    spec = torch.fft.rfft(segs * win, dim=-1)
    return ((spec.real**2 + spec.imag**2) / (fs * win_norm)).mean(-2)


def welch_psd(series, fs: float, nperseg: int = 1024,
              noverlap: Optional[int] = None,
              detrend: str = "linear") -> Tuple[torch.Tensor, torch.Tensor]:
    """Welch power spectral density over the last axis of ``series``
    (..., F), on its device and in its dtype: periodic Hann segments of
    ``nperseg`` frames (at most F) overlapping by ``noverlap``
    (nperseg // 2), each detrended ("linear", "constant" or none), the
    one-sided density averaged over segments.  Returns (freqs (nfreq,),
    psd (..., nfreq))."""
    series = torch.as_tensor(series)
    if not series.is_floating_point():
        series = series.to(torch.float32)
    F = series.shape[-1]
    nperseg = min(nperseg, F)
    if noverlap is None:
        noverlap = nperseg // 2
    step = nperseg - noverlap
    n_seg = max((F - nperseg) // step + 1, 1)
    win = torch.as_tensor(_hann(nperseg), dtype=series.dtype, device=series.device)
    win_norm = (win * win).sum()
    nfreq = nperseg // 2 + 1
    lead = series.shape[:-1]
    rows = series.reshape(-1, F)
    block = max(1, MAX_ELEMENTS // (n_seg * nperseg))
    psd = torch.cat([
        _welch_block(rows[s : s + block], fs, nperseg, step, detrend, win, win_norm)
        for s in range(0, rows.shape[0], block)
    ]) if rows.shape[0] else rows.new_empty((0, nfreq))
    # one-sided: double every bin but DC (and Nyquist for an even nperseg)
    scale = torch.full((nfreq,), 2.0, dtype=series.dtype, device=series.device)
    scale[0] = 1.0
    if nperseg % 2 == 0:
        scale[-1] = 1.0
    freqs = torch.arange(nfreq, dtype=series.dtype, device=series.device) * (
        fs / nperseg)
    return freqs, (psd * scale).reshape(lead + (nfreq,))


def surface_psd(pressure_transpose, frame_rate: float, nperseg: int = 1024):
    """Whole-surface PSD map of (nodes, frames) delta-Cp: (freqs,
    (nodes, nfreq)); NaN nodes stay NaN."""
    return welch_psd(pressure_transpose, frame_rate, nperseg=nperseg)
