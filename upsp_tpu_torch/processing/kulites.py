"""Kulite (pressure transducer) data: loading, PSD, RMS, comparison support.

Format parity with python/upsp/processing/kulite_utilities.py:20-340 (studied,
not copied): a ``*.info`` tab-separated header of four blocks (filepaths,
statistics, daqconfig, channelconfig) plus ``*.fast`` / ``*.slow`` binary
int32 sample files (samples x channels), scaled counts -> volts -> psi through
the per-channel coefficients.

A copy of ``upsp_tpu/processing/kulites.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import glob
import os
import re
from collections import OrderedDict, namedtuple
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
from scipy import signal

HeaderInfo = namedtuple(
    "HeaderInfo", ["filename", "filepaths", "statistics", "daqconfig", "chanconfig"]
)


def _read_blocks(path: str) -> List[List[List[str]]]:
    with open(path, "r") as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    blocks = []
    i = 0
    while i < len(rows) and len(blocks) < 4:
        n = int(rows[i][1])
        block = [r[2:] for r in rows[i : i + n + 1]]
        blocks.append(block)
        i += n + 1
    return blocks


def _to_frame(block: List[List[str]]):
    import pandas as pd

    df = pd.DataFrame(block[1:], columns=block[0])
    for col in df.columns:
        try:
            df[col] = pd.to_numeric(df[col])
        except (ValueError, TypeError):
            pass
    return df


def read_info(path: str) -> HeaderInfo:
    """Parse a kulite .info header into four dataframes."""
    blocks = _read_blocks(path)
    filepaths = _to_frame(blocks[0])
    statistics = _to_frame(blocks[1])
    daqconfig = _to_frame(blocks[2])
    chanconfig = _to_frame(blocks[3])
    if "User Name" not in chanconfig.columns:
        chanconfig["User Name"] = [
            "K%02d" % int(s) for s in chanconfig["User Channel"]
        ]
    chanconfig = chanconfig.set_index("User Name")
    return HeaderInfo(path, filepaths, statistics, daqconfig, chanconfig)


def find_info_files(data_dir: str, run: int, seq: int) -> List[str]:
    """Autodetect the datapoint's .info files by filename pattern."""
    fnames = sorted(glob.glob(os.path.join(data_dir, "*.info")))
    patterns = [
        r"T(?P<run>\d+)p(?P<seq>\d+)t\d+$",
        r"r(?P<run>\d{4})s(?P<seq>\d{3})t\d+_S\dC\d$",
    ]
    out = []
    for fn in fnames:
        prefix = os.path.splitext(os.path.basename(fn))[0]
        for p in patterns:
            m = re.search(p, prefix)
            if m and (int(m.group("run")), int(m.group("seq"))) == (run, seq):
                out.append(fn)
                break
    return out


class Kulites:
    """Pressure time histories for selected kulites of one datapoint (psi)."""

    def __init__(
        self,
        data_dir: str,
        run: int,
        seq: int,
        kulites: Union[str, Sequence[str]] = "all",
        data_type=np.float32,
        psf: bool = False,
        f_type: str = "slow",
    ):
        self.data: Dict[str, np.ndarray] = OrderedDict()
        self.raw: Dict[str, np.ndarray] = OrderedDict()
        self.sample_rate = 0.0
        for info_file in find_info_files(data_dir, run, seq):
            info = read_info(info_file)
            names = [
                k
                for k in info.chanconfig.index
                if (kulites == "all" and "K" in str(k)) or k in kulites
            ]
            if not names:
                continue
            raw, data = _read_channel_data(info, names, f_type)
            for k in names:
                v = data[k] * (144.0 if psf else 1.0)
                self.data[k] = np.asarray(v, data_type)
                self.raw[k] = np.asarray(raw[k], data_type)
            row_idx = 0 if f_type == "fast" else 1
            self.sample_rate = float(
                info.statistics["Sampling Rate"][row_idx]
            )
        self.data = OrderedDict(sorted(self.data.items()))


def _read_channel_data(info: HeaderInfo, names: Sequence[str], f_type: str):
    freq_id = 0 if f_type == "fast" else 1
    stats = info.statistics
    chan = info.chanconfig
    n_channels = int(stats.loc[freq_id, "Number Channels"])
    n_samples = int(stats.loc[freq_id, "Samples Acquired"])

    row_idx = 1 if f_type == "fast" else 2
    fname = os.path.join(
        os.path.dirname(info.filename),
        str(info.filepaths["File Name"][row_idx]),
    )
    if not os.path.exists(fname):
        fname = os.path.splitext(info.filename)[0] + "." + f_type
    bin_data = np.fromfile(fname, dtype="<i4").reshape(n_samples, n_channels)

    raw, data = {}, {}
    for k in names:
        ch = int(chan.loc[k, "User Channel"]) - 1
        vraw = bin_data[:, ch]
        vnative = vraw * float(chan.loc[k, "Coeff k1"]) + float(
            chan.loc[k, "Coeff k0"]
        )
        sens = float(chan.loc[k].get("Sensitivity", 1.0) or 1.0)
        offset = float(chan.loc[k].get("Offset", 0.0) or 0.0)
        data[k] = (vnative - offset) / sens if sens else vnative
        raw[k] = vraw
    return raw, data


# ---------------------------------------------------------------------------
# analysis


def compute_psd(
    data: Dict[str, np.ndarray], sample_rate: float, w_len: int = 1024
) -> Dict[str, np.ndarray]:
    """Welch PSDs per kulite with an extra 'freq' entry (kulite_utilities
    compute_psd parity: hann window, linear detrend)."""
    out: Dict[str, np.ndarray] = {}
    freq = None
    for key, val in data.items():
        a = np.asarray(val).ravel()
        freq, out[key] = signal.welch(
            a, fs=sample_rate, window="hann", nperseg=w_len, detrend="linear"
        )
    out["freq"] = freq
    return out


def compute_delta_rms(
    data: Dict[str, np.ndarray], sosfilter=None
) -> Dict[str, float]:
    """Mean-removed RMS per channel (optionally sos-filtered first)."""
    out = {}
    for name, series in data.items():
        x = signal.sosfilt(sosfilter, series) if sosfilter is not None else series
        out[name] = float(np.sqrt(np.mean((x - np.mean(x)) ** 2)))
    return out


def compute_rms_from_psd(
    psds: Dict[str, np.ndarray], startfreq: Optional[float] = None
) -> Dict[str, float]:
    freqs = psds["freq"]
    out = {}
    for name, p in psds.items():
        if name == "freq":
            continue
        sel = slice(None) if startfreq is None else freqs >= startfreq
        out[name] = float(np.sum(p[sel]))
    return out


def read_kulite_positions(tgts_file: str) -> Dict[str, np.ndarray]:
    """Kulite xyz positions from the tgts file (*Kulites-ish rows by name)."""
    from upsp_tpu_torch.io.tgts import read_tgts

    out = {}
    for section in ("*Targets", "*Kulites"):
        try:
            for t in read_tgts(tgts_file, section=section):
                if "K" in t.name and t.target_type in ("kulite", "painted_kulite", t.name):
                    out[t.name] = t.xyz
        except FileNotFoundError:
            break
    return out


# ---------------------------------------------------------------------------
# virtual kulites: sample uPSP frames at transducer image locations
# (cpp/include/kulites.h:41-77 role — studied, not copied)


def virtual_kulite_histories(
    frames: np.ndarray,  # (F, H, W)
    uv: np.ndarray,  # (K, 2) image positions of the kulites
    pad: int = 1,
) -> np.ndarray:
    """(K, F) mean intensity in a (2*pad+1)^2 patch around each kulite."""
    F, H, W = frames.shape
    uv = np.atleast_2d(uv)
    out = np.empty((uv.shape[0], F), frames.dtype)
    for k, (x, y) in enumerate(np.rint(uv).astype(int)):
        x0, x1 = max(x - pad, 0), min(x + pad + 1, W)
        y0, y1 = max(y - pad, 0), min(y + pad + 1, H)
        out[k] = frames[:, y0:y1, x0:x1].mean(axis=(1, 2))
    return out
