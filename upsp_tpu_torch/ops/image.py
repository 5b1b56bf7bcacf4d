"""Image-space utilities: hot-pixel repair, blurs, histogram threshold.

Port of ``upsp_tpu/ops/image.py``.  The per-frame functions take batched
(..., H, W) tensors on any device and are plain PyTorch; ``fix_hot_pixels``
is also the plain twin of the hot-pixel kernel K6
(``ops/ecc_kernels.fix_hot_pixels_kernel``), which the frame program uses.
The histogram-threshold helpers and ``scale_image{,_max_inlier}`` are host
numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def fix_hot_pixels(
    img: torch.Tensor, thresh: int = 4064, min_change: int = 512,
    max_hot: int = 5,
) -> torch.Tensor:
    """Replace hot pixels (>= thresh) by the median of their 4-neighbours.

    A frame with more than ``max_hot`` hot pixels is returned unchanged; a
    replacement needs ``old - median > min_change``.  All hot pixels are
    repaired against the original frame.  ``img`` is (..., H, W); the
    result keeps its dtype.
    """
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    x = img.reshape(-1, h, w).to(torch.float32)
    big = 3.0e38  # sentinel for missing neighbours
    xp = F.pad(x[:, None], (1, 1, 1, 1), value=big)[:, 0]
    up = xp[:, :-2, 1:-1]
    down = xp[:, 2:, 1:-1]
    left = xp[:, 1:-1, :-2]
    right = xp[:, 1:-1, 2:]
    # 4-element sorting network; the median is the 3rd smallest with all
    # four neighbours, the 2nd smallest at edges (3) and corners (2)
    n_valid = 4 - ((up >= big).int() + (down >= big).int()
                   + (left >= big).int() + (right >= big).int())
    lo1, hi1 = torch.minimum(up, down), torch.maximum(up, down)
    lo2, hi2 = torch.minimum(left, right), torch.maximum(left, right)
    mid_lo = torch.maximum(lo1, lo2)
    mid_hi = torch.minimum(hi1, hi2)
    s2 = torch.minimum(mid_lo, mid_hi)
    s3 = torch.maximum(mid_lo, mid_hi)
    median = torch.where(n_valid == 4, s3, s2)
    hot = x >= thresh
    few = hot.sum(dim=(1, 2)) <= max_hot
    replace = hot & ((x - median) > min_change) & few[:, None, None]
    out = torch.where(replace, median, x).to(img.dtype)
    return out.reshape(lead + (h, w))


def convert_to_8u(img: np.ndarray) -> np.ndarray:
    """Min-max scale to uint8 (diagnostic images; host-side)."""
    img = np.asarray(img, np.float64)
    lo, hi = img.min(), img.max()
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    return np.rint((img - lo) * scale).clip(0, 255).astype(np.uint8)


def _reflect101_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of the last two axes (cv2 default)."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    p = F.pad(x.reshape(-1, 1, h, w), (r, r, r, r), mode="reflect")
    return p.reshape(lead + (h + 2 * r, w + 2 * r))


_SMALL_GAUSSIAN = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array(
        [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        np.float32,
    ),
}


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV-compatible Gaussian kernel (fixed binomial taps for sigma<=0
    and ksize in {1,3,5,7}, as cv2.getGaussianKernel)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) / 2
    xs = np.arange(ksize) - r
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def separable_filter(img: torch.Tensor, taps, scale: float = 1.0) -> torch.Tensor:
    """Reflect-101 separable filter of (..., H, W) in f32, horizontal pass
    then vertical, divided by ``scale``."""
    k = len(taps)
    r = k // 2
    h, w = img.shape[-2:]
    x = _reflect101_pad(img.to(torch.float32), r)
    xh = sum(float(taps[i]) * x[..., :, i : i + w] for i in range(k))
    xv = sum(float(taps[i]) * xh[..., i : i + h, :] for i in range(k))
    return xv if scale == 1.0 else xv / scale


def image_dtype(img: torch.Tensor) -> torch.dtype:
    """bfloat16 images stay bfloat16 (the ``compute_dtype="bfloat16"``
    pipeline: computed in f32, rounded once); everything else is f32."""
    return torch.bfloat16 if img.dtype == torch.bfloat16 else torch.float32


def gaussian_blur(img: torch.Tensor, ksize: int = 3, sigma: float = 0.0):
    """Separable Gaussian blur with reflect-101 borders (cv2.GaussianBlur
    parity), horizontal then vertical, in f32 (:func:`image_dtype` out)."""
    out = separable_filter(img, gaussian_kernel_1d(ksize, sigma))
    return out.to(image_dtype(img))


def box_blur(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Normalized box filter with reflect-101 borders (cv2.blur parity)."""
    out = separable_filter(img, [1.0] * ksize, float(ksize * ksize))
    return out.to(image_dtype(img))


def apply_filter(img: torch.Tensor, filter_type: str, ksize: int):
    """Dispatch on the input-deck FilterType (none/gaussian/box)."""
    if filter_type == "gaussian":
        return gaussian_blur(img, ksize)
    if filter_type == "box":
        return box_blur(img, ksize)
    return img.to(image_dtype(img))


# ---------------------------------------------------------------------------
# Histogram-based patch threshold (phase 0, host-side numpy)


def intensity_histc(img: np.ndarray, depth: int = 12, bins: int = 256):
    """Histogram counts/edges over [0, 2^depth) with ceil-sized bins."""
    img = np.asarray(img)
    max_value = 2**depth
    bin_sz = int(np.ceil(max_value / bins))
    counts = np.zeros(bins, np.int64)
    vals = img[img < max_value].astype(np.int64) // bin_sz
    np.add.at(counts, vals, 1)
    edges = np.arange(bins + 1, dtype=np.int64) * bin_sz
    return edges, counts


def find_peaks(data: np.ndarray, separation: int = 1) -> list:
    """Local maxima with plateau handling and a minimum index separation."""
    data = np.asarray(data, np.float64)
    peaks = []
    plateau = False
    plateau_begin = 0
    for i in range(len(data) - 1):
        if not plateau:
            rising = data[i] > data[i + 1] and (i == 0 or data[i] > data[i - 1])
            if rising:
                if peaks and (i - peaks[-1]) < separation:
                    if data[peaks[-1]] < data[i]:
                        peaks[-1] = i
                    continue
                peaks.append(i)
            elif i > 0 and data[i] > data[i - 1] and data[i] == data[i + 1]:
                plateau = True
                plateau_begin = i
        elif data[i] < data[i + 1]:
            plateau = False
        elif data[i] > data[i + 1]:
            plateau = False
            plateau_i = (i + plateau_begin) // 2
            if peaks and (plateau_i - peaks[-1]) < separation:
                if data[peaks[-1]] < data[plateau_i]:
                    peaks[-1] = plateau_i
                continue
            peaks.append(plateau_i)
    return peaks


def first_min_threshold(counts: np.ndarray, separation: int = 1) -> int:
    """Index of the first histogram valley after the first (dark) peak."""
    counts = np.asarray(counts, np.float64)
    max_peaks = find_peaks(counts, separation)
    if not max_peaks:
        return 0
    with np.errstate(divide="ignore"):
        inv = np.where(counts > 0, 1.0 / counts, np.inf)
    finite = np.isfinite(inv)
    fill = np.nanmax(inv[finite]) if finite.any() else 0.0
    min_peaks = find_peaks(np.where(finite, inv, fill), separation)
    first_max = max_peaks[0]
    for p in min_peaks:
        if p > first_max:
            return p
    return 0


def patch_threshold_from_frame(img: np.ndarray, bit_depth: int = 12) -> int:
    """histc -> first-min valley -> +5 offset (psp_process.cpp:2157-2158)."""
    edges, counts = intensity_histc(img, depth=bit_depth, bins=256)
    return int(edges[first_min_threshold(counts, 5)] + 5)


def scale_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Clip to `scale`, normalize to [0,1], round to uint8 [0,255]
    (numpy, as ``upsp_tpu/ops/image.py:243``)."""
    img_temp = np.minimum(np.asarray(img), scale).astype(np.float64) / scale
    return np.rint(img_temp * 255).astype(np.uint8)


def scale_image_max_inlier(img: np.ndarray) -> np.ndarray:
    """Normalize so the max *inlier* intensity maps to 255 (uint8).

    Max inlier = largest sorted intensity[i] with
    ``0.9 * intensity[i] <= intensity[round(i * 0.999)]`` — robust to a few
    saturated pixels (numpy, as ``upsp_tpu/ops/image.py:249``).
    """
    img_flat = np.sort(np.asarray(img).ravel())
    i = len(img_flat) - 1
    while i > 0 and 0.9 * img_flat[i] > img_flat[min(int(np.rint(i * 0.999)), i - 1)]:
        i -= 1
    return scale_image(img, scale=float(img_flat[i]))
