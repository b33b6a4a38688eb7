# SPDX-License-Identifier: CECILL-2.1
"""Perceptual image-quality metrics (counterpart of
``barc4dip_tpu/metrics/perceptual.py``):

- :func:`psnr`: peak signal-to-noise ratio;
- :func:`ssim`: structural similarity (Wang et al. 2004), Gaussian- or
  uniform-windowed, matching the standard formulation (skimage-compatible
  defaults: 7x7 uniform window, sample covariance normalisation);
- :func:`ms_ssim`: multi-scale SSIM (Wang et al. 2003) with the standard
  5-scale weights.

The window filters are separable shifted adds: no convolution, so no TF32
path. Each function returns a Python float. NumPy inputs compute on
``device`` (``None``: the card, and an error without one), tensors on their
own device; each image of a mixed-dtype pair is cast on its own (float64
stays, integers compute in float32).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import device_arrays

__all__ = ["psnr", "ssim", "ms_ssim"]


def _as_float_pair(a, b, device):
    if np.shape(a) != np.shape(b):
        raise ValueError(f"shapes must match; got {tuple(np.shape(a))} and {tuple(np.shape(b))}")
    if np.ndim(a) != 2:
        raise ValueError("expected 2D images")
    # each image is cast on its own: a mixed call (float processed vs uint16
    # raw) must not leave the integer one to wrap around in y*y
    x, y = device_arrays(a, b, device=device)
    return (x.real if x.is_complex() else x), (y.real if y.is_complex() else y)


def _data_range(y, data_range, dtype):
    """``data_range`` (default: the reference image's range) as a 0-d tensor
    of the compute dtype."""
    if data_range is None:
        data_range = float(y.max() - y.min())
    return torch.as_tensor(data_range, dtype=dtype, device=y.device)


def psnr(image, reference, *, data_range: float | None = None, device=None) -> float:
    """Peak signal-to-noise ratio in dB (inf for identical images)."""
    x, y = _as_float_pair(image, reference, device)
    dr = _data_range(y, data_range, x.dtype)
    mse = ((x - y) ** 2).mean()
    out = torch.where(
        mse > 0, 10.0 * torch.log10(dr * dr / torch.where(mse > 0, mse, 1.0)), torch.inf
    )
    return float(out)


def _sep_filter(img, kernel1d):
    """Separable 'valid' correlation along both axes, by shifted adds."""
    k = len(kernel1d)
    H, W = img.shape[-2], img.shape[-1]
    out = torch.zeros((H - k + 1, W), dtype=img.dtype, device=img.device)
    for i in range(k):
        out = out + kernel1d[i] * img[i : i + H - k + 1, :]
    out2 = torch.zeros((H - k + 1, W - k + 1), dtype=img.dtype, device=img.device)
    for i in range(k):
        out2 = out2 + kernel1d[i] * out[:, i : i + W - k + 1]
    return out2


@lru_cache(maxsize=16)
def _window(win_size: int, gaussian: bool, sigma: float):
    if gaussian:
        x = np.arange(win_size, dtype=np.float64) - (win_size - 1) / 2.0
        w = np.exp(-0.5 * (x / sigma) ** 2)
    else:
        w = np.ones(win_size, dtype=np.float64)
    return w / w.sum()


def _ssim_map(x, y, *, data_range, win_size, gaussian, sigma, k1, k2):
    # the taps as Python floats: each multiplies in the images' dtype, and
    # no tap is read from the device
    w = _window(win_size, gaussian, sigma).tolist()

    mu_x = _sep_filter(x, w)
    mu_y = _sep_filter(y, w)
    mu_xx = _sep_filter(x * x, w)
    mu_yy = _sep_filter(y * y, w)
    mu_xy = _sep_filter(x * y, w)

    # sample (unbiased-style) normalisation as in skimage: cov_norm = n/(n-1)
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    vx = cov_norm * (mu_xx - mu_x * mu_x)
    vy = cov_norm * (mu_yy - mu_y * mu_y)
    vxy = cov_norm * (mu_xy - mu_x * mu_y)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    num = (2 * mu_x * mu_y + c1) * (2 * vxy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (vx + vy + c2)
    cs = (2 * vxy + c2) / (vx + vy + c2)
    return num / den, cs


def ssim(
    image,
    reference,
    *,
    data_range: float | None = None,
    win_size: int = 7,
    gaussian_weights: bool = False,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    device=None,
) -> float:
    """Mean structural similarity index (Wang et al. 2004)."""
    x, y = _as_float_pair(image, reference, device)
    if win_size % 2 == 0 or win_size < 3:
        raise ValueError("win_size must be odd and >= 3")
    if min(x.shape) < win_size:
        raise ValueError("image smaller than the SSIM window")
    dtype = torch.promote_types(x.dtype, y.dtype)
    s, _ = _ssim_map(
        x.to(dtype), y.to(dtype), data_range=_data_range(y, data_range, x.dtype),
        win_size=int(win_size), gaussian=bool(gaussian_weights), sigma=float(sigma),
        k1=float(k1), k2=float(k2),
    )
    return float(s.mean())


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _downsample(img):
    """2x2 mean over the even-sized part of the image."""
    H, W = img.shape
    return 0.25 * (
        img[0 : H - H % 2 : 2, 0 : W - W % 2 : 2]
        + img[1 : H : 2, 0 : W - W % 2 : 2]
        + img[0 : H - H % 2 : 2, 1 : W : 2]
        + img[1 : H : 2, 1 : W : 2]
    )


def ms_ssim(
    image,
    reference,
    *,
    data_range: float | None = None,
    levels: int = 5,
    win_size: int = 11,
    k1: float = 0.01,
    k2: float = 0.03,
    device=None,
) -> float:
    """Multi-scale SSIM (Wang et al. 2003), standard 5-scale weighting."""
    x, y = _as_float_pair(image, reference, device)
    if min(x.shape) < win_size * 2 ** (levels - 1):
        raise ValueError(
            f"image too small for {levels} scales with win_size={win_size}"
        )
    dr = _data_range(y, data_range, x.dtype)
    dtype = torch.promote_types(x.dtype, y.dtype)
    x, y = x.to(dtype), y.to(dtype)
    levels = int(levels)
    weights = np.asarray(_MSSSIM_WEIGHTS[:levels])
    weights = weights / weights.sum()

    vals = []
    for lvl in range(levels):
        s_map, cs_map = _ssim_map(
            x, y, data_range=dr, win_size=int(win_size), gaussian=True,
            sigma=1.5, k1=float(k1), k2=float(k2),
        )
        vals.append(s_map.mean() if lvl == levels - 1 else cs_map.mean())
        if lvl != levels - 1:
            x = _downsample(x)
            y = _downsample(y)
    out = torch.ones((), dtype=vals[0].dtype, device=vals[0].device)
    for v, w in zip(vals, weights):
        out = out * torch.clamp_min(v, 1e-6) ** float(w)
    return float(out)
