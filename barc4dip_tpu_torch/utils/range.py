# SPDX-License-Identifier: CECILL-2.1
"""Robust (min, max) range estimation (counterpart of
``barc4dip_tpu/utils/range.py``). The median prefilter is
:func:`..ops.rank.median_filter2d` (kernel K2 for the 3x3 case on CUDA).

A numpy input computes on the default device (cuda when present), a tensor
on its own device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device, upload
from ..ops.quantile import nanpercentiles_exact
from ..ops.rank import median_filter2d

__all__ = [
    "filtered_minmax_range",
    "percentile_minmax_range",
    "filtered_minmax_range_streaming",
]


def _as_tensor(image) -> torch.Tensor:
    """A tensor as it is; a numpy array uploaded in its compute dtype."""
    if isinstance(image, torch.Tensor):
        return image
    return upload(np.asarray(image), resolve_device(None))


def _median_minmax(x: torch.Tensor, size: int) -> tuple[float, float]:
    ref = median_filter2d(x.to(torch.float32), size=size)
    nan = torch.isnan(ref)
    lo = torch.where(nan, math.inf, ref).min()
    hi = torch.where(nan, -math.inf, ref).max()
    return float(lo), float(hi)


def _checked(vmin: float, vmax: float) -> tuple[float, float]:
    if not np.isfinite(vmin) or not np.isfinite(vmax) or vmax <= vmin:
        raise ValueError(f"Invalid range after filtering: vmin={vmin}, vmax={vmax}")
    return float(vmin), float(vmax)


def filtered_minmax_range(image, size: int = 3) -> tuple[float, float]:
    """(vmin, vmax) of a median-filtered copy (salt & pepper suppression).

    For 3D stacks the filter is spatial-only (size applied in y/x).
    """
    img = _as_tensor(image)
    if img.dim() not in (2, 3):
        raise ValueError(f"Expected 2D or 3D array, got ndim={img.dim()}")
    return _checked(*_median_minmax(img, int(size)))


def percentile_minmax_range(
    image, p_low: float = 0.05, p_high: float = 99.95
) -> tuple[float, float]:
    """Global NaN-aware percentile range across all pixels. Integer input
    computes in float64, the widest float, as the JAX package does under
    x64."""
    floating = (image.dtype.is_floating_point if isinstance(image, torch.Tensor)
                else np.asarray(image).dtype.kind == "f")
    arr = _as_tensor(image)
    if not floating:
        arr = arr.to(torch.float64)
    q = nanpercentiles_exact(arr.reshape(1, -1), (float(p_low), float(p_high)))
    return float(q[0]), float(q[1])


def filtered_minmax_range_streaming(image, size: int = 3) -> tuple[float, float]:
    """Per-frame median-filter robust bounds, streamed over frames: the
    same result as :func:`filtered_minmax_range`."""
    img = image if isinstance(image, torch.Tensor) else np.asarray(image)
    if img.ndim == 2:
        return filtered_minmax_range(img, size=size)
    if img.ndim != 3:
        raise ValueError(f"Expected 2D or 3D array, got ndim={img.ndim}")
    vmin, vmax = math.inf, -math.inf
    for i in range(img.shape[0]):
        lo, hi = _median_minmax(_as_tensor(img[i]), int(size))
        vmin = min(vmin, lo)
        vmax = max(vmax, hi)
    return _checked(vmin, vmax)
