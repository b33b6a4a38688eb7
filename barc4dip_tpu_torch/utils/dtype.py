# SPDX-License-Identifier: CECILL-2.1
"""dtype conversions to the uint16 detector range (counterpart of
``barc4dip_tpu/utils/dtype.py``): count-valued data (mean >
counts_threshold) is clipped; normalised data is contrast-stretched to
``65535 * scaling`` over the median-filtered robust range widened by 5%.
"""
from __future__ import annotations

import numpy as np
import torch

from .range import _as_tensor, filtered_minmax_range

__all__ = ["to_uint16", "round_uint16_bounds"]


def _u16(y: torch.Tensor) -> np.ndarray:
    # values are already clipped to [0, 65535]: int32 truncates as uint16 does
    return y.to(torch.int32).cpu().numpy().astype(np.uint16)


def to_uint16(
    data,
    *,
    median_size: int = 3,
    counts_threshold: float = 10.0,
    scaling: float = 1 / np.sqrt(2),
    device=None,
) -> np.ndarray:
    """Convert a 2D image or 3D stack to uint16 (a numpy array). A numpy
    input that is not uint16 already computes on ``device`` (``None``: the
    card, and an error without one), a tensor on its own device.

    Count-valued data (mean > counts_threshold) is clipped; normalised data
    is contrast-stretched to ``65535 * scaling`` via the robust filtered
    range (vmin*0.95, vmax/0.95).
    """
    if isinstance(data, np.ndarray) and data.dtype == np.uint16:
        return np.array(data)
    arr = _as_tensor(data, device)
    if arr.dtype == torch.uint16:
        return arr.cpu().numpy()
    if arr.dim() not in (2, 3):
        raise ValueError(f"Expected 2D or 3D array, got ndim={arr.dim()}")

    m = float(torch.nanmean(arr.to(torch.float32)))
    if m > counts_threshold:
        return _u16(torch.clamp(arr, 0, 65535))

    vmin, vmax = filtered_minmax_range(arr, size=median_size)
    vmin *= 0.95
    vmax /= 0.95
    inv = 65535 * scaling / (vmax - vmin)
    y = (arr.to(torch.float32) - float(np.float32(vmin))) * float(np.float32(inv))
    return _u16(torch.clamp(y, 0.0, 65535.0))


def round_uint16_bounds(vmin: float, vmax: float, k: float = 1000) -> tuple[int, int]:
    """Round (vmin floored, vmax ceiled) to multiples of k, clipped to
    [0, 65535]."""
    vmin_r = int(np.floor(vmin / k) * k)
    vmax_r = int(np.ceil(vmax / k) * k)
    return max(0, vmin_r), min(65535, vmax_r)
