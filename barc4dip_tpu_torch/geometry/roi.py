# SPDX-License-Identifier: CECILL-2.1
"""ROI slice construction (numpy copy of ``barc4dip_tpu/geometry/roi.py``'s
``odd_size``, ``roi_slices`` and ``roi_grid_3x3``, without the clipping
option): odd sizes, raise on out-of-bounds, NW..SE row-major grid labels."""
from __future__ import annotations

import math

import numpy as np

__all__ = ["odd_size", "roi_slices", "roi_grid_3x3"]

GRID3_LABELS = np.array(
    [["NW", "N", "NE"], ["W", "C", "E"], ["SW", "S", "SE"]], dtype=object
)


def odd_size(n: float | int, *, min_size: int = 3) -> int:
    """Smallest odd integer >= ceil(n), at least ``min_size``."""
    if not math.isfinite(n):
        raise ValueError("n must be finite.")
    if min_size < 1:
        raise ValueError("min_size must be >= 1.")
    return max(math.ceil(n), int(min_size)) | 1


def _axis_span(center: int, size: int, bound: int) -> tuple[int, int]:
    """[lo, hi) of an odd ``size`` window centred at ``center`` on one axis."""
    half = size // 2
    lo, hi = int(center) - half, int(center) + half + 1
    if lo < 0 or hi > bound:
        raise ValueError("ROI exceeds image bounds.")
    return lo, hi


def roi_slices(
    image_shape: tuple[int, int],
    size_yx: tuple[int, int],
    *,
    center_yx: tuple[int, int] | None = None,
) -> tuple[slice, slice]:
    """Slices of an odd-sized ROI around ``center_yx`` (default image center)."""
    for size in size_yx:
        if size <= 0:
            raise ValueError("ROI sizes must be positive.")
        if size % 2 == 0:
            raise ValueError("ROI sizes must be odd for symmetry.")
    if center_yx is None:
        center_yx = tuple(bound // 2 for bound in image_shape)
    spans = [
        _axis_span(center, size, bound)
        for center, size, bound in zip(center_yx, size_yx, image_shape)
    ]
    return tuple(slice(lo, hi) for lo, hi in spans)


def roi_grid_3x3(
    image_shape: tuple[int, int],
    roi_size_yx: tuple[int, int],
    step_yx: tuple[int, int],
    *,
    center_yx: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """3x3 grid of ROI slices around a center; row-major NW..SE labels."""
    if center_yx is None:
        center_yx = tuple(bound // 2 for bound in image_shape)
    grid = np.empty((3, 3), dtype=object)
    for row, col in np.ndindex(3, 3):
        node = (
            int(center_yx[0] + (row - 1) * step_yx[0]),
            int(center_yx[1] + (col - 1) * step_yx[1]),
        )
        grid[row, col] = roi_slices(
            image_shape, roi_size_yx, center_yx=node
        )
    return grid, GRID3_LABELS.copy()
