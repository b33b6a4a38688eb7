# SPDX-License-Identifier: CECILL-2.1
"""ROI slice construction and embedding (copy of
``barc4dip_tpu/geometry/roi.py``): odd sizes, clip-or-raise semantics,
NW..SE row-major grid labels. The slice helpers are host-side shape logic;
:func:`embed_roi` takes a NumPy array or a tensor and returns the same
kind."""
from __future__ import annotations

import math

import numpy as np
import torch.nn.functional as F

__all__ = ["odd_size", "roi_slices", "roi_grid_3x3", "embed_roi"]

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


def _axis_span(center: int, size: int, bound: int, clip: bool) -> tuple[int, int]:
    """[lo, hi) of an odd ``size`` window centred at ``center`` on one axis.

    ``clip=True`` clamps both endpoints into [0, bound]: a centre fully
    outside the image yields an empty ordered span at the nearest edge."""
    half = size // 2
    lo, hi = int(center) - half, int(center) + half + 1
    if clip:
        return min(max(lo, 0), bound), min(max(hi, 0), bound)
    if lo < 0 or hi > bound:
        raise ValueError("ROI exceeds image bounds.")
    return lo, hi


def roi_slices(
    image_shape: tuple[int, int],
    size_yx: tuple[int, int],
    *,
    center_yx: tuple[int, int] | None = None,
    clip: bool = False,
) -> tuple[slice, slice]:
    """Slices of an odd-sized ROI around ``center_yx`` (default image center).

    With ``clip=False`` raises if the ROI exceeds bounds; with ``clip=True``
    the ROI is clipped (and may shrink)."""
    for size in size_yx:
        if size <= 0:
            raise ValueError("ROI sizes must be positive.")
        if size % 2 == 0:
            raise ValueError("ROI sizes must be odd for symmetry.")
    if center_yx is None:
        center_yx = tuple(bound // 2 for bound in image_shape)
    spans = [
        _axis_span(center, size, bound, clip)
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
            image_shape, roi_size_yx, center_yx=node, clip=False
        )
    return grid, GRID3_LABELS.copy()


def embed_roi(
    roi,
    *,
    out_shape: tuple[int, int],
    slices_yx: tuple[slice, slice],
    fill_value: float = 0.0,
    dtype=None,
):
    """Embed a 2D ROI into a full-size array at ``slices_yx``.

    A NumPy ROI gives a NumPy array (``dtype`` a numpy dtype), a tensor a
    tensor on its device (``dtype`` a torch dtype): one constant pad."""
    sy, sx = slices_yx
    if tuple(roi.shape) != (sy.stop - sy.start, sx.stop - sx.start):
        raise ValueError("ROI shape does not match target slice dimensions.")

    if isinstance(roi, np.ndarray):
        out = np.full(out_shape, fill_value, dtype=dtype or roi.dtype)
        out[sy, sx] = roi
        return out

    arr = roi if dtype is None else roi.to(dtype)
    margins = (sx.start, out_shape[1] - sx.stop, sy.start, out_shape[0] - sy.stop)
    return F.pad(arr, margins, mode="constant", value=fill_value)
