# SPDX-License-Identifier: CECILL-2.1
"""3x3 ROI grid geometry and tile gather for stack tracking (counterpart of
``barc4dip_tpu/metrics/tracking_batch.py``)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["_extract_tiles", "_grid_geometry"]


def _grid_geometry(grid_slices) -> tuple[np.ndarray, np.ndarray, int]:
    """(starts (9, 2), centers (9, 2), roi_side) of a 3x3 slice grid."""
    starts = []
    centers = []
    sides = set()
    for iy in range(3):
        for ix in range(3):
            sy, sx = grid_slices[iy, ix]
            starts.append((sy.start, sx.start))
            centers.append(
                ((sy.start + sy.stop - 1) / 2.0, (sx.start + sx.stop - 1) / 2.0)
            )
            sides.add((sy.stop - sy.start, sx.stop - sx.start))
    if len(sides) != 1:
        raise ValueError("All grid ROIs must share one shape.")
    (sh, sw), = sides
    if sh != sw:
        raise ValueError("Grid ROIs must be square.")
    return np.asarray(starts, np.int32), np.asarray(centers, np.float64), int(sh)


def _extract_tiles(frames, starts: np.ndarray, s: int):
    """The 9 (s, s) tiles at ``starts`` of (..., H, W) frames: (..., 9, s, s)."""
    return torch.stack(
        [frames[..., y0 : y0 + s, x0 : x0 + s] for (y0, x0) in starts], dim=-3
    )
