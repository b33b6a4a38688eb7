# SPDX-License-Identifier: CECILL-2.1
"""Geometry helpers: ROI slices, grids, padding, crops."""
from .crop import crop_to_square_center
from .masks import pad_to_square, square_embed_slices
from .roi import embed_roi, odd_size, roi_grid_3x3, roi_slices

__all__ = [
    "crop_to_square_center",
    "embed_roi",
    "odd_size",
    "pad_to_square",
    "roi_grid_3x3",
    "roi_slices",
    "square_embed_slices",
]
