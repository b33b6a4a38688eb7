# SPDX-License-Identifier: CECILL-2.1
"""Host-side ROI and padding geometry (numpy only)."""
from .masks import square_embed_slices
from .roi import odd_size, roi_grid_3x3, roi_slices

__all__ = ["odd_size", "roi_grid_3x3", "roi_slices", "square_embed_slices"]
