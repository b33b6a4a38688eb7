# SPDX-License-Identifier: CECILL-2.1
"""Square padding used before every FFT-based metric (counterpart of
``barc4dip_tpu/geometry/masks.py``)."""
from __future__ import annotations

from .roi import embed_roi

__all__ = ["pad_to_square", "square_embed_slices"]


def square_embed_slices(shape: tuple[int, int]) -> tuple[slice, slice, int]:
    """The (sy, sx, N) placement for centering (H, W) in (N, N)."""
    H, W = shape
    N = max(H, W)
    y0 = (N - H) // 2
    x0 = (N - W) // 2
    return slice(y0, y0 + H), slice(x0, x0 + W), N


def pad_to_square(image, *, fill_value: float = 0.0, dtype=None):
    """Symmetrically pad a 2D array or tensor to (N, N), N = max(H, W)."""
    if image.ndim != 2:
        raise ValueError("Input must be a 2D array.")
    sy, sx, N = square_embed_slices(tuple(image.shape))
    return embed_roi(
        image, out_shape=(N, N), slices_yx=(sy, sx), fill_value=fill_value, dtype=dtype
    )
