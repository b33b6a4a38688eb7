# SPDX-License-Identifier: CECILL-2.1
"""Square embedding used before every FFT-based metric (copy of
``barc4dip_tpu/geometry/masks.py::square_embed_slices``)."""
from __future__ import annotations

__all__ = ["square_embed_slices"]


def square_embed_slices(shape: tuple[int, int]) -> tuple[slice, slice, int]:
    """The (sy, sx, N) placement for centering (H, W) in (N, N)."""
    H, W = shape
    N = max(H, W)
    y0 = (N - H) // 2
    x0 = (N - W) // 2
    return slice(y0, y0 + H), slice(x0, x0 + W), N
