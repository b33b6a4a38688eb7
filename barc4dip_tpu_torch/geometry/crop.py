# SPDX-License-Identifier: CECILL-2.1
"""Center square crops (copy of ``barc4dip_tpu/geometry/crop.py``)."""
from __future__ import annotations

__all__ = ["crop_to_square_center"]


def crop_to_square_center(array, constant: float = 1.0):
    """Crop a 2D array to a centered odd-sized square.

    Square side = odd(floor(constant * min(shape))), clamped to the largest
    odd side that fits. Works on NumPy arrays and tensors alike (static
    slicing: a view of the input).
    """
    min_dim = min(array.shape)
    square_size = int(min_dim * constant)

    if square_size % 2 == 0:
        square_size -= 1
    fit = min_dim if min_dim % 2 else min_dim - 1
    square_size = min(square_size, fit)
    if square_size < 1:
        raise ValueError(
            f"constant={constant} gives a non-positive square side for "
            f"shape {tuple(array.shape)}"
        )

    center_y, center_x = array.shape[0] // 2, array.shape[1] // 2
    half = square_size // 2
    start_y = max(center_y - half, 0)
    start_x = max(center_x - half, 0)
    end_y = min(start_y + square_size, array.shape[0])
    end_x = min(start_x + square_size, array.shape[1])
    start_y = end_y - square_size
    start_x = end_x - square_size

    return array[start_y:end_y, start_x:end_x]
