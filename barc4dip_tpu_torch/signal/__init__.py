# SPDX-License-Identifier: CECILL-2.1
"""Signal layer of the PyTorch port: dense XST tracking and wavefronts."""
from .xst import (
    track_displacement_field,
    track_displacement_stack,
    wavefront_from_displacements,
)

__all__ = [
    "track_displacement_field",
    "track_displacement_stack",
    "wavefront_from_displacements",
]
