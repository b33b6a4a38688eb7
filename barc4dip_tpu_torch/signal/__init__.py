# SPDX-License-Identifier: CECILL-2.1
"""Signal layer of the PyTorch port: sampling-step resolution, dense XST
tracking and wavefronts."""
from .common import lag_axis_from_step, resolve_step_1d, resolve_steps_2d, uniform_step
from .xst import (
    track_displacement_field,
    track_displacement_stack,
    wavefront_from_displacements,
)

__all__ = [
    "lag_axis_from_step",
    "resolve_step_1d",
    "resolve_steps_2d",
    "track_displacement_field",
    "track_displacement_stack",
    "uniform_step",
    "wavefront_from_displacements",
]
