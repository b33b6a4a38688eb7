# SPDX-License-Identifier: CECILL-2.1
"""Speckle metrics of the PyTorch port."""
from .speckles import (
    amplitude,
    bandwidth,
    grain,
    speckle_stack_stats,
    speckle_stats,
    tracking_grid_from_frame0,
)
from .statistics import distribution_moments

__all__ = [
    "amplitude",
    "bandwidth",
    "distribution_moments",
    "grain",
    "speckle_stack_stats",
    "speckle_stats",
    "tracking_grid_from_frame0",
]
