# SPDX-License-Identifier: CECILL-2.1
"""Speckle metrics of the PyTorch port."""
from .speckles import speckle_stack_stats, tracking_grid_from_frame0

__all__ = ["speckle_stack_stats", "tracking_grid_from_frame0"]
