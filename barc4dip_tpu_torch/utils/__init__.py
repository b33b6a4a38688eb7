# SPDX-License-Identifier: CECILL-2.1
"""Host-side utilities of the PyTorch port (numpy only)."""
from .synthetic import speckle_field, speckle_stack, spiral_motion

__all__ = ["speckle_field", "speckle_stack", "spiral_motion"]
