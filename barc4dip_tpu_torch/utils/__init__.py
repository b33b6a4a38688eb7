# SPDX-License-Identifier: CECILL-2.1
"""Host-side utilities of the PyTorch port (numpy only)."""
from .checkpoint import ChunkStore, config_hash
from .lazy import LazyMap, LazyMapStack
from .synthetic import speckle_field, speckle_stack, spiral_motion

__all__ = [
    "ChunkStore",
    "LazyMap",
    "LazyMapStack",
    "config_hash",
    "speckle_field",
    "speckle_stack",
    "spiral_motion",
]
