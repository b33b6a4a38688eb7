# SPDX-License-Identifier: CECILL-2.1
"""Host-side utilities of the PyTorch port (numpy only)."""
from .checkpoint import ChunkStore, config_hash
from .lazy import LazyMap, LazyMapStack
from .synthetic import speckle_field, speckle_stack, spiral_motion
from .time import elapsed_time, now, progress_done, progress_update

__all__ = [
    "ChunkStore",
    "LazyMap",
    "LazyMapStack",
    "config_hash",
    "elapsed_time",
    "now",
    "progress_done",
    "progress_update",
    "speckle_field",
    "speckle_stack",
    "spiral_motion",
]
