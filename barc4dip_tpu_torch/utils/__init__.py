# SPDX-License-Identifier: CECILL-2.1
"""Utilities of the PyTorch port: chunk checkpoints, lazy maps, synthetic
speckle and timing on the host; ``to_uint16`` and the robust display
ranges on a device (torch, through ``ops.quantile`` and ``ops.rank``)."""
from .checkpoint import ChunkStore, config_hash
from .dtype import round_uint16_bounds, to_uint16
from .lazy import LazyMap, LazyMapStack
from .range import (
    filtered_minmax_range,
    filtered_minmax_range_streaming,
    percentile_minmax_range,
)
from .synthetic import speckle_field, speckle_stack, spiral_motion
from .time import elapsed_time, now, progress_done, progress_update

__all__ = [
    "ChunkStore",
    "LazyMap",
    "LazyMapStack",
    "config_hash",
    "elapsed_time",
    "filtered_minmax_range",
    "filtered_minmax_range_streaming",
    "now",
    "percentile_minmax_range",
    "progress_done",
    "progress_update",
    "round_uint16_bounds",
    "speckle_field",
    "speckle_stack",
    "spiral_motion",
    "to_uint16",
]
