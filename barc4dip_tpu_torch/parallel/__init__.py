# SPDX-License-Identifier: CECILL-2.1
"""Multi-device parallelism: frame-axis data parallelism for the stack
pipelines (counterpart of ``barc4dip_tpu/parallel``)."""
from .mesh import (
    FRAME_AXIS,
    frame_mesh,
    frames_sharding,
    init_distributed,
    replicated_sharding,
    shard_frames,
)

__all__ = [
    "FRAME_AXIS",
    "frame_mesh",
    "init_distributed",
    "frames_sharding",
    "replicated_sharding",
    "shard_frames",
]
