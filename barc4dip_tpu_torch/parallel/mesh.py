# SPDX-License-Identifier: CECILL-2.1
"""Frame-axis data parallelism over devices (counterpart of
``barc4dip_tpu/parallel/mesh.py``).

Per-frame metric and tracking programs are independent across frames, so a
stack spreads over devices by cutting each chunk's frames into contiguous
shards, one a device, with no collective on the hot path: the temporal
reductions happen on small host arrays afterwards. A :class:`FrameMesh` is
the port's counterpart of the JAX package's 1-D ``Mesh``: an ordered tuple
of devices, one shard each, along the one axis :data:`FRAME_AXIS`. The
stack calls take it as ``mesh=``; each shard is uploaded to (or sliced onto)
its device, runs there, and its results come back to the host.

Several processes (one a host, say) join through :func:`init_distributed`,
as in the JAX package, where that path is wiring only: no stack pipeline
spans processes.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "FRAME_AXIS",
    "FrameMesh",
    "FrameSharding",
    "ShardedFrames",
    "frame_mesh",
    "frames_sharding",
    "init_distributed",
    "replicated_sharding",
    "shard_bounds",
    "shard_frames",
]

FRAME_AXIS = "frames"


@dataclass(frozen=True)
class FrameMesh:
    """An ordered tuple of devices along the axis :data:`FRAME_AXIS`; each
    entry holds one shard, so a device named twice holds two."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (FRAME_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {FRAME_AXIS: self.size}


@dataclass(frozen=True)
class FrameSharding:
    """How an array lies on a mesh: ``spec == (FRAME_AXIS,)`` cuts the
    leading axis into one contiguous shard a mesh entry; ``spec == ()``
    places the whole array on every device."""

    mesh: FrameMesh
    spec: tuple[str, ...]

    @property
    def device_set(self) -> set:
        return set(self.mesh.devices)


@dataclass(frozen=True)
class ShardedFrames:
    """The shards :func:`shard_frames` placed: ``shards[k]`` is frames
    ``bounds[k]`` on ``sharding.mesh.devices[k]``."""

    shards: tuple[torch.Tensor, ...]
    bounds: tuple[tuple[int, int], ...]
    sharding: FrameSharding
    shape: tuple[int, ...]

    @property
    def device_set(self) -> set:
        return {t.device for t in self.shards}


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def frame_mesh(devices=None) -> FrameMesh:
    """A mesh over every visible CUDA device, or over ``devices``.

    With ``None`` it raises ``RuntimeError`` where no card is available:
    the CPU is never chosen unasked (the device rule of ``config``). An
    explicit list may name one device more than once, each entry one shard.
    That is the counterpart of the JAX tests' forced host device count:
    ``frame_mesh(["cpu"] * 8)`` crosses eight shard boundaries on one CPU,
    ``frame_mesh(["cuda:0", "cuda:0"])`` two on one card. It is there to
    test the sharded paths, not to speed anything up."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available (torch.cuda.is_available() is False) and "
                'none was asked for: pass devices, e.g. frame_mesh(["cpu"])'
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("a frame mesh needs at least one device")
    return FrameMesh(devices)


def frames_sharding(mesh: FrameMesh) -> FrameSharding:
    """Shard the leading (frame) axis across the mesh."""
    return FrameSharding(mesh, (FRAME_AXIS,))


def replicated_sharding(mesh: FrameMesh) -> FrameSharding:
    return FrameSharding(mesh, ())


def shard_bounds(c0: int, c1: int, n: int, width: int | None = None) -> list[tuple[int, int]]:
    """Frames [c0, c1) cut into ``n`` contiguous shards of ``width`` frames
    (default ceil((c1 - c0) / n)); the last ones are short or empty where
    the frames run out (a chunk's tail)."""
    if width is None:
        width = max(1, -(-(c1 - c0) // n))
    return [(min(c0 + k * width, c1), min(c0 + (k + 1) * width, c1)) for k in range(n)]


def shard_frames(arr, mesh: FrameMesh) -> ShardedFrames:
    """Place a (T, ...) numpy array or tensor on the mesh, frame axis
    sharded: contiguous shards of ceil(T / mesh.size) frames, each on its
    device in the array's own dtype."""
    T = int(arr.shape[0])
    bounds = shard_bounds(0, T, mesh.size)
    shards = []
    for (a, b), dev in zip(bounds, mesh.devices):
        if isinstance(arr, torch.Tensor):
            shards.append(arr[a:b].to(dev))
        else:
            shards.append(torch.from_numpy(np.ascontiguousarray(arr[a:b])).to(dev))
    return ShardedFrames(tuple(shards), tuple(bounds), frames_sharding(mesh), tuple(arr.shape))


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join a multi-process job before building meshes (counterpart of
    ``jax.distributed.initialize``).

    Wraps ``torch.distributed.init_process_group``: the rendezvous is
    ``tcp://`` + ``coordinator_address`` ("host:port"), the backend
    ``nccl`` where this process has a card and ``gloo`` where it has none.
    An argument left ``None`` is read from the environment as
    ``torch.distributed`` reads it (``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``)."""
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init = "env://"
    else:
        addr = str(coordinator_address)
        init = addr if "://" in addr else f"tcp://{addr}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dist.init_process_group(backend, init_method=init, world_size=int(num_processes),
                            rank=int(process_id))
