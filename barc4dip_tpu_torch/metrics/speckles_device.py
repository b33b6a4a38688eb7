# SPDX-License-Identifier: CECILL-2.1
"""Full-frame plus tiles speckle metrics for a batch of frames (counterpart
of ``barc4dip_tpu/metrics/speckles_device.py``), and the CUDA graphs that
replay them on a card.

The step runs its work in one order on every device: amplitude, stats and
bandwidth on the frame and on each tile bucket; then, for each tile bucket
and last for the frame, the grain group's autocorrelation map
(``estimators.grain_map_core``: kernel K1a on the frame, cuFFT on the
227/228-px subtiles, both launched from ``corrcore.autocorr2d_core``) and the
widths read from it; then the tile grids, their 3x3 pooling and the packed
result vector. Each operation sees the inputs it sees in the JAX program's
group order, so the leaves are the same to the bit.

:func:`metric_step` runs the step on (n, H, W) frames. On a card, the second
time a process meets a key (groups, tiling mode, saturation, eps, integer
range, flip, the frames' shape, dtype and device) it captures the step as
CUDA graphs, one before the first autocorrelation and one after each, and
from then on replays them: a few graph launches and the autocorrelations in
place of some eight hundred kernel launches a frame. The autocorrelations
stay eager, so that kernel K1 is launched, counted (``cuda_fftp.LAUNCHES``)
and timed inside its own functions. A key met once, the CPU, and any other
device run the step eagerly. :data:`GRAPH_COUNTS` counts both ways.

The graphs read the flipped frames from one buffer of the frames' size,
``shown``. Each tile bucket's autocorrelation maps are copied into a second
buffer of the largest bucket's size, and the frame's maps into ``shown``,
which nothing reads by then: the step holds no more memory outside the
graphs' private pool than the eager step holds while the tracker runs.
"""
from __future__ import annotations

import math
import warnings
from collections import OrderedDict

import numpy as np
import torch

from ..config import device_constant, holding_cached
from ..geometry.masks import square_embed_slices
from ..utils.profiling import annotate
from .common import (
    apply_display_origin,
    pack_leaves,
    subtile_grids_to_3x3_device,
    tile_batch,
    tile_grids,
    tile_plan,
)
from .estimators import (
    amplitude_core,
    bandwidth_core,
    distribution_moments_core,
    grain_from_autocorr,
    grain_map_core,
)

__all__ = ["GRAPH_COUNTS", "GRAPHS_PER_DEVICE", "int_value_hint", "metric_step", "speckle_device_fn"]

#: Keys whose graphs a device keeps; each holds a private memory pool, so the
#: least recently used goes when another is captured.
GRAPHS_PER_DEVICE = 4
#: How :func:`metric_step` ran over the process: ``graph_replays`` (steps
#: replayed as CUDA graphs), ``graph_captures`` (keys captured) and
#: ``eager_steps`` (steps run eagerly). A step that captures is also replayed.
GRAPH_COUNTS: dict[str, int] = {"graph_replays": 0, "graph_captures": 0, "eager_steps": 0}

_SIGHTED = 64  # keys remembered from a first sighting
_SEEN: OrderedDict = OrderedDict()
_GRAPHED: OrderedDict = OrderedDict()  # key -> _Graphs, or None where the capture failed
_GROUPS = ("amplitude", "grain", "stats", "bandwidth")


def int_value_hint(dtype):
    """(lo, hi) integer-value range of a float image converted from an
    integer numpy or torch ``dtype`` (uint16 detector frames), or None."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point or dtype.is_complex or dtype == torch.bool:
            return None
        info = torch.iinfo(dtype)
    elif np.issubdtype(np.dtype(dtype), np.integer):
        info = np.iinfo(dtype)
    else:
        return None
    if info.max - info.min < (1 << 24) and abs(int(info.min)) < (1 << 24):
        return (int(info.min), int(info.max))
    return None


class _SpeckleStep:
    """The metric step of one static configuration, in its parts: ``direct``
    (every group but grain, on the frame and each tile bucket), the grain
    maps and widths of each place (``grain_places``), and ``tree``."""

    def __init__(self, groups: frozenset, mode: str, sat: float | None, eps: float):
        self.groups, self.mode, self.sat, self.eps = frozenset(groups), mode, sat, eps
        self.chosen = [g for g in _GROUPS if g in self.groups]
        self.n = {"subtiles_9x9": 9, "tiles_3x3": 3}.get(mode)
        self.cores = {
            "amplitude": lambda img, int_range: amplitude_core(img, integer_range=int_range),
            "stats": lambda img, int_range: distribution_moments_core(img, saturation_value=sat, eps=eps),
            "bandwidth": lambda img, int_range: bandwidth_core(img),
        }

    def buckets(self, h: int, w: int) -> tuple:
        return tile_plan(h, w, self.n) if self.n else ()

    def image(self, imgs, bucket):
        """The frames (``bucket`` None) or one tile bucket's batch."""
        return imgs if bucket is None else tile_batch(imgs, bucket)

    def direct(self, imgs, int_range) -> list:
        """[{group: {field: (...)}}] of every group but grain: the frame's,
        then each tile bucket's."""
        h, w = (int(v) for v in imgs.shape[-2:])
        vals = []
        for bucket in (None, *self.buckets(h, w)):
            img = self.image(imgs, bucket)
            vals.append({})
            for g in self.chosen:
                if g != "grain":
                    with annotate(f"group.{g}"):
                        vals[-1][g] = self.cores[g](img, int_range)
        return vals

    def grain_places(self, h: int, w: int) -> list:
        """[(index into ``direct``'s list, bucket)] of the grain group: each
        tile bucket, then the frame."""
        if "grain" not in self.groups:
            return []
        buckets = self.buckets(h, w)
        return [(i, b) for i, b in enumerate(buckets, 1)] + [(0, None)]

    def tree(self, vals: list, lead: tuple, h: int, w: int) -> dict:
        out: dict = {"full": {g: vals[0][g] for g in self.chosen}}
        if self.n:
            grids = tile_grids(lead, self.n, (
                (b, {f"{g}/{k}": v for g in self.chosen for k, v in vals[i][g].items()})
                for i, b in enumerate(self.buckets(h, w), 1)))
            if self.mode == "subtiles_9x9":
                out["tiles"] = subtile_grids_to_3x3_device(grids)
            else:
                out["tiles"] = {k: {"mean": v} for k, v in grids.items()}
        return out

    def __call__(self, imgs, int_range=None) -> dict:
        h, w = (int(v) for v in imgs.shape[-2:])
        vals = self.direct(imgs, int_range)
        for i, bucket in self.grain_places(h, w):
            with annotate("group.grain"):
                vals[i]["grain"] = grain_from_autocorr(grain_map_core(self.image(imgs, bucket)))
        return self.tree(vals, tuple(imgs.shape[:-2]), h, w)


def speckle_device_fn(groups: frozenset, mode: str, sat: float | None, eps: float):
    """The metric step for one static configuration: ``fn(imgs,
    int_range=None)`` maps (..., H, W) frames to {"full": {group: {field:
    (...)}}, "tiles": {"group/field": {"mean", ["std"]}: (..., 3, 3)}}.

    Grain and bandwidth each run their own forward FFT, as in the JAX
    program. :func:`metric_step` runs ``fn`` as CUDA graphs on a card."""
    return _SpeckleStep(groups, mode, sat, eps)


def _map_shape(lead: tuple, h: int, w: int, bucket) -> tuple:
    """Shape of the grain maps of the frames or of one tile bucket."""
    if bucket is None:
        n = square_embed_slices((h, w))[2]
        return (*lead, n, n)
    th, tw, positions = bucket
    n = square_embed_slices((th, tw))[2]
    return (*lead, len(positions), n, n)


class _Graphs:
    """One key's step as CUDA graphs sharing one private memory pool: the
    first before the first grain map, one after each; the last packs the
    result vector. ``shown`` holds the flipped frames, ``inputs`` the view
    each grain map is copied into."""

    def __init__(self, step: _SpeckleStep, frames, int_range):
        lead, (h, w) = tuple(frames.shape[:-2]), (int(v) for v in frames.shape[-2:])
        dev, dt = frames.device, frames.dtype
        self.step = step
        self.shown = torch.empty(frames.shape, dtype=dt, device=dev)
        self.places = step.grain_places(h, w)
        shapes = [_map_shape(lead, h, w, b) for _, b in self.places]
        into_shown = [b is None and s == tuple(frames.shape) for (_, b), s in zip(self.places, shapes)]
        size = max((math.prod(s) for s, into in zip(shapes, into_shown) if not into), default=0)
        buffer = torch.empty(size, dtype=dt, device=dev)
        self.inputs = [self.shown if into else buffer[: math.prod(s)].view(s)
                       for s, into in zip(shapes, into_shown)]
        self.rows_down = device_constant(np.arange(h - 1, -1, -1), torch.int64, dev)

        vals: list = []
        packed: list = []

        def direct():
            vals.extend(step.direct(self.shown, int_range))

        def grain(i, maps):
            def segment():
                vals[i]["grain"] = grain_from_autocorr(maps)
            return segment

        segments = [direct] + [grain(i, m) for (i, _), m in zip(self.places, self.inputs)]
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(dev)
        self.graphs = []
        # the cached plans and constants the graphs read stay theirs (held)
        with torch.cuda.device(dev), holding_cached() as self.held:
            for k, segment in enumerate(segments):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    segment()
                    if k == len(segments) - 1:
                        packed.extend(pack_leaves(step.tree(vals, lead, h, w), frames.shape[0], dt))
                self.graphs.append(graph)
        self.vals = vals  # the graphs' outputs stay allocated in their pool
        self.flat, self.spec = packed

    def __call__(self, frames, flip: bool):
        if flip:
            torch.index_select(frames, -2, self.rows_down, out=self.shown)
        else:
            self.shown.copy_(frames)
        with annotate("step.graph"):
            self.graphs[0].replay()
        for (_, bucket), maps, graph in zip(self.places, self.inputs, self.graphs[1:]):
            with annotate("group.grain"):
                maps.copy_(grain_map_core(self.step.image(self.shown, bucket)))
            with annotate("step.graph"):
                graph.replay()
        # the next replay overwrites the graphs' output
        return self.flat.clone(), self.spec


def _graph_key(fn, frames, flip: bool, int_range):
    if not (isinstance(fn, _SpeckleStep) and frames.is_cuda and frames.is_contiguous()):
        return None
    return (fn.groups, fn.mode, fn.sat, fn.eps, int_range, bool(flip),
            tuple(frames.shape), frames.dtype, frames.device)


def _graphs_for(fn, frames, flip: bool, int_range):
    """The key's graphs, captured at its second sighting; None where the
    step runs eagerly."""
    key = _graph_key(fn, frames, flip, int_range)
    if key is None:
        return None
    if key in _GRAPHED:
        _GRAPHED.move_to_end(key)
        return _GRAPHED[key]
    if key not in _SEEN:
        _SEEN[key] = None
        if len(_SEEN) > _SIGHTED:
            _SEEN.popitem(last=False)
        return None
    del _SEEN[key]
    try:
        with annotate("step.capture"):
            graphs = _Graphs(fn, frames, int_range)
        GRAPH_COUNTS["graph_captures"] += 1
    except RuntimeError as err:  # an operation the capture refuses: this key stays eager
        warnings.warn(f"the metric step runs eagerly: its CUDA graph capture failed ({err})",
                      RuntimeWarning, stacklevel=3)
        graphs = None
    _GRAPHED[key] = graphs
    same = [k for k in _GRAPHED if k[-1] == key[-1]]
    if len(same) > GRAPHS_PER_DEVICE:
        torch.cuda.synchronize(key[-1])  # no replay of the graphs dropped is in flight
        del _GRAPHED[same[0]]
    return graphs


def metric_step(fn, frames, *, flip: bool, int_range=None):
    """(flat (n, L), spec): :func:`..common.pack_leaves` of the metric tree
    ``fn(shown, int_range=int_range)`` of (n, H, W) frames, ``shown`` being
    the frames after the display-origin flip where ``flip``.

    ``fn`` is :func:`speckle_device_fn`'s step or any callable that gives
    such a tree. The step of :func:`speckle_device_fn` on contiguous CUDA
    frames is replayed as CUDA graphs from the second sighting of its key
    (module docstring); everything else runs eagerly. The leaves are the
    same either way."""
    graphs = _graphs_for(fn, frames, flip, int_range)
    if graphs is not None:
        GRAPH_COUNTS["graph_replays"] += 1
        return graphs(frames, flip)
    GRAPH_COUNTS["eager_steps"] += 1
    shown = apply_display_origin(frames, display_origin="lower") if flip else frames
    return pack_leaves(fn(shown, int_range=int_range), int(frames.shape[0]), frames.dtype)
