# SPDX-License-Identifier: CECILL-2.1
"""Display origin, group selection, the tiling policy with its batched
tile executor, the tile schema, the stack chunk layout and the chunk loop
of every stack path (counterpart of ``barc4dip_tpu/metrics/common.py``).

Tiles are cut with static slices and grouped into equal-shape buckets
(split_edges gives at most two sizes per axis); each bucket becomes one
batch dimension of the estimator call, where the JAX package vmaps.

The port's stack loop runs uniform chunks of ``frame_chunk`` frames. The
JAX package ramps its first and last chunks on one device; both layouts
give equal results (``tests/test_aggregators.py``,
``test_ramped_chunk_schedule_matches_single_chunk``).

:func:`run_chunks` is the port's one chunk loop, which every stack path
runs its step through (``stack_fused``; :func:`run_stack_program`), and
not a translation: the JAX package's padded uploads, prefetch pool and
chunk ramp answer a hosted link and fixed compiled shapes, which a card on
the host's own bus and eager PyTorch do not have.
"""
from __future__ import annotations

import math
import time
import warnings
from functools import lru_cache
from typing import Callable, Literal, Sequence

import numpy as np
import torch

from ..config import device_constant, resolve_device, to_compute, upload
from ..parallel.mesh import shard_bounds
from ..utils.profiling import annotate

__all__ = [
    "TILE_GRID_SHAPE_3X3",
    "TILE_LABELS_3X3",
    "TILE_ORDER",
    "aggregate_subtiles_9x9_to_3x3",
    "apply_display_origin",
    "choose_tiling_mode",
    "chunk_from_shards",
    "chunk_layout_signature",
    "chunk_width",
    "frame_loader",
    "nan_std_grid_3x3",
    "normalize_display_origin",
    "normalize_groups",
    "pack_leaves",
    "pack_mean_std",
    "pull_to_host",
    "run_stack_program",
    "shard_loaders",
    "split_edges",
    "stack_time_series",
    "subtile_grids_to_3x3_device",
    "tile_batch",
    "tile_grids",
    "tile_plan",
    "tiled_scalar_fields",
    "tiled_scalar_fields_device",
    "tiles_meta",
    "unflatten_leaves",
    "unpack_leaves",
]

TILE_GRID_SHAPE_3X3: tuple[int, int] = (3, 3)
TILE_ORDER: str = "row-major"
TILE_LABELS_3X3: np.ndarray = np.array(
    [["NW", "N", "NE"], ["W", "C", "E"], ["SW", "S", "SE"]], dtype=object
)


def normalize_display_origin(display_origin: str) -> Literal["upper", "lower"]:
    origin = str(display_origin).strip().lower()
    if origin not in ("upper", "lower"):
        raise ValueError("display_origin must be 'upper' or 'lower'.")
    return origin


def apply_display_origin(image, *, display_origin: str):
    """Row flip of (..., H, W) images for origin="lower" (detector
    convention). A copy: torch has no negative strides."""
    if normalize_display_origin(display_origin) == "lower":
        return torch.flip(image, dims=[-2])
    return image


def split_edges(length: int, n_parts: int) -> list[tuple[int, int]]:
    """Split [0, length) into n_parts contiguous (start, stop) pairs via
    rounded linspace; the last part ends at ``length``."""
    if length < 1:
        raise ValueError("length must be >= 1.")
    if n_parts < 1:
        raise ValueError("n_parts must be >= 1.")
    edges = np.linspace(0, length, n_parts + 1)
    out: list[tuple[int, int]] = []
    for i in range(n_parts):
        a = int(round(float(edges[i])))
        b = int(round(float(edges[i + 1])))
        out.append((a, max(b, a + 1)))
    out[-1] = (out[-1][0], length)
    return out


def choose_tiling_mode(
    h: int, w: int, *, tiles: bool = False, min_tile_px: int = 128
) -> tuple[Literal["off", "tiles_3x3", "subtiles_9x9"], tuple[int, int] | None]:
    """Prefer 9x9 subtiles when (h//9, w//9) >= min_tile_px, fall back to
    direct 3x3, else warn and disable."""
    if h < 1 or w < 1:
        raise ValueError("Invalid image shape (h and w must be >= 1).")
    if min_tile_px < 1:
        raise ValueError("min_tile_px must be >= 1.")
    if not bool(tiles):
        return "off", None
    if (h // 9) >= min_tile_px and (w // 9) >= min_tile_px:
        return "subtiles_9x9", (h // 9, w // 9)
    if (h // 3) >= min_tile_px and (w // 3) >= min_tile_px:
        return "tiles_3x3", (h // 3, w // 3)
    warnings.warn(
        f"Image too small for tiling: shape=({h}, {w}), min_tile_px={min_tile_px}.",
        RuntimeWarning,
        stacklevel=2,
    )
    return "off", None


def tiles_meta(
    h: int,
    w: int,
    *,
    tile_mode: Literal["off", "tiles_3x3", "subtiles_9x9"],
    tile_shape_px: tuple[int, int] | None = None,
) -> dict:
    """The ``meta`` entries that describe a tiling."""
    meta: dict = {"tile_mode": tile_mode}
    if tile_mode == "off":
        return meta
    if tile_shape_px is None:
        raise ValueError("tile_shape_px must be provided when tile_mode is not 'off'.")
    meta.update(
        {
            "tile_grid_shape": TILE_GRID_SHAPE_3X3,
            "tile_labels": TILE_LABELS_3X3,
            "tile_order": TILE_ORDER,
            "tile_shape_px": (int(tile_shape_px[0]), int(tile_shape_px[1])),
            "used_subtiles": bool(tile_mode == "subtiles_9x9"),
        }
    )
    return meta


def nan_std_grid_3x3() -> np.ndarray:
    return np.full((3, 3), np.nan, dtype=float)


def pack_mean_std(mean, std) -> dict:
    return {"mean": np.asarray(mean, dtype=float), "std": np.asarray(std, dtype=float)}


def aggregate_subtiles_9x9_to_3x3(sub) -> tuple[np.ndarray, np.ndarray]:
    """Aggregate a 9x9 grid into 3x3 mean/std blocks (population std)."""
    arr = np.asarray(sub, dtype=float)
    if arr.shape != (9, 9):
        raise ValueError("Expected subtiles grid of shape (9, 9).")
    blocks = arr.reshape(3, 3, 3, 3).transpose(0, 2, 1, 3).reshape(3, 3, 9)
    return blocks.mean(axis=-1), blocks.std(axis=-1, ddof=0)


def chunk_width(T: int, frame_chunk: int, mesh=None) -> int:
    """Frames a chunk of the stack loop holds: ``frame_chunk`` (at most T),
    rounded up to a multiple of ``mesh.size`` under a mesh, as the JAX
    package rounds it."""
    B = max(1, min(int(frame_chunk), max(1, int(T))))
    if mesh is not None:
        B = max(1, -(-B // mesh.size)) * mesh.size
    return B


def chunk_layout_signature(T: int, frame_chunk: int, mesh=None) -> tuple:
    """Chunk starts of the port's stack loop over T frames: uniform chunks
    of :func:`chunk_width` frames. Part of a checkpoint's configuration, so
    chunks saved under one layout (a mesh of another size, or none) never
    resume under another."""
    return tuple(range(0, int(T), chunk_width(T, frame_chunk, mesh)))


@lru_cache(maxsize=256)
def tile_plan(h: int, w: int, n: int):
    """Buckets ``(tile_h, tile_w, ((row, col, y0, x0), ...))`` of an
    n x n tiling of an (h, w) image, one per tile shape."""
    buckets: dict[tuple[int, int], list[tuple[int, int, int, int]]] = {}
    for r, (y0, y1) in enumerate(split_edges(h, n)):
        for c, (x0, x1) in enumerate(split_edges(w, n)):
            buckets.setdefault((y1 - y0, x1 - x0), []).append((r, c, y0, x0))
    return tuple((th, tw, tuple(pos)) for (th, tw), pos in sorted(buckets.items()))


def tile_batch(image, bucket):
    """The (..., P, th, tw) batch of one :func:`tile_plan` bucket's tiles of
    (..., h, w) images."""
    th, tw, positions = bucket
    return torch.stack(
        [image[..., y0 : y0 + th, x0 : x0 + tw] for (_, _, y0, x0) in positions], dim=-3
    )


def tile_grids(lead: tuple, n: int, per_bucket) -> dict:
    """{field: (*lead, n, n)} grids from ``per_bucket``, an iterable of
    (bucket, {field: (*lead, P)}) over :func:`tile_plan`'s buckets; a cell no
    bucket fills reads NaN. The grid indices are device constants
    (``config.device_constant``), so no call copies them to the card."""
    grids: dict[str, torch.Tensor] = {}
    for (_, _, positions), vals in per_bucket:
        if not vals:
            continue
        dev = next(iter(vals.values())).device
        rows = device_constant([p[0] for p in positions], torch.int64, dev)
        cols = device_constant([p[1] for p in positions], torch.int64, dev)
        for k, v in vals.items():
            if k not in grids:
                grids[k] = torch.full((*lead, n, n), math.nan, dtype=v.dtype, device=v.device)
            grids[k][..., rows, cols] = v
    return grids


def tiled_scalar_fields_device(
    image, *, n: int, compute_fn: Callable[[torch.Tensor], dict]
) -> dict:
    """``compute_fn`` on every tile of an n x n grid of (..., h, w) images.

    ``compute_fn`` takes a (..., P, th, tw) batch and returns {field:
    (..., P)}. Returns {field: (..., n, n)}. One bucket's batch is alive at
    a time."""
    h, w = (int(s) for s in image.shape[-2:])
    return tile_grids(
        tuple(image.shape[:-2]), n,
        ((b, compute_fn(tile_batch(image, b))) for b in tile_plan(h, w, n)),
    )


def subtile_grids_to_3x3_device(grids: dict) -> dict:
    """(..., 9, 9) field grids -> {field: {"mean": (..., 3, 3), "std":
    (..., 3, 3)}}, population std over each 3x3 block of subtiles."""
    out = {}
    for k, g in grids.items():
        lead = g.shape[:-2]
        blocks = g.reshape(*lead, 3, 3, 3, 3).transpose(-3, -2).reshape(*lead, 3, 3, 9)
        out[k] = {"mean": blocks.mean(-1), "std": blocks.std(-1, correction=0)}
    return out


def tiled_scalar_fields(
    image,
    *,
    tile_mode: Literal["tiles_3x3", "subtiles_9x9"],
    compute_fn: Callable[[torch.Tensor], dict],
) -> dict[str, dict[str, np.ndarray]]:
    """Host-facing generic tiling executor (reference-compatible signature).

    ``compute_fn`` receives one (th, tw) tile as a tensor and returns a
    dict of scalars (tensors or numbers); it is called tile by tile, where
    the JAX package vmaps it. ``image`` is a numpy array or a tensor, which
    stays on its device. Returns ``{field: {"mean": grid3x3, "std":
    grid3x3}}`` as NumPy."""
    img = image if isinstance(image, torch.Tensor) else torch.as_tensor(np.asarray(image))
    if img.ndim != 2:
        raise ValueError(f"tiled_scalar_fields expects a 2D array, got ndim={img.ndim}")

    def scalar(v, like):
        if isinstance(v, torch.Tensor):
            return v.to(like.device)
        return torch.as_tensor(v, dtype=like.dtype, device=like.device)

    def batch_fn(batch):
        rows = [compute_fn(tile) for tile in batch]
        return {k: torch.stack([scalar(r[k], batch) for r in rows]) for k in rows[0]}

    if tile_mode == "tiles_3x3":
        grids = tiled_scalar_fields_device(img, n=3, compute_fn=batch_fn)
        nan_std = nan_std_grid_3x3()
        return {k: pack_mean_std(v.cpu().numpy(), nan_std) for k, v in grids.items()}
    if tile_mode == "subtiles_9x9":
        grids = tiled_scalar_fields_device(img, n=9, compute_fn=batch_fn)
        return {
            k: pack_mean_std(*aggregate_subtiles_9x9_to_3x3(sub.cpu().numpy()))
            for k, sub in grids.items()
        }
    raise ValueError("tile_mode must be 'tiles_3x3' or 'subtiles_9x9'.")


# ---------------------------------------------------------------------------
# Chunked stack execution
# ---------------------------------------------------------------------------

def _loader(stack, device):
    """``load(c0, c1)``: frames [c0, c1) of a host stack uploaded to
    ``device`` (:func:`..config.upload`), or of a tensor stack moved there
    (a no-op on its own device) and cast there, as a compute-dtype tensor."""
    if isinstance(stack, torch.Tensor):
        return lambda c0, c1: to_compute(stack[c0:c1].to(device))
    return lambda c0, c1: upload(stack[c0:c1], device)


def frame_loader(stack, device=None, mesh=None):
    """(device, load): ``load(c0, c1)`` gives frames [c0, c1) of a host
    stack or a tensor stack as a compute-dtype tensor on ``device``. A
    tensor stack stays on its own device. Under a ``mesh``, a host stack
    loads onto the mesh's first device and ``device`` is not used."""
    if isinstance(stack, torch.Tensor):
        device = stack.device
    else:
        device = resolve_device(mesh.devices[0] if mesh is not None else device)
    return device, _loader(stack, device)


def shard_loaders(stack, device=None, mesh=None) -> list:
    """One (device, load) per shard of a chunk: :func:`frame_loader`'s
    alone without a mesh, else one a mesh entry, loading onto that entry's
    device."""
    if mesh is None:
        return [frame_loader(stack, device)]
    return [(dev, _loader(stack, dev)) for dev in mesh.devices]


def chunk_from_shards(shards) -> dict:
    """The {path: array} leaves of a chunk from its shards' ``(host, event,
    spec)`` (:func:`pull_to_host`, :func:`pack_leaves`), in frame order,
    each read once its copy is done."""
    parts = []
    for host, ready, spec in shards:
        if ready is not None:
            ready.synchronize()
        parts.append(unpack_leaves(host.numpy(), spec))
    return {path: np.concatenate([p[path] for p in parts]) for path in parts[0]}


def pull_to_host(flat: torch.Tensor, device: torch.device):
    """(host tensor, event): ``flat`` copied into pinned host memory without
    blocking, and the event that marks the copy done on ``device``'s current
    stream; on the CPU, ``flat`` itself and no event."""
    if device.type != "cuda":
        return flat, None
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    return host, ready


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}\0")
        else:
            yield f"{prefix}{k}", v


def unflatten_leaves(flat: dict) -> dict:
    """{path: leaf} with NUL-separated paths -> the nested tree."""
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("\0")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def pack_leaves(tree: dict, n: int, dtype):
    """Every leaf of a tree of (n, ...) tensors as one (n, L) tensor of
    ``dtype``, and the (path, shape) spec that :func:`unpack_leaves` reads."""
    spec, cols = [], []
    for path, v in _leaves(tree):
        spec.append((path, tuple(v.shape)))
        cols.append(v.reshape(n, -1).to(dtype))
    return torch.cat(cols, dim=1), spec


def unpack_leaves(flat: np.ndarray, spec) -> dict:
    """The {path: array} leaves of a :func:`pack_leaves` vector on the host."""
    out, off = {}, 0
    for path, shape in spec:
        k = int(np.prod(shape[1:], dtype=np.int64))
        out[path] = flat[:, off : off + k].reshape(shape)
        off += k
    return out


def run_chunks(stack, step, *, frame_chunk: int = 4, mesh=None, checkpoint=None, device=None):
    """The chunk loop of every stack path: ``(tree, record)`` of a (T, H,
    W) host array or tensor run in uniform chunks of ``frame_chunk`` frames
    (:func:`chunk_layout_signature`), each cut into one contiguous shard a
    placement (:func:`shard_loaders`; a tail chunk's empty shards skipped).

    For each shard, ``step(device, first, carry)`` runs under ``chunk``
    before the shard's load, so what it reads of the stack stays outside
    the load and the enqueue, and returns ``enqueue(shard) -> (flat, spec,
    carry)``, run under ``chunk.enqueue``: it pops the shard's frames
    (compute dtype, on ``device``) from the one-item list ``shard``, so the
    loop keeps no reference that would outlive a copy the step makes, and
    enqueues their (n, L) result vector and its :func:`pack_leaves` spec.
    ``first`` is the shard's first frame; ``carry`` is the previous
    ``enqueue``'s, ``None`` for the
    first shard run and after a chunk loaded from ``checkpoint`` (a
    :class:`..utils.checkpoint.ChunkStore`: chunks it holds are loaded, the
    others run and are saved as their leaf tree). Each vector is pulled
    without blocking and read one chunk behind.

    ``tree``: every leaf with a leading T axis, as NumPy. ``record``:
    ``upload_s`` (host seconds in a host stack's loads), ``upload_io_s``
    (the card's time for those copies and casts, by CUDA events, the
    largest sum over the devices; ``upload_s`` off a card), ``dispatch_s``
    (host seconds from each load's end to its pull's enqueue),
    ``pull_wait_s`` (waiting for and unpacking the pulls: the device time
    shows here), ``upload_bytes`` (in the frames' own dtype),
    ``pull_bytes``, ``chunks`` (run, not loaded), ``resident: True`` for a
    tensor stack."""
    placements = shard_loaders(stack, device, mesh)
    T = int(stack.shape[0])
    width = -(-chunk_width(T, frame_chunk, mesh) // len(placements))
    resident = isinstance(stack, torch.Tensor)
    frame_bytes = 0 if resident else math.prod(stack.shape[1:]) * np.dtype(stack.dtype).itemsize
    record = {"upload_s": 0.0, "dispatch_s": 0.0, "pull_wait_s": 0.0, "upload_bytes": 0, "pull_bytes": 0,
              "chunks": 0}
    if resident:
        record["resident"] = True
    copies: dict = {}  # device -> [(start, end)]: CUDA events around each host-stack load
    pieces: dict[int, dict] = {}
    pending = carry = None

    def collect(c0, shards):
        t0 = time.perf_counter()
        with annotate("pull.wait"):
            piece = chunk_from_shards(shards)
        record["pull_wait_s"] += time.perf_counter() - t0
        if checkpoint is not None:
            checkpoint.save(c0, unflatten_leaves(piece))
        pieces[c0] = piece

    starts = chunk_layout_signature(T, frame_chunk, mesh)
    for c0, c1 in zip(starts, (*starts[1:], T)):
        with annotate("chunk"):
            if checkpoint is not None and checkpoint.has(c0):
                pieces[c0] = dict(_leaves(checkpoint.load(c0)))
                carry = None
                continue
            shards = []
            for (a, b), (dev, load) in zip(shard_bounds(c0, c1, len(placements), width), placements):
                if a == b:  # the tail chunk leaves the last shards empty
                    continue
                enqueue = step(dev, a, carry)
                timed_copy = not resident and dev.type == "cuda"
                if timed_copy:
                    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    ev[0].record(torch.cuda.current_stream(dev))
                t0 = time.perf_counter()
                shard = [load(a, b)]
                t1 = time.perf_counter()
                if timed_copy:
                    ev[1].record(torch.cuda.current_stream(dev))
                    copies.setdefault(dev, []).append(ev)
                if not resident:
                    record["upload_s"] += t1 - t0
                    record["upload_bytes"] += (b - a) * frame_bytes
                with annotate("chunk.enqueue"):  # one vector per shard leaves the device
                    flat, spec, carry = enqueue(shard)
                    shards.append((*pull_to_host(flat, dev), spec))
                record["dispatch_s"] += time.perf_counter() - t1
                record["pull_bytes"] += flat.numel() * flat.element_size()
            record["chunks"] += 1
            if pending is not None:
                collect(*pending)
            pending = (c0, shards)
    if pending is not None:
        collect(*pending)
    if copies:  # every copy precedes a result pull that collect waited for
        record["upload_io_s"] = max(sum(a.elapsed_time(b) for a, b in evs) for evs in copies.values()) / 1e3
    else:
        record["upload_io_s"] = record["upload_s"]

    with annotate("entry.assemble"):
        ordered = [pieces[c0] for c0 in sorted(pieces)]
        tree = unflatten_leaves({path: np.concatenate([p[path] for p in ordered]) for path in ordered[0]})
    return tree, record


def run_stack_program(
    stack, program, *, frame_chunk: int = 4, flip: bool = False, mesh=None,
    checkpoint=None, device=None,
):
    """Run a per-frame metric program over a (T, H, W) numpy array or
    tensor through :func:`run_chunks`.

    ``program`` maps (B, H, W) frames in their compute dtype (a numpy
    stack's chunks uploaded in their own dtype, a tensor stack sliced on its
    own device, integer frames cast on the device) to a tree of (B, ...)
    tensors; with ``flip`` the rows are reversed on the device first. With
    ``mesh`` (:func:`..parallel.frame_mesh`) a chunk holds a multiple of
    ``mesh.size`` frames, cut into one shard a mesh entry that runs on its
    device; ``device`` is then not used.

    Returns the program's tree with a leading T axis, as NumPy."""

    def enqueue(shard):
        frames = shard.pop()
        if flip:
            frames = torch.flip(frames, dims=[-2])
        with annotate("step.metrics"):
            result = program(frames)
        return (*pack_leaves(result, frames.shape[0], frames.dtype), None)

    tree, _ = run_chunks(
        stack, lambda dev, first, carry: enqueue, frame_chunk=frame_chunk, mesh=mesh,
        checkpoint=checkpoint, device=device,
    )
    return tree


# ---------------------------------------------------------------------------
# Time series stacking and group selection (host-side)
# ---------------------------------------------------------------------------

def stack_time_series(values: list):
    """Stack per-frame outputs along a new leading time axis (recursive for
    dicts; arrays and tensors via np.stack; scalars into a 1D array)."""
    if not values:
        raise ValueError("No values provided for stacking.")
    v0 = values[0]
    if isinstance(v0, dict):
        return {k: stack_time_series([v[k] for v in values]) for k in v0.keys()}
    if isinstance(v0, torch.Tensor):
        return np.stack([v.detach().cpu().numpy() for v in values], axis=0)
    if isinstance(v0, np.ndarray):
        return np.stack([np.asarray(v) for v in values], axis=0)
    if isinstance(v0, (float, int, np.floating, np.integer, bool, np.bool_)):
        return np.asarray(values)
    return list(values)


def normalize_groups(
    groups: str | Sequence[str],
    *,
    all_groups: set[str],
    context: str,
    param_name: str = "metrics",
) -> set[str]:
    """Parse "all" / comma-string / sequence group selectors with validation."""
    if isinstance(groups, str):
        keys = {g.strip() for g in groups.split(",")} if "," in groups else {groups.strip()}
    elif isinstance(groups, Sequence):
        keys = set()
        for g in groups:
            if not isinstance(g, str):
                raise TypeError(f"{context}: {param_name} must be str or a sequence of str")
            keys.add(g.strip())
    else:
        raise TypeError(f"{context}: {param_name} must be str or a sequence of str")
    if "all" in keys:
        return set(all_groups)
    unknown = sorted(k for k in keys if k not in all_groups)
    if unknown:
        allowed = ", ".join(sorted(all_groups))
        bad = ", ".join(unknown)
        raise ValueError(
            f"{context}: unknown {param_name} group(s): {bad}. Allowed: {allowed}"
        )
    return keys
