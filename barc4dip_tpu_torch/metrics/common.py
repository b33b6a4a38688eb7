# SPDX-License-Identifier: CECILL-2.1
"""Display origin, group selection, the tiling policy with its batched
tile executor, the tile schema and the stack chunk layout (counterpart of
``barc4dip_tpu/metrics/common.py``).

Tiles are cut with static slices and grouped into equal-shape buckets
(split_edges gives at most two sizes per axis); each bucket becomes one
batch dimension of the estimator call, where the JAX package vmaps.

The port's stack loop runs uniform chunks of ``frame_chunk`` frames. The
JAX package ramps its first and last chunks on one device; both layouts
give equal results (``tests/test_aggregators.py``,
``test_ramped_chunk_schedule_matches_single_chunk``).
"""
from __future__ import annotations

import math
import warnings
from functools import lru_cache
from typing import Callable, Literal, Sequence

import numpy as np
import torch

__all__ = [
    "TILE_GRID_SHAPE_3X3",
    "TILE_LABELS_3X3",
    "TILE_ORDER",
    "apply_display_origin",
    "choose_tiling_mode",
    "chunk_layout_signature",
    "nan_std_grid_3x3",
    "normalize_display_origin",
    "normalize_groups",
    "pack_mean_std",
    "split_edges",
    "subtile_grids_to_3x3_device",
    "tile_plan",
    "tiled_scalar_fields_device",
    "tiles_meta",
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


def chunk_layout_signature(T: int, frame_chunk: int) -> tuple:
    """Chunk starts of the port's stack loop over T frames: uniform chunks
    of ``frame_chunk`` (at most T) frames. Part of a checkpoint's
    configuration, so chunks saved under one layout never resume under
    another."""
    B = max(1, min(int(frame_chunk), max(1, int(T))))
    return tuple(range(0, int(T), B))


@lru_cache(maxsize=256)
def tile_plan(h: int, w: int, n: int):
    """Buckets ``(tile_h, tile_w, ((row, col, y0, x0), ...))`` of an
    n x n tiling of an (h, w) image, one per tile shape."""
    buckets: dict[tuple[int, int], list[tuple[int, int, int, int]]] = {}
    for r, (y0, y1) in enumerate(split_edges(h, n)):
        for c, (x0, x1) in enumerate(split_edges(w, n)):
            buckets.setdefault((y1 - y0, x1 - x0), []).append((r, c, y0, x0))
    return tuple((th, tw, tuple(pos)) for (th, tw), pos in sorted(buckets.items()))


def tiled_scalar_fields_device(
    image, *, n: int, compute_fn: Callable[[torch.Tensor], dict]
) -> dict:
    """``compute_fn`` on every tile of an n x n grid of (..., h, w) images.

    ``compute_fn`` takes a (..., P, th, tw) batch and returns {field:
    (..., P)}. Returns {field: (..., n, n)}."""
    h, w = (int(s) for s in image.shape[-2:])
    grids: dict[str, torch.Tensor] = {}
    for th, tw, positions in tile_plan(h, w, n):
        batch = torch.stack(
            [image[..., y0 : y0 + th, x0 : x0 + tw] for (_, _, y0, x0) in positions],
            dim=-3,
        )
        rows = [p[0] for p in positions]
        cols = [p[1] for p in positions]
        for k, v in compute_fn(batch).items():
            if k not in grids:
                grids[k] = torch.full(
                    (*image.shape[:-2], n, n), math.nan, dtype=v.dtype, device=v.device
                )
            grids[k][..., rows, cols] = v
    return grids


def subtile_grids_to_3x3_device(grids: dict) -> dict:
    """(..., 9, 9) field grids -> {field: {"mean": (..., 3, 3), "std":
    (..., 3, 3)}}, population std over each 3x3 block of subtiles."""
    out = {}
    for k, g in grids.items():
        lead = g.shape[:-2]
        blocks = g.reshape(*lead, 3, 3, 3, 3).transpose(-3, -2).reshape(*lead, 3, 3, 9)
        out[k] = {"mean": blocks.mean(-1), "std": blocks.std(-1, correction=0)}
    return out


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
