# SPDX-License-Identifier: CECILL-2.1
"""Speckle stack statistics (counterpart of
``barc4dip_tpu/metrics/speckles.py::speckle_stack_stats``): per-frame
metrics stacked over time plus abs/inc translation tracking of a central
3x3 ROI grid, with the same ``meta`` / ``full`` / ``tiles`` / ``temporal``
dict.
"""
from __future__ import annotations

import logging
import time
from typing import Literal, Sequence

import numpy as np
import torch

from ..config import MIN_TILE_PX
from ..geometry.roi import odd_size, roi_grid_3x3
from .common import choose_tiling_mode, normalize_display_origin, normalize_groups
from .estimators import grain_core
from .stack_fused import run_fused_speckle_stack

logger = logging.getLogger(__name__)

__all__ = ["speckle_stack_stats", "tracking_grid_from_frame0"]

_SPECKLE_UNITS: dict[str, dict[str, str]] = {
    "amplitude": {"visibility": "", "contrast": ""},
    "stats": {
        "mean": "a.u.",
        "std": "a.u.",
        "variance": "a.u.^2",
        "skewness": "",
        "kurtosis": "",
        "frac_zero": "",
        "frac_sat": "",
        "SNRdB": "dB",
    },
    "grain": {
        "lx": "px",
        "ly": "px",
        "leq": "px",
        "r": "",
        "xlag": "px",
        "ylag": "px",
        "autocorr": "",
    },
    "bandwidth": {
        "spr": "",
        "feq": "1/px",
        "f95": "1/px",
        "sig_fx": "1/px",
        "sig_fy": "1/px",
        "rf": "",
    },
    "temporal": {
        "dx": "px",
        "dy": "px",
        "r": "px",
        "std_dx": "px",
        "std_dy": "px",
        "std_r": "px",
    },
}

_ALL_SPECKLE_GROUPS: set[str] = {"amplitude", "grain", "bandwidth", "stats"}

_GRAIN_MIN_PX = 128


def tracking_grid_from_frame0(
    stack, *, roi_grain_factor: float = 3.0, roi_step_factor: float = 0.5
):
    """3x3 tracking-ROI geometry sized from frame-0 grain:
    (grid_slices, grid_labels, roi_side, step, grain0).

    Frame 0 is sized on the CPU, in float32 unless the stack is float64,
    as the JAX package does, so ``roi_side`` comes out identical."""
    T, H, W = (int(s) for s in stack.shape)
    frame0 = np.asarray(stack[0], np.float64 if stack.dtype == np.float64 else np.float32)
    g0 = grain_core(torch.from_numpy(frame0))
    grain0 = {k: float(g0[k]) for k in ("lx", "ly", "leq", "r")}

    l = float(np.nanmax([grain0["lx"], grain0["ly"], grain0["leq"]]))
    if not np.isfinite(l) or l <= 0:
        raise ValueError("Could not infer a valid grain size from frame 0 (lx/ly/leq).")
    roi_side = odd_size(int(np.ceil(roi_grain_factor * l)))
    step = int(max(1, round(roi_step_factor * roi_side)))
    grid_slices, grid_labels = roi_grid_3x3(
        (H, W), (roi_side, roi_side), (step, step), center_yx=None
    )
    return grid_slices, grid_labels, roi_side, step, grain0


def _assemble_stack_output(raw: dict, mode: str) -> tuple[dict, dict | None]:
    """Stacked raw results -> the reference (full, tiles) schema."""
    out_full = {g: dict(raw["full"][g]) for g in ("amplitude", "grain", "stats", "bandwidth")
                if g in raw["full"]}
    if mode == "off" or "tiles" not in raw:
        return out_full, None
    out_tiles: dict = {}
    for key, v in raw["tiles"].items():
        g, f = key.split("/", 1)
        mean = v["mean"]
        std = v["std"] if mode == "subtiles_9x9" else np.full(mean.shape, np.nan)
        out_tiles.setdefault(g, {})[f] = {"mean": mean, "std": std}
    return out_full, out_tiles


def _not_covered(what: str, item: str):
    return NotImplementedError(
        f"speckle_stack_stats: {what} is not ported yet (ROADMAP.md, {item})"
    )


def speckle_stack_stats(
    stack,
    *,
    metrics: str | Sequence[str] = "all",
    tiles: bool = True,
    display_origin: Literal["upper", "lower"] = "lower",
    roi_grain_factor: float = 3.0,
    roi_step_factor: float = 0.5,
    tracking_method: str = "template",
    tracking_backend: Literal["internal", "skimage", "opencv"] = "skimage",
    subpixel: bool = True,
    saturation_value: float | None = 65535.0,
    eps: float = 1e-6,
    verbose: bool = True,
    parallel: bool = True,
    n_jobs: int | None = None,
    frame_chunk: int = 4,
    mesh=None,
    checkpoint_dir=None,
    grain_maps: bool = True,
    tracking_search_radius: float | None = None,
    device=None,
) -> dict:
    """Per-frame speckle metrics stacked over time plus abs/inc template
    tracking of a central 3x3 ROI grid, for a host (T, H, W) stack.

    Frames run in chunks of ``frame_chunk`` on ``device`` (default: cuda
    when present). ``parallel``/``n_jobs``/``tracking_backend`` are
    accepted for API parity. Not covered yet, and raising
    ``NotImplementedError``: ``grain_maps=True`` (pass False),
    ``mesh``, ``checkpoint_dir``, ``tracking_search_radius``,
    ``tracking_method="phase"`` and a device-resident (tensor) stack."""
    t0 = time.perf_counter()
    if isinstance(stack, torch.Tensor):
        raise _not_covered("a device-resident stack", "Queue 1 item 5, resident path")
    if not isinstance(stack, np.ndarray):
        raise TypeError("speckle_stack_stats expects a numpy.ndarray")
    if stack.ndim != 3:
        raise ValueError(
            f"stack must be a 3D array with shape (T, H, W); got ndim={stack.ndim}"
        )
    T, H, W = (int(s) for s in stack.shape)
    if T < 1:
        raise ValueError("stack must contain at least one frame.")

    serial_mode = (not parallel) or (n_jobs is not None and int(n_jobs) <= 1)
    groups = normalize_groups(
        metrics, all_groups=_ALL_SPECKLE_GROUPS, context="speckles", param_name="metrics"
    )
    if "grain" in groups and min(H, W) < _GRAIN_MIN_PX:
        raise ValueError("image too small for speckle grain metrics (min dimension < 128).")
    method_norm = str(tracking_method).strip().lower()
    if method_norm not in ("template", "phase"):
        raise ValueError(f"Unsupported tracking method for stacks: {tracking_method!r}")
    if method_norm == "phase":
        raise _not_covered("tracking_method='phase'", "Queue 1 item 5")
    if tracking_search_radius is not None:
        raise _not_covered("tracking_search_radius", "Queue 1 item 5")
    if mesh is not None:
        raise _not_covered("mesh", "Queue 1 item 12")
    if checkpoint_dir is not None:
        raise _not_covered("checkpoint_dir", "Queue 1 item 5")
    if grain_maps and "grain" in groups:
        raise _not_covered("grain_maps=True (lazy grain maps)", "Queue 1 item 5")
    flip = normalize_display_origin(display_origin) == "lower"

    mode, _tile_shape = choose_tiling_mode(H, W, tiles=tiles, min_tile_px=MIN_TILE_PX)
    grid_slices, grid_labels, roi_side, step, grain0 = tracking_grid_from_frame0(
        stack, roi_grain_factor=roi_grain_factor, roi_step_factor=roi_step_factor
    )
    raw_metrics, track = run_fused_speckle_stack(
        stack,
        grid_slices,
        groups=groups,
        mode=mode,
        sat=None if saturation_value is None else float(saturation_value),
        eps=float(eps),
        flip=flip,
        subpixel=bool(subpixel),
        track_eps=1e-9,
        frame_chunk=frame_chunk,
        device=device,
    )
    out_full, out_tiles = _assemble_stack_output(raw_metrics, mode)
    dx_abs_tiles, dy_abs_tiles, dx_inc_tiles, dy_inc_tiles = track

    def _agg(a):
        return (
            np.nanmean(a, axis=(1, 2)).astype(np.float32),
            np.nanstd(a, axis=(1, 2)).astype(np.float32),
        )

    temporal: dict = {"qc": {"roi_grid_shape": (3, 3)}}
    for kind, dx, dy in (("abs", dx_abs_tiles, dy_abs_tiles), ("inc", dx_inc_tiles, dy_inc_tiles)):
        aggs = {name: _agg(a) for name, a in (("dx", dx), ("dy", dy), ("r", np.sqrt(dx**2 + dy**2)))}
        temporal[kind] = {
            **{name: m for name, (m, _s) in aggs.items()},
            **{f"std_{name}": s for name, (_m, s) in aggs.items()},
        }

    meta: dict = {
        "kind": "speckle_stack_stats",
        "input_shape": (H, W),
        "stack_shape": (T, H, W),
        "n_frames": T,
        "display_origin": display_origin,
        "units": _SPECKLE_UNITS,
        "grain0": {k: grain0.get(k) for k in ("lx", "ly", "leq", "r")},
        "tracking": {
            "method": str(tracking_method),
            "backend": str(tracking_backend),
            "subpixel": bool(subpixel),
            "peak_mode": "abs",
            "search_area": "full_frame",
            "normalization": {"template": "zscore_local", "search": "zscore_global"},
            "roi_grain_factor": float(roi_grain_factor),
            "roi_size_yx": (int(roi_side), int(roi_side)),
            "roi_step_factor": float(roi_step_factor),
            "roi_step_yx": (int(step), int(step)),
            "roi_labels": grid_labels,
            "roi_order": "row-major",
        },
        "parallel": {
            "enabled": bool(not serial_mode),
            "device_batched": True,
            "frame_chunk": int(frame_chunk),
        },
    }
    out: dict = {"meta": meta, "full": out_full, "temporal": temporal}
    if out_tiles is not None:
        out["tiles"] = out_tiles
    if verbose:
        logger.info(
            "> speckle_stack_stats | frames=%d | roi=%dx%d | step=%d | elapsed=%.1f s",
            T, roi_side, roi_side, step, time.perf_counter() - t0,
        )
    return out
