# SPDX-License-Identifier: CECILL-2.1
"""Declarative figure scaffolding shared by every plot module (the port's
own copy of ``barc4dip_tpu/plotting/_scaffold.py``, with :func:`host_array`).

This package's plotting layer is organised differently from the reference
(which repeats imperative axis/limit/grid branches inside each function,
reference plotting/image.py, spectral.py, stack.py): here every public
plot assembles a small :class:`Frame` description — labels, limits, axis
scales, grid flavour — plus data marks, and a single applier (:func:`dress`)
realises the description. Shared quantities (trapezoid CDFs, percentile
positions, pixel-centered extents, metric-path/unit resolution, 3x3 tile
blocks) live here once, so the figure conventions cannot drift between the
image, spectral and stack modules.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import matplotlib.pyplot as plt
import numpy as np
import torch

from ..utils.lazy import _LazyArrayBase
from .style import start_plotting

# one place for the shared look: dotted grids, the accent colours the
# whole layer uses for markers/overlays
GRID_KW = dict(linestyle=":", linewidth=0.5)
MARKER_COLOR = "olive"      # percentile verticals
PRIMARY = "steelblue"       # main curve / histogram
SECONDARY = "darkred"       # cuts, CDF overlays
TINY_FLOOR = 1e-300         # log-axis bottom guard

GRID3_LABELS = np.array(
    [["NW", "N", "NE"], ["W", "C", "E"], ["SW", "S", "SE"]], dtype=object
)


def need(condition: bool, message: str, exc: type[Exception] = ValueError):
    """Single-line guard used across the layer (exception type explicit)."""
    if not condition:
        raise exc(message)


# ---------------------------------------------------------------- frames


@dataclass
class Frame:
    """What a finished pair of axes should look like, as data."""

    xlabel: str | None = None
    ylabel: str | None = None
    title: str | None = None
    title_size: float | None = None
    xlim: tuple[float | None, float | None] = (None, None)
    ylim: tuple[float | None, float | None] = (None, None)
    logx: bool = False
    logy: bool = False
    grid: str | None = "dots"  # "dots" | "dots-x" | "soft" | None
    box_ticks: bool = False
    legend: dict | None = None
    extras: dict = field(default_factory=dict)


def dress(ax, frame: Frame) -> None:
    """Realise a :class:`Frame` on existing axes (the only code path that
    touches scales/limits/grids, for every plot in the layer)."""
    if frame.xlabel is not None:
        ax.set_xlabel(frame.xlabel)
    if frame.ylabel is not None:
        ax.set_ylabel(frame.ylabel)
    if frame.title:
        ax.set_title(frame.title, fontsize=frame.title_size)
    if frame.logx:
        ax.set_xscale("log")
    if frame.logy:
        ax.set_yscale("log")
    lo, hi = frame.xlim
    if lo is not None or hi is not None:
        ax.set_xlim(left=lo, right=hi)
    lo, hi = frame.ylim
    if lo is not None or hi is not None:
        ax.set_ylim(bottom=lo, top=hi)
    if frame.grid == "dots":
        ax.grid(True, which="both", **GRID_KW)
    elif frame.grid == "dots-x":
        ax.grid(True, which="both", axis="x", **GRID_KW)
    elif frame.grid == "soft":
        ax.grid(True, alpha=0.3)
    if frame.box_ticks:
        ax.tick_params(direction="in", top=True, right=True)
    if frame.legend is not None:
        ax.legend(**frame.legend)


def canvas(k: float, *, size: tuple[float, float]):
    """rcParams-scaled figure + single axes."""
    start_plotting(k)
    return plt.subplots(figsize=size)


# ------------------------------------------------------ numeric helpers


def host_array(x):
    """A tensor (CPU or CUDA) or a lazy map as a numpy array on the host;
    anything else as it is, so each plot's own checks still see it."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, _LazyArrayBase):
        return np.asarray(x)
    return x


def finite_xy(x: np.ndarray, y: np.ndarray):
    """Jointly finite samples of a curve, as float arrays."""
    keep = np.isfinite(x) & np.isfinite(y)
    return np.asarray(x[keep], float), np.asarray(y[keep], float)


def log_safe(y: np.ndarray) -> np.ndarray:
    """Non-positive samples -> NaN so log axes drop them silently."""
    return np.where(y > 0.0, y, np.nan)


def log_floor(y: np.ndarray) -> float | None:
    """A sensible log-axis bottom: half the smallest positive sample."""
    pos = y[np.isfinite(y) & (y > 0.0)]
    if pos.size == 0:
        return None
    return max(0.5 * float(pos.min()), TINY_FLOOR)


def trapz_cdf(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Normalised cumulative trapezoid integral of max(y, 0) along x.

    Shared by the percentile markers and the CDF overlay so both always
    agree on where mass sits (reference computes it inline twice)."""
    w = np.clip(y, 0.0, None)
    area = np.concatenate(
        [[0.0], np.cumsum(0.5 * (w[:-1] + w[1:]) * np.abs(np.diff(x)))]
    )
    return area / area[-1] if area[-1] > 0.0 else area


def checked_percentiles(p) -> np.ndarray:
    pv = np.asarray(p, dtype=float)
    need(not np.any((pv < 0) | (pv > 100)), "percentiles must be in [0, 100]")
    return pv


def mark_verticals(ax, positions) -> None:
    for xv in np.atleast_1d(positions):
        ax.axvline(float(xv), color=MARKER_COLOR, linewidth=1.5)


def cdf_overlay(ax, x, cdf) -> None:
    """Twin-axis cumulative curve in the layer's secondary colour."""
    twin = ax.twinx()
    twin.plot(x, cdf, color=SECONDARY, linewidth=1.5)
    twin.set_ylabel("cumulative")
    twin.set_ylim(-0.05, 1.05)


def half_step(vals: np.ndarray) -> float:
    """Half the mean grid step (0.5 for a single sample)."""
    return 0.5 * (1.0 if vals.size <= 1 else float(np.mean(np.diff(vals))))


def node_extent(x: np.ndarray, y: np.ndarray):
    """imshow extent centering each cell on its node coordinate."""
    hx, hy = half_step(x), half_step(y)
    return (
        float(x[0]) - hx, float(x[-1]) + hx,
        float(y[0]) - hy, float(y[-1]) + hy,
    )


# ----------------------------------------------- stats-dict conventions


def split_path(metric_path) -> tuple[str, str]:
    """'grain.lx' / 'grain/lx' / ('grain', 'lx') -> (group, metric)."""
    if isinstance(metric_path, str):
        parts = [p for p in metric_path.replace("/", ".").split(".") if p]
    else:
        parts = list(metric_path)
    need(len(parts) == 2, "metric_path must be like ('grain','lx') or 'grain.lx'")
    return str(parts[0]), str(parts[1])


def unit_of(meta: dict, group: str, metric: str) -> str | None:
    table = meta.get("units", {})
    entry = table.get(group) if isinstance(table, dict) else None
    return entry.get(metric) if isinstance(entry, dict) else None


def labelled(metric: str, unit: str | None) -> str:
    """Metric label with its unit appended when one is known."""
    if isinstance(unit, str) and unit.strip():
        return f"{metric} ({unit})"
    return metric


def grid3_labels(meta: dict) -> np.ndarray:
    labels = meta.get("tile_labels")
    if isinstance(labels, np.ndarray) and labels.shape == (3, 3):
        return labels
    return GRID3_LABELS


def tile_block(tiles: dict, group: str, metric: str) -> dict:
    """The mean/std dict for one tile metric (KeyError when absent — part
    of the public contract, tested)."""
    group_entry = tiles.get(group)
    need(isinstance(group_entry, dict), f"tiles has no group {group!r}", KeyError)
    entry = group_entry.get(metric)
    need(
        isinstance(entry, dict),
        f"tiles[{group!r}] has no metric {metric!r}", KeyError,
    )
    return entry


def stats_blocks(stats: dict, *names: str) -> tuple:
    """Required top-level dict blocks of a stats result, in order."""
    out = []
    for name in names:
        block = stats.get(name)
        need(
            isinstance(block, dict),
            f"a stats dict with a {name!r} block is required",
        )
        out.append(block)
    return tuple(out)


# ----------------------------------------------------------- rendering


def attach_cbar(fig, ax, mappable, label: str | None = None, *,
                width: str = "5%", pad: float = 0.05):
    """Size-matched colorbar (axes_grid1) used by every image-like plot."""
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    cax = make_axes_locatable(ax).append_axes("right", size=width, pad=pad)
    bar = fig.colorbar(mappable, cax=cax)
    if label is not None:
        bar.set_label(label)
    return bar


def rgba_capture(fig) -> np.ndarray:
    """Rendered RGB pixels of a figure (for GIF/PNG sequence export)."""
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
