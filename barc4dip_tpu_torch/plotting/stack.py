# SPDX-License-Identifier: CECILL-2.1
"""Stack plots: displacement trajectories/time series, metric series,
tile-overlay animations and dense displacement fields.

Same capability surface as reference plotting/stack.py:101,340
(plt_displacement / plt_stack_metric) plus two extensions with no
reference counterpart (plt_tiles_metric_stack, plt_displacement_field).
Rebuilt on the package's declarative scaffold: series data is first pulled
into a plain :class:`_Motion` record, then rendered by one marked-series
painter shared across every mode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Sequence

import matplotlib.pyplot as plt
import numpy as np
from matplotlib.figure import Figure

from . import _scaffold as sc

__all__ = [
    "plt_displacement",
    "plt_displacement_field",
    "plt_stack_metric",
    "plt_tiles_metric_stack",
]

_TemporalKey = Literal["abs", "inc"]
_ViewKind = Literal["trajectory", "timeseries"]
_Uncertainty = Literal["none", "band", "errorbar"]
_StatsScope = Literal["full", "tiles", "both"]

#: tile-curve styling: 9 distinguishable markers, colormap-spread colours
_TILE_MARKERS = ("o", "s", "^", "v", "D", "P", "X", "<", ">")


def _marked_series(ax, t, y, *, color, label=None, marker="o", size=3.0,
                   spread: _Uncertainty = "none", width=None) -> None:
    """The layer's one line+marker painter: open-face markers, optional
    band/errorbar uncertainty around the curve."""
    ax.plot(t, y, color=color, linewidth=1.0, linestyle="-", label=label,
            marker=marker, markersize=size, markerfacecolor="white",
            markeredgecolor=color, markeredgewidth=1.1)
    if spread == "none" or width is None:
        return
    if spread == "band":
        ax.fill_between(t, y - width, y + width, alpha=0.2, color=color)
    elif spread == "errorbar":
        ax.errorbar(t, y, yerr=width, fmt="none", elinewidth=0.8, capsize=0,
                    color=color)
    else:
        raise ValueError(f"unknown uncertainty={spread!r}")


# ----------------------------------------------------- displacement data


@dataclass
class _Motion:
    """Displacement series pulled out of a stats dict or raw arrays."""

    dx: np.ndarray
    dy: np.ndarray
    r: np.ndarray | None = None
    sx: np.ndarray | None = None
    sy: np.ndarray | None = None
    sr: np.ndarray | None = None
    unit: str = "px"

    def pruned(self, *, with_r: bool, with_std: bool) -> "_Motion":
        """Jointly-finite samples over whichever series the view needs."""
        n = self.dx.size
        for name in ("dy", "r", "sx", "sy", "sr"):
            arr = getattr(self, name)
            label = {"sx": "std_dx", "sy": "std_dy", "sr": "std_r"}.get(name, name)
            sc.need(arr is None or arr.size == n,
                    f"{label} must match dx length; got "
                    f"{arr.size if arr is not None else 0} vs {n}")
        keep = np.isfinite(self.dx) & np.isfinite(self.dy)
        if with_r and self.r is not None:
            keep &= np.isfinite(self.r)
        if with_std:
            for arr in (self.sx, self.sy):
                if arr is not None:
                    keep &= np.isfinite(arr)
            if with_r and self.r is not None and self.sr is not None:
                keep &= np.isfinite(self.sr)
        pick = lambda a: None if a is None else a[keep]
        return _Motion(self.dx[keep], self.dy[keep], pick(self.r),
                       pick(self.sx), pick(self.sy), pick(self.sr), self.unit)


def _temporal_series(block: dict, key: str, *, optional=False):
    arr = block.get(key)
    if arr is None and key.startswith("std_"):
        arr = block.get(key[4:] + "_std")  # legacy spelling
    if arr is None and optional:
        return None
    sc.need(isinstance(arr, np.ndarray),
            f"temporal block missing numpy array key {key!r}")
    sc.need(arr.ndim == 1,
            f"temporal[{key!r}] must be 1D; got shape={arr.shape!r}")
    return arr.astype(float, copy=False)


def _motion_from_stats(stack_stats: dict, temporal: _TemporalKey) -> _Motion:
    (meta,) = sc.stats_blocks(stack_stats, "meta")
    root = stack_stats.get("temporal")
    sc.need(isinstance(root, dict), "stack_stats must contain dict key 'temporal'")
    block = root.get(temporal)
    sc.need(isinstance(block, dict),
            f"stack_stats['temporal'] must contain dict key {temporal!r}")

    unit = sc.unit_of(meta, "temporal", "dx")
    has = lambda key: isinstance(block.get(key), np.ndarray) or isinstance(
        block.get(key[4:] + "_std") if key.startswith("std_") else None,
        np.ndarray,
    )
    return _Motion(
        dx=_temporal_series(block, "dx"),
        dy=_temporal_series(block, "dy"),
        r=_temporal_series(block, "r") if has("r") else None,
        sx=_temporal_series(block, "std_dx") if has("std_dx") else None,
        sy=_temporal_series(block, "std_dy") if has("std_dy") else None,
        sr=_temporal_series(block, "std_r") if has("std_r") else None,
        unit=unit if isinstance(unit, str) and unit.strip() else "px",
    )


def _motion_from_arrays(xarr, yarr, temporal, uncertainty) -> _Motion:
    sc.need(xarr is not None and yarr is not None,
            "Both 'xarr' and 'yarr' must be provided together.")
    sc.need(temporal == "abs",
            "When using 'xarr' and 'yarr', temporal must be 'abs'.")
    sc.need(uncertainty == "none",
            "When using 'xarr' and 'yarr', uncertainty must be 'none'.")
    dx = np.asarray(sc.host_array(xarr), dtype=float).ravel()
    dy = np.asarray(sc.host_array(yarr), dtype=float).ravel()
    return _Motion(dx, dy, r=np.hypot(dx, dy))


def plt_displacement(
    stack_stats: dict | None = None,
    *,
    xarr: np.ndarray | None = None,
    yarr: np.ndarray | None = None,
    temporal: _TemporalKey = "abs",
    kind: _ViewKind = "trajectory",
    cmap: str = "viridis",
    show_path: bool = True,
    uncertainty: _Uncertainty = "none",
    k: float = 1.0,
    title: str | None = None,
) -> Figure:
    """Displacement diagnostics: XY trajectory colored by frame, or dx/dy/r
    stacked time series with band/errorbar uncertainty. Accepts either a
    speckle_stack_stats dict or raw xarr/yarr displacement arrays."""
    from_stats = stack_stats is not None
    from_arrays = xarr is not None or yarr is not None
    sc.need(from_stats != from_arrays,
            "Provide either 'stack_stats' or both 'xarr' and 'yarr'"
            + (", not both." if from_stats and from_arrays else "."))

    from .style import start_plotting

    start_plotting(k)
    motion = (
        _motion_from_stats(stack_stats, temporal) if from_stats
        else _motion_from_arrays(xarr, yarr, temporal, uncertainty)
    )
    want_std = kind == "timeseries" and uncertainty != "none"
    motion = motion.pruned(with_r=kind == "timeseries", with_std=want_std)
    heading = title if title is not None else f"speckle displacement ({temporal})"
    frames = np.arange(motion.dx.size, dtype=float)

    if kind == "trajectory":
        return _trajectory_figure(motion, frames, heading,
                                  cmap=cmap, show_path=show_path, k=k)
    sc.need(kind == "timeseries", f"unknown kind={kind!r}")

    fig, rows = plt.subplots(nrows=3, ncols=1, sharex=True, figsize=(8.0, 7.0))
    panels = [
        (rows[0], motion.dx, motion.sx, "darkred", "dx"),
        (rows[1], motion.dy, motion.sy, "olive", "dy"),
        (rows[2], motion.r, motion.sr, "steelblue", "r"),
    ]
    for ax, series, width, color, name in panels:
        _marked_series(ax, frames, series, color=color,
                       spread=uncertainty if want_std else "none", width=width)
        sc.dress(ax, sc.Frame(ylabel=f"{name} ({motion.unit})", grid="soft"))
    rows[-1].set_xlabel("(frame)")
    fig.suptitle(heading, fontsize=15 * k)
    fig.tight_layout()
    return fig


def _trajectory_figure(motion: _Motion, frames, heading, *, cmap, show_path,
                       k) -> Figure:
    fig, ax = sc.canvas(k, size=(6.0, 6.0))
    if show_path:
        ax.plot(motion.dx, motion.dy, linewidth=1.0, color="black")
    dots = ax.scatter(motion.dx, motion.dy, c=frames, cmap=cmap, s=35,
                      zorder=3, edgecolors="black", linewidths=0.5)
    ax.set_aspect(1)
    sc.dress(ax, sc.Frame(
        xlabel=f"dx ({motion.unit})", ylabel=f"dy ({motion.unit})",
        title=heading, title_size=15 * k, grid="soft",
    ))
    sc.attach_cbar(fig, ax, dots, width="4%", pad=0.08)
    return fig


# -------------------------------------------------------- metric series


def _metric_timeseries(stack_stats: dict, group: str, metric: str):
    """(frames, values) of a full-image metric, finite samples only."""
    (full,) = sc.stats_blocks(stack_stats, "full")
    entry = full.get(group)
    sc.need(isinstance(entry, dict), f"full has no group {group!r}", KeyError)
    y = entry.get(metric)
    sc.need(isinstance(y, np.ndarray),
            f"Expected full[{group!r}][{metric!r}] as numpy array; got {type(y)}")
    sc.need(y.ndim == 1,
            f"Expected 1D time series for full[{group!r}][{metric!r}]; "
            f"got shape={y.shape!r}")
    keep = np.isfinite(y)
    return np.arange(y.size, dtype=float)[keep], y[keep]


def _tile_timeseries(stack_stats: dict, group: str, metric: str,
                     need_std: bool):
    """(T,3,3) mean (+std) grids of a tile metric over the stack."""
    (tiles,) = sc.stats_blocks(stack_stats, "tiles")
    entry = sc.tile_block(tiles, group, metric)
    mean, std = entry.get("mean"), entry.get("std")
    sc.need(
        isinstance(mean, np.ndarray) and mean.ndim == 3
        and mean.shape[1:] == (3, 3),
        f"Expected tiles[{group!r}][{metric!r}]['mean'] with shape (T,3,3); "
        f"got {type(mean)} shape={getattr(mean, 'shape', None)!r}",
    )
    if not need_std:
        return mean, None
    sc.need(
        isinstance(std, np.ndarray) and std.shape == mean.shape,
        f"Expected tiles[{group!r}][{metric!r}]['std'] with shape "
        f"{mean.shape!r}; got {type(std)} shape={getattr(std, 'shape', None)!r}",
    )
    return mean, std


def plt_stack_metric(
    stack_stats: dict,
    metric_path: str | Sequence[str],
    *,
    scope: _StatsScope = "full",
    uncertainty: _Uncertainty = "none",
    cmap: str = "tab10",
    color: str = "darkred",
    markers: Sequence[str] | None = None,
    k: float = 1.0,
    title: str | None = None,
) -> Figure:
    """Metric time series from *_stack_stats output: one full-image curve,
    the 9 labeled tile curves, or both."""
    sc.need(isinstance(stack_stats, dict), "stack_stats must be a dict",
            TypeError)
    (meta,) = sc.stats_blocks(stack_stats, "meta")
    group, metric = sc.split_path(metric_path)
    ylabel = sc.labelled(metric, sc.unit_of(meta, group, metric))

    scope_word = {"full": "from full image", "tiles": "from tiled image",
                  "both": "from tiled + full image"}
    sc.need(scope in scope_word, f"unknown scope={scope!r}")

    fig, ax = sc.canvas(k, size=(9.0, 3.0))
    sc.dress(ax, sc.Frame(
        xlabel="(frame)", ylabel=ylabel, grid="soft",
        title=title if title is not None else f"{metric} {scope_word[scope]}",
        title_size=15 * k,
    ))

    last_frame = None
    if scope == "full":
        frames, values = _metric_timeseries(stack_stats, group, metric)
        width = None if uncertainty == "none" else float(np.nanstd(values))
        _marked_series(ax, frames, values, color=color,
                       spread=uncertainty, width=width)
        last_frame = frames[-1] if frames.size > 1 else None
    else:
        mean, std = _tile_timeseries(stack_stats, group, metric,
                                     need_std=uncertainty != "none")
        marks = _TILE_MARKERS if markers is None else markers
        sc.need(len(marks) >= 9, "markers must have length >= 9 (tiles mode)")
        palette = plt.get_cmap(cmap)
        labels = sc.grid3_labels(meta)
        frames = np.arange(mean.shape[0], dtype=float)
        for slot, (row, col) in enumerate(np.ndindex(3, 3)):
            values = mean[:, row, col].astype(float, copy=False)
            width = None if std is None else std[:, row, col].astype(
                float, copy=False)
            keep = np.isfinite(values)
            if width is not None:
                keep &= np.isfinite(width)
            if not np.any(keep):
                continue
            _marked_series(
                ax, frames[keep], values[keep], color=palette(slot / 8),
                label=str(labels[row, col]), marker=str(marks[slot]),
                spread=uncertainty, width=None if width is None else width[keep],
            )
        if scope == "both":
            frames_f, values_f = _metric_timeseries(stack_stats, group, metric)
            _marked_series(ax, frames_f, values_f, color="black", label="full",
                           marker="x", size=4.0)
        if mean.shape[0] > 1:
            last_frame = frames[-1]
        ax.legend(loc="center right", fontsize=9 * k, framealpha=0.85)

    if last_frame is not None:
        left, _ = ax.get_xlim()
        ax.set_xlim(left, 1.18 * last_frame)  # room for the legend / labels
    return fig


# ------------------------------------------- tile-overlay stack export


def plt_tiles_metric_stack(
    stack: np.ndarray,
    stack_stats: dict,
    metric_path: str | Sequence[str],
    save_path: str,
    *,
    frames: Sequence[int] | None = None,
    fps: float = 5.0,
    vmin: float | None = None,
    vmax: float | None = None,
    k: float = 1.0,
    **tile_kwargs,
) -> list[str]:
    """Render the per-frame 3x3 tile overlay of a *_stack_stats result as an
    animated GIF (``save_path`` ending in .gif) or a PNG sequence
    (``save_path`` used as ``<stem>_%04d.png``). Extends the single-image
    :func:`plt_tiles_metric` to stacks (no reference counterpart).

    The colour scale is fixed across frames (global stack min/max unless
    vmin/vmax are given) so intensity changes stay comparable. Returns the
    list of file paths written.
    """
    from pathlib import Path

    from PIL import Image

    from .image import plt_tiles_metric

    meta, _tiles = sc.stats_blocks(stack_stats, "meta", "tiles")
    group, metric = sc.split_path(metric_path)
    mean, _ = _tile_timeseries(stack_stats, group, metric, need_std=False)
    # std is optional for the overlay boxes: take it raw when present
    std = stack_stats["tiles"][group][metric].get("std")
    T = mean.shape[0]
    sc.need(
        getattr(stack, "ndim", 0) == 3 and stack.shape[0] == T,
        f"stack must be (T,H,W) with T={T}; "
        f"got shape={getattr(stack, 'shape', None)!r}",
    )
    picks = list(range(T)) if frames is None else [int(t) for t in frames]

    if vmin is None or vmax is None:
        # per-frame running extrema: list-indexing the stack would both
        # materialise an out-of-core source in full and reject lazy frame
        # sequences outright
        lo, hi = np.inf, -np.inf
        for t in picks:
            frame = np.asarray(sc.host_array(stack[t]), dtype=float)
            lo = min(lo, float(np.nanmin(frame)))
            hi = max(hi, float(np.nanmax(frame)))
        vmin = lo if vmin is None else vmin
        vmax = hi if vmax is None else vmax

    user_title = tile_kwargs.pop("title", None)
    shots: list[Image.Image] = []
    for t in picks:
        frame_stats = {
            "meta": meta,
            "tiles": {group: {metric: {
                "mean": np.asarray(mean[t]),
                "std": np.asarray(std[t]) if isinstance(std, np.ndarray) else None,
            }}},
        }
        fig = plt_tiles_metric(
            np.asarray(sc.host_array(stack[t]), dtype=float), frame_stats, (group, metric),
            vmin=vmin, vmax=vmax, k=k,
            title=f"{user_title} — frame {t}" if user_title
            else f"{metric} — frame {t}",
            **tile_kwargs,
        )
        shots.append(Image.fromarray(sc.rgba_capture(fig)))
        plt.close(fig)

    out = Path(save_path)
    if out.suffix.lower() == ".gif":
        out.parent.mkdir(parents=True, exist_ok=True)
        shots[0].save(
            out, save_all=True, append_images=shots[1:],
            duration=max(1, int(round(1000.0 / fps))), loop=0,
        )
        return [str(out)]

    stem = out.with_suffix("")
    stem.parent.mkdir(parents=True, exist_ok=True)
    paths = []
    for t, im in zip(picks, shots):
        p = stem.parent / f"{stem.name}_{t:04d}.png"
        im.save(p)
        paths.append(str(p))
    return paths


# ------------------------------------------------ dense field (XST) view


def plt_displacement_field(
    field: dict,
    *,
    frame: int | None = None,
    k: float = 1.0,
    cmap: str = "viridis",
    quiver_step: int = 1,
    quiver_color: str = "white",
    title: str | None = None,
) -> Figure:
    """Dense displacement field (signal.track_displacement_field /
    track_displacement_stack output): |d| magnitude map with a quiver
    overlay of the (dx, dy) vectors at the grid nodes.

    ``frame`` selects one frame of a displacement_stack result;
    ``quiver_step`` thins the arrow grid for dense fields.
    """
    dy = np.asarray(sc.host_array(field["dy"]), dtype=float)
    dx = np.asarray(sc.host_array(field["dx"]), dtype=float)
    if dy.ndim == 3:
        sc.need(frame is not None,
                "field holds a (T, gy, gx) displacement stack: pass frame=.")
        dy, dx = dy[int(frame)], dx[int(frame)]
    else:
        sc.need(frame is None,
                "frame= is only meaningful for displacement stacks.")
    sc.need(dy.ndim == 2, f"expected 2D displacement maps; got ndim={dy.ndim}")

    ys = np.asarray(sc.host_array(field.get("y", np.arange(dy.shape[0]))), dtype=float)
    xs = np.asarray(sc.host_array(field.get("x", np.arange(dy.shape[1]))), dtype=float)

    fig, ax = sc.canvas(k, size=tuple(plt.rcParams["figure.figsize"]))
    # node_extent centres each magnitude CELL on its node — the quiver
    # arrows sit at node coordinates, not cell corners
    art = ax.imshow(np.hypot(dy, dx), origin="lower", cmap=cmap,
                    extent=sc.node_extent(xs, ys), aspect="equal")
    q = max(1, int(quiver_step))
    ax.quiver(xs[::q], ys[::q], dx[::q, ::q], dy[::q, ::q],
              color=quiver_color, angles="xy", width=0.003)
    sc.attach_cbar(fig, ax, art, "|d| [px]", width="4%", pad=0.08)
    sc.dress(ax, sc.Frame(xlabel="x [px]", ylabel="y [px]",
                          title=title or "displacement field", grid=None))
    fig.tight_layout()
    return fig
