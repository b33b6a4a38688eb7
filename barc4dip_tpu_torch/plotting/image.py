# SPDX-License-Identifier: CECILL-2.1
"""Image plots: pixel-coordinate display, 3x3 tile overlays, histograms.

Same capability surface as reference plotting/image.py:18,217,453
(plt_image / plt_tiles_metric / plt_histogram), rebuilt on the package's
declarative scaffold (:mod:`._scaffold`): validation guards, one Frame
applier for labels/limits/grids, and shared tile/unit resolution.
"""
from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
from matplotlib.figure import Figure
from matplotlib.patches import Rectangle

from . import _scaffold as sc
from .style import resolve_cmap

__all__ = ["plt_image", "plt_tiles_metric", "plt_histogram"]


# --------------------------------------------------- pixel-frame imshow


def _norm_slice(s: slice, n: int, name: str) -> tuple[int, int]:
    """Clamped [start, stop) bounds of a unit-step slice over n samples."""
    sc.need(isinstance(s, slice), f"{name} must be a slice; got {type(s)!r}",
            TypeError)
    sc.need(
        s.step in (None, 1),
        f"{name}.step must be 1 or None for a rectangular ROI; got {s.step!r}",
    )
    bounds = []
    for raw, default in ((s.start, 0), (s.stop, n)):
        v = default if raw is None else int(raw)
        if v < 0:
            v += n
        bounds.append(min(max(v, 0), n))
    lo, hi = bounds
    return (hi, lo) if hi < lo else (lo, hi)


def _pixel_axes(img: np.ndarray, *, origin: str, cmap: str, vmin, vmax,
                k: float, height: float = 5.0):
    """Figure + axes + imshow where the y axis carries NUMPY ROW
    COORDINATES under either origin.

    With origin="upper" the extent runs top-to-bottom (bottom=ny, top=0)
    so array row r always displays at y=r — without this, ROI rectangles
    and zooms given in slice coordinates would mark the vertically
    mirrored region.
    """
    ny, nx = img.shape
    fig, ax = sc.canvas(k, size=(height * (nx / ny), height))
    span_y = (float(ny), 0.0) if origin == "upper" else (0.0, float(ny))
    art = ax.imshow(
        img, origin=origin, cmap=resolve_cmap(cmap), vmin=vmin, vmax=vmax,
        interpolation="none", aspect="equal",
        extent=(0.0, float(nx)) + span_y,
    )
    return fig, ax, art


def plt_image(
    img: np.ndarray, title: str | None = None, *, k: float = 1.0,
    vmin: float | None = None, vmax: float | None = None,
    cmap: str = "viridis",
    xmin: float | None = None, xmax: float | None = None,
    ymin: float | None = None, ymax: float | None = None,
    display_origin: Literal["upper", "lower"] = "lower",
    colorbar: bool = True, cbar_label: str | None = None,
    roi: slice | tuple[slice, slice] | None = None, roi_zoom: bool = False,
    roi_color: str = "orange", roi_lw: float = 1.75, roi_alpha: float = 0.95,
) -> Figure:
    """Plot a 2D image in pixel coordinates with an optional size-matched
    colorbar and an optional ROI rectangle/zoom (numpy slice convention)."""
    img = sc.host_array(img)
    sc.need(img.ndim == 2, f"plt_image needs a 2D array, not shape {img.shape!r}")

    fig, ax, art = _pixel_axes(
        img, origin=display_origin, cmap=cmap, vmin=vmin, vmax=vmax, k=k
    )

    zoom = None
    if roi is not None:
        if isinstance(roi, tuple):
            sc.need(len(roi) == 2, "roi tuple must be (yslice, xslice)")
            ysl, xsl = roi
        else:
            ysl, xsl = roi, slice(None)
        ny, nx = img.shape
        ry = _norm_slice(ysl, ny, "roi[0] (yslice)")
        rx = _norm_slice(xsl, nx, "roi[1] (xslice)")
        if roi_zoom:
            flip = display_origin == "upper"
            zoom = (
                (float(rx[0]), float(rx[1])),
                (float(ry[1]), float(ry[0])) if flip
                else (float(ry[0]), float(ry[1])),
            )
        else:
            ax.add_patch(Rectangle(
                (float(rx[0]), float(ry[0])),
                float(rx[1] - rx[0]), float(ry[1] - ry[0]),
                fill=False, edgecolor=roi_color, linewidth=roi_lw,
                alpha=roi_alpha,
            ))

    # per-side: an explicit limit wins over the ROI zoom's side
    zx, zy = zoom if zoom else ((None, None), (None, None))
    frame = sc.Frame(
        xlabel="x (px)", ylabel="y (px)",
        title=title or None, title_size=15 * k,
        xlim=(zx[0] if xmin is None else xmin, zx[1] if xmax is None else xmax),
        ylim=(zy[0] if ymin is None else ymin, zy[1] if ymax is None else ymax),
        grid=None,
    )
    sc.dress(ax, frame)

    if colorbar:
        sc.attach_cbar(fig, ax, art, cbar_label)
    return fig


# -------------------------------------------------------- tile overlays


def _grid33(entry: dict, name: str, group: str, metric: str, required: bool):
    g = entry.get(name)
    if isinstance(g, np.ndarray) and g.shape == (3, 3):
        return g.astype(np.float64, copy=False)
    sc.need(
        not required,
        f"tile {name} for {group}.{metric} must be a (3,3) array; "
        f"got {type(g).__name__} / shape {getattr(g, 'shape', None)!r}",
    )
    return None


def plt_tiles_metric(
    img: np.ndarray, stats: dict, metric_path: str | Sequence[str], *,
    title: str | None = None, k: float = 1.0, cmap: str = "gray",
    vmin: float | None = None, vmax: float | None = None,
    colorbar: bool = True, cbar_label: str | None = None,
    show_std: bool = True, fmt: str = "{:.2f}", normalize: bool = False,
    display_origin: Literal["upper", "lower"] | None = None,
) -> Figure:
    """Image with the orange 3x3 tiling grid and per-tile "LABEL / mean ±
    std" boxes from a stats dict. ``normalize=True`` divides displayed
    values by the central (C) tile mean."""
    img = sc.host_array(img)
    sc.need(
        isinstance(img, np.ndarray) and img.ndim == 2,
        f"plt_tiles_metric needs a 2D numpy image, not "
        f"{type(img).__name__} / shape {getattr(img, 'shape', None)!r}",
    )
    meta, tiles = sc.stats_blocks(stats, "meta", "tiles")
    group, metric = sc.split_path(metric_path)
    entry = sc.tile_block(tiles, group, metric)
    mean = _grid33(entry, "mean", group, metric, required=True)
    std = _grid33(entry, "std", group, metric, required=show_std)

    if normalize:
        center = float(mean[1, 1])
        sc.need(np.isfinite(center), "normalize=True needs a finite central-tile mean")
        sc.need(not np.isclose(center, 0.0),
                "normalize=True needs a nonzero central-tile mean")
        mean = mean / center
        std = None if std is None else std / center
        heading = f"{metric} [norm.]"
    else:
        heading = sc.labelled(metric, sc.unit_of(meta, group, metric))

    origin = display_origin or meta.get("display_origin", "lower")
    if origin not in ("upper", "lower"):
        origin = "lower"

    fig, ax, art = _pixel_axes(
        img, origin=origin, cmap=cmap, vmin=vmin, vmax=vmax, k=k
    )
    sc.dress(ax, sc.Frame(
        xlabel="x (px)", ylabel="y (px)",
        title=title if title is not None else heading,
        title_size=14 * k, grid=None,
    ))

    _overlay_grid33(ax, mean, std, sc.grid3_labels(meta), fmt=fmt, k=k)

    if colorbar:
        sc.attach_cbar(fig, ax, art, cbar_label)
    return fig


def _overlay_grid33(ax, mean, std, labels, *, fmt: str, k: float) -> None:
    """Orange 3x3 grid lines + labelled value boxes in axes data space."""
    (x0, x1), (y_lo, y_hi) = ax.get_xlim(), ax.get_ylim()
    xs = np.linspace(x0, x1, 4)
    # rows of the (3,3) grids are laid out top-of-display first, so the
    # row edges run from the display top (y_hi) downward
    ys = np.linspace(y_hi, y_lo, 4)
    line_kw = dict(lw=1.5, alpha=0.9, color="orange")
    for v in xs:
        ax.plot([v, v], [y_hi, y_lo], "-", **line_kw)
    for v in ys:
        ax.plot([x0, x1], [v, v], "-", **line_kw)

    box = dict(boxstyle="round,pad=0.25", facecolor="black", alpha=0.60,
               edgecolor="black", linewidth=0.0)
    mid = lambda edges: 0.5 * (edges[:-1] + edges[1:])
    for row, cy in enumerate(mid(ys)):
        for col, cx in enumerate(mid(xs)):
            text = fmt.format(float(mean[row, col]))
            if std is not None:
                text += f" ± {fmt.format(float(std[row, col]))}"
            ax.text(cx, cy, f"{labels[row, col]}\n{text}",
                    ha="center", va="center", fontsize=10 * k,
                    color="w", alpha=0.95, bbox=box)


# ----------------------------------------------------------- histograms


def plt_histogram(
    img: np.ndarray, title: str | None = None, *, k: float = 1.0,
    bin_min: int = 0, bin_max: int = 65536,
    ymin: float | None = None, ymax: float | None = None,
    logy: bool = False, cumulative: bool = False, density: bool = False,
    percentiles: tuple[float, ...] | None = None,
) -> Figure:
    """Histogram of finite pixel values at one bin per gray level, with
    optional log-y, CDF twin axis and percentile markers."""
    img = sc.host_array(img)
    sc.need(isinstance(img, np.ndarray), "plt_histogram works on numpy arrays",
            TypeError)
    sc.need(img.ndim == 2,
            f"plt_histogram needs a 2D array, not shape {img.shape!r}")
    sc.need(np.issubdtype(img.dtype, np.number),
            f"plt_histogram needs numeric data, not dtype={img.dtype}",
            TypeError)
    sc.need(bin_max > bin_min, "bin_max must exceed bin_min")

    values = img.ravel()
    values = values[np.isfinite(values)]
    sc.need(values.size > 0, "histogram expects at least one finite value")
    if np.issubdtype(values.dtype, np.floating):
        values = np.clip(values, float(bin_min), float(bin_max))

    fig, ax = sc.canvas(k, size=(7.0, 4.5))
    counts, edges, _ = ax.hist(
        values, bins=int(bin_max - bin_min), range=(bin_min, bin_max),
        histtype="step", linewidth=1.5, color=sc.PRIMARY, alpha=1,
        density=density,
    )

    floor = (0.5 if logy else 0.0) if ymin is None else ymin
    sc.dress(ax, sc.Frame(
        xlabel="value", ylabel="density" if density else "counts",
        title=title or None, title_size=15 * k,
        xlim=(bin_min, bin_max), ylim=(floor, ymax), logy=logy,
        grid="dots" if (logy or not cumulative) else "dots-x",
    ))

    if percentiles is not None and len(percentiles) > 0:
        p = sc.checked_percentiles(percentiles)
        sc.mark_verticals(ax, np.percentile(values, p))

    if cumulative:
        mass = np.cumsum(counts)
        if mass.size and mass[-1] > 0:
            mass = mass / mass[-1]
        sc.cdf_overlay(ax, 0.5 * (edges[:-1] + edges[1:]), mass)
    return fig
