# SPDX-License-Identifier: CECILL-2.1
"""Spectral plots: 1D radial/spectral curves, 2D magnitude/phase maps.

Same capability surface as reference plotting/spectral.py:19,229
(plt_spectrum1d / plt_spectrum2d), rebuilt on the package's declarative
scaffold: one Frame applier, shared trapezoid-CDF/percentile helpers, and
a single map+cuts renderer reused for intensity and phase.
"""
from __future__ import annotations

import matplotlib.pyplot as plt
import numpy as np
from matplotlib.colors import LogNorm
from matplotlib.figure import Figure

from . import _scaffold as sc
from .style import resolve_cmap

__all__ = ["plt_spectrum1d", "plt_spectrum2d", "plt_radial_waterfall"]


def _monotonic(x: np.ndarray, name: str) -> None:
    steps = np.diff(x)
    ok = steps.size == 0 or (np.all(steps > 0.0) or np.all(steps < 0.0))
    sc.need(ok, f"{name} must be strictly monotonic")


# ------------------------------------------------------------ 1D curves


def plt_spectrum1d(
    curve: np.ndarray, axis: np.ndarray, title: str | None = None, *,
    k: float = 1.0, xlabel: str = "radius", ylabel: str = "value",
    xmin: float | None = None, xmax: float | None = None,
    ymin: float | None = None, ymax: float | None = None,
    logx: bool = False, logy: bool = False, cumulative: bool = False,
    percentiles: tuple[float, ...] | None = None, mask_center: bool = False,
) -> Figure:
    """Plot a 1D spectral curve (radial mean of FFT/PSD/autocorr maps) with
    optional log axes, trapezoid-CDF overlay and percentile markers.
    ``mask_center=True`` drops the first two samples."""
    curve, axis = sc.host_array(curve), sc.host_array(axis)
    for arr, name in ((axis, "axis"), (curve, "curve")):
        sc.need(isinstance(arr, np.ndarray),
                f"plt_spectrum1d expects {name} as a numpy.ndarray", TypeError)
        sc.need(arr.ndim == 1,
                f"plt_spectrum1d expects a 1D {name}; got shape={arr.shape!r}")
        sc.need(np.issubdtype(arr.dtype, np.number),
                "plt_spectrum1d expects numeric arrays", TypeError)
    sc.need(
        axis.size == curve.size,
        f"plt_spectrum1d expects axis and curve with the same length; "
        f"got {axis.size} and {curve.size}",
    )

    x, y = sc.finite_xy(axis, curve)
    sc.need(x.size > 0, "plt_spectrum1d expects at least one finite sample")
    if mask_center:
        x, y = x[2:], y[2:]
    sc.need(x.size >= 2, "plt_spectrum1d expects at least two finite samples")
    _monotonic(x, "axis")
    sc.need(not (logx and np.any(x <= 0.0)),
            "logx=True requires strictly positive axis values")

    y_draw = y
    floor = None
    if logy:
        y_draw = sc.log_safe(y)
        sc.need(np.any(np.isfinite(y_draw)),
                "logy=True requires at least one strictly positive finite value")
        floor = sc.log_floor(y_draw)

    fig, ax = sc.canvas(k, size=(7.0, 4.5))
    ax.plot(x, y_draw, color=sc.PRIMARY, linewidth=1.5)
    sc.dress(ax, sc.Frame(
        xlabel=xlabel, ylabel=ylabel, title=title or None, title_size=15 * k,
        logx=logx, logy=logy,
        xlim=(
            (float(x[0]) if xmin is None else float(xmin),
             float(x[-1]) if xmax is None else float(xmax))
            if (xmin is not None or xmax is not None) else (None, None)
        ),
        ylim=((floor if ymin is None else ymin) if logy else ymin, ymax),
        grid="dots-x" if (cumulative and not logy) else "dots",
    ))

    mass = sc.trapz_cdf(x, y)  # one CDF shared by markers + overlay
    if percentiles is not None and len(percentiles) > 0:
        p = sc.checked_percentiles(percentiles)
        sc.need(mass[-1] > 0.0,
                "percentiles require a curve with positive cumulative integral")
        sc.mark_verticals(ax, np.interp(p / 100.0, mass, x))
    if cumulative:
        sc.cdf_overlay(ax, x, mass)
    return fig


# --------------------------------------------------------- 2D map + cuts


def _axis_or_default(axis, n: int, name: str) -> np.ndarray:
    if axis is None:
        return np.arange(n, dtype=float)
    vals = np.asarray(axis, dtype=float)
    sc.need(vals.ndim == 1, f"{name} must be a 1D array; got ndim={vals.ndim}")
    sc.need(vals.size == n, f"{name} must have length {n}; got {vals.size}")
    sc.need(bool(np.all(np.isfinite(vals))), f"{name} contains non-finite values")
    if n > 1:
        _monotonic(vals, name)
    return vals


def _blank_center(data: np.ndarray) -> np.ndarray:
    """Copy with the central 4/5-px block NaN-masked (parity-aware)."""
    out = data.copy()
    ny, nx = out.shape
    out[(ny - 2) // 2 : ny // 2 + 2, (nx - 2) // 2 : nx // 2 + 2] = np.nan
    return out


class _MapView:
    """One 2D map with shared axes/extent/limits, rendered as a colormapped
    figure and/or a central-cuts figure (used for intensity and phase)."""

    def __init__(self, x, y, extent, xlabel, ylabel, lims, origin, k):
        self.x, self.y, self.extent = x, y, extent
        self.xlabel, self.ylabel = xlabel, ylabel
        self.xmin, self.xmax, self.ymin, self.ymax = lims
        self.origin, self.k = origin, k

    def map_figure(self, data, *, cmap, norm, vmin, vmax, title) -> Figure:
        fig, ax = sc.canvas(self.k, size=tuple(plt.rcParams["figure.figsize"]))
        extent = self.extent
        if self.origin == "upper":
            # keep row r on axis value y[r] whichever way the axis runs: an
            # ascending extent under origin="upper" would mirror the map
            # against its own tick labels and the cuts figures
            left, right, bottom, top = extent
            extent = (left, right, top, bottom)
        art = ax.imshow(data, origin=self.origin, cmap=cmap, norm=norm,
                        vmin=vmin, vmax=vmax, interpolation="none",
                        aspect="equal", extent=extent)
        sc.dress(ax, sc.Frame(
            xlabel=self.xlabel, ylabel=self.ylabel, title=title,
            xlim=(self.xmin, self.xmax), ylim=(self.ymin, self.ymax),
            grid="dots", box_ticks=True,
        ))
        bar = plt.colorbar(art, ax=ax, fraction=0.046, pad=0.04)
        bar.set_label(None)
        return fig

    def cuts_figure(self, data, *, logy, unit=None) -> Figure:
        """Side-by-side central row/column profiles of the map."""
        iy, ix = data.shape[0] // 2, data.shape[1] // 2
        fig, panes = plt.subplots(1, 2, figsize=(10, 4), sharey=True)
        at_h = f" ({self.ylabel}=0)" if unit else ""
        at_v = f" ({self.xlabel}=0)" if unit else ""
        specs = [
            (panes[0], self.x, data[iy, :], self.xlabel,
             f"Hor. cut{at_h}", self.xmin, self.xmax),
            (panes[1], self.y, data[:, ix], self.ylabel,
             f"Ver. cut{at_v}", self.ymin, self.ymax),
        ]
        for ax, along, profile, lab, head, lo, hi in specs:
            vals = np.asarray(profile, dtype=float)
            plot = ax.semilogy if logy else ax.plot
            plot(along, sc.log_safe(vals) if logy else vals,
                 color=sc.SECONDARY, lw=1.5)
            sc.dress(ax, sc.Frame(
                xlabel=lab, ylabel=unit, title=head,
                xlim=(float(along[0]) if lo is None else float(lo),
                      float(along[-1]) if hi is None else float(hi)),
                grid="dots", box_ticks=True,
            ))
        fig.tight_layout()
        return fig


def plt_spectrum2d(
    data: np.ndarray, *,
    x: np.ndarray | None = None, y: np.ndarray | None = None,
    cuts: bool = True, show_phase: bool = True,
    log_intensity: bool = False, mask_center: bool = False,
    k: float = 1.0, cmap: str = "igor",
    vmin: float | None = None, vmax: float | None = None,
    xmin: float | None = None, xmax: float | None = None,
    ymin: float | None = None, ymax: float | None = None,
    xlabel: str = "x", ylabel: str = "y", title: str | None = None,
    display_origin: str = "lower",
) -> dict[str, Figure | None]:
    """Plot a 2D spectral map (magnitude + phase for complex input) and
    optionally its central cuts. Returns a dict of up to 4 figures:
    {"intensity", "intensity_cuts", "phase", "phase_cuts"}."""
    from .style import start_plotting

    start_plotting(k)
    arr = np.asarray(sc.host_array(data))
    x, y = sc.host_array(x), sc.host_array(y)
    sc.need(arr.ndim == 2, f"data must be a 2D array; got shape={arr.shape!r}")
    ny, nx = arr.shape

    view = _MapView(
        _axis_or_default(x, nx, "x"), _axis_or_default(y, ny, "y"),
        None, xlabel, ylabel, (xmin, xmax, ymin, ymax), display_origin, k,
    )
    view.extent = sc.node_extent(view.x, view.y)

    figures: dict[str, Figure | None] = dict.fromkeys(
        ("intensity", "intensity_cuts", "phase", "phase_cuts")
    )

    has_phase = np.iscomplexobj(arr)
    magnitude = np.abs(arr) if has_phase else np.asarray(arr, dtype=float)
    shown = _blank_center(magnitude) if mask_center else magnitude

    norm = None
    lo, hi = vmin, vmax
    body = shown
    if log_intensity:
        pos = shown[np.isfinite(shown) & (shown > 0.0)]
        sc.need(pos.size > 0,
                "log_intensity=True requires at least one strictly positive "
                "finite value")
        floor = vmin if (vmin is not None and vmin > 0.0) else float(pos.min())
        ceil = vmax if (vmax is not None and vmax > floor) else float(pos.max())
        norm, lo, hi = LogNorm(vmin=floor, vmax=ceil), None, None
        body = sc.log_safe(shown)

    figures["intensity"] = view.map_figure(
        body, cmap=resolve_cmap(cmap), norm=norm, vmin=lo, vmax=hi,
        title=title if title is not None else (
            "Magnitude - |A|" if has_phase else "Intensity - |A|$^2$"),
    )
    if cuts:
        figures["intensity_cuts"] = view.cuts_figure(shown, logy=log_intensity)

    if has_phase and show_phase:
        angle = np.angle(arr)
        if mask_center:
            angle = _blank_center(angle)
        figures["phase"] = view.map_figure(
            angle, cmap="coolwarm", norm=None, vmin=None, vmax=None,
            title="Phase - $\\angle A$" if title is None else f"{title}",
        )
        if cuts:
            figures["phase_cuts"] = view.cuts_figure(angle, logy=False,
                                                     unit="rad")
    return figures


def plt_radial_waterfall(
    curves, r=None, *,
    k: float = 1.0, cmap: str = "viridis", logz: bool = False,
    xlabel: str = "r", ylabel: str = "frame", zlabel: str | None = None,
    title: str | None = None,
) -> Figure:
    """Waterfall view of per-frame radial profiles: a (T, nr) heatmap with
    frames on the vertical axis (companion to
    ``signal.spectral_summary_stack``; no reference counterpart).

    ``curves`` may be the (T, nr) array itself or a
    ``spectral_summary_stack`` result dict (uses its interpolated profile
    and radius axis unless ``r`` is given).
    """
    if isinstance(curves, dict):
        if r is None:
            r = curves.get("r_interpolated")
        curves = curves.get("radial_interpolated")
    arr = np.asarray(sc.host_array(curves), dtype=float)
    r = sc.host_array(r)
    sc.need(arr.ndim == 2, f"curves must be (T, nr); got shape={arr.shape!r}")
    T, nr = arr.shape
    radius = np.arange(nr, dtype=float) if r is None else np.asarray(r, float)
    sc.need(radius.size == nr, f"r must have length {nr}; got {radius.size}")

    shown = sc.log_safe(arr) if logz else arr
    norm = LogNorm() if logz else None

    from .style import start_plotting

    start_plotting(k)
    fig, ax = plt.subplots(figsize=(7.0, 4.5))
    art = ax.imshow(
        shown, origin="lower", aspect="auto", cmap=resolve_cmap(cmap),
        norm=norm,
        extent=(float(radius[0]), float(radius[-1]), -0.5, T - 0.5),
        interpolation="nearest",
    )
    sc.dress(ax, sc.Frame(xlabel=xlabel, ylabel=ylabel,
                          title=title or None, title_size=15 * k, grid=None))
    bar = plt.colorbar(art, ax=ax, fraction=0.046, pad=0.04)
    if zlabel:
        bar.set_label(zlabel)
    return fig
