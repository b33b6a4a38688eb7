# SPDX-License-Identifier: CECILL-2.1
"""Radial means on the pixel grid (counterpart of
``barc4dip_tpu/ops/radialcore.py``).

Pixel-center origin convention ``x = arange(nx) - nx//2``. The polar
sample plan depends only on (shape, dtype, device) and is built once on the
device; each call is then one bilinear gather over a batch of maps.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..config import device_cache, device_constant

__all__ = [
    "binned_geometry",
    "interpolated_geometry",
    "radial_mean_binned_core",
    "radial_mean_interpolated_core",
]


def _inscribed_rmax(shape: tuple[int, int]) -> float:
    ny, nx = shape
    return float(min(nx // 2, ny // 2))


@lru_cache(maxsize=256)
def binned_geometry(shape: tuple[int, int], r_max: float | None, bin_size: float):
    """Host-side scalars for annular binning: (r_max, nbins, r_centers)."""
    if r_max is None:
        r_max = _inscribed_rmax(shape)
    if r_max <= 0:
        raise ValueError("r_max must be > 0 (or leave it as None with valid shape).")
    if bin_size <= 0:
        raise ValueError("bin_size must be > 0.")
    nbins = int(np.floor(r_max / bin_size)) + 1
    r_centers = (np.arange(nbins, dtype=np.float64) + 0.5) * float(bin_size)
    return float(r_max), nbins, r_centers


def radial_mean_binned_core(signal_2d, *, r_max: float | None = None, bin_size: float = 1.0):
    """Annular-bin radial mean of (..., ny, nx) maps. Returns (radial
    (..., nbins), r_centers); empty bins give NaN. ``r_centers`` is shared
    between calls (``config.device_constant``): read it, never write it."""
    ny, nx = (int(s) for s in signal_2d.shape[-2:])
    _, nbins, r_centers = binned_geometry(
        (ny, nx), None if r_max is None else float(r_max), float(bin_size)
    )
    dt, dev = signal_2d.dtype, signal_2d.device
    x = torch.arange(nx, dtype=dt, device=dev) - (nx // 2)
    y = torch.arange(ny, dtype=dt, device=dev) - (ny // 2)
    R = torch.sqrt(x[None, :] * x[None, :] + y[:, None] * y[:, None])
    ids = torch.floor(R / bin_size).long().reshape(-1)
    ids = torch.where(ids < nbins, ids, nbins)  # out-of-range pixels -> discard bin
    vals = signal_2d.flatten(-2)
    sums = torch.zeros(*vals.shape[:-1], nbins + 1, dtype=dt, device=dev)
    sums.index_add_(-1, ids, vals)
    counts = torch.bincount(ids, minlength=nbins + 1).to(dt)
    radial = torch.where(counts > 0, sums / counts.clamp_min(1), math.nan)[..., :nbins]
    return radial, device_constant(r_centers, dt, dev)


@lru_cache(maxsize=256)
def interpolated_geometry(
    shape: tuple[int, int], r_max: float | None, nr: int | None, ntheta: int | None,
):
    """Host-side scalars for polar resampling: (r_max, nr, ntheta, r)."""
    if r_max is None:
        r_max = _inscribed_rmax(shape)
    if r_max <= 0:
        raise ValueError("r_max must be > 0 (or leave it as None with valid shape).")
    if nr is None:
        nr = int(np.floor(r_max)) + 1
    if ntheta is None:
        ntheta = int(2.0 * np.pi * 180.0)  # ~1 degree sampling
    if nr <= 1:
        raise ValueError("nr must be > 1.")
    if ntheta <= 3:
        raise ValueError("ntheta must be > 3.")
    r = np.linspace(0.0, float(r_max), int(nr))
    return float(r_max), int(nr), int(ntheta), r


@device_cache(64)
def _polar_plan(shape, rm: float, nr: int, nt: int, half: bool, dt, dev):
    """Flat gather index, bilinear fractions, out-of-bounds mask and
    half-ring weights of the polar samples, in the map's dtype."""
    ny, nx = shape
    step = 2.0 * math.pi / nt
    if half:
        nt = nt // 2
    r = torch.linspace(0.0, rm, nr, dtype=dt, device=dev)
    theta = torch.arange(nt, dtype=dt, device=dev) * torch.tensor(step, dtype=dt)
    xi = (r[:, None] * torch.cos(theta)[None, :] + (nx // 2)).reshape(-1)
    yi = (r[:, None] * torch.sin(theta)[None, :] + (ny // 2)).reshape(-1)

    def inb(x, y):
        return (x >= 0) & (x <= nx - 1) & (y >= 0) & (y <= ny - 1)

    if half:
        # the dropped theta + pi sample mirrors the kept one through the
        # centre; the grid is asymmetric about n//2 for even n, so evaluate
        # whichever member of the pair is in bounds, weighted by the count
        xm = 2.0 * (nx // 2) - xi
        ym = 2.0 * (ny // 2) - yi
        in_p = inb(xi, yi)
        in_m = inb(xm, ym)
        xi = torch.where(in_p, xi, xm)
        yi = torch.where(in_p, yi, ym)
        w = 0.5 * (in_p.to(dt) + in_m.to(dt))
        oob = ~(in_p | in_m)
    else:
        w = None
        oob = ~inb(xi, yi)
    x0 = torch.clamp(torch.floor(xi), 0, nx - 2).long()
    y0 = torch.clamp(torch.floor(yi), 0, ny - 2).long()
    fx = torch.clamp(xi - x0, 0.0, 1.0)
    fy = torch.clamp(yi - y0, 0.0, 1.0)
    return y0 * nx + x0, fx, fy, oob, w, nt


def radial_mean_interpolated_core(
    signal_2d,
    *,
    r_max: float | None = None,
    nr: int | None = None,
    ntheta: int | None = None,
    fill_value: float = 0.0,
    centrosymmetric: bool = False,
):
    """Polar-resampled (bilinear) radial mean of (..., ny, nx) maps.

    Returns (radial (..., nr), r). Out-of-bounds samples take
    ``fill_value`` entirely (SciPy RegularGridInterpolator semantics,
    which ``F.grid_sample``'s border modes do not give).
    ``centrosymmetric=True`` samples theta over [0, pi) only: for a map
    with map[c+k] == map[c-k] about c = n//2 (autocorrelation, PSD) the
    half-ring mean is the full-ring mean. Needs an even ``ntheta``. ``r`` is
    shared between calls, as :func:`radial_mean_binned_core`'s axis is."""
    ny, nx = (int(s) for s in signal_2d.shape[-2:])
    rm, nr_, nt_, r_np = interpolated_geometry(
        (ny, nx),
        None if r_max is None else float(r_max),
        None if nr is None else int(nr),
        None if ntheta is None else int(ntheta),
    )
    dt = signal_2d.dtype
    half = bool(centrosymmetric and nt_ % 2 == 0)
    base, fx, fy, oob, w, nt_ = _polar_plan(
        (ny, nx), rm, nr_, nt_, half, dt, signal_2d.device
    )
    flat = signal_2d.flatten(-2)
    v00 = flat[..., base]
    v01 = flat[..., base + 1]
    v10 = flat[..., base + nx]
    v11 = flat[..., base + nx + 1]
    vals = (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11)
    fill = device_constant(fill_value, dt, signal_2d.device)
    vals = torch.where(oob, fill, vals)
    if w is not None:
        vals = w * vals + (1.0 - w) * fill
    radial = vals.reshape(*vals.shape[:-1], nr_, nt_).mean(-1)
    return radial, device_constant(r_np, dt, signal_2d.device)
