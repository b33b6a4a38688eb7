# SPDX-License-Identifier: CECILL-2.1
"""Speckle estimator cores (counterpart of the speckle half of
``barc4dip_tpu/metrics/estimators.py``).

Each core takes a batch of images (..., h, w) and returns a dict of (...)
tensors. Degenerate images give NaN/Inf instead of raising.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..geometry.masks import square_embed_slices
from ..ops.corrcore import autocorr2d_core
from ..ops.fftcore import psd2d_core
from ..ops.momentscore import distribution_moments_core, nanmean2d, nanstd2d
from ..ops.quantile import nanpercentiles_exact
from ..ops.radialcore import (
    binned_geometry,
    interpolated_geometry,
    radial_mean_binned_core,
    radial_mean_interpolated_core,
)
from ..ops.widths import distance_at_fraction_core, width_at_fraction_core
from ..signal.common import lag_axis_from_step

__all__ = [
    "amplitude_core",
    "bandwidth_core",
    "distribution_moments_core",
    "grain_core",
    "grain_map_core",
]

_INV_E = float(1.0 / np.e)


def _pad_to_square_mean(img):
    """Center (..., H, W) in (..., N, N), N = max(H, W), filling with each
    image's mean."""
    H, W = img.shape[-2], img.shape[-1]
    sy, sx, N = square_embed_slices((H, W))
    if N == H and N == W:
        return img
    fill = img.mean(dim=(-2, -1))
    out = fill[..., None, None].expand(*img.shape[:-2], N, N).clone()
    out[..., sy, sx] = img
    return out


def amplitude_core(img, *, p_low: float = 0.05, p_high: float = 99.95, integer_range=None) -> dict:
    """Visibility (nanstd/nanmean) and Michelson contrast from the
    [p_low, p_high] nan-percentile range."""
    mu = nanmean2d(img)
    visibility = nanstd2d(img) / mu
    q = nanpercentiles_exact(img, (p_low, p_high), integer_range=integer_range)
    vmin, vmax = q[..., 0], q[..., 1]
    denom = vmax + vmin
    contrast = torch.where(
        denom > 0, (vmax - vmin) / torch.where(denom > 0, denom, 1.0), np.nan
    )
    visibility = torch.where(mu > 0, visibility, np.nan)
    return {"visibility": visibility, "contrast": contrast}


def _widths_from_autocorr(ac, *, fraction: float, radial_method: str):
    """peak -> axis cuts -> widths -> radial fraction distance of
    peak-normalized autocorrelation maps. Returns (lx, ly, leq)."""
    N = ac.shape[-1]
    flat = ac.flatten(-2).argmax(-1)
    iy, ix = flat // N, flat % N
    y_cut = ac.gather(-1, ix[..., None, None].expand(*ac.shape[:-1], 1))[..., 0]
    x_cut = ac.gather(-2, iy[..., None, None].expand(*ac.shape[:-2], 1, N))[..., 0, :]
    ly, _ = width_at_fraction_core(y_cut, fraction=fraction, center_index=iy)
    lx, _ = width_at_fraction_core(x_cut, fraction=fraction, center_index=ix)

    if radial_method == "binned":
        rad, _ = radial_mean_binned_core(ac)
        *_rest, r_np = binned_geometry((int(N), int(N)), None, 1.0)
    elif radial_method == "interpolated":
        # the peak-normalized autocorrelation is centro-symmetric about N//2:
        # the half-ring mean is the full-ring mean
        rad, _ = radial_mean_interpolated_core(ac, centrosymmetric=True)
        *_rest, r_np = interpolated_geometry((int(N), int(N)), None, None, None)
    else:
        raise ValueError("radial_method must be 'binned' or 'interpolated'.")
    dr = float(r_np[1] - r_np[0])
    dist, _ = distance_at_fraction_core(rad, fraction=fraction, peak_index=0)
    return lx, ly, 2.0 * dist * dr


def grain_core(
    img, *, fraction: float = _INV_E, radial_method: str = "interpolated", with_map: bool = True
) -> dict:
    """Speckle grain sizes from the autocorrelation peak: lx, ly, leq and
    the anisotropy r = lx/ly, plus the peak-normalized autocorrelation map
    (..., N, N) and its lag axes (N,) unless ``with_map=False``."""
    ac = grain_map_core(img)
    lx, ly, leq = _widths_from_autocorr(ac, fraction=fraction, radial_method=radial_method)
    r = torch.where(ly != 0, lx / torch.where(ly != 0, ly, 1.0), np.inf)
    out = {"lx": lx, "ly": ly, "leq": leq, "r": r}
    if with_map:
        lag = torch.as_tensor(lag_axis_from_step(ac.shape[-1], 1.0), dtype=ac.dtype, device=ac.device)
        out.update(autocorr=ac, xlag=lag, ylag=lag)
    return out


def grain_map_core(img):
    """The peak-normalized, fftshifted autocorrelation map of the
    mean-padded square image, (..., N, N): what a lazy map leaf computes
    when it is read."""
    return autocorr2d_core(_pad_to_square_mean(img), remove_mean=True, normalize="peak")


def bandwidth_core(img) -> dict:
    """RMS radial bandwidth, 95% encircled-energy radius, per-axis RMS
    bandwidths, spectral anisotropy and participation ratio of the
    mean-removed, DC-zeroed PSD over the inscribed frequency circle."""
    data = _pad_to_square_mean(img)
    data = data - nanmean2d(data)[..., None, None]
    return _bandwidth_from_psd(psd2d_core(data, step_x=1.0, step_y=1.0, scale=True))


@lru_cache(maxsize=32)
def _freq_plan(N: int, dt, dev):
    """Flattened shifted-frequency fields and the integer radius class
    s = ix^2 + iy^2 of every position of an (N, N) fftshifted spectrum."""
    i = torch.arange(N, dtype=torch.int32, device=dev) - (N // 2)
    ixi = i[None, :].expand(N, N)
    iyi = i[:, None].expand(N, N)
    FX = ixi.to(dt) / N
    FY = iyi.to(dt) / N
    FR = torch.sqrt(FX * FX + FY * FY)
    f_max = float(max(N // 2, N - 1 - N // 2)) / N
    s = (ixi * ixi + iyi * iyi).reshape(-1)
    return FX.reshape(-1), FY.reshape(-1), FR.reshape(-1), (FR <= f_max).reshape(-1), s


def _bandwidth_from_psd(P) -> dict:
    """Bandwidth statistics of fftshifted scaled PSDs (..., N, N)."""
    N = int(P.shape[-1])
    P = torch.nan_to_num(P, nan=0.0, posinf=0.0, neginf=0.0)
    P[..., N // 2, N // 2] = 0.0
    dt = P.dtype
    fxm, fym, frm, inside, s_flat = _freq_plan(N, dt, P.device)

    Pm = torch.where(inside, P.flatten(-2), 0.0)
    total = Pm.sum(-1)
    tsafe = torch.where(total > 0, total, 1.0)
    feq = torch.sqrt((frm * frm * Pm).sum(-1) / tsafe)
    sig_fx = torch.sqrt((fxm * fxm * Pm).sum(-1) / tsafe)
    sig_fy = torch.sqrt((fym * fym * Pm).sum(-1) / tsafe)
    rf = torch.where(sig_fy != 0, sig_fx / torch.where(sig_fy != 0, sig_fy, 1.0), np.inf)

    # f95 by exact integer-radius classes: shifted frequencies are
    # (i - N//2)/N, so FR groups by s = ix^2 + iy^2 and the crossing radius
    # is the smallest s whose inclusive mass reaches 0.95 of the total,
    # found by bisection on s (masked sums, deterministic)
    smax = (N // 2) ** 2
    target = torch.tensor(0.95, dtype=dt) * tsafe
    lo = torch.zeros(total.shape, dtype=torch.int32, device=P.device)
    hi = torch.full(total.shape, smax, dtype=torch.int32, device=P.device)
    for _ in range(max(1, int(np.ceil(np.log2(smax + 1)))) + 1):
        mid = (lo + hi) // 2
        reached = torch.where(s_flat <= mid[..., None], Pm, 0.0).sum(-1) >= target
        lo, hi = torch.where(reached, lo, mid + 1), torch.where(reached, mid, hi)
    f95 = torch.sqrt(hi.to(dt)) / N

    p = Pm / tsafe[..., None]
    spr_denom = (p * p).sum(-1)
    spr = torch.where(spr_denom > 0, 1.0 / torch.where(spr_denom > 0, spr_denom, 1.0), np.nan)

    bad = ~(torch.isfinite(total) & (total > 0))
    out = {"feq": feq, "f95": f95, "sig_fx": sig_fx, "sig_fy": sig_fy, "rf": rf, "spr": spr}
    return {k: torch.where(bad, np.nan, v) for k, v in out.items()}
