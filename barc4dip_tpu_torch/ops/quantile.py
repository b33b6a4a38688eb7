# SPDX-License-Identifier: CECILL-2.1
"""Exact NaN-aware percentiles (counterpart of
``barc4dip_tpu/ops/quantile.py::nanpercentiles_exact``).

The TPU build finds order statistics by bisection on bit patterns because
TPU sorts compile slowly; on the GPU a sort of each image is the plain way
to the same order statistics. ``torch.quantile`` is avoided: it caps its
input size.
"""
from __future__ import annotations

import math

import torch

from ..config import device_constant

__all__ = ["median_exact", "nanmedian_exact", "nanpercentiles_exact", "nanquantiles_exact"]


def nanquantiles_exact(x, qs: tuple[float, ...], *, integer_range=None):
    """Linear-interpolation quantiles (q in [0, 1]) over the last two axes
    of ``x`` (..., H, W), or over all of a 1-D ``x``, excluding NaNs;
    infinities are ranked. Returns (..., len(qs)) in x's dtype; an all-NaN
    image gives NaN. Equal order
    statistics return that value (an infinite one stays infinite).

    ``integer_range=(lo, hi)`` is accepted for API parity (the TPU build
    uses it to shorten its bisection) and validated; the result is the same
    with or without it."""
    if integer_range is not None:
        lo_v, hi_v = (int(v) for v in integer_range)
        if not (lo_v <= hi_v and hi_v - lo_v < (1 << 24) and abs(lo_v) < (1 << 24)):
            raise ValueError(
                "integer_range must satisfy lo <= hi with span/magnitude "
                "< 2^24 (float32-exact thresholds)"
            )
    x = x.flatten(-2) if x.dim() >= 2 else x.reshape(-1)
    nan = torch.isnan(x)
    n = (~nan).sum(-1)
    # NaNs sort past every ranked value: the first n entries are the ranked ones
    xs = torch.sort(torch.where(nan, math.inf, x), dim=-1).values

    q = device_constant(qs, torch.float64, x.device)
    rank = q * (n.clamp_min(1) - 1)[..., None].to(torch.float64)
    lo_k = torch.floor(rank).long()
    hi_k = torch.ceil(rank).long()
    frac = (rank - torch.floor(rank)).to(x.dtype)
    v_lo = xs.gather(-1, lo_k)
    v_hi = xs.gather(-1, hi_k)
    out = v_lo + frac * (v_hi - v_lo)
    out = torch.where(v_lo == v_hi, v_lo, out)
    return torch.where(n[..., None] > 0, out, math.nan)


def nanpercentiles_exact(x, ps: tuple[float, ...], *, integer_range=None):
    """Exact NaN-aware percentiles (p in [0, 100]); see
    :func:`nanquantiles_exact`."""
    return nanquantiles_exact(
        x, tuple(p / 100.0 for p in ps), integer_range=integer_range
    )


def nanmedian_exact(x):
    """Exact NaN-aware median over the last two axes."""
    return nanquantiles_exact(x, (0.5,))[..., 0]


def median_exact(x):
    """Exact median over the last two axes of an input free of NaNs."""
    return nanmedian_exact(x)
