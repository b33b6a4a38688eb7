# SPDX-License-Identifier: CECILL-2.1
"""Masked distribution moments (counterpart of
``barc4dip_tpu/ops/momentscore.py``) and the NaN-aware image mean/std the
other estimators share.

Every function reduces the last two axes of a (..., H, W) tensor.
"""
from __future__ import annotations

import math

import torch

__all__ = ["distribution_moments_core", "nanmean2d", "nanstd2d"]


def nanmean2d(x):
    """Mean over the last two axes ignoring NaNs (``jnp.nanmean``)."""
    valid = ~torch.isnan(x)
    n = valid.sum(dim=(-2, -1))
    return torch.where(valid, x, 0).sum(dim=(-2, -1)) / n


def nanstd2d(x):
    """Population std over the last two axes ignoring NaNs (``jnp.nanstd``,
    ddof 0)."""
    valid = ~torch.isnan(x)
    n = valid.sum(dim=(-2, -1))
    d = torch.where(valid, x - nanmean2d(x)[..., None, None], 0)
    return torch.sqrt((d * d).sum(dim=(-2, -1)) / n)


def distribution_moments_core(
    x, *, saturation_value: float | None = 65535.0, eps: float = 1e-6
) -> dict:
    """mean, population std/var, biased skewness and Fisher kurtosis
    (scipy.stats.describe conventions), frac_zero, frac_sat and SNRdB over
    the finite values of each image. No finite value gives NaN everywhere."""
    x = x.flatten(-2)
    finite = torch.isfinite(x)
    n = finite.sum(-1)
    nf = n.clamp_min(1).to(x.dtype)

    mean = torch.where(finite, x, 0).sum(-1) / nf
    d = torch.where(finite, x - mean[..., None], 0)
    m2 = (d * d).sum(-1) / nf
    m3 = (d * d * d).sum(-1) / nf
    m4 = (d * d * d * d).sum(-1) / nf

    std = torch.sqrt(m2)
    variance = std * std

    zero_m2 = m2 == 0
    m2s = torch.where(zero_m2, 1.0, m2)
    nan = torch.full_like(m2, math.nan)
    skewness = torch.where(zero_m2, nan, m3 / m2s**1.5)
    kurtosis = torch.where(zero_m2, nan, m4 / (m2s * m2s) - 3.0)

    frac_zero = (finite & (x.abs() <= eps)).sum(-1) / nf
    if saturation_value is None:
        frac_sat = nan
    else:
        frac_sat = (finite & (x >= saturation_value)).sum(-1) / nf

    # SNRdB edge cases: std == 0 gives +inf if mean > 0 else nan;
    # mean/std == 0 gives -inf, mean/std < 0 gives nan
    inf = torch.full_like(m2, math.inf)
    snr_lin = torch.where(std == 0, inf, mean / torch.where(std == 0, 1.0, std))
    snr_db = torch.where(
        std == 0.0,
        torch.where(mean > 0.0, inf, nan),
        torch.where(
            snr_lin > 0.0,
            20.0 * torch.log10(torch.where(snr_lin > 0.0, snr_lin, 1.0)),
            torch.where(snr_lin == 0.0, -inf, nan),
        ),
    )

    empty = n == 0
    out = {
        "mean": mean, "std": std, "variance": variance, "skewness": skewness,
        "kurtosis": kurtosis, "frac_zero": frac_zero, "frac_sat": frac_sat,
        "SNRdB": snr_db,
    }
    return {k: torch.where(empty, nan, v) for k, v in out.items()}
