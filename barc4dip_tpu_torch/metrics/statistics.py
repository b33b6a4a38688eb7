# SPDX-License-Identifier: CECILL-2.1
"""Intensity distribution moments of one image (counterpart of
``barc4dip_tpu/metrics/statistics.py``)."""
from __future__ import annotations

import logging

import torch

from ..config import device_array
from ..ops.momentscore import distribution_moments_core

logger = logging.getLogger(__name__)

__all__ = ["distribution_moments"]


def distribution_moments(
    image,
    *,
    saturation_value: float | None = 65535.0,
    eps: float = 1e-6,
    verbose: bool = False,
    device=None,
) -> dict:
    """Intensity distribution moments and simple diagnostics of a 1D or 2D
    numpy array or tensor.

    Returns mean, std, variance, skewness, kurtosis (scipy.stats.describe
    conventions), frac_zero (|x| <= eps), frac_sat (>= saturation_value or
    NaN), and SNRdB = 20*log10(mean/std) with inf/nan edge handling."""
    x = device_array(image, device)
    if x.ndim not in (1, 2):
        raise ValueError(f"Expected 1D or 2D array, got ndim={x.ndim}")
    if x.numel() == 0:
        raise ValueError("distribution_moments received an empty image.")
    if not bool(torch.isfinite(x).any()):
        raise ValueError("distribution_moments received no finite values.")

    out = distribution_moments_core(
        x.reshape(1, -1) if x.ndim == 1 else x,
        saturation_value=None if saturation_value is None else float(saturation_value),
        eps=float(eps),
    )
    moments = {k: float(v) for k, v in out.items()}

    if verbose:
        m = moments
        fields = (
            f"mean={m['mean']:.0f}", f"std={m['std']:.0f}",
            f"var={m['variance']:.0f}", f"skew={m['skewness']:.2f}",
            f"kurt={m['kurtosis']:.2f}", f"SNR={m['SNRdB']:.2f} dB",
            f"zero={m['frac_zero']:.6f}", f"sat={m['frac_sat']:.6f}",
        )
        logger.info("> moments: %s", " | ".join(fields))
    return moments
