# SPDX-License-Identifier: CECILL-2.1
"""Fourier Ring Correlation: resolution estimation from two acquisitions
(counterpart of ``barc4dip_tpu/metrics/frc.py``).

The standard way to measure the achieved spatial resolution of a
detector/optics chain is to correlate two independent noisy acquisitions of
the same field ring-by-ring in frequency space (van Heel & Schatz, JSB 151
(2005) 250):

    FRC(r) = Re sum_{|f| in r} F1(f) conj(F2(f))
             / sqrt( sum_{|f| in r} |F1|^2 * sum_{|f| in r} |F2|^2 )

The curve falls from ~1 (correlated signal dominates) to ~0 (independent
noise); the frequency where it crosses a threshold (0.143 is the
single-image gold standard, 0.5 the conservative classic) is the
resolution.

Both FFTs, the conjugate product and the three per-ring reductions run on
the device in complex64 whatever the input dtype; only the (nr,) curve
comes to the host, where the threshold crossing is interpolated. The ring
sums are ``index_add_`` sums over integer-radius frequency rings, which on
CUDA add with atomics in no fixed order: two runs of the same call may
differ in the last float32 bits of the curve.
"""
from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..config import device_arrays

__all__ = ["fourier_ring_correlation"]

logger = logging.getLogger(__name__)


def _ring_ids(shape: tuple[int, int], device) -> tuple[torch.Tensor, int]:
    """(flat ring id of every bin of the unshifted frequency grid, nr):
    the id is ``rint`` of the float32 radius in units of one frequency
    sample of the shorter side; rings beyond the inscribed Nyquist circle
    share the discard id ``nr``."""
    H, W = shape
    n = min(H, W)
    nr = n // 2
    fy = torch.from_numpy(np.fft.fftfreq(H).astype(np.float32)).to(device)[:, None]
    fx = torch.from_numpy(np.fft.fftfreq(W).astype(np.float32)).to(device)[None, :]
    rid = torch.round(torch.sqrt(fy * fy + fx * fx) * n).long()
    return torch.where(rid < nr, rid, nr).reshape(-1), nr


def _frc_curve(a, b, *, complex_dtype=torch.complex64):
    """The FRC curve (nr,) of two mean-removed real (H, W) tensors, computed
    in ``complex_dtype``."""
    rid, nr = _ring_ids(tuple(a.shape), a.device)
    Fa = torch.fft.fft2(a.to(complex_dtype))
    Fb = torch.fft.fft2(b.to(complex_dtype))
    cross = Fa * Fb.conj()

    def ring_sum(values):
        sums = torch.zeros(nr + 1, dtype=values.dtype, device=values.device)
        return sums.index_add_(0, rid, values.reshape(-1))[:nr]

    num = ring_sum(cross.real)
    den = torch.sqrt(ring_sum(Fa.abs() ** 2) * ring_sum(Fb.abs() ** 2))
    return torch.where(den > 0.0, num / torch.where(den > 0.0, den, 1.0), math.nan)


def fourier_ring_correlation(
    image1,
    image2,
    *,
    threshold: float = 0.143,
    verbose: bool = False,
    device=None,
) -> dict:
    """FRC curve of two same-shape acquisitions plus the resolution at
    ``threshold``.

    Parameters
    ----------
    image1, image2 : (H, W) arrays (NumPy or tensors)
        Two independent acquisitions of the same field (e.g. split frames
        or consecutive exposures). Means are removed (the DC ring carries
        no resolution information and would otherwise pin FRC(0) to 1).
    threshold : float
        Crossing level; 0.143 (default) or 0.5 are the standard choices.
    device
        Where NumPy inputs compute: ``None`` is the card, and an error
        without one. Tensors compute on their own device.

    Returns
    -------
    dict with ``freq`` (cycles/px ring centers, (nr,)), ``frc`` ((nr,)),
    ``threshold``, ``resolution_cyc_per_px`` (first downward crossing,
    linearly interpolated; NaN if the curve never falls below the
    threshold) and ``resolution_px`` (its reciprocal: the full period of
    the finest reliably-transferred feature).
    """
    shapes = [tuple(np.shape(im)) for im in (image1, image2)]
    if len(shapes[0]) != 2 or len(shapes[1]) != 2:
        raise ValueError("fourier_ring_correlation expects two 2D images.")
    if shapes[0] != shapes[1]:
        raise ValueError(f"shape mismatch: {shapes[0]} vs {shapes[1]}")
    if not (0.0 < float(threshold) < 1.0):
        raise ValueError("threshold must be in (0, 1).")

    a, b = device_arrays(image1, image2, device=device)
    n = min(shapes[0])
    a32 = a.to(torch.float32)
    b32 = b.to(torch.float32)
    a32 = a32 - a32.mean()
    b32 = b32 - b32.mean()
    frc = _frc_curve(a32, b32).cpu().numpy().astype(np.float64)
    nr = frc.shape[0]
    freq = np.arange(nr, dtype=np.float64) / n  # cycles per pixel

    # first downward crossing below the threshold (skip the DC ring, whose
    # mean-removed numerator is ~0 by construction)
    res_f = np.nan
    thr = float(threshold)
    for i in range(2, nr):
        y0, y1 = frc[i - 1], frc[i]
        if np.isfinite(y0) and np.isfinite(y1) and y0 >= thr > y1:
            t = (y0 - thr) / (y0 - y1)
            res_f = freq[i - 1] + t * (freq[i] - freq[i - 1])
            break
    out = {
        "freq": freq,
        "frc": frc,
        "threshold": thr,
        "resolution_cyc_per_px": float(res_f),
        "resolution_px": float(1.0 / res_f) if np.isfinite(res_f) else np.nan,
    }
    if verbose:
        logger.info(
            "> fourier_ring_correlation: rings=%d | threshold=%.3f | "
            "resolution=%.4f cyc/px (%.2f px)",
            nr, thr, out["resolution_cyc_per_px"], out["resolution_px"],
        )
    return out
