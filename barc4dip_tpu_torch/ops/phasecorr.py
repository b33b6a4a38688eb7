# SPDX-License-Identifier: CECILL-2.1
"""Phase correlation and peak localisation (counterpart of
``barc4dip_tpu/ops/phasecorr.py``) on batches of (..., H, W) maps.

The phase-correlation surface runs on ``torch.fft``: its inverse transform
is of a whitened cross-power spectrum, not of the plain product kernel K1
computes.
"""
from __future__ import annotations

import torch

from .momentscore import nanmean2d, nanstd2d
from .quantile import median_exact

__all__ = [
    "argmax2d",
    "peak_quality",
    "phase_corr_from_spectra",
    "phase_corr_surface",
    "subpixel_taylor",
    "zscore2d",
]


def zscore2d(a, *, eps: float = 1e-9):
    """(a - nanmean) / (nanstd + eps) of each image (reference _zscore2d)."""
    return (a - nanmean2d(a)[..., None, None]) / (nanstd2d(a)[..., None, None] + eps)


def phase_corr_surface(img_z, tpl_pad, *, eps: float = 1e-9):
    """|fftshift(irfft2(whitened cross-power spectrum))| of same-shape real
    images (pre-normalised: z-scored, templates embedded)."""
    H, W = img_z.shape[-2], img_z.shape[-1]
    return phase_corr_from_spectra(
        torch.fft.rfft2(img_z), torch.fft.rfft2(tpl_pad), s=(H, W), eps=eps
    )


def phase_corr_from_spectra(Fi, Ft, *, s, eps: float = 1e-9):
    """:func:`phase_corr_surface` from the rfft2 spectra (broadcasting), so
    one image spectrum serves a bank of templates."""
    prod = Fi * Ft.conj()
    corr = torch.fft.irfft2(prod / (prod.abs() + eps), s=s)
    return torch.fft.fftshift(corr, dim=(-2, -1)).abs()


def argmax2d(a):
    """(i, j) of the maximum of each map: the first occurrence in
    row-major order, NaN ranked highest (``jnp.argmax`` semantics)."""
    W = a.shape[-1]
    idx = a.flatten(-2).argmax(-1)
    return idx // W, idx % W


def peak_quality(corr, i, j, *, eps: float = 1e-9):
    """(peak value, snr) with snr = |peak| / (median|corr| + eps), per map
    (reference _corr_peak_quality)."""
    W = corr.shape[-1]
    idx = torch.as_tensor(i, device=corr.device) * W + torch.as_tensor(j, device=corr.device)
    peak = corr.flatten(-2).gather(-1, idx[..., None].expand(*corr.shape[:-2], 1))[..., 0]
    return peak, peak.abs() / (median_exact(corr.abs()) + eps)


def subpixel_taylor(corr, i, j, *, convention: str = "newton", bounds=None):
    """Subpixel (di, dj) from a 3x3 quadratic fit around the integer peak
    (i, j). Border peaks and degenerate Hessians give (0, 0).

    ``convention="newton"`` is the 2-D Newton step; ``"reference"`` the
    reference's swapped-component solve. ``bounds=(by, bx)`` sets the border
    extent for maps whose trailing region is masked rather than sliced."""
    if convention not in ("newton", "reference"):
        raise ValueError("convention must be 'newton' or 'reference'.")
    H, W = corr.shape[-2], corr.shape[-1]
    ny, nx = (H, W) if bounds is None else bounds

    ic = i.clamp(1, ny - 2)
    jc = j.clamp(1, nx - 2)
    off = torch.arange(-1, 2, device=corr.device)
    idx = (ic[..., None, None] + off[:, None]) * W + (jc[..., None, None] + off[None, :])
    nb = corr.flatten(-2).gather(-1, idx.flatten(-2)).unflatten(-1, (3, 3))

    dy = (nb[..., 2, 1] - nb[..., 0, 1]) / 2.0
    dyy = nb[..., 2, 1] + nb[..., 0, 1] - 2.0 * nb[..., 1, 1]
    dx = (nb[..., 1, 2] - nb[..., 1, 0]) / 2.0
    dxx = nb[..., 1, 2] + nb[..., 1, 0] - 2.0 * nb[..., 1, 1]
    dxy = (nb[..., 2, 2] - nb[..., 2, 0] - nb[..., 0, 2] + nb[..., 0, 0]) / 4.0

    det = dxx * dyy - dxy * dxy
    safe_det = torch.where(det == 0.0, 1.0, det)
    if convention == "newton":
        di = -(dxx * dy - dxy * dx) / safe_det
        dj = -(dyy * dx - dxy * dy) / safe_det
    else:
        di = -(dyy * dx - dxy * dy) / safe_det
        dj = -(dxx * dy - dxy * dx) / safe_det

    bad = (i <= 0) | (i >= ny - 1) | (j <= 0) | (j >= nx - 1) | (det == 0.0)
    return torch.where(bad, 0.0, di), torch.where(bad, 0.0, dj)
