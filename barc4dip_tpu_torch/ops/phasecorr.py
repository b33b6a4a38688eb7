# SPDX-License-Identifier: CECILL-2.1
"""Peak localisation (counterpart of ``barc4dip_tpu/ops/phasecorr.py``'s
``argmax2d`` and ``subpixel_taylor``) on batches of (..., H, W) maps."""
from __future__ import annotations

import torch

__all__ = ["argmax2d", "subpixel_taylor"]


def argmax2d(a):
    """(i, j) of the maximum of each map: the first occurrence in
    row-major order, NaN ranked highest (``jnp.argmax`` semantics)."""
    W = a.shape[-1]
    idx = a.flatten(-2).argmax(-1)
    return idx // W, idx % W


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
