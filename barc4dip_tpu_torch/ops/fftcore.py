# SPDX-License-Identifier: CECILL-2.1
"""Shifted PSD (counterpart of ``barc4dip_tpu/ops/fftcore.py::psd2d_core``).

Functions take (..., H, W) tensors and transform the last two axes.
"""
from __future__ import annotations

import torch

__all__ = ["psd2d_core"]


def psd2d_core(image, *, step_x: float = 1.0, step_y: float = 1.0, scale: bool = True):
    """|FFT2|^2 of real images, fftshifted; optional scaling
    ``*(dx*dy)/(nx*ny)``. Uses rfft2 and mirrors the half spectrum back."""
    ny, nx = image.shape[-2], image.shape[-1]
    Fh = torch.fft.rfft2(image)
    P = _mirror_half_spectrum_2d(Fh.real**2 + Fh.imag**2, nx)
    P = torch.fft.fftshift(P, dim=(-2, -1))
    if scale:
        P = P * ((step_x * step_y) / (float(nx) * float(ny)))
    return P


def _mirror_half_spectrum_2d(Ph, nx: int):
    """Full |F2|^2 from the rfft2 half spectrum (..., ny, nx//2+1), using
    |F[ky, kx]| = |F[(-ky) % ny, (-kx) % nx]|."""
    tail = Ph[..., :, 1:-1] if nx % 2 == 0 else Ph[..., :, 1:]
    tail = torch.flip(tail, dims=[-1])
    tail = torch.roll(torch.flip(tail, dims=[-2]), 1, dims=-2)
    return torch.cat([Ph, tail], dim=-1)
