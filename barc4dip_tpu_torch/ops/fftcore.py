# SPDX-License-Identifier: CECILL-2.1
"""Shifted FFT / PSD primitives (counterpart of
``barc4dip_tpu/ops/fftcore.py``).

All spectra are fftshifted (DC centered) and frequency axes are shifted to
match. The 1-D functions transform the last axis of (..., n) tensors, the
2-D functions the last two axes of (..., H, W) tensors; the physical-units
wrappers live in :mod:`barc4dip_tpu_torch.signal.fft`.
"""
from __future__ import annotations

import torch

__all__ = [
    "shifted_freqs",
    "fft1_shifted",
    "ifft1_shifted",
    "fft2_shifted",
    "ifft2_shifted",
    "psd1d_core",
    "psd2d_core",
]


def shifted_freqs(n: int, step: float, dtype=None, device=None):
    """fftshift(fftfreq(n, d=step)): the shifted frequency axis."""
    return torch.fft.fftshift(torch.fft.fftfreq(int(n), d=step, dtype=dtype, device=device))


def fft1_shifted(signal):
    """Shifted complex 1D FFT along the last axis."""
    return torch.fft.fftshift(torch.fft.fft(signal, dim=-1), dim=-1)


def ifft1_shifted(F):
    """Inverse of :func:`fft1_shifted` (takes a shifted spectrum)."""
    return torch.fft.ifft(torch.fft.ifftshift(F, dim=-1), dim=-1)


def fft2_shifted(image):
    """Shifted complex 2D FFT over the last two axes."""
    return torch.fft.fftshift(torch.fft.fft2(image, dim=(-2, -1)), dim=(-2, -1))


def ifft2_shifted(F):
    """Inverse of :func:`fft2_shifted` (takes a shifted spectrum)."""
    return torch.fft.ifft2(torch.fft.ifftshift(F, dim=(-2, -1)), dim=(-2, -1))


def psd1d_core(signal, *, step: float = 1.0, scale: bool = True):
    """|FFT|^2 of 1D signals, shifted; optional physical scaling ``*step/n``.

    Real input takes the rfft path (half-spectrum compute, mirrored back):
    the |F|^2 of a real signal is Hermitian-symmetric.
    """
    n = signal.shape[-1]
    if signal.is_complex():
        P = torch.fft.fft(signal, dim=-1).abs() ** 2
    else:
        Fh = torch.fft.rfft(signal, dim=-1)
        P = _mirror_half_spectrum_1d(Fh.real**2 + Fh.imag**2, n)
    P = torch.fft.fftshift(P, dim=-1)
    if scale:
        P = P * (step / float(n))
    return P


def psd2d_core(image, *, step_x: float = 1.0, step_y: float = 1.0, scale: bool = True):
    """|FFT2|^2, fftshifted; optional scaling ``*(dx*dy)/(nx*ny)``. Real
    input uses rfft2 and mirrors the half spectrum back (half the FFT work
    and an exactly real result)."""
    ny, nx = image.shape[-2], image.shape[-1]
    if image.is_complex():
        P = torch.fft.fft2(image, dim=(-2, -1)).abs() ** 2
    else:
        Fh = torch.fft.rfft2(image)
        P = _mirror_half_spectrum_2d(Fh.real**2 + Fh.imag**2, nx)
    P = torch.fft.fftshift(P, dim=(-2, -1))
    if scale:
        P = P * ((step_x * step_y) / (float(nx) * float(ny)))
    return P


def _mirror_half_spectrum_1d(Ph, n: int):
    """Full |F|^2 from the rfft half spectrum (length n//2+1): P[k] = Ph[k]
    for k <= n//2, P[k] = Ph[n - k] otherwise."""
    tail = Ph[..., 1:-1] if n % 2 == 0 else Ph[..., 1:]
    return torch.cat([Ph, torch.flip(tail, dims=[-1])], dim=-1)


def _mirror_half_spectrum_2d(Ph, nx: int):
    """Full |F2|^2 from the rfft2 half spectrum (..., ny, nx//2+1), using
    |F[ky, kx]| = |F[(-ky) % ny, (-kx) % nx]|."""
    tail = Ph[..., :, 1:-1] if nx % 2 == 0 else Ph[..., :, 1:]
    tail = torch.flip(tail, dims=[-1])
    tail = torch.roll(torch.flip(tail, dims=[-2]), 1, dims=-2)
    return torch.cat([Ph, tail], dim=-1)
