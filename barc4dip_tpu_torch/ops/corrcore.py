# SPDX-License-Identifier: CECILL-2.1
"""FFT-based circular correlation (counterpart of
``barc4dip_tpu/ops/corrcore.py``, natural order): ``ifft(Fa * conj(Fb))``
with optional mean removal / standardisation, fftshifted so zero lag sits
at the centre, and optional peak normalisation. Real inputs go through
rfft/irfft: half the FFT work and an exactly real result.

The 1-D cores take (..., n) signals and reduce over the last axis, the 2-D
cores (..., H, W) images and reduce over the last two, per signal or image.

The autocorrelation's inverse transform goes through
``cuda_fftp.corr_from_rfft``: kernel K1 on CUDA for the shapes it covers,
its plain version otherwise. That is the same split as the TPU build, where
only the 2-D autocorrelation of a real image reaches the Pallas kernel; the
cross-correlations are plain ``fft`` calls in both packages.
"""
from __future__ import annotations

import torch

from ..utils.profiling import annotate
from . import cuda_fftp

__all__ = ["xcorr1d_core", "xcorr2d_core", "autocorr2d_core"]


def _finalize(corr, normalize: str, dims=(-2, -1)):
    if normalize == "none":
        return corr
    if normalize == "peak":
        m = corr.abs().amax(dim=dims, keepdim=True)
        return torch.where(m > 0, corr / torch.where(m > 0, m, 1.0), corr)
    raise ValueError(f"Invalid normalize='{normalize}'. Use 'none' or 'peak'.")


def _precondition(a, remove_mean: bool, standardize: bool, dims=(-2, -1)):
    """Per image (per signal for ``dims=(-1,)``): subtract the mean, then
    divide by the population std where that is > 0."""
    if remove_mean:
        a = a - a.mean(dim=dims, keepdim=True)
    if standardize:
        if a.is_complex():
            dev = a - a.mean(dim=dims, keepdim=True)
            s = (dev.real**2 + dev.imag**2).mean(dim=dims, keepdim=True).sqrt()
        else:
            s = a.std(dim=dims, correction=0, keepdim=True)
        a = torch.where(s > 0, a / torch.where(s > 0, s, 1.0), a)
    return a


def xcorr1d_core(a, b, *, remove_mean=True, standardize=False, normalize="peak"):
    """Shifted circular cross-correlation of 1D signals along the last axis."""
    a = _precondition(a, remove_mean, standardize, (-1,))
    b = _precondition(b, remove_mean, standardize, (-1,))
    n = a.shape[-1]
    if a.is_complex() or b.is_complex():
        corr = torch.fft.ifft(torch.fft.fft(a) * torch.fft.fft(b).conj())
    else:
        corr = torch.fft.irfft(torch.fft.rfft(a) * torch.fft.rfft(b).conj(), n=n)
    return _finalize(torch.fft.fftshift(corr, dim=-1), normalize, (-1,))


def xcorr2d_core(a, b, *, remove_mean=True, standardize=False, normalize="peak"):
    """Shifted circular cross-correlation of 2D signals over the last two
    axes."""
    a = _precondition(a, remove_mean, standardize)
    b = _precondition(b, remove_mean, standardize)
    shape = tuple(a.shape[-2:])
    if a.is_complex() or b.is_complex():
        corr = torch.fft.ifft2(torch.fft.fft2(a) * torch.fft.fft2(b).conj())
    else:
        corr = torch.fft.irfft2(torch.fft.rfft2(a) * torch.fft.rfft2(b).conj(), s=shape)
    return _finalize(torch.fft.fftshift(corr, dim=(-2, -1)), normalize)


@annotate("k1.autocorr")
def autocorr2d_core(
    a, *, remove_mean: bool = True, standardize: bool = False, normalize: str = "peak"
):
    """fftshifted circular autocorrelation of real (..., H, W) images,
    ``irfft2(|rfft2(a)|^2)``: exactly real by construction."""
    a = _precondition(a, remove_mean, standardize)
    H, W = a.shape[-2], a.shape[-1]
    lead = a.shape[:-2]
    F = torch.fft.rfft2(a.reshape(-1, H, W))
    corr = cuda_fftp.corr_from_rfft(F, F[:, None], s=(H, W))[:, 0]
    corr = torch.fft.fftshift(corr.reshape(*lead, H, W), dim=(-2, -1))
    return _finalize(corr, normalize)
