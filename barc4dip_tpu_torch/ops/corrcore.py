# SPDX-License-Identifier: CECILL-2.1
"""Circular autocorrelation (counterpart of
``barc4dip_tpu/ops/corrcore.py::autocorr2d_core``, natural order).

The inverse transform goes through ``cuda_fftp.corr_from_rfft``: kernel K1
on CUDA for the shapes it covers, its plain version otherwise. That is the
same split as the TPU build, where the 2-D call reaches the Pallas kernel.
"""
from __future__ import annotations

import torch

from . import cuda_fftp

__all__ = ["autocorr2d_core"]


def _finalize(corr, normalize: str):
    if normalize == "none":
        return corr
    if normalize == "peak":
        m = corr.abs().amax(dim=(-2, -1), keepdim=True)
        return torch.where(m > 0, corr / torch.where(m > 0, m, 1.0), corr)
    raise ValueError(f"Invalid normalize='{normalize}'. Use 'none' or 'peak'.")


def _precondition(a, remove_mean: bool, standardize: bool):
    """Per image: subtract the mean, then divide by the population std
    where that is > 0."""
    if remove_mean:
        a = a - a.mean(dim=(-2, -1), keepdim=True)
    if standardize:
        s = a.std(dim=(-2, -1), correction=0, keepdim=True)
        a = torch.where(s > 0, a / torch.where(s > 0, s, 1.0), a)
    return a


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
