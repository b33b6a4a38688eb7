# SPDX-License-Identifier: CECILL-2.1
"""Matrix-multiply DFT local upsampling (Guizar-Sicairos et al., Opt. Lett.
33, 156 (2008)) and the upsampled phase cross-correlation built on it
(counterpart of ``barc4dip_tpu/ops/upsampled_dft.py``).

A coarse FFT correlation peak is refined by an upsampled DFT evaluated only
in a small neighbourhood: two small complex matrix products, which the JAX
package also computes outside any kernel. On CUDA they go through cuBLAS;
``config`` pins TF32 off.
"""
from __future__ import annotations

import math

import torch

from .phasecorr import argmax2d

__all__ = ["upsampled_dft", "phase_cross_correlation_upsampled"]


def upsampled_dft(data, upsampled_region_size: int, upsample_factor: int, axis_offsets):
    """Upsampled 2D DFT of ``data`` (complex, shape (ny, nx)) by matrix
    multiplication, evaluated on a (S, S) grid starting at ``axis_offsets``
    (two numbers or a 2-vector tensor on ``data``'s device)."""
    ny, nx = data.shape
    S = int(upsampled_region_size)
    u = float(upsample_factor)
    real, dev = data.real.dtype, data.device

    def kernel(n, offset):
        # (S, n) complex kernel for one axis
        rows = torch.arange(S, device=dev)[:, None].to(real) - offset
        cols = (torch.fft.ifftshift(torch.arange(n, device=dev)) - n // 2)[None, :]
        return torch.exp((-2j * math.pi / (n * u)) * rows * cols)

    ky = kernel(ny, axis_offsets[0])
    kx = kernel(nx, axis_offsets[1])
    return ky @ data @ kx.T


def phase_cross_correlation_upsampled(reference, moving, *, upsample_factor: int = 1):
    """Subpixel translation registration, skimage-compatible semantics
    (normalization="phase"). Returns (dy, dx), 0-d tensors, such that
    shifting ``moving`` by (dy, dx) aligns it to ``reference``. Peaks are
    row-major first maxima (:func:`..phasecorr.argmax2d`)."""
    shape = tuple(reference.shape)
    src_freq = torch.fft.fft2(reference)
    target_freq = torch.fft.fft2(moving)
    real, dev = src_freq.real.dtype, src_freq.device

    image_product = src_freq * target_freq.conj()
    eps = torch.finfo(real).eps
    image_product = image_product / torch.clamp_min(image_product.abs(), 100 * eps)

    cross_correlation = torch.fft.ifft2(image_product)
    maxima = torch.stack(argmax2d(cross_correlation.abs())).to(real)

    midpoints = torch.tensor([s // 2 for s in shape], dtype=real, device=dev)
    sizes = torch.tensor(shape, dtype=real, device=dev)
    shifts = torch.where(maxima > midpoints, maxima - sizes, maxima)

    if upsample_factor == 1:
        return shifts[0], shifts[1]

    u = float(upsample_factor)
    shifts = torch.round(shifts * u) / u
    S = int(math.ceil(u * 1.5))
    dftshift = float(int(S / 2))  # np.fix of a positive value

    sample_region_offset = dftshift - shifts * u
    cc_up = upsampled_dft(image_product.conj(), S, upsample_factor, sample_region_offset).conj()
    maxima_up = torch.stack(argmax2d(cc_up.abs())).to(real)

    shifts = shifts + (maxima_up - dftshift) / u
    return shifts[0], shifts[1]
