# SPDX-License-Identifier: CECILL-2.1
"""Gradient-field integration by Frankot-Chellappa least squares
(counterpart of ``barc4dip_tpu/maths/integrate.py``): the last step of
speckle-tracking wavefront sensing, where dense displacement maps are local
wavefront slopes.

    Z = F^-1 [ -i (kx F[gx] + ky F[gy]) / (kx^2 + ky^2) ],  Z(0,0) := 0

Periodic-boundary least squares, returned zero-mean (piston is
undetermined).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["integrate_gradients"]


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


def integrate_gradients(gy, gx, *, dy: float = 1.0, dx: float = 1.0) -> torch.Tensor:
    """Surface ``z`` with ``dz/dy ~ gy`` and ``dz/dx ~ gx`` (least squares).

    ``gy``, ``gx``: equal-shape 2D arrays or tensors (row axis = y). Both
    promote together; integer gradients compute in float32. Tensors stay on
    their device; numpy gradients compute on the CPU (a grid of a few
    hundred nodes). Returns the zero-mean integrated surface as a tensor.
    """
    gy = _as_tensor(gy)
    gx = _as_tensor(gx)
    dtype = torch.promote_types(gy.dtype, gx.dtype)
    if not (dtype.is_floating_point or dtype.is_complex):
        dtype = torch.promote_types(dtype, torch.float32)
    gy = gy.to(dtype)
    if gy.dim() != 2 or gy.shape != gx.shape:
        raise ValueError(
            f"gy and gx must be equal-shape 2D arrays; got {tuple(gy.shape)} vs {tuple(gx.shape)}"
        )
    if not (np.isfinite(dy) and np.isfinite(dx)) or dy <= 0 or dx <= 0:
        raise ValueError("dy and dx must be positive finite grid spacings.")
    gx = gx.to(device=gy.device, dtype=dtype)

    real = gy.real.dtype if dtype.is_complex else dtype
    ny, nx = gy.shape
    ky = 2.0 * math.pi * torch.fft.fftfreq(ny, d=float(dy), dtype=real, device=gy.device)[:, None]
    kx = 2.0 * math.pi * torch.fft.fftfreq(nx, d=float(dx), dtype=real, device=gy.device)[None, :]
    k2 = ky * ky + kx * kx
    # DC carries the undetermined piston: divide safely, zero it after
    k2_safe = torch.where(k2 == 0.0, 1.0, k2)
    Fz = -1j * (kx * torch.fft.fft2(gx) + ky * torch.fft.fft2(gy)) / k2_safe
    Fz[0, 0] = 0.0
    z = torch.fft.ifft2(Fz).real
    return z - z.mean()
