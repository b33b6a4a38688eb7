# SPDX-License-Identifier: CECILL-2.1
"""FFT and power spectral density helpers (counterpart of
``barc4dip_tpu/signal/fft.py``).

Conventions:
- 2D arrays use NumPy shape (ny, nx), axes (y, x).
- FFT outputs are always shifted (DC centered) via fftshift.
- Frequency axes are shifted to match; cycles/pixel without calibration,
  cycles/unit with dx/dy or explicit x/y axes.

Thin wrappers over :mod:`barc4dip_tpu_torch.ops.fftcore`. Spectra and maps
come back as tensors on the device, frequency axes as NumPy. A numpy input
computes on ``device`` (``None``: the card, and an error without one), a
tensor on its own device. float64 stays float64, integer input computes in
float32, complex64/complex128 pass through.
"""
from __future__ import annotations

import numpy as np

from ..config import device_array
from ..ops import fftcore
from .common import resolve_step_1d, resolve_steps_2d

__all__ = [
    "freq_axis1d",
    "freq_axes2d",
    "fft1d",
    "ifft1d",
    "psd1d",
    "fft2d",
    "ifft2d",
    "psd2d",
]


def freq_axis1d(*, n: int, x: np.ndarray | None = None, dx: float = 1.0) -> np.ndarray:
    """Shifted 1D frequency axis (length n), cycles per unit."""
    if n < 1:
        raise ValueError("n must be >= 1.")
    step = resolve_step_1d(n=n, x=x, dx=dx, name="x")
    return np.fft.fftshift(np.fft.fftfreq(int(n), d=step))


def freq_axes2d(
    *,
    shape: tuple[int, int],
    x: np.ndarray | None = None,
    y: np.ndarray | None = None,
    dx: float = 1.0,
    dy: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Shifted 2D frequency axes (fx of length nx, fy of length ny)."""
    ny, nx = shape
    if ny < 1 or nx < 1:
        raise ValueError("shape must contain positive integers.")
    step_x, step_y = resolve_steps_2d(shape=shape, x=x, y=y, dx=dx, dy=dy)
    fx = np.fft.fftshift(np.fft.fftfreq(int(nx), d=step_x))
    fy = np.fft.fftshift(np.fft.fftfreq(int(ny), d=step_y))
    return fx, fy


def _signal_1d(signal, device, name: str = "signal"):
    s = device_array(signal, device)
    if s.dim() != 1:
        raise ValueError(f"{name} must be a 1D array.")
    return s


def _image_2d(image, device, name: str = "image"):
    img = device_array(image, device)
    if img.dim() != 2:
        raise ValueError(f"{name} must be a 2D array.")
    return img


def fft1d(signal, *, x: np.ndarray | None = None, dx: float = 1.0, device=None):
    """Shifted 1D FFT and its shifted frequency axis: (F, fx)."""
    s = _signal_1d(signal, device)
    fx = freq_axis1d(n=int(s.numel()), x=x, dx=dx)
    return fftcore.fft1_shifted(s), fx


def ifft1d(F, *, device=None):
    """Inverse 1D FFT from a shifted spectrum."""
    return fftcore.ifft1_shifted(_signal_1d(F, device, "F"))


def psd1d(
    signal, *, x: np.ndarray | None = None, dx: float = 1.0, scale: bool = True, device=None
):
    """Shifted 1D PSD: (P, fx). ``scale=True`` applies ``P *= dx/n``."""
    s = _signal_1d(signal, device)
    n = int(s.numel())
    step = resolve_step_1d(n=n, x=x, dx=dx, name="x")
    fx = freq_axis1d(n=n, x=x, dx=dx)
    return fftcore.psd1d_core(s, step=float(step), scale=bool(scale)), fx


def fft2d(
    image,
    *,
    x: np.ndarray | None = None,
    y: np.ndarray | None = None,
    dx: float = 1.0,
    dy: float = 1.0,
    device=None,
):
    """Shifted 2D FFT and shifted frequency axes: (F, fx, fy)."""
    img = _image_2d(image, device)
    ny, nx = img.shape
    fx, fy = freq_axes2d(shape=(int(ny), int(nx)), x=x, y=y, dx=dx, dy=dy)
    return fftcore.fft2_shifted(img), fx, fy


def ifft2d(F, *, device=None):
    """Inverse 2D FFT from a shifted spectrum."""
    return fftcore.ifft2_shifted(_image_2d(F, device, "F"))


def psd2d(
    image,
    *,
    x: np.ndarray | None = None,
    y: np.ndarray | None = None,
    dx: float = 1.0,
    dy: float = 1.0,
    scale: bool = True,
    device=None,
):
    """Shifted 2D PSD: (P, fx, fy). ``scale=True`` applies
    ``P *= (dx*dy)/(nx*ny)``.

    P stays on the device; for real input it is centro-symmetric, so
    :func:`barc4dip_tpu_torch.signal.pull_centrosymmetric` brings it to the
    host with half the transfer (``P.cpu()`` pulls it whole)."""
    img = _image_2d(image, device)
    ny, nx = (int(s) for s in img.shape)
    step_x, step_y = resolve_steps_2d(shape=(ny, nx), x=x, y=y, dx=dx, dy=dy)
    fx, fy = freq_axes2d(shape=(ny, nx), x=x, y=y, dx=dx, dy=dy)
    P = fftcore.psd2d_core(img, step_x=float(step_x), step_y=float(step_y), scale=bool(scale))
    return P, fx, fy
