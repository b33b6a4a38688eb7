# SPDX-License-Identifier: CECILL-2.1
"""FFT-based circular correlation (counterpart of
``barc4dip_tpu/signal/corr.py``): shifted output (zero lag centered),
optional mean removal / standardisation, ``normalize in {"none", "peak"}``,
and centered lag axes.

Real inputs take the rfft path of :mod:`barc4dip_tpu_torch.ops.corrcore`,
making the result exactly real. The autocorrelation of a real 2-D image
runs kernel K1a on CUDA for the sides it covers
(``ops/cuda_fftp.corr_from_rfft``); every other correlation here is
``torch.fft``, as it is ``jnp.fft`` in the JAX package.

Correlations come back as tensors on the device, lag axes as NumPy. A numpy
input computes on ``device`` (``None``: the card, and an error without
one), a tensor on its own device.
"""
from __future__ import annotations

import numpy as np

from ..config import device_array, device_arrays
from ..ops import corrcore
from .common import lag_axis_from_step, resolve_step_1d, resolve_steps_2d

__all__ = ["xcorr1d", "autocorr1d", "xcorr2d", "autocorr2d"]

_VALID_NORMALIZE = ("none", "peak")


def _check_normalize(normalize: str) -> str:
    if normalize not in _VALID_NORMALIZE:
        raise ValueError(f"Invalid normalize='{normalize}'. Use 'none' or 'peak'.")
    return normalize


def xcorr1d(
    a,
    b,
    *,
    x: np.ndarray | None = None,
    dx: float = 1.0,
    remove_mean: bool = True,
    standardize: bool = False,
    normalize: str = "peak",
    device=None,
):
    """Circular cross-correlation of two 1D signals: (corr, xlag)."""
    aa, bb = device_arrays(a, b, device=device)
    if aa.dim() != 1 or bb.dim() != 1:
        raise ValueError("a and b must be 1D arrays.")
    if aa.numel() != bb.numel():
        raise ValueError("a and b must have the same length.")
    _check_normalize(normalize)

    n = int(aa.numel())
    step = resolve_step_1d(n=n, x=x, dx=dx, name="x")
    xlag = lag_axis_from_step(n, step)
    corr = corrcore.xcorr1d_core(
        aa, bb, remove_mean=bool(remove_mean), standardize=bool(standardize),
        normalize=str(normalize),
    )
    return corr, xlag


def autocorr1d(
    a,
    *,
    x: np.ndarray | None = None,
    dx: float = 1.0,
    remove_mean: bool = True,
    standardize: bool = False,
    normalize: str = "peak",
    device=None,
):
    """Circular auto-correlation of a 1D signal: (corr, xlag)."""
    aa = device_array(a, device)
    return xcorr1d(
        aa, aa, x=x, dx=dx, remove_mean=remove_mean, standardize=standardize,
        normalize=normalize,
    )


def xcorr2d(
    a,
    b,
    *,
    x: np.ndarray | None = None,
    y: np.ndarray | None = None,
    dx: float = 1.0,
    dy: float = 1.0,
    remove_mean: bool = True,
    standardize: bool = False,
    normalize: str = "peak",
    device=None,
):
    """Circular cross-correlation of two 2D signals: (corr, xlag, ylag)."""
    aa, bb = device_arrays(a, b, device=device)
    if aa.dim() != 2 or bb.dim() != 2:
        raise ValueError("a and b must be 2D arrays.")
    if aa.shape != bb.shape:
        raise ValueError("a and b must have the same shape.")
    _check_normalize(normalize)

    ny, nx = (int(s) for s in aa.shape)
    step_x, step_y = resolve_steps_2d(shape=(ny, nx), x=x, y=y, dx=dx, dy=dy)
    xlag = lag_axis_from_step(nx, step_x)
    ylag = lag_axis_from_step(ny, step_y)
    corr = corrcore.xcorr2d_core(
        aa, bb, remove_mean=bool(remove_mean), standardize=bool(standardize),
        normalize=str(normalize),
    )
    return corr, xlag, ylag


def autocorr2d(
    a,
    *,
    x: np.ndarray | None = None,
    y: np.ndarray | None = None,
    dx: float = 1.0,
    dy: float = 1.0,
    remove_mean: bool = True,
    standardize: bool = False,
    normalize: str = "peak",
    device=None,
):
    """Circular auto-correlation of a 2D signal: (corr, xlag, ylag).

    Exactly real for real input (rfft path, kernel K1a on CUDA). The map is
    centro-symmetric:
    :func:`barc4dip_tpu_torch.signal.pull_centrosymmetric` brings it to the
    host with half the transfer. A complex field goes through the
    cross-correlation and its real part is returned.
    """
    aa = device_array(a, device)
    if aa.dim() != 2:
        raise ValueError("a must be a 2D array.")
    _check_normalize(normalize)

    ny, nx = (int(s) for s in aa.shape)
    step_x, step_y = resolve_steps_2d(shape=(ny, nx), x=x, y=y, dx=dx, dy=dy)
    xlag = lag_axis_from_step(nx, step_x)
    ylag = lag_axis_from_step(ny, step_y)

    kw = dict(remove_mean=bool(remove_mean), standardize=bool(standardize),
              normalize=str(normalize))
    if aa.is_complex():
        corr = corrcore.xcorr2d_core(aa, aa, **kw).real
    else:
        corr = corrcore.autocorr2d_core(aa, **kw)
    return corr, xlag, ylag
