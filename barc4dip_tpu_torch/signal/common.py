# SPDX-License-Identifier: CECILL-2.1
"""Sampling-step resolution for the signal layer (the port's own copy of
``barc4dip_tpu/signal/common.py``).

Every FFT/correlation entry point accepts its spatial calibration in one of
two mutually-exclusive forms: scalar step sizes (``dx``/``dy``) or explicit
coordinate axes (``x``/``y``) that must be uniformly sampled.  The helpers
here normalise both forms down to plain step floats, rejecting ambiguous or
non-uniform input up front (behavioral contract of reference
signal/common.py:13-90).

Calibration is pure metadata, so all of this is host-side NumPy.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "uniform_step",
    "resolve_step_1d",
    "resolve_steps_2d",
    "lag_axis_from_step",
]

# An axis counts as uniformly sampled when no spacing strays from the
# representative step by more than this relative amount.
_UNIFORMITY_RTOL = 1e-6


def uniform_step(axis, name: str) -> float:
    """Extract the (positive) sampling step of a uniform 1D coordinate axis.

    Raises ``ValueError`` when the axis is too short, contains non-finite
    samples, changes direction, or is sampled non-uniformly beyond 1e-6
    relative tolerance. Descending axes are accepted; the returned step is
    always positive.
    """
    samples = np.asarray(axis, dtype=float)
    if samples.ndim != 1 or samples.size < 2:
        raise ValueError(f"{name} must be a 1D array with at least 2 samples.")

    spacing = np.diff(samples)
    if not np.isfinite(spacing).all():
        raise ValueError(f"{name} contains non-finite values.")

    signs = np.sign(spacing)
    if signs[0] == 0 or (signs != signs[0]).any():
        raise ValueError(
            f"{name} must be strictly monotonic (uniform sampling assumed)."
        )

    magnitudes = np.abs(spacing)
    step = float(np.median(magnitudes))
    if not step > 0:
        raise ValueError(f"{name} has non-positive sampling step.")

    worst = float(np.abs(magnitudes / step - 1.0).max())
    if worst > _UNIFORMITY_RTOL:
        raise ValueError(
            f"{name} appears non-uniform (max relative deviation {worst:.2e}). "
            "Provide uniformly sampled axes."
        )
    return step


def resolve_step_1d(*, n: int, x, dx: float, name: str) -> float:
    """Turn a 1D calibration (``x`` axis XOR ``dx`` step) into a step float.

    Passing an explicit axis together with a non-default ``dx`` is ambiguous
    and rejected; the axis length must match the signal length ``n``.
    """
    if x is None:
        if dx <= 0:
            raise ValueError(f"d{name} must be > 0.")
        return float(dx)

    if dx != 1.0:
        raise ValueError(f"Provide either {name} or d{name}, not both.")

    arr = np.asarray(x, dtype=float)
    if arr.ndim != 1:
        raise ValueError(f"{name} must be a 1D array.")
    if arr.size != int(n):
        raise ValueError(f"{name}.size must match the signal length ({n}).")
    return uniform_step(arr, name)


def resolve_steps_2d(*, shape, x, y, dx: float, dy: float):
    """Turn a 2D calibration into ``(step_x, step_y)``.

    The two axes travel together: give both ``x`` and ``y`` or neither, and
    never mix explicit axes with non-default scalar steps. Axis lengths must
    match the image's (ny, nx).
    """
    ny, nx = (int(v) for v in shape)

    have_x, have_y = x is not None, y is not None
    if have_x != have_y:
        raise ValueError("Provide both x and y axes, or neither.")

    if not have_x:
        if dx <= 0 or dy <= 0:
            raise ValueError("dx and dy must be > 0.")
        return float(dx), float(dy)

    if dx != 1.0 or dy != 1.0:
        raise ValueError("Provide either (x, y) or (dx, dy), not both.")

    ax = np.asarray(x, dtype=float)
    ay = np.asarray(y, dtype=float)
    if ax.ndim != 1 or ay.ndim != 1:
        raise ValueError("x and y must be 1D arrays.")
    if ax.size != nx or ay.size != ny:
        raise ValueError("x/y sizes must match (nx, ny) of the image.")
    return uniform_step(ax, "x"), uniform_step(ay, "y")


def lag_axis_from_step(n: int, step: float) -> np.ndarray:
    """Centered lag axis for an ``n``-sample correlation: zero sits at index
    ``n//2`` (the fftshifted origin), spacing ``step``."""
    offsets = np.arange(int(n), dtype=float) - int(n) // 2
    return offsets * float(step)
