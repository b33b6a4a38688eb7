# SPDX-License-Identifier: CECILL-2.1
"""Radial reductions (counterpart of ``barc4dip_tpu/maths/radial.py``) over
:mod:`barc4dip_tpu_torch.ops.radialcore`. Origin: pixel-center coordinates
``x = arange(nx) - nx//2``.

Both functions return tensors on the device, the radial axis a copy of the
cores' shared one. A numpy input computes on
``device`` (``None``: the card, and an error without one), a tensor on its
own device; integer input computes in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import device_array
from ..ops import radialcore

__all__ = ["radial_mean_binned", "radial_mean_interpolated"]


def _validate(signal_2d, device):
    if np.ndim(signal_2d) != 2:
        raise ValueError("signal_2d must be a 2D array.")
    # a host input is checked on the host, before it is uploaded; a tensor by
    # one reduction on its device (pulling the map to validate it would cost
    # more than the radial mean)
    on_host = not isinstance(signal_2d, torch.Tensor)
    finite = bool(np.all(np.isfinite(signal_2d))) if on_host else True
    z = device_array(signal_2d, device) if finite else None
    if not (finite and (on_host or bool(torch.isfinite(z).all()))):
        raise ValueError("signal_2d contains non-finite values.")
    return z


def radial_mean_binned(
    signal_2d, *, r_max: float | None = None, bin_size: float = 1.0, device=None
):
    """Radial mean by annular binning: (radial[nbins], r_centers[nbins]).

    On CUDA the bin sums are ``index_add_`` sums, which add with atomics in
    no fixed order: two runs may differ in the last bits."""
    z = _validate(signal_2d, device)
    radial, r = radialcore.radial_mean_binned_core(
        z, r_max=None if r_max is None else float(r_max), bin_size=float(bin_size)
    )
    return radial, r.clone()


def radial_mean_interpolated(
    signal_2d,
    *,
    r_max: float | None = None,
    nr: int | None = None,
    ntheta: int | None = None,
    fill_value: float = 0.0,
    device=None,
):
    """Radial mean via polar resampling + bilinear interpolation: (radial, r)."""
    z = _validate(signal_2d, device)
    radial, r = radialcore.radial_mean_interpolated_core(
        z,
        r_max=None if r_max is None else float(r_max),
        nr=None if nr is None else int(nr),
        ntheta=None if ntheta is None else int(ntheta),
        fill_value=float(fill_value),
    )
    return radial, r.clone()
