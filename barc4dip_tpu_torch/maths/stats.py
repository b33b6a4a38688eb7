# SPDX-License-Identifier: CECILL-2.1
"""Peak-width estimators (counterpart of ``barc4dip_tpu/maths/stats.py``)
over the masked reductions of :mod:`barc4dip_tpu_torch.ops.widths`.

Both functions return ``(value, hit_edge)`` as a Python float and bool,
pulled from the device in one transfer. A numpy profile computes on
``device`` (``None``: the card, and an error without one), a tensor on its
own device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import device_array
from ..ops import widths

__all__ = ["width_at_fraction", "distance_at_fraction_from_peak"]


def _validate_profile(profile, fraction, device):
    p = device_array(profile, device)
    if p.dim() != 1 or p.numel() == 0:
        raise ValueError("profile must be a non-empty 1D array.")
    if not (0.0 < fraction < 1.0):
        raise ValueError("fraction must be in (0, 1).")
    return p


def _pull(value, hit_edge) -> tuple[float, bool]:
    v, h = torch.stack([value, hit_edge.to(value.dtype)]).tolist()
    return float(v), bool(h)


def width_at_fraction(
    profile, *, fraction: float = 1.0 / np.e, center_index: int | None = None, device=None
) -> tuple[float, bool]:
    """Full width of a 1D peak at ``fraction`` of its value: (width, hit_edge)."""
    p = _validate_profile(profile, fraction, device)
    ci = None if center_index is None else torch.tensor(int(center_index), device=p.device)
    return _pull(*widths.width_at_fraction_core(p, fraction=float(fraction), center_index=ci))


def distance_at_fraction_from_peak(
    profile, *, fraction: float = 1.0 / np.e, peak_index: int = 0, device=None
) -> tuple[float, bool]:
    """One-sided distance from peak to the ``fraction`` crossing: (dist, hit_edge)."""
    p = _validate_profile(profile, fraction, device)
    return _pull(*widths.distance_at_fraction_core(
        p, fraction=float(fraction), peak_index=int(peak_index)
    ))
