# SPDX-License-Identifier: CECILL-2.1
"""Numeric maths helpers: radial reductions, peak widths and gradient
integration."""
from .integrate import integrate_gradients
from .radial import radial_mean_binned, radial_mean_interpolated
from .stats import distance_at_fraction_from_peak, width_at_fraction

__all__ = [
    "radial_mean_binned",
    "radial_mean_interpolated",
    "width_at_fraction",
    "distance_at_fraction_from_peak",
    "integrate_gradients",
]
