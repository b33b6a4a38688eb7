# SPDX-License-Identifier: CECILL-2.1
"""Speckle and sharpness metrics of the PyTorch port."""
from .frc import fourier_ring_correlation
from .maps import visibility_map
from .sharpness import (
    eigenvalues,
    inverse_autocorr_width,
    laplacian_variance,
    sharpness_stack_stats,
    sharpness_stats,
    spectral_entropy,
    tenengrad,
)
from .speckles import (
    amplitude,
    bandwidth,
    grain,
    speckle_stack_stats,
    speckle_stats,
    tracking_grid_from_frame0,
)
from .statistics import distribution_moments

__all__ = [
    "amplitude",
    "bandwidth",
    "distribution_moments",
    "eigenvalues",
    "fourier_ring_correlation",
    "grain",
    "inverse_autocorr_width",
    "laplacian_variance",
    "sharpness_stack_stats",
    "sharpness_stats",
    "speckle_stack_stats",
    "speckle_stats",
    "spectral_entropy",
    "tenengrad",
    "tracking_grid_from_frame0",
    "visibility_map",
]
