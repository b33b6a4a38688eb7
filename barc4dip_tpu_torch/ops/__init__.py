# SPDX-License-Identifier: CECILL-2.1
"""Tensor primitives of the port: the cores the metric layers call, each on
the device of its input (counterpart of ``barc4dip_tpu/ops``).

The hand-written kernels' wrappers stay submodules and are not re-exported:
``cuda_fftp`` (K1), ``cuda_median`` (K2), ``cuda_densetrack`` (K3),
``cuda_symeig`` (K4), all built by ``_nvcc``.
"""
from .corrcore import autocorr2d_core, xcorr1d_core, xcorr2d_core
from .fftcore import (
    fft1_shifted,
    fft2_shifted,
    ifft1_shifted,
    ifft2_shifted,
    psd1d_core,
    psd2d_core,
    shifted_freqs,
)
from .momentscore import distribution_moments_core
from .ncc import ncc_valid, ncc_valid_from_prepared, window_sums, zncc_prepare_image
from .phasecorr import (
    argmax2d,
    peak_quality,
    phase_corr_surface,
    subpixel_taylor,
    zscore2d,
)
from .radialcore import radial_mean_binned_core, radial_mean_interpolated_core
from .rank import median_filter2d
from .stencils import conv3x3_symmetric, laplace, sobel_x, sobel_y
from .widths import distance_at_fraction_core, width_at_fraction_core

__all__ = [
    "fft1_shifted",
    "ifft1_shifted",
    "fft2_shifted",
    "ifft2_shifted",
    "psd1d_core",
    "psd2d_core",
    "shifted_freqs",
    "xcorr1d_core",
    "xcorr2d_core",
    "autocorr2d_core",
    "width_at_fraction_core",
    "distance_at_fraction_core",
    "radial_mean_binned_core",
    "radial_mean_interpolated_core",
    "median_filter2d",
    "sobel_x",
    "sobel_y",
    "laplace",
    "conv3x3_symmetric",
    "distribution_moments_core",
    "ncc_valid",
    "ncc_valid_from_prepared",
    "zncc_prepare_image",
    "window_sums",
    "zscore2d",
    "phase_corr_surface",
    "peak_quality",
    "subpixel_taylor",
    "argmax2d",
]
