# SPDX-License-Identifier: CECILL-2.1
"""Signal layer of the PyTorch port: FFT/PSD, correlation, translation
tracking, the spectral quick-look, dense XST tracking and wavefronts."""
from ..ops.symmetry import pull_centrosymmetric
from .common import lag_axis_from_step, resolve_step_1d, resolve_steps_2d, uniform_step
from .corr import autocorr1d, autocorr2d, xcorr1d, xcorr2d
from .fft import (
    fft1d,
    fft2d,
    freq_axes2d,
    freq_axis1d,
    ifft1d,
    ifft2d,
    psd1d,
    psd2d,
)
from .summary import spectral_summary, spectral_summary_stack
from .tracking import phase_correlation, template_matching, track_translation
from .xst import (
    track_displacement_field,
    track_displacement_stack,
    wavefront_from_displacements,
)

__all__ = [
    "fft1d",
    "ifft1d",
    "fft2d",
    "ifft2d",
    "psd1d",
    "psd2d",
    "freq_axis1d",
    "freq_axes2d",
    "xcorr1d",
    "autocorr1d",
    "xcorr2d",
    "autocorr2d",
    "track_translation",
    "template_matching",
    "phase_correlation",
    "pull_centrosymmetric",
    "spectral_summary",
    "spectral_summary_stack",
    "track_displacement_field",
    "track_displacement_stack",
    "wavefront_from_displacements",
    "lag_axis_from_step",
    "resolve_step_1d",
    "resolve_steps_2d",
    "uniform_step",
]
