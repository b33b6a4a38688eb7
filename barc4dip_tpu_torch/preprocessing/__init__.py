# SPDX-License-Identifier: CECILL-2.1
"""Preprocessing of the PyTorch port: flat-field correction, PSF
deconvolution (``deconvolve_psf``), CLAHE (``clahe``), distortion
correction (``correct_distortion``, ``distortion_map``) and stack
registration (``register_stack``, ``shift_stack``): the seven names the
JAX package's ``preprocessing`` exports."""
from .distortion import correct_distortion, distortion_map
from .enhancement import clahe
from .filters import deconvolve_psf
from .normalize import flat_field_correction
from .registration import register_stack, shift_stack

__all__ = [
    "flat_field_correction",
    "deconvolve_psf",
    "clahe",
    "correct_distortion",
    "distortion_map",
    "register_stack",
    "shift_stack",
]
