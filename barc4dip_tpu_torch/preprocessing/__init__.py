# SPDX-License-Identifier: CECILL-2.1
"""Preprocessing of the PyTorch port: flat-field correction."""
from .normalize import flat_field_correction

__all__ = ["flat_field_correction"]
