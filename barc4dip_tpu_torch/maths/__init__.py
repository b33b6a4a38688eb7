# SPDX-License-Identifier: CECILL-2.1
"""Numerical helpers of the PyTorch port."""
from .integrate import integrate_gradients

__all__ = ["integrate_gradients"]
