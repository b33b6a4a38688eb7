# SPDX-License-Identifier: CECILL-2.1
"""3x3 stencils (Sobel, Laplace) with SciPy-compatible boundaries
(counterpart of ``barc4dip_tpu/ops/stencils.py``) on (..., H, W) tensors.

Parity targets: ``scipy.ndimage.sobel(x, axis, mode="reflect")`` and
``scipy.ndimage.laplace(x, mode="reflect")``. SciPy's "reflect" duplicates
the edge sample; at pad width 1 that is an edge-replicating pad.

One pad and the shifted views of the non-zero taps, combined in row-major
tap order. Not a convolution call: a zero tap is skipped, so a NaN under it
does not spread (``0 * NaN`` would), and the result does not depend on a
convolution library's precision mode.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["conv3x3_symmetric", "laplace", "sobel_x", "sobel_y"]

# SciPy sobel: correlate1d([-1, 0, 1]) along the derivative axis,
# correlate1d([1, 2, 1]) along the other.
_SOBEL_X = np.outer([1.0, 2.0, 1.0], [-1.0, 0.0, 1.0])  # derivative along x (axis=-1)
_SOBEL_Y = _SOBEL_X.T  # derivative along y (axis=-2)
_LAPLACE = np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]])


def conv3x3_symmetric(x, kernel: np.ndarray):
    """Correlate (..., H, W) images with a 3x3 kernel, symmetric
    (edge-duplicating) boundary. ``kernel`` is a host-side constant."""
    p = torch.cat([x[..., :1, :], x, x[..., -1:, :]], dim=-2)
    p = torch.cat([p[..., :, :1], p, p[..., :, -1:]], dim=-1)
    H, W = x.shape[-2], x.shape[-1]
    out = None
    for dy in range(3):
        for dx in range(3):
            k = float(kernel[dy, dx])
            if k == 0.0:
                continue
            term = p[..., dy : dy + H, dx : dx + W] * k
            out = term if out is None else out + term
    return out


def sobel_x(x):
    """SciPy-compatible ``sobel(x, axis=-1, mode='reflect')``."""
    return conv3x3_symmetric(x, _SOBEL_X)


def sobel_y(x):
    """SciPy-compatible ``sobel(x, axis=-2, mode='reflect')``."""
    return conv3x3_symmetric(x, _SOBEL_Y)


def laplace(x):
    """SciPy-compatible ``laplace(x, mode='reflect')``."""
    return conv3x3_symmetric(x, _LAPLACE)
