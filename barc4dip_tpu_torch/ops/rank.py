# SPDX-License-Identifier: CECILL-2.1
"""Rank filters (counterpart of ``barc4dip_tpu/ops/rank.py``).

Parity target: ``scipy.ndimage.median_filter(x, size=k, mode="reflect")``
over the last two axes; SciPy's "reflect" duplicates edges, which is
numpy's symmetric pad.
"""
from __future__ import annotations

from . import cuda_median

__all__ = ["median_filter2d"]


def median_filter2d(x, size: int = 3):
    """Median filter over the last two axes with an odd square window.

    ``size == 3`` on (H, W) or (B, H, W) goes through kernel K2
    (:func:`.cuda_median.median3x3`: the kernel for CUDA float32, its plain
    version on the CPU, counted when a CUDA tensor is not covered); other
    sizes take the plain window-stack median, counted on CUDA."""
    k = int(size)
    if k < 1 or k % 2 == 0:
        raise ValueError("size must be a positive odd integer.")
    if k == 1:
        return x
    if k == 3 and x.dim() in (2, 3):
        return cuda_median.median3x3(x.contiguous())
    if x.is_cuda:
        cuda_median.count_plain(x, f"median{k}x{k}")
    return cuda_median.median_filter_plain(x, k)
