# SPDX-License-Identifier: CECILL-2.1
"""Dense per-pixel metric maps (counterpart of
``barc4dip_tpu/metrics/maps.py``). :func:`visibility_map` is the dense
version of the visibility estimator (``std/mean``): a sliding-window
speckle-contrast map, the standard beamline diagnostic for spatially
resolved coherence/visibility.

Numerics: the window sums are separable box sums (a (w, 1) then a (1, w)
sum pool), not the integral-image trick of ``ops/ncc.py::window_sums``. A
float32 integral image of a 2048^2 frame of ~1e3 counts reaches ~4e9 while a
16^2 window sum is ~2.6e5, so the subtraction would lose about three
significant digits of a user-facing metric value. Each separable sum stays
at window magnitude, and the intensities are pre-scaled by the global mean
(visibility is scale-invariant), which keeps the map at float32 round-off
at any frame size. The sum pool is ``avg_pool2d`` with the divisor set to
1: no convolution, so no TF32 path.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import to_compute

__all__ = ["visibility_map"]


def _box_sum_valid(x, w: int):
    """Separable (w, w) sliding-window sum of (B, H, W) frames, valid mode."""
    x = F.avg_pool2d(x, (w, 1), stride=1, divisor_override=1)
    return F.avg_pool2d(x, (1, w), stride=1, divisor_override=1)


def _visibility_frames(frames, window: int, stride: int):
    """The visibility map of each (H, W) frame of a (B, H, W) batch, in the
    batch's dtype."""
    # visibility is scale-invariant: normalize by the global mean so the
    # window sums are O(window^2) regardless of the count level
    g = frames.mean(dim=(-2, -1), keepdim=True)
    y = frames / torch.where(g > 0.0, g, 1.0)
    area = float(window * window)
    mean = _box_sum_valid(y, window) / area
    # population variance (ddof=0), tiny negatives clamped
    var = torch.clamp_min(_box_sum_valid(y * y, window) / area - mean * mean, 0.0)
    vis = torch.where(mean > 0.0, torch.sqrt(var) / mean, math.nan)
    return vis[..., ::stride, ::stride]


def visibility_map(image, *, window: int = 16, stride: int = 1,
                   frame_chunk: int = 8, device=None):
    """Sliding-window speckle visibility (contrast) map, ``std/mean`` over
    every (window, window) patch (valid mode, population std: the same
    definition as the full-frame/tile ``visibility`` metric), in float32.

    Parameters
    ----------
    image : (H, W) or (T, H, W) numpy.ndarray or torch.Tensor
        Intensity frame(s); windows whose mean is not positive map to NaN.
    window : int
        Patch side in pixels.
    stride : int
        Output decimation (1 = every valid position).
    frame_chunk : int
        Frames per batch for stacks (bounds device memory like every other
        stack API; NumPy stacks go through the shared chunk loop, tensor
        stacks are sliced on their device).
    device
        Where a NumPy input computes: ``None`` is the card, and an error
        without one. A tensor computes on its own device.

    Returns
    -------
    (H-window+1, W-window+1) map (strided), with a leading T axis for
    stacks. Residence follows the input: NumPy in -> NumPy out, tensor in
    -> tensor out on its device.
    """
    window = int(window)
    stride = int(stride)
    if window < 2:
        raise ValueError("window must be >= 2.")
    if stride < 1:
        raise ValueError("stride must be >= 1.")
    if not isinstance(image, (np.ndarray, torch.Tensor)):
        raise TypeError("visibility_map expects a numpy.ndarray or torch.Tensor")
    if image.ndim not in {2, 3}:
        raise ValueError(
            f"image must be 2D (H, W) or 3D (T, H, W); got ndim={image.ndim}"
        )
    H, W = (int(s) for s in image.shape[-2:])
    if window > min(H, W):
        raise ValueError(
            f"window ({window}) exceeds the image extent ({H}x{W})."
        )

    single = image.ndim == 2
    frames = image[None] if single else image
    T = int(frames.shape[0])
    B = max(1, min(int(frame_chunk), T))

    if isinstance(image, torch.Tensor):
        pieces = [
            _visibility_frames(to_compute(frames[c0 : c0 + B]).to(torch.float32), window, stride)
            for c0 in range(0, T, B)
        ]
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)
        return out[0] if single else out

    from .common import run_stack_program

    out = run_stack_program(
        np.asarray(frames, dtype=np.float32),
        lambda chunk: {"visibility": _visibility_frames(chunk, window, stride)},
        frame_chunk=B, device=device,
    )["visibility"]
    return out[0] if single else out
