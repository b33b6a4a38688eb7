# SPDX-License-Identifier: CECILL-2.1
"""Optical distortion correction (counterpart of
``barc4dip_tpu/preprocessing/distortion.py``).

A Brown-Conrady radial/tangential model resampled through one bilinear
gather on the device. The sampling plan is built on the host in float64
(this module's own copy of the JAX package's ``_warp_plan``); on the device
each output pixel gathers its four source corners, weights them, and takes
``fill_value`` where its source lies outside the frame.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import resolve_device, to_compute

__all__ = ["correct_distortion", "distortion_map"]


@lru_cache(maxsize=16)
def _warp_plan(
    shape: tuple[int, int],
    k1: float,
    k2: float,
    k3: float,
    p1: float,
    p2: float,
    center: tuple[float, float] | None,
):
    """Source sampling coordinates for undistorting an (H, W) image."""
    H, W = shape
    cy, cx = center if center is not None else ((H - 1) / 2.0, (W - 1) / 2.0)
    norm = max(cy, cx, 1.0)

    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    y = (yy - cy) / norm
    x = (xx - cx) / norm
    r2 = x * x + y * y

    radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    x_d = x * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * x * x)
    y_d = y * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * y * y)

    src_y = y_d * norm + cy
    src_x = x_d * norm + cx

    y0 = np.clip(np.floor(src_y), 0, H - 2).astype(np.int32)
    x0 = np.clip(np.floor(src_x), 0, W - 2).astype(np.int32)
    fy = np.clip(src_y - y0, 0.0, 1.0)
    fx = np.clip(src_x - x0, 0.0, 1.0)
    oob = (src_y < 0) | (src_y > H - 1) | (src_x < 0) | (src_x > W - 1)

    flat00 = (y0 * W + x0).ravel()
    w00 = ((1 - fy) * (1 - fx)).ravel()
    w01 = ((1 - fy) * fx).ravel()
    w10 = (fy * (1 - fx)).ravel()
    w11 = (fy * fx).ravel()
    return flat00, np.stack([w00, w01, w10, w11]), oob.ravel(), (src_y, src_x)


def distortion_map(
    shape: tuple[int, int],
    *,
    k1: float = 0.0,
    k2: float = 0.0,
    k3: float = 0.0,
    p1: float = 0.0,
    p2: float = 0.0,
    center: tuple[float, float] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(src_y, src_x) sampling maps for the given distortion coefficients."""
    *_, (src_y, src_x) = _warp_plan(
        tuple(shape), float(k1), float(k2), float(k3), float(p1), float(p2),
        None if center is None else (float(center[0]), float(center[1])),
    )
    return src_y, src_x


@lru_cache(maxsize=4)
def _device_plan(plan_key, dtype: torch.dtype, device: torch.device):
    """The plan's corner indices, weights in ``dtype`` and out-of-bounds
    mask on ``device``: one upload per (plan, dtype, device), ~200 MiB at
    2048²."""
    flat00, w, oob, _ = _warp_plan(*plan_key)
    W = plan_key[0][1]
    i00 = torch.from_numpy(flat00.astype(np.int64)).to(device)
    idx = torch.stack([i00, i00 + 1, i00 + W, i00 + W + 1])
    return idx, torch.from_numpy(w).to(device=device, dtype=dtype), torch.from_numpy(oob).to(device)


def correct_distortion(
    image,
    *,
    k1: float = 0.0,
    k2: float = 0.0,
    k3: float = 0.0,
    p1: float = 0.0,
    p2: float = 0.0,
    center: tuple[float, float] | None = None,
    fill_value: float = 0.0,
    device=None,
):
    """Undistort a 2D image or (T, H, W) stack (Brown-Conrady model).

    Radii are normalised by max(cy, cx); positive k1 corrects barrel
    distortion. Out-of-bounds samples take ``fill_value``. Floating input
    keeps its dtype, any other becomes float32. Residence follows the input:
    numpy in -> numpy out, computed on ``device`` (``None``: the card, and
    an error without one); a tensor in -> a tensor out on its own device.
    """
    device_in = isinstance(image, torch.Tensor)
    x = image if device_in else np.asarray(image)
    if x.ndim not in (2, 3):
        raise ValueError("image must be 2D or 3D (stack).")
    if not device_in:
        x = torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))
    if not x.is_floating_point():
        x = to_compute(x)
    H, W = (int(s) for s in x.shape[-2:])
    plan_key = (
        (H, W), float(k1), float(k2), float(k3), float(p1), float(p2),
        None if center is None else (float(center[0]), float(center[1])),
    )
    idx, w, oob = _device_plan(plan_key, x.dtype, x.device)

    flat = x.reshape(x.shape[:-2] + (-1,))
    vals = (flat[..., idx] * w).sum(dim=-2)  # (..., 4, npix) corners
    vals = torch.where(oob, torch.tensor(fill_value, dtype=vals.dtype, device=vals.device), vals)
    out = vals.reshape(x.shape)
    return out if device_in else out.cpu().numpy()
