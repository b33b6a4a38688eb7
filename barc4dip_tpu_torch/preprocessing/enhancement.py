# SPDX-License-Identifier: CECILL-2.1
"""Image enhancement: CLAHE (counterpart of
``barc4dip_tpu/preprocessing/enhancement.py``).

Contrast-limited adaptive histogram equalization on the device: per-tile
histograms as one ``bincount`` over (tile, bin) codes (float32 counts are
exact), clipped and redistributed, float32 cumulative sums as lookup
tables, and bilinear blending of the four neighbouring tiles' mappings.
The cumulative sum runs in float32 as in the JAX package, in a fixed order
of additions (:func:`_scan16`): the order XLA's CPU backend gives
``jnp.cumsum``, so the lookup tables do not depend on the device's scan
algorithm, and a code can differ from the JAX package's only where the
histogram's float32 sums do. The bilinear blend is two fused
multiply-adds per axis (:func:`_fma`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["clahe"]

_NBINS = 65536  # uint16 dynamic range


@lru_cache(maxsize=16)
def _geometry(shape: tuple[int, int], grid: tuple[int, int]):
    """Tile sizes, padded shape and the blending geometry (host constants)."""
    H, W = shape
    gy, gx = grid
    th, tw = -(-H // gy), -(-W // gx)  # ceil tile sizes
    Hp, Wp = th * gy, tw * gx
    fy = (np.arange(Hp) + 0.5) / th - 0.5
    fx = (np.arange(Wp) + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, gy - 1)
    y1 = np.clip(y0 + 1, 0, gy - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, gx - 1)
    x1 = np.clip(x0 + 1, 0, gx - 1)
    wy = np.clip(fy - y0, 0.0, 1.0).astype(np.float32)
    wx = np.clip(fx - x0, 0.0, 1.0).astype(np.float32)
    return th, tw, Hp, Wp, y0, y1, x0, x1, wy, wx


def _scan16(x):
    """Inclusive float32 cumulative sum over the last axis, as blocks of 16
    summed left to right, the block totals scanned the same way, and each
    block's exclusive offset added last (XLA rewrites ``cumsum`` so)."""
    n = x.shape[-1]
    if n <= 16:
        parts = [x[..., 0]]
        for i in range(1, n):
            parts.append(parts[-1] + x[..., i])
        return torch.stack(parts, dim=-1)
    nb = -(-n // 16)
    xp = torch.nn.functional.pad(x, (0, nb * 16 - n)).unflatten(-1, (nb, 16))
    within = _scan16(xp)
    offsets = _scan16(within[..., -1])
    excl = torch.nn.functional.pad(offsets[..., :-1], (1, 0))
    return (within + excl[..., None]).flatten(-2)[..., :n]


def _fma(a, b, c):
    """float32 a*b + c rounded once, as a fused multiply-add: the float64
    product of two float32 values is exact. The blend is written so because
    XLA contracts it so on the CPU, and a blend rounded twice lands a code
    apart wherever it sits near a .5 boundary before ``rint``."""
    return (a.double() * b.double() + c.double()).float()


def _clahe(img, clip_limit: float, grid: tuple[int, int], nbins: int):
    """The equalized (H, W) float32 image of a 2D tensor."""
    H, W = (int(s) for s in img.shape)
    gy, gx = grid
    th, tw, Hp, Wp, y0, y1, x0, x1, wy, wx = _geometry((H, W), grid)
    dev = img.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # pad to full tiles (edge padding, as OpenCV does), then the bin codes
    rows = torch.arange(Hp, device=dev).clamp_max(H - 1)
    cols = torch.arange(Wp, device=dev).clamp_max(W - 1)
    v = img[rows[:, None], cols[None, :]].to(torch.int32).clamp(0, nbins - 1).long()

    tile = (torch.arange(Hp, device=dev) // th)[:, None] * gx + (torch.arange(Wp, device=dev) // tw)[None, :]
    hist = torch.bincount((tile * nbins + v).ravel(), minlength=gy * gx * nbins)
    hist = hist.to(torch.float32).view(gy * gx, nbins)

    # contrast limiting: clip histogram, redistribute excess uniformly
    limit = torch.clamp_min(torch.tensor(clip_limit, dtype=torch.float32) * (th * tw) / nbins, 1.0).to(dev)
    excess = (hist - limit).clamp_min(0.0).sum(dim=1, keepdim=True)
    hist = torch.minimum(hist, limit) + excess / nbins

    cdf = _scan16(hist)
    luts = (cdf / cdf[:, -1:] * (nbins - 1)).view(gy, gx, nbins)

    def lookup(ty, tx):
        return luts[t(ty)[:, None], t(tx)[None, :], v]

    wyj = t(wy)[:, None]
    wxj = t(wx)[None, :]
    top = _fma(1 - wxj, lookup(y0, x0), wxj * lookup(y0, x1))
    bottom = _fma(1 - wxj, lookup(y1, x0), wxj * lookup(y1, x1))
    return _fma(1 - wyj, top, wyj * bottom)[:H, :W]


def clahe(image, clip_limit: float = 2.0, tile_grid_size: tuple = (8, 8), *, device=None):
    """Contrast Limited Adaptive Histogram Equalization.

    Accepts uint8/uint16 (or integer-valued float) images; returns the
    equalized image in the input dtype (float input: the float32 result).
    Residence follows the input: numpy in -> numpy out, computed on
    ``device`` (``None``: the card, and an error without one); a tensor in
    -> a tensor out on its own device.
    """
    device_in = isinstance(image, torch.Tensor)
    img = image if device_in else np.asarray(image)
    if img.ndim != 2:
        raise ValueError("clahe expects a 2D image.")
    nbins = 256 if img.dtype == (torch.uint8 if device_in else np.uint8) else _NBINS
    if not device_in:
        img = torch.from_numpy(np.ascontiguousarray(img)).to(resolve_device(device))
    integer = not (img.is_floating_point() or img.is_complex())
    if img.dtype == torch.uint16:  # read as int32: torch's uint16 supports few operations
        img = img.view(torch.int16).to(torch.int32) & 0xFFFF
    out = _clahe(img, float(clip_limit), tuple(int(g) for g in tile_grid_size), nbins)
    if integer:
        out = torch.round(out).clamp(0, nbins - 1).to(image.dtype if device_in else img.dtype)
    if device_in:
        return out
    arr = out.cpu().numpy()
    return arr.astype(np.asarray(image).dtype) if integer else arr
