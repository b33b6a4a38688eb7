# SPDX-License-Identifier: CECILL-2.1
"""Dense windowed ZNCC displacement fields, the core of X-ray speckle
tracking (counterpart of ``barc4dip_tpu/ops/densetrack.py``).

For every node of a regular grid the ``s``-square tile of the reference is
located inside the ``w = s + 2r`` search window of the image by
zero-normalised cross-correlation over the (2r+1)^2 offsets, then refined by
the 3x3 Newton step. Both images are z-scored globally (NaN-aware, then
``nan_to_num``) first: NCC is affine-invariant, and raw detector counts
would otherwise ruin float32 window-variance sums.

Three correlation cores, the JAX package's method names:

- ``pallas``: the fused correlation-plus-sums pass, kernel K3
  (:func:`.cuda_densetrack.ncc_sums`) on CUDA and its plain version on the
  CPU; the sums run in float32 and are cast back to the image's dtype;
- ``conv``: ``torch.nn.functional.conv2d`` with one group per node (TF32 is
  pinned off in ``config.py``);
- ``fft``: batched rfft2 correlations and integral-image window sums.

``auto`` resolves to ``pallas`` on CUDA and ``fft`` on the CPU. The layout
is node-first, (N, L, L) with L = 2r + 1; the JAX package's node-on-lane
layout and its 128-node padding are TPU artefacts.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as nnf

from ..config import resolve_device
from ..utils.profiling import annotate
from . import cuda_densetrack
from .cuda_densetrack import grid_patches
from .momentscore import nanmean2d, nanstd2d
from .phasecorr import argmax2d, subpixel_taylor

__all__ = [
    "dense_track_program",
    "dense_track_stack_program",
    "grid_starts",
    "peaks_node_first",
    "resolve_track_method",
]


def grid_starts(
    H: int, W: int, tile: int, search: int, step: int
) -> tuple[np.ndarray, np.ndarray]:
    """Tile start positions (y0s, x0s) of a regular tracking grid.

    Starts are chosen so each tile's search window (side ``tile + 2*search``)
    stays fully inside the frame; the grid covers the largest centred span
    with the requested step.
    """
    if tile < 3:
        raise ValueError("tile_size must be >= 3 px.")
    if search < 1:
        raise ValueError("search_radius must be >= 1 px.")
    if step < 1:
        raise ValueError("step must be >= 1 px.")
    lo_y, hi_y = search, H - tile - search
    lo_x, hi_x = search, W - tile - search
    if hi_y < lo_y or hi_x < lo_x:
        raise ValueError(
            f"frame ({H}, {W}) too small for tile_size={tile} with "
            f"search_radius={search}."
        )
    y0s = np.arange(lo_y, hi_y + 1, step, dtype=np.int32)
    x0s = np.arange(lo_x, hi_x + 1, step, dtype=np.int32)
    # centre the grid's leftover margin
    y0s = y0s + (hi_y - y0s[-1]) // 2
    x0s = x0s + (hi_x - x0s[-1]) // 2
    return y0s, x0s


def resolve_track_method(method: str = "auto", device=None) -> str:
    """Resolve ``"auto"`` for the device the tracking runs on (``None``: the
    card, and an error without one): ``"pallas"`` on CUDA, ``"fft"`` on the
    CPU."""
    if method == "auto":
        method = "pallas" if resolve_device(device).type == "cuda" else "fft"
    if method not in ("pallas", "conv", "fft"):
        raise ValueError(
            f"method must be 'auto', 'pallas', 'conv' or 'fft'; got {method!r}"
        )
    return method


def peaks_node_first(corr, r: int, subpixel: bool):
    """(dy, dx, peak) per node from a node-first (N, L, L) correlation
    field: the first-occurrence argmax and, with ``subpixel``, the 3x3
    Newton step; border and degenerate-Hessian nodes keep the integer peak."""
    L = 2 * r + 1
    i, j = argmax2d(corr)
    peak = corr.flatten(-2).gather(-1, (i * L + j)[:, None])[:, 0]
    fi = i.to(corr.dtype)
    fj = j.to(corr.dtype)
    if not subpixel:
        return fi - float(r), fj - float(r), peak
    di, dj = subpixel_taylor(corr, i, j, convention="newton")
    return fi + di - float(r), fj + dj - float(r), peak


def _zscore(x, eps: float):
    """Per-image NaN-aware z-score over the last two axes; NaN -> 0."""
    m = nanmean2d(x)[..., None, None]
    sd = nanstd2d(x)[..., None, None]
    return torch.nan_to_num((x - m) / (sd + eps))


def _ncc_from_sums(num, s1, s2, energy, s: int, eps: float):
    var_sum = torch.clamp_min(s2 - (s1 * s1) / float(s * s), 0.0)
    denom = torch.sqrt(var_sum * energy[:, None, None])
    safe = denom > eps
    return torch.where(safe, num / torch.where(safe, denom, 1.0), 0.0)


def _centred_tiles(ref, y0s, x0s, s: int):
    t = grid_patches(ref, y0s, x0s, s)
    t = t - t.mean(dim=(-2, -1), keepdim=True)
    return t, (t * t).sum(dim=(-2, -1))


def _pallas_corr(img3, ref, y0s, x0s, s: int, r: int, eps: float):
    """NCC field (F*N, L, L) of F frames against one reference via K3."""
    _t, energy = _centred_tiles(ref, y0s, x0s, s)
    with annotate("k3"):
        sums = cuda_densetrack.ncc_sums(ref, img3, y0s, x0s, s, r)
    num, s1, s2 = (a.to(img3.dtype) for a in sums)
    return _ncc_from_sums(num, s1, s2, energy.repeat(img3.shape[0]), s, eps)


def _to_float(img, ref):
    if img.dtype not in (torch.float32, torch.float64):
        img = img.to(torch.float32)
    return img, ref.to(img.dtype)


def dense_track_program(
    H: int, W: int, tile: int, search: int, step: int, subpixel: bool,
    method: str = "auto",
):
    """``(program, (y0s, x0s))`` with ``program(img, ref, eps) -> (dy, dx,
    peak)`` on the grid, each (len(y0s), len(x0s)).

    ``ref`` provides the tiles (the undisturbed speckle pattern), ``img``
    the search windows; displacements are img-relative-to-ref in pixels.
    ``img`` and ``ref`` are (H, W) tensors on one device; the results stay
    there. ``method``: see the module docstring."""
    return _dense_track_program(H, W, tile, search, step, subpixel, resolve_track_method(method))


@lru_cache(maxsize=32)
def _dense_track_program(H, W, tile, search, step, subpixel, method):
    s, r = int(tile), int(search)
    w = s + 2 * r
    y0s, x0s = grid_starts(H, W, s, r, step)
    gy, gx = len(y0s), len(x0s)
    N = gy * gx

    def program(img, ref, eps):
        img, ref = _to_float(img, ref)
        img = _zscore(img, eps)
        ref = _zscore(ref, eps)
        if method == "pallas":
            corr = _pallas_corr(img[None], ref, y0s, x0s, s, r, eps)
        else:
            t, energy = _centred_tiles(ref, y0s, x0s, s)
            win = grid_patches(img, y0s, x0s, w, -r)            # (N, w, w)
            if method == "conv":
                numer = nnf.conv2d(win[None], t[:, None], groups=N)[0]
                ones = torch.ones((1, 1, s, s), dtype=win.dtype, device=win.device)
                s1 = nnf.conv2d(win[:, None], ones)[:, 0]
                s2 = nnf.conv2d((win * win)[:, None], ones)[:, 0]
            else:  # the plain version of K3's sums, in the image's dtype
                numer, s1, s2 = cuda_densetrack.ncc_sums_plain(t, win, r)
            corr = _ncc_from_sums(numer, s1, s2, energy, s, eps)
        dy, dx, peak = peaks_node_first(corr, r, subpixel)
        return dy.reshape(gy, gx), dx.reshape(gy, gx), peak.reshape(gy, gx)

    return program, (y0s, x0s)


@lru_cache(maxsize=16)
def dense_track_stack_program(
    H: int, W: int, tile: int, search: int, step: int, subpixel: bool, F: int
):
    """Frame-batched ``pallas`` variant of :func:`dense_track_program`:
    ``program(frames (F, H, W), ref (H, W), eps) -> (dy, dx, peak)``, each
    (F, gy, gx). Frames are z-scored one by one; window f*N + n is tracked
    against tile n (the JAX package's lane index), so K3 runs once per
    batch."""
    s, r = int(tile), int(search)
    y0s, x0s = grid_starts(H, W, s, r, step)
    gy, gx = len(y0s), len(x0s)

    def program(frames, ref, eps):
        frames, ref = _to_float(frames, ref)
        corr = _pallas_corr(_zscore(frames, eps), _zscore(ref, eps), y0s, x0s, s, r, eps)
        dy, dx, peak = peaks_node_first(corr, r, subpixel)
        return dy.reshape(F, gy, gx), dx.reshape(F, gy, gx), peak.reshape(F, gy, gx)

    return program, (y0s, x0s)
