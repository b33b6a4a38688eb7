# SPDX-License-Identifier: CECILL-2.1
"""Flat-field (gain) correction (counterpart of
``barc4dip_tpu/preprocessing/normalize.py``).

``(I - D) / (F - D) * scale`` with stacked flats/darks mean-reduced on the
host in float32, bad pixels (den <= eps) zeroed and optionally repaired by
the 3x3 median (kernel K2 on CUDA), scale in {none, flat_mean,
flat_median}, float32 output.

Each call leaves its host split in :data:`LAST_RUN_PERF`, and marks its
stages with spans (``utils/profiling.annotate``): ``ffc.calib`` (the host
reduction of flats and darks), ``ffc.upload`` (the float32 conversion and
the copies to the device) and ``k2`` (the 3x3 median repair).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import resolve_device
from ..ops.quantile import median_exact, nanmedian_exact
from ..ops.rank import median_filter2d
from ..utils.profiling import annotate

__all__ = ["LAST_RUN_PERF", "flat_field_correction"]

#: Host split of the last :func:`flat_field_correction` call: ``calib_s``
#: (seconds reducing the stacked flats and darks on the host),
#: ``calib_bytes`` (the bytes of flats and darks reduced) and ``upload_s``
#: (seconds converting the images to float32 and copying images, flat and
#: dark to the device). Reset at the start of every call.
LAST_RUN_PERF: dict = {}


def _ffc(img, flat2d, dark2d, eps, *, scale: str, bad_pixel_removal: bool):
    den = flat2d - dark2d
    if eps is None:
        med = median_exact(den)
        eps_t = torch.where(med > 0, 1e-6 * med, 1e-6)
    else:
        eps_t = torch.tensor(eps, dtype=torch.float32, device=den.device)

    bad = den <= eps_t
    den_safe = torch.where(bad, 1.0, den)
    out = (img - dark2d) / den_safe  # broadcasts over a leading stack axis

    if scale != "none":
        valid = ~bad
        nvalid = valid.sum().clamp_min(1)
        if scale == "flat_mean":
            s = torch.where(valid, den, 0.0).sum() / nvalid
        else:  # flat_median over the valid pixels
            s = nanmedian_exact(torch.where(valid, den, torch.nan))
        out = out * s

    out = torch.where(bad, 0.0, out)
    if bad_pixel_removal:
        with annotate("k2"):
            med = median_filter2d(out, size=3)
        out = torch.where(bad, med, out)
    return out.to(torch.float32)


def _host_f32(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr, dtype=np.float32)


def _nbytes(arr) -> int:
    if arr is None:
        return 0
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.asarray(arr).nbytes)


@annotate("entry.flat_field_correction")
def flat_field_correction(
    images,
    *,
    flats=None,
    darks=None,
    scale: str = "flat_median",
    bad_pixel_removal: bool = False,
    eps: float | None = None,
    verbose: bool = False,
    as_numpy: bool | None = None,
    device=None,
):
    """Apply flat-field correction to a 2D image or (N, H, W) stack.

    Returns float32 with the input's shape. Degenerate paths match the
    reference: no flats/darks -> copy; dark-only -> subtraction; flat-only
    -> zero dark.

    ``as_numpy=None`` keeps the result where the input lives: numpy in ->
    numpy out, a tensor in -> a tensor out on its device. Pass True/False to
    force either residence. A numpy input computes on ``device`` (``None``:
    the card, and an error without one).
    """
    t0 = time.perf_counter()
    perf = LAST_RUN_PERF
    perf.clear()
    perf.update(calib_s=0.0, calib_bytes=0, upload_s=0.0)
    if scale not in {"none", "flat_mean", "flat_median"}:
        raise ValueError(f"Invalid scale option: {scale}")
    if images.ndim not in {2, 3}:
        raise ValueError("images must be 2D or 3D")

    device_in = isinstance(images, torch.Tensor)
    if as_numpy is None:
        as_numpy = not device_in

    def _reduce_stack(arr):
        if arr is None:
            return None
        if arr.ndim == 3:
            return _host_f32(arr).mean(axis=0)
        if arr.ndim == 2:
            return _host_f32(arr)
        raise ValueError("flats/darks must be 2D or 3D")

    tc = time.perf_counter()
    with annotate("ffc.calib"):
        flat2d = _reduce_stack(flats)
        dark2d = _reduce_stack(darks)
    perf["calib_s"] = time.perf_counter() - tc
    perf["calib_bytes"] = _nbytes(flats) + _nbytes(darks)

    def _deliver(out):
        if verbose:
            print(f"> flat_field_correction | elapsed {time.perf_counter() - t0:.3f} s")
        if as_numpy:
            return out.detach().cpu().numpy().astype(np.float32, copy=False)
        return out.to(device)

    tu = time.perf_counter()
    with annotate("ffc.upload"):
        if device_in:
            img = images.to(torch.float32)
            device = images.device
        else:
            img = torch.from_numpy(np.array(images, dtype=np.float32))
            device = resolve_device(device)
        calibrated = flat2d is not None or dark2d is not None
        if calibrated:
            img = img.to(device)
            dark = (
                torch.zeros((), dtype=torch.float32, device=device) if dark2d is None
                else torch.from_numpy(dark2d).to(device)
            )
            flat = None if flat2d is None else torch.from_numpy(flat2d).to(device)
    perf["upload_s"] = time.perf_counter() - tu

    if not calibrated:
        return _deliver(img.clone())
    if flat is None:
        return _deliver(img - dark)
    out = _ffc(
        img, flat, dark, eps,
        scale=scale, bad_pixel_removal=bool(bad_pixel_removal),
    )
    return _deliver(out)
