# SPDX-License-Identifier: CECILL-2.1
"""Flat-field (gain) correction (counterpart of
``barc4dip_tpu/preprocessing/normalize.py``).

``(I - D) / (F - D) * scale`` with stacked flats/darks mean-reduced in
float32 on the compute device from their raw counts, bad pixels (den <=
eps) zeroed and optionally repaired by the 3x3 median (kernel K2 on CUDA),
scale in {none, flat_mean, flat_median}, float32 output.

Each call leaves its host split in :data:`LAST_RUN_PERF`, and marks its
stages with spans (``utils/profiling.annotate``): ``ffc.calib`` (the copies
of flats and darks to the device and their reduction there),
``ffc.upload`` (the images' copies to the device: a numpy input's raw
counts a few frames at a time through ``config.upload``, cast to float32
there) and ``k2`` (the 3x3 median repair).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import resolve_device, to_compute, upload
from ..ops.quantile import median_exact, nanmedian_exact
from ..ops.rank import median_filter2d
from ..utils.profiling import annotate

__all__ = ["LAST_RUN_PERF", "flat_field_correction"]

#: Host split of the last :func:`flat_field_correction` call: ``calib_s``
#: (host-clock seconds of the calibration stage: copying the flats and darks
#: to the device in their own dtype and enqueueing their reduction),
#: ``calib_bytes`` (the raw bytes of flats and darks), ``calib_device_frames``
#: (the frames of stacked flats and darks reduced on a device), ``upload_s``
#: (host-clock seconds bringing the images to the device as float32) and
#: ``upload_device_frames`` (the image frames of a numpy input brought to
#: the device in chunks, their raw counts cast there). Reset at the start of
#: every call.
LAST_RUN_PERF: dict = {}

#: Frames of a numpy image stack copied to the device at a time: 32 MiB of
#: 2048² uint16, so the host pins the next chunk while this one copies and
#: is cast there.
UPLOAD_CHUNK_FRAMES = 4


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


def _frame_f32(frame, device) -> torch.Tensor:
    """One raw frame as float32 on ``device``: the bytes travel in the
    frame's own dtype and the cast happens there."""
    if isinstance(frame, torch.Tensor):
        t = to_compute(frame.detach().to(device))
    else:
        t = upload(frame, device)
    return t.to(torch.float32)


def _images_f32(images, device, perf) -> torch.Tensor:
    """A numpy image or stack as float32 on ``device``, a chunk of
    :data:`UPLOAD_CHUNK_FRAMES` frames at a time into one result allocated
    there (an image is one chunk). Counts of 4 bytes or fewer travel in their
    own dtype and are cast there; wider values (float64) are cast on the host
    a chunk at a time, so float32 bytes travel. Every cast is exact or rounds
    to nearest even: the result is ``np.array(images, dtype=np.float32)``'s
    bit for bit."""
    arr = np.asarray(images)
    stack = arr.reshape(-1, *arr.shape[-2:])
    out = torch.empty(stack.shape, dtype=torch.float32, device=device)
    for t in range(0, stack.shape[0], UPLOAD_CHUNK_FRAMES):
        chunk = stack[t:t + UPLOAD_CHUNK_FRAMES]
        if chunk.dtype.itemsize > 4:
            chunk = chunk.astype(np.float32)
        out[t:t + UPLOAD_CHUNK_FRAMES] = _frame_f32(chunk, device)
    perf["upload_device_frames"] += stack.shape[0]
    return out.reshape(arr.shape)


def _calibration(arr, device, perf) -> torch.Tensor | None:
    """A flats or darks input as one float32 frame on ``device``.

    A stack is summed frame by frame into one float32 accumulator and
    divided by its frame count: integer counts sum exactly below 2**24, so
    the quotient is the host's float32 mean bit for bit, and the transient
    is a few frames. A tensor on a card is reduced where it lives; anything
    else is reduced on ``device``."""
    if arr is None:
        return None
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    if arr.ndim == 2:
        return _frame_f32(arr, device)
    if arr.ndim != 3:
        raise ValueError("flats/darks must be 2D or 3D")
    on_card = isinstance(arr, torch.Tensor) and arr.device.type != "cpu"
    where = arr.device if on_card else device
    acc = torch.zeros(arr.shape[1:], dtype=torch.float32, device=where)
    for frame in arr:
        acc += _frame_f32(frame, where)
    perf["calib_device_frames"] += int(arr.shape[0])
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python scalar
    return acc.div_(torch.full((), float(arr.shape[0]), device=where)).to(device)


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
    perf.update(calib_s=0.0, calib_bytes=0, calib_device_frames=0, upload_s=0.0, upload_device_frames=0)
    if scale not in {"none", "flat_mean", "flat_median"}:
        raise ValueError(f"Invalid scale option: {scale}")
    if images.ndim not in {2, 3}:
        raise ValueError("images must be 2D or 3D")

    device_in = isinstance(images, torch.Tensor)
    if as_numpy is None:
        as_numpy = not device_in
    device = images.device if device_in else resolve_device(device)

    tc = time.perf_counter()
    with annotate("ffc.calib"):
        flat = _calibration(flats, device, perf)
        dark = _calibration(darks, device, perf)
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
        calibrated = flat is not None or dark is not None
        if device_in:
            img = images.to(torch.float32)
        elif calibrated:
            img = _images_f32(images, device, perf)
        else:
            img = torch.from_numpy(np.array(images, dtype=np.float32))
        if calibrated:
            img = img.to(device)
            if dark is None:
                dark = torch.zeros((), dtype=torch.float32, device=device)
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
