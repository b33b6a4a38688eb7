# SPDX-License-Identifier: CECILL-2.1
"""The Fourier quick-look in one call (counterpart of
``barc4dip_tpu/signal/summary.py``): PSD, peak-normalized autocorrelation
and both radial-mean profiles of the autocorrelation from one upload. The
two maps stay on the device (bring them to the host with
:func:`barc4dip_tpu_torch.signal.pull_centrosymmetric`); curves and axes
are NumPy.

The autocorrelation's inverse transform is kernel K1a on CUDA for the sides
it covers (``ops/cuda_fftp.corr_from_rfft``): one launch pair an image, one
a chunk of the stack call. Results match the separate ``psd2d`` /
``autocorr2d`` / ``maths.radial_mean_*`` calls; the binned curve's ring
sums are ``index_add_`` sums, which on CUDA add with atomics in no fixed
order, so there it matches to float32 round-off, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import device_array
from ..ops.corrcore import autocorr2d_core
from ..ops.fftcore import psd2d_core
from ..ops.radialcore import (
    binned_geometry,
    interpolated_geometry,
    radial_mean_binned_core,
    radial_mean_interpolated_core,
)
from .common import lag_axis_from_step, resolve_steps_2d
from .fft import freq_axes2d

__all__ = ["spectral_summary", "spectral_summary_stack"]


def _radial_curves(frames) -> dict:
    """Both radial means of the peak-normalized autocorrelation of
    (..., H, W) frames, and the autocorrelation itself."""
    ac = autocorr2d_core(frames, remove_mean=True, standardize=False, normalize="peak")
    rad_b, _ = radial_mean_binned_core(ac)
    rad_i, _ = radial_mean_interpolated_core(ac)
    return {"autocorr": ac, "radial_binned": rad_b, "radial_interpolated": rad_i}


def spectral_summary(
    image,
    *,
    x: np.ndarray | None = None,
    y: np.ndarray | None = None,
    dx: float = 1.0,
    dy: float = 1.0,
    scale: bool = True,
    device=None,
):
    """Spectral quick-look of a 2D image.

    Returns a dict with maps on the device and host axes:

    - ``psd`` (N0, N1) shifted PSD, ``fx``/``fy`` frequency axes;
    - ``autocorr`` (N0, N1) peak-normalized circular autocorrelation,
      ``xlag``/``ylag`` lag axes;
    - ``radial_binned`` / ``radial_interpolated`` radial-mean profiles of
      the autocorrelation (host NumPy), with ``r_binned`` /
      ``r_interpolated`` radius axes in pixel units.

    A numpy image computes on ``device`` (``None``: the card, and an error
    without one), a tensor on its own device.
    """
    img = device_array(image, device)
    if img.dim() != 2:
        raise ValueError("image must be a 2D array.")
    if img.is_complex():
        raise ValueError(
            "spectral_summary expects a real-valued image; for complex "
            "fields use signal.psd2d / signal.autocorr2d directly."
        )
    ny, nx = (int(s) for s in img.shape)
    step_x, step_y = resolve_steps_2d(shape=(ny, nx), x=x, y=y, dx=dx, dy=dy)

    P = psd2d_core(img, step_x=float(step_x), step_y=float(step_y), scale=bool(scale))
    out = _radial_curves(img)
    # both curves leave the device in one transfer
    nb = out["radial_binned"].shape[-1]
    curves = torch.cat([out["radial_binned"], out["radial_interpolated"]]).cpu().numpy()

    fx, fy = freq_axes2d(shape=(ny, nx), x=x, y=y, dx=dx, dy=dy)
    *_, r_b = binned_geometry((ny, nx), None, 1.0)
    *_, r_i = interpolated_geometry((ny, nx), None, None, None)
    return {
        "psd": P,
        "fx": fx,
        "fy": fy,
        "autocorr": out["autocorr"],
        "xlag": lag_axis_from_step(nx, step_x),
        "ylag": lag_axis_from_step(ny, step_y),
        "radial_binned": curves[:nb],
        "r_binned": r_b.copy(),
        "radial_interpolated": curves[nb:],
        "r_interpolated": r_i.copy(),
    }


def _stack_program(frames) -> dict:
    """(B, H, W) frames -> curves with a leading B axis. The per-frame maps
    are not returned: at stack scale they would dominate transfer and
    memory; use :func:`spectral_summary` on a single frame for maps."""
    out = _radial_curves(frames)
    return {k: out[k] for k in ("radial_binned", "radial_interpolated")}


def spectral_summary_stack(
    stack,
    *,
    x: np.ndarray | None = None,
    y: np.ndarray | None = None,
    dx: float = 1.0,
    dy: float = 1.0,
    frame_chunk: int = 8,
    mesh=None,
    device=None,
):
    """Per-frame radial autocorrelation profiles of a (T, H, W) stack.

    The scan-series form of :func:`spectral_summary`: each frame's
    peak-normalized autocorrelation reduces to its binned and interpolated
    radial means on the device, one batched call a chunk of ``frame_chunk``
    frames, and only the (T, nbins)/(T, nr) curves come back. A numpy stack
    is uploaded chunk by chunk in its own dtype (integer detector frames
    are cast on the device); a tensor stack is sliced on its own device.
    ``mesh`` (:func:`..parallel.frame_mesh`) shards each chunk's frames
    over the mesh's devices.

    Returns {"radial_binned": (T, nbins), "r_binned": (nbins,),
    "radial_interpolated": (T, nr), "r_interpolated": (nr,)} as NumPy.
    """
    from ..metrics.common import run_stack_program

    arr = stack if hasattr(stack, "ndim") else np.asarray(stack)
    if arr.ndim != 3:
        raise ValueError(f"stack must be 3D (T, H, W); got ndim={arr.ndim}")
    _, ny, nx = (int(v) for v in arr.shape)
    resolve_steps_2d(shape=(ny, nx), x=x, y=y, dx=dx, dy=dy)  # validates the calibration

    out = run_stack_program(
        arr, _stack_program, frame_chunk=frame_chunk, mesh=mesh, device=device
    )

    *_, r_b = binned_geometry((ny, nx), None, 1.0)
    *_, r_i = interpolated_geometry((ny, nx), None, None, None)
    return {
        "radial_binned": out["radial_binned"],
        "r_binned": r_b.copy(),
        "radial_interpolated": out["radial_interpolated"],
        "r_interpolated": r_i.copy(),
    }
