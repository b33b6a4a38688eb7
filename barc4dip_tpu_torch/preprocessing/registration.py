# SPDX-License-Identifier: CECILL-2.1
"""Stack registration: measure per-frame drift and re-align frames
(counterpart of ``barc4dip_tpu/preprocessing/registration.py``).

- :func:`register_stack` estimates each frame's translation against a
  reference (first frame, stack mean, or the previous frame) by full-frame
  phase correlation refined by the upsampled DFT
  (``ops/upsampled_dft.phase_cross_correlation_upsampled`` on z-scored
  frames, ``ops/phasecorr.zscore2d``), then shifts every frame back, chunk
  by chunk on the device.
- :func:`shift_stack` applies given per-frame (dy, dx) translations, as an
  exact subpixel Fourier phase ramp or an integer roll.

Conventions match the tracker: displacements are numpy row/column order
((dy, dx) = frame position relative to the reference, so
``frame ~ reference shifted by (+dy, +dx)``); alignment applies (-dy, -dx).
Fourier shifts are circular; ``shift_mode="roll"`` rounds to integer pixels
(half to even, as ``jnp.round``) and is exactly lossless. The frequency
grids are float64-built and rounded once to float32, as the JAX package's
are. Chunks go through the port's frame loader (pinned, non-blocking
uploads for numpy stacks); residence follows the input.
"""
from __future__ import annotations

import logging
from typing import Literal

import numpy as np
import torch

from ..metrics.common import frame_loader
from ..ops import phasecorr as pc_ops
from ..ops import upsampled_dft as upsampled
from ..utils.time import elapsed_time, now

__all__ = ["register_stack", "shift_stack"]

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# device kernels on (B, H, W) chunks
# ---------------------------------------------------------------------------

def _measure(frames, refs_z, upsample_factor: int):
    """(dy, dx), (B,) float32, of each frame relative to its z-scored
    reference (one (H, W) for the chunk, or one per frame), such that
    ``frame ~ reference shifted by (+dy, +dx)``. The upsampled phase
    correlation returns the shift that aligns ``moving`` to ``reference``:
    the negative of the drift measured here."""
    shifts = []
    for b in range(frames.shape[0]):
        ref_z = refs_z if refs_z.dim() == 2 else refs_z[b]
        sy, sx = upsampled.phase_cross_correlation_upsampled(
            ref_z, pc_ops.zscore2d(frames[b]), upsample_factor=upsample_factor
        )
        shifts.append(torch.stack([-sy, -sx]))
    d = torch.stack(shifts).to(torch.float32)
    return d[:, 0], d[:, 1]


def _freqs(n: int, real: bool, device):
    f = np.fft.rfftfreq(n) if real else np.fft.fftfreq(n)
    return torch.from_numpy(f.astype(np.float32)).to(device)


def _fourier_shift(frames, sy, sx):
    """y(p) = x(p - s): move each frame's content by its (+sy, +sx) pixels
    by an exact frequency-domain phase ramp (circular boundary)."""
    H, W = frames.shape[-2], frames.shape[-1]
    fy = _freqs(H, False, frames.device)[:, None]
    fx = _freqs(W, True, frames.device)[None, :]
    ang = (-2.0 * np.pi) * (fy * sy[:, None, None] + fx * sx[:, None, None])
    ramp = torch.complex(torch.cos(ang), torch.sin(ang))
    return torch.fft.irfft2(torch.fft.rfft2(frames) * ramp, s=(H, W))


def _roll_shift(frames, sy, sx):
    """Integer-pixel circular shift by (round(sy), round(sx)): lossless."""
    H, W = frames.shape[-2], frames.shape[-1]
    dev = frames.device
    rows = torch.remainder(torch.arange(H, device=dev) - torch.round(sy).to(torch.int64)[:, None], H)
    cols = torch.remainder(torch.arange(W, device=dev) - torch.round(sx).to(torch.int64)[:, None], W)
    b = torch.arange(frames.shape[0], device=dev)[:, None, None]
    return frames[b, rows[:, :, None], cols[:, None, :]]


def _apply_shift(frames, sy, sx, mode: str):
    return _fourier_shift(frames, sy, sx) if mode == "fourier" else _roll_shift(frames, sy, sx)


# ---------------------------------------------------------------------------
# chunked orchestration
# ---------------------------------------------------------------------------

def _to_host(x, device_in: bool):
    return x if device_in else x.cpu()


def _as_float32_frames(stack):
    """The stack as float32 frames: numpy stays on the host for the loader,
    a tensor is cast on its own device."""
    if isinstance(stack, torch.Tensor):
        return stack.to(torch.float32)
    return np.asarray(stack, dtype=np.float32)


def shift_stack(
    stack,
    dy,
    dx,
    *,
    shift_mode: Literal["fourier", "roll"] = "fourier",
    frame_chunk: int = 8,
    device=None,
):
    """Translate every frame of a (T, H, W) stack by its own (+dy, +dx).

    ``shift_mode="fourier"`` applies an exact subpixel phase ramp
    (circular); ``"roll"`` rounds to integers and is lossless. Residence
    follows the input: numpy in -> numpy out, computed on ``device``
    (``None``: the card, and an error without one); a tensor in -> a tensor
    out on its own device. A 2D image is accepted with scalar shifts."""
    if shift_mode not in {"fourier", "roll"}:
        raise ValueError("shift_mode must be 'fourier' or 'roll'.")
    single = stack.ndim == 2
    frames = stack[None] if single else stack
    if frames.ndim != 3:
        raise ValueError(
            f"stack must be 2D (H, W) or 3D (T, H, W); got ndim={stack.ndim}"
        )
    if frames.shape[0] < 1:
        raise ValueError("stack must contain at least one frame.")
    device_in = isinstance(frames, torch.Tensor)
    frames = _as_float32_frames(frames)
    T = int(frames.shape[0])
    dy = torch.from_numpy(np.broadcast_to(np.asarray(dy, np.float32), (T,)).copy())
    dx = torch.from_numpy(np.broadcast_to(np.asarray(dx, np.float32), (T,)).copy())

    device, load = frame_loader(frames, device)
    B = max(1, min(int(frame_chunk), T))
    pieces = []
    for c0 in range(0, T, B):
        c1 = min(c0 + B, T)
        sy, sx = dy[c0:c1].to(device), dx[c0:c1].to(device)
        pieces.append(_to_host(_apply_shift(load(c0, c1), sy, sx, shift_mode), device_in))
    out = torch.cat(pieces)
    out = out[0] if single else out
    return out if device_in else out.numpy()


def register_stack(
    stack,
    *,
    reference: Literal["first", "mean", "previous"] = "first",
    subpixel: bool = True,
    upsample_factor: int = 20,
    shift_mode: Literal["fourier", "roll"] = "fourier",
    frame_chunk: int = 8,
    verbose: bool = False,
    device=None,
):
    """Measure and remove per-frame translational drift from a stack.

    Parameters
    ----------
    stack : (T, H, W) numpy.ndarray or torch.Tensor
        Frames to align. Residence follows the input (numpy in -> numpy
        out, computed on ``device``: ``None`` means the card and raises
        without one; a tensor in -> a tensor out on its own device, nothing
        pulled but the shifts).
    reference : "first" | "mean" | "previous"
        What each frame is registered against. "first"/"mean" measure
        absolute drift in one measure+align pass per chunk (the mean of a
        numpy stack is taken on the host in float32, of a tensor on its
        device); "previous" measures incremental drift (robust when total
        drift is large but frame-to-frame motion is small), integrates it
        on the host as a float32 cumsum, then aligns in a second chunked
        pass.
    subpixel : bool
        Refine the correlation peak with the upsampled-DFT evaluation at
        ``upsample_factor``; ``False`` measures integer-pixel drift only.
    upsample_factor : int
        Subpixel resolution of the refinement (1/upsample_factor px).
    shift_mode : "fourier" | "roll"
        How frames are moved back: exact subpixel phase ramp (circular)
        or lossless integer roll.
    frame_chunk : int
        Frames per device step.

    Returns
    -------
    (aligned, shifts) : aligned stack + ``{"dy", "dx", "reference"}``
        with (T,) float32 per-frame displacements as MEASURED (the applied
        correction is their negative); ``dy[0] == dx[0] == 0`` by
        construction for "first" and "previous".
    """
    if reference not in {"first", "mean", "previous"}:
        raise ValueError("reference must be 'first', 'mean' or 'previous'.")
    if shift_mode not in {"fourier", "roll"}:
        raise ValueError("shift_mode must be 'fourier' or 'roll'.")
    if not isinstance(stack, (np.ndarray, torch.Tensor)):
        raise TypeError("register_stack expects a numpy.ndarray or torch.Tensor")
    if stack.ndim != 3:
        raise ValueError(
            f"stack must be a 3D array with shape (T, H, W); got ndim={stack.ndim}"
        )
    if stack.shape[0] < 1:
        raise ValueError("stack must contain at least one frame.")

    t0 = now()
    device_in = isinstance(stack, torch.Tensor)
    frames = _as_float32_frames(stack)
    T = int(frames.shape[0])
    B = max(1, min(int(frame_chunk), T))
    u = int(upsample_factor) if subpixel else 1
    if u < 1:
        raise ValueError("upsample_factor must be >= 1.")
    device, load = frame_loader(frames, device)
    spans = [(c0, min(c0 + B, T)) for c0 in range(0, T, B)]

    if reference == "previous":
        incs = []
        for c0, c1 in spans:
            chunk = load(c0, c1)
            boundary = chunk[:1] if c0 == 0 else load(c0 - 1, c0)
            prevs = torch.cat([boundary, chunk[:-1]])
            incs.append(torch.stack(_measure(chunk, pc_ops.zscore2d(prevs), u)))
        inc = torch.cat(incs, dim=1).cpu().numpy()
        dy = np.cumsum(inc[0], dtype=np.float32)
        dx = np.cumsum(inc[1], dtype=np.float32)
        aligned = shift_stack(
            frames, -dy, -dx, shift_mode=shift_mode, frame_chunk=B, device=device
        )
    else:
        if reference == "first":
            ref = load(0, 1)[0]
        elif device_in:
            ref = frames.mean(dim=0)
        else:
            ref = torch.from_numpy(frames.mean(axis=0, dtype=np.float32)).to(device)
        ref_z = pc_ops.zscore2d(ref)
        pieces, shifts = [], []
        for c0, c1 in spans:
            chunk = load(c0, c1)
            d = _measure(chunk, ref_z, u)
            pieces.append(_to_host(_apply_shift(chunk, -d[0], -d[1], shift_mode), device_in))
            shifts.append(torch.stack(d))
        aligned = torch.cat(pieces)
        if not device_in:
            aligned = aligned.numpy()
        d = torch.cat(shifts, dim=1).cpu().numpy()
        dy, dx = d[0], d[1]

    if verbose:
        logger.info(
            "> register_stack | frames=%d | reference=%s | mode=%s | "
            "max|d|=%.3f px | elapsed=%.3fs",
            T, reference, shift_mode,
            float(np.hypot(dy, dx).max()) if T else 0.0,
            elapsed_time(t0, verbose=False),
        )
    return aligned, {
        "dy": np.asarray(dy, np.float32),
        "dx": np.asarray(dx, np.float32),
        "reference": reference,
    }
