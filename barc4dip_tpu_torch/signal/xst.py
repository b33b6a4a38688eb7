# SPDX-License-Identifier: CECILL-2.1
"""Dense speckle-tracking displacement fields and wavefront reconstruction
(counterpart of ``barc4dip_tpu/signal/xst.py``).

X-ray speckle tracking (XST) compares a sample image against a reference
speckle image over a dense sub-aperture grid: each local displacement is
proportional to the local wavefront slope, and integrating the slope field
gives the wavefront. The tracking core is :mod:`..ops.densetrack` (kernel
K3 on CUDA).

Inputs may be numpy arrays or tensors. Tensors are tracked on their device;
numpy frames are uploaded to the device of a tensor argument, else to
``device`` (``None``: the card, and an error without one). Displacement
results come back to the
host as float32 numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, upload
from ..maths.integrate import integrate_gradients
from ..ops.densetrack import (
    dense_track_program,
    dense_track_stack_program,
    resolve_track_method,
)

__all__ = [
    "track_displacement_field",
    "track_displacement_stack",
    "wavefront_from_displacements",
]


def _device_of(device, *arrays) -> torch.device:
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(device)


def _on(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return upload(np.asarray(a), device)


def _host(*arrs, n=None):
    return tuple(a.detach().cpu().numpy().astype(np.float32)[:n] for a in arrs)


def _meta(kind, shape_key, shape, s, step, r, subpixel, method, y0s, x0s, **extra):
    return {
        "kind": kind,
        shape_key: shape,
        "tile_size": s,
        "step": step,
        "search_radius": r,
        "subpixel": subpixel,
        "method": method,
        **extra,
        "grid_shape": (len(y0s), len(x0s)),
        "units": {"dy": "px", "dx": "px", "peak": "1"},
    }


def track_displacement_field(
    img,
    ref,
    *,
    tile_size: int = 33,
    step: int = 16,
    search_radius: int = 10,
    subpixel: bool = True,
    eps: float = 1e-9,
    method: str = "auto",
    device=None,
) -> dict:
    """Dense (dy, dx) displacement field of ``img`` relative to ``ref``.

    For every node of a regular grid, the ``tile_size``-square patch of
    ``ref`` is located inside the corresponding ``img`` search window
    (``tile_size + 2*search_radius`` square) by zero-normalised
    cross-correlation with optional Newton subpixel refinement.

    Returns a dict: ``dy``, ``dx`` (gy, gx) float32 displacement maps [px];
    ``peak`` (gy, gx) NCC peak values; ``y``, ``x`` grid node centres [px];
    ``meta`` (geometry record, with the resolved ``method``).
    """
    if img.ndim != 2 or ref.ndim != 2 or tuple(img.shape) != tuple(ref.shape):
        raise ValueError(
            f"img and ref must be equal-shape 2D images; got "
            f"{tuple(img.shape)} vs {tuple(ref.shape)}"
        )
    H, W = (int(v) for v in img.shape)
    device = _device_of(device, img, ref)
    s, r, step = int(tile_size), int(search_radius), int(step)
    method = resolve_track_method(str(method), device)
    program, (y0s, x0s) = dense_track_program(H, W, s, r, step, bool(subpixel), method)
    dy, dx, peak = _host(*program(_on(img, device), _on(ref, device), float(np.float32(eps))))

    half = (s - 1) / 2.0
    return {
        "dy": dy,
        "dx": dx,
        "peak": peak,
        "y": np.asarray(y0s, np.float64) + half,
        "x": np.asarray(x0s, np.float64) + half,
        "meta": _meta("displacement_field", "input_shape", (H, W), s, step, r,
                      bool(subpixel), method, y0s, x0s),
    }


def track_displacement_stack(
    stack,
    ref=None,
    *,
    tile_size: int = 33,
    step: int = 16,
    search_radius: int = 10,
    subpixel: bool = True,
    eps: float = 1e-9,
    method: str = "auto",
    mesh=None,
    frame_batch: int = 4,
    device=None,
) -> dict:
    """Dense displacement fields for every frame of a (T, H, W) stack.

    With ``method`` resolving to ``"pallas"``, frames run in batches of
    ``frame_batch`` through one K3 launch per batch (the tail batch is padded
    with copies of its last frame). Otherwise each frame is tracked alone.
    Either way the device runs one call ahead of the host's pull. With
    ``mesh`` (:func:`..parallel.frame_mesh`), frames go round-robin over
    the mesh's entries, the reference is placed once a device, one frame a
    device is in flight before the host collects, and frames are not
    batched (one K3 launch a frame); ``device`` is then not used. Returns
    the dict of :func:`track_displacement_field` with a leading T axis on
    ``dy``/``dx``/``peak``.
    """
    if not hasattr(stack, "ndim"):  # a lazy frame view stays lazy
        stack = np.asarray(stack)
    if stack.ndim != 3:
        raise ValueError(f"stack must be 3D (T, H, W); got ndim={stack.ndim}")
    T, H, W = (int(v) for v in stack.shape)
    ref = stack[0] if ref is None else ref
    if tuple(ref.shape) != (H, W):
        raise ValueError(f"ref shape {tuple(ref.shape)} != frame shape {(H, W)}")
    s, r, step, subpixel = int(tile_size), int(search_radius), int(step), bool(subpixel)
    eps = float(np.float32(eps))
    if mesh is not None:
        return _track_stack_mesh(stack, ref, mesh, T, H, W, s, r, step, subpixel, eps, method)
    device = _device_of(device, stack, ref)
    ref_dev = _on(ref, device)

    resolved = resolve_track_method(str(method), device)
    Fb = max(1, int(frame_batch))
    extra = {}
    if resolved == "pallas" and Fb > 1 and T > 1:
        Fb = min(Fb, T)
        program, (y0s, x0s) = dense_track_stack_program(H, W, s, r, step, subpixel, Fb)
        extra = {"frame_batch": Fb}
    else:
        Fb = 1
        program, (y0s, x0s) = dense_track_program(H, W, s, r, step, subpixel, resolved)

    def chunks():
        """(frames on the device, frames valid), uploaded as the loop asks."""
        for c0 in range(0, T, Fb):
            c1 = min(c0 + Fb, T)
            if Fb == 1:
                yield _on(stack[c0], device), 1
                continue
            chunk = _on(stack[c0:c1], device)
            if c1 - c0 < Fb:  # pad the tail to the batch's shape
                chunk = torch.cat([chunk, chunk[-1:].expand(Fb - (c1 - c0), H, W)])
            yield chunk, c1 - c0

    dys, dxs, peaks = [], [], []
    pending = None  # (device results, frames valid): pulled one call behind
    for chunk, n in chunks():
        out = program(chunk, ref_dev, eps)
        if pending is not None:
            _collect(pending, dys, dxs, peaks)
        pending = (out, n)
    _collect(pending, dys, dxs, peaks)

    return _stack_result(dys, dxs, peaks, y0s, x0s, (T, H, W), s, step, r, subpixel,
                         resolved, **extra)


def _track_stack_mesh(stack, ref, mesh, T, H, W, s, r, step, subpixel, eps, method) -> dict:
    """Frame t on mesh entry t % mesh.size, tracked alone (F = 1), with at
    most one frame an entry in flight before the host collects."""
    devices = mesh.devices
    resolved = resolve_track_method(str(method), devices[0])
    program, (y0s, x0s) = dense_track_program(H, W, s, r, step, subpixel, resolved)
    refs = {d: _on(ref, d) for d in dict.fromkeys(devices)}  # placed once a device
    dys, dxs, peaks = [], [], []
    pending: list = []
    for t in range(T):
        d = devices[t % len(devices)]
        pending.append((program(_on(stack[t], d), refs[d], eps), 1))
        if len(pending) > len(devices):
            _collect(pending.pop(0), dys, dxs, peaks)
    for item in pending:
        _collect(item, dys, dxs, peaks)
    return _stack_result(dys, dxs, peaks, y0s, x0s, (T, H, W), s, step, r, subpixel, resolved)


def _stack_result(dys, dxs, peaks, y0s, x0s, shape, s, step, r, subpixel, method, **extra):
    half = (s - 1) / 2.0
    return {
        "dy": np.concatenate(dys),
        "dx": np.concatenate(dxs),
        "peak": np.concatenate(peaks),
        "y": np.asarray(y0s, np.float64) + half,
        "x": np.asarray(x0s, np.float64) + half,
        "meta": _meta("displacement_stack", "stack_shape", shape, s, step, r,
                      subpixel, method, y0s, x0s, **extra),
    }


def _collect(pending, dys, dxs, peaks) -> None:
    out, n = pending
    if out[0].dim() == 2:  # one frame: add its T axis
        out = tuple(a[None] for a in out)
    dy, dx, pk = _host(*out, n=n)
    dys.append(dy)
    dxs.append(dx)
    peaks.append(pk)


def wavefront_from_displacements(
    field: dict,
    *,
    pixel_size: float,
    distance: float,
    wavelength: float | None = None,
) -> dict:
    """Integrate a dense displacement field into a wavefront surface.

    XST relation (Berujon et al. 2012): a displacement ``d`` [px] at
    propagation ``distance`` is a local wavefront slope
    ``d * pixel_size / distance``; the slopes integrate (Frankot-Chellappa,
    :func:`..maths.integrate_gradients`) into the wavefront height [unit of
    ``pixel_size``]; with ``wavelength`` the phase ``2*pi/lambda * W`` [rad]
    is returned too. Stacked fields integrate frame by frame.
    """
    if pixel_size <= 0 or distance <= 0:
        raise ValueError("pixel_size and distance must be positive.")
    slope_y = np.asarray(field["dy"], np.float64) * pixel_size / distance
    slope_x = np.asarray(field["dx"], np.float64) * pixel_size / distance
    grid_step = float(field["meta"]["step"]) * pixel_size

    def surface_of(gy, gx):
        return integrate_gradients(gy, gx, dy=grid_step, dx=grid_step).numpy()

    if slope_y.ndim == 3:  # displacement_stack: integrate per frame
        surface = np.stack([surface_of(gy, gx) for gy, gx in zip(slope_y, slope_x)])
    else:
        surface = surface_of(slope_y, slope_x)
    out = {
        "wavefront": surface,
        "slope_y": slope_y,
        "slope_x": slope_x,
        "meta": {
            "kind": "wavefront",
            "pixel_size": float(pixel_size),
            "distance": float(distance),
            "grid_step": grid_step,
            "units": {"wavefront": "pixel_size unit", "slope": "rad (small-angle)"},
        },
    }
    if wavelength is not None:
        if wavelength <= 0:
            raise ValueError("wavelength must be positive.")
        out["phase"] = 2.0 * np.pi / wavelength * surface
        out["meta"]["wavelength"] = float(wavelength)
        out["meta"]["units"]["phase"] = "rad"
    return out
