# SPDX-License-Identifier: CECILL-2.1
"""Chunked stack pipeline: per-frame metrics and abs/inc template tracking
(counterpart of the host loop of
``barc4dip_tpu/metrics/stack_fused.py::run_fused_speckle_stack``).

- each chunk of raw frames is uploaded once, in its own dtype, from pinned
  memory without blocking, and cast on the device;
- the metric step and the tracker read that one copy; the tracker sees the
  frames as uploaded, the metric step after the display-origin flip;
- the chunk's last frame stays on the device as the next chunk's
  incremental-tracking reference;
- each chunk's results leave the device as one vector, copied without
  blocking; the host unpacks chunk k while chunk k+1 runs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, to_compute
from ..ops import ncc as ncc_ops
from ..ops import phasecorr as pc_ops
from .common import apply_display_origin
from .speckles_device import int_value_hint, speckle_device_fn
from .tracking_batch import _extract_tiles, _grid_geometry

__all__ = ["run_fused_speckle_stack", "upload"]


def upload(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host frames -> device tensor in their compute dtype.

    The bytes travel in the frames' own dtype. Unsigned 16/32-bit data
    travels as the signed type of the same width and is masked back on the
    device, where torch's unsigned types support few operations."""
    a = np.ascontiguousarray(frames)
    if a.dtype.kind == "u" and a.itemsize in (2, 4):
        signed, wide = {2: (np.int16, torch.int32), 4: (np.int32, torch.int64)}[a.itemsize]
        t = _to_device(torch.from_numpy(a.view(signed)), device)
        return to_compute(t.to(wide) & ((1 << (8 * a.itemsize)) - 1))
    return to_compute(_to_device(torch.from_numpy(a), device))


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _build_tpl0(frame0, starts, s: int, H: int, W: int):
    """Frame-0 template bank: spectra (9, H, W//2+1) and energies (9,)."""
    return ncc_ops.prep_template(_extract_tiles(frame0, starts, s), H, W)


def _track_chunk(frames, prevs, tpl0, starts, s: int, subpixel: bool, eps: float):
    """(dy_abs, dx_abs, dy_inc, dx_inc), each (n, 9), of n frames against
    the frame-0 bank and against each frame's predecessor."""
    H, W = frames.shape[-2:]
    prep = ncc_ops.zncc_prepare_image(frames, s, s, eps=eps)
    inc_bank = ncc_ops.prep_template(_extract_tiles(prevs, starts, s), H, W)

    def bank_peaks(bank):
        maps, iy, ix, vb = ncc_ops.ncc_bank_masked_peaks(prep, bank, eps=eps)
        if subpixel:
            di, dj = pc_ops.subpixel_taylor(maps, iy, ix, convention="newton", bounds=vb)
        else:
            di = dj = torch.zeros((), dtype=maps.dtype, device=maps.device)
        return iy.to(maps.dtype) + di, ix.to(maps.dtype) + dj

    py_a, px_a = bank_peaks(tpl0)
    py_i, px_i = bank_peaks(inc_bank)
    half = (s - 1) / 2.0
    cy = torch.as_tensor(starts[:, 0] + half, dtype=frames.dtype, device=frames.device)
    cx = torch.as_tensor(starts[:, 1] + half, dtype=frames.dtype, device=frames.device)
    return py_a + half - cy, px_a + half - cx, py_i + half - cy, px_i + half - cx


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}\0")
        else:
            yield f"{prefix}{k}", v


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("\0")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def run_fused_speckle_stack(
    stack: np.ndarray,
    grid_slices,
    *,
    groups: set,
    mode: str,
    sat: float | None,
    eps: float,
    flip: bool,
    subpixel: bool = True,
    track_eps: float = 1e-9,
    frame_chunk: int = 4,
    device=None,
):
    """Metrics and template tracking over a host (T, H, W) stack.

    Returns (metrics tree with a leading T axis, as numpy;
    (dx_abs, dy_abs, dx_inc, dy_inc), each (T, 3, 3) float32)."""
    device = resolve_device(device)
    T, H, W = (int(v) for v in stack.shape)
    starts, _, s = _grid_geometry(grid_slices)
    B = max(1, min(int(frame_chunk), T))
    hint = int_value_hint(stack.dtype)
    metric_fn = speckle_device_fn(frozenset(groups), mode, sat, eps)

    frame0 = upload(stack[0], device)
    tpl0 = _build_tpl0(frame0, starts, s, H, W)
    prev = frame0  # the predecessor of frame 0 is frame 0 itself

    track = np.empty((4, T, 9), np.float32)  # dy_a, dx_a, dy_i, dx_i
    pieces: list[dict] = []
    pending = None

    def collect(host, ready, spec, c0, c1):
        if ready is not None:
            ready.synchronize()
        flat = host.numpy()
        out, off = {}, 0
        for path, shape in spec:
            n = int(np.prod(shape[1:], dtype=np.int64))
            out[path] = flat[:, off : off + n].reshape(shape)
            off += n
        track[:, c0:c1] = np.stack([out.pop(f"track\0{i}") for i in range(4)])
        pieces.append(out)

    for c0 in range(0, T, B):
        c1 = min(c0 + B, T)
        frames = upload(stack[c0:c1], device)
        shown = apply_display_origin(frames, display_origin="lower") if flip else frames
        result = metric_fn(shown, int_range=hint)
        prevs = torch.cat([prev[None], frames[:-1]])
        result["track"] = dict(
            enumerate(_track_chunk(frames, prevs, tpl0, starts, s, subpixel, track_eps))
        )
        prev = frames[-1]

        # one vector per chunk leaves the device
        spec, cols = [], []
        for path, v in _leaves(result):
            spec.append((path, tuple(v.shape)))
            cols.append(v.reshape(c1 - c0, -1).to(frames.dtype))
        flat = torch.cat(cols, dim=1)
        if device.type == "cuda":
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        else:
            host, ready = flat, None
        if pending is not None:
            collect(*pending)
        pending = (host, ready, spec, c0, c1)
    collect(*pending)

    metrics = {path: np.concatenate([p[path] for p in pieces]) for path in pieces[0]}
    dy_a, dx_a, dy_i, dx_i = (a.reshape(T, 3, 3) for a in track)
    return _unflatten(metrics), (dx_a, dy_a, dx_i, dy_i)

