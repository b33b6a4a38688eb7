# SPDX-License-Identifier: CECILL-2.1
"""Chunked stack pipeline: per-frame metrics and abs/inc tracking
(counterpart of ``barc4dip_tpu/metrics/stack_fused.py``).

- a host stack's chunks are uploaded once each, in their own dtype, from
  pinned memory without blocking, and cast on the device; a tensor stack
  (the JAX package's device-resident path) is sliced on its own device and
  cast there, with no upload and the same per-chunk math, so it gives
  exactly the host stack's results;
- the metric step and the tracker read that one copy; the tracker sees the
  frames as they are, the metric step after the display-origin flip;
- the chunk's last frame stays on the device as the next chunk's
  incremental-tracking reference;
- each chunk's results leave the device as one vector, copied without
  blocking; the host unpacks chunk k while chunk k+1 runs;
- with a checkpoint, chunks already on disk are loaded instead of run, and
  the tracking reference after such a chunk is re-derived from the stack.

Three trackers: ``template`` over the full frame (the NCC bank through
kernel K1b), ``template`` in per-tile windows (``search`` px around each
tile's home; the valid NCC maps through ``cuda_fftp.corr_from_rfft``), and
``phase`` (whitened cross-power spectra on ``torch.fft``).

Each run leaves its per-stage split in :data:`LAST_RUN_PERF`.
:func:`device_compute_probe` runs the same per-chunk step over a stack
made resident first, so it times the step without the uploads.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import resolve_device, to_compute, upload
from ..ops import ncc as ncc_ops
from ..ops import phasecorr as pc_ops
from ..parallel.mesh import shard_bounds
from .common import (
    _leaves,
    apply_display_origin,
    chunk_from_shards,
    chunk_layout_signature,
    chunk_width,
    frame_loader,
    pack_leaves,
    pull_to_host,
    shard_loaders,
    unflatten_leaves,
    unpack_leaves,
)
from .speckles_device import int_value_hint, speckle_device_fn
from .tracking_batch import _extract_tiles, _grid_geometry

__all__ = [
    "LAST_RUN_PERF",
    "device_compute_probe",
    "frame_loader",
    "pack_leaves",
    "run_fused_speckle_stack",
    "unflatten_leaves",
    "unpack_leaves",
]

#: Per-stage split of the last :func:`run_fused_speckle_stack` call, with
#: the JAX package's keys: ``upload_s`` (host seconds in the shards' loads
#: of a host stack: pinning and the non-blocking copy), ``upload_io_s`` (the
#: card's time for those copies and their casts, by CUDA events around each
#: load, the largest sum over the devices; ``upload_s`` on the CPU),
#: ``dispatch_s`` (host seconds enqueuing the metric and tracking steps and
#: the result pull), ``pull_wait_s`` (host seconds waiting for and unpacking
#: the pulled results: the device time shows here), ``upload_bytes`` (host
#: frames uploaded, in their own dtype), ``pull_bytes``, ``chunks`` (chunks
#: run, not loaded from a checkpoint), and ``resident: True`` for a tensor
#: stack.
LAST_RUN_PERF: dict = {}


def _search_windows(H: int, W: int, s: int, starts: np.ndarray, search: int):
    """Per-tile search windows of side w = s + 2 * search around each
    tile's home, clamped to stay in the frame: (wy0 (9,), wx0 (9,), w), or
    None when the window would cover the frame (the full search runs)."""
    w = s + 2 * int(search)
    if w >= min(H, W):
        return None
    wy0 = np.clip(starts[:, 0] - int(search), 0, H - w).astype(np.int64)
    wx0 = np.clip(starts[:, 1] - int(search), 0, W - w).astype(np.int64)
    return wy0, wx0, int(w)


def _refine(maps, i, j, subpixel: bool, bounds=None):
    """Integer peaks plus the Newton subpixel step (zero without it)."""
    if subpixel:
        di, dj = pc_ops.subpixel_taylor(maps, i, j, convention="newton", bounds=bounds)
    else:
        di = dj = torch.zeros((), dtype=maps.dtype, device=maps.device)
    return i.to(maps.dtype) + di, j.to(maps.dtype) + dj


def _phase_bank(tiles, starts, s: int, H: int, W: int, eps: float):
    """Spectra (..., 9, H, W//2+1) of z-scored tiles embedded at their
    places in an (H, W) frame of zeros. The tiles round to float32 first,
    as in the JAX package."""
    z = pc_ops.zscore2d(tiles, eps=eps).to(torch.float32).to(tiles.dtype)
    emb = torch.zeros((*tiles.shape[:-2], H, W), dtype=tiles.dtype, device=tiles.device)
    for k, (y0, x0) in enumerate(starts):
        emb[..., k, y0 : y0 + s, x0 : x0 + s] = z[..., k, :, :]
    return torch.fft.rfft2(emb)


def _build_tpl0(frame0, starts, s: int, H: int, W: int, method: str = "template",
                eps: float = 1e-9, windows=None):
    """Frame-0 template bank: NCC spectra and energies (template; windowed
    search: at the window's side) or whitening spectra (phase)."""
    tiles = _extract_tiles(frame0, starts, s)
    if method == "phase":
        return _phase_bank(tiles, starts, s, H, W, eps)
    n_h, n_w = (H, W) if windows is None else (windows[2], windows[2])
    return ncc_ops.prep_template(tiles, n_h, n_w)


def _track_chunk(frames, prevs, tpl0, starts, s: int, subpixel: bool, eps: float):
    """Full-frame template tracking: (dy_abs, dx_abs, dy_inc, dx_inc), each
    (n, 9), of n frames against the frame-0 bank and against each frame's
    predecessor."""
    H, W = frames.shape[-2:]
    prep = ncc_ops.zncc_prepare_image(frames, s, s, eps=eps)
    inc_bank = ncc_ops.prep_template(_extract_tiles(prevs, starts, s), H, W)

    def bank_peaks(bank):
        maps, iy, ix, vb = ncc_ops.ncc_bank_masked_peaks(prep, bank, eps=eps)
        return _refine(maps, iy, ix, subpixel, bounds=vb)

    py_a, px_a = bank_peaks(tpl0)
    py_i, px_i = bank_peaks(inc_bank)
    half = (s - 1) / 2.0
    cy = torch.as_tensor(starts[:, 0] + half, dtype=frames.dtype, device=frames.device)
    cx = torch.as_tensor(starts[:, 1] + half, dtype=frames.dtype, device=frames.device)
    return py_a + half - cy, px_a + half - cx, py_i + half - cy, px_i + half - cx


def _track_windowed(frames, prevs, tpl0, starts, s: int, windows, subpixel: bool, eps: float):
    """Template tracking inside each tile's search window: every window is
    an image of its own (z-scored on its own) against a bank of one
    template, so the NCC values are the full search's wherever the peak
    stays inside the window."""
    wy0, wx0, w = windows
    n = frames.shape[0]
    wins = torch.stack([frames[:, y0 : y0 + w, x0 : x0 + w] for y0, x0 in zip(wy0, wx0)], dim=1)
    prep = ncc_ops.zncc_prepare_image(wins.reshape(n * 9, w, w), s, s, eps=eps)
    abs_bank = {
        "Ft": tpl0["Ft"].expand(n, *tpl0["Ft"].shape).reshape(n * 9, 1, *tpl0["Ft"].shape[-2:]),
        "energy": tpl0["energy"].expand(n, 9).reshape(n * 9, 1),
    }
    inc_bank = ncc_ops.prep_template(_extract_tiles(prevs, starts, s).reshape(n * 9, 1, s, s), w, w)

    def peaks(bank):
        maps = ncc_ops.ncc_valid_from_preps(prep, bank, eps=eps)[:, 0]
        i, j = pc_ops.argmax2d(maps)
        py, px = _refine(maps, i, j, subpixel)
        return py.reshape(n, 9), px.reshape(n, 9)

    py_a, px_a = peaks(abs_bank)
    py_i, px_i = peaks(inc_bank)
    half = (s - 1) / 2.0
    oy = torch.as_tensor(wy0 - starts[:, 0], dtype=frames.dtype, device=frames.device)
    ox = torch.as_tensor(wx0 - starts[:, 1], dtype=frames.dtype, device=frames.device)
    # window offset + peak + half - (tile start + half)
    return py_a + oy, px_a + ox, py_i + oy, px_i + ox


def _track_phase(frames, prevs, tpl0, starts, s: int, subpixel: bool, eps: float):
    """Phase-correlation tracking: the shift of each frame-0 (abs) and
    predecessor (inc) tile, embedded in a frame of zeros, against the
    frame."""
    H, W = frames.shape[-2:]
    Fi = torch.fft.rfft2(pc_ops.zscore2d(frames, eps=eps))[:, None]
    inc_bank = _phase_bank(_extract_tiles(prevs, starts, s), starts, s, H, W, eps)

    def shifts(bank):
        mag = pc_ops.phase_corr_from_spectra(Fi, bank, s=(H, W), eps=eps)
        i, j = pc_ops.argmax2d(mag)
        py, px = _refine(mag, i, j, subpixel)
        return py - H // 2, px - W // 2

    dy_a, dx_a = shifts(tpl0)
    dy_i, dx_i = shifts(inc_bank)
    return dy_a, dx_a, dy_i, dx_i


_TRACK_KEYS = ("dy_a", "dx_a", "dy_i", "dx_i")


def _stack_step(H: int, W: int, grid_slices, *, groups: set, mode: str, sat, eps: float,
                flip: bool, method: str, subpixel: bool, track_eps: float,
                search_radius: int | None, int_range):
    """The per-chunk step of the stack loop and of the probe: ``(bank,
    step)``.

    ``bank(frame0)`` builds the frame-0 template bank on frame0's device.
    ``step(frames, prev, tpl0, metrics=True, tracking=True)`` gives a
    chunk's tree of (n, ...) results: the metric tree of the frames after
    the display-origin flip, and under ``"track"`` their four trajectories
    against ``tpl0`` and against each frame's predecessor (``prev`` for the
    first frame)."""
    starts, _, s = _grid_geometry(grid_slices)
    metric_fn = speckle_device_fn(frozenset(groups), mode, sat, eps)
    windows = None
    if method == "template" and search_radius is not None:
        windows = _search_windows(H, W, s, starts, search_radius)
    if method == "phase":
        def track(frames, prevs, tpl0):
            return _track_phase(frames, prevs, tpl0, starts, s, subpixel, track_eps)
    elif windows is not None:
        def track(frames, prevs, tpl0):
            return _track_windowed(frames, prevs, tpl0, starts, s, windows, subpixel, track_eps)
    else:
        def track(frames, prevs, tpl0):
            return _track_chunk(frames, prevs, tpl0, starts, s, subpixel, track_eps)

    def bank(frame0):
        return _build_tpl0(frame0, starts, s, H, W, method, track_eps, windows)

    def step(frames, prev, tpl0, *, metrics: bool = True, tracking: bool = True) -> dict:
        result = {}
        if metrics:
            shown = apply_display_origin(frames, display_origin="lower") if flip else frames
            result = metric_fn(shown, int_range=int_range)
        if tracking:
            prevs = torch.cat([prev.to(frames.device)[None], frames[:-1]])
            result["track"] = dict(enumerate(track(frames, prevs, tpl0)))
        return result

    return bank, step


def run_fused_speckle_stack(
    stack,
    grid_slices,
    *,
    groups: set,
    mode: str,
    sat: float | None,
    eps: float,
    flip: bool,
    method: str = "template",
    subpixel: bool = True,
    track_eps: float = 1e-9,
    frame_chunk: int = 4,
    search_radius: int | None = None,
    mesh=None,
    checkpoint=None,
    device=None,
):
    """Metrics and tracking over a (T, H, W) host array or tensor.

    ``method`` is "template" or "phase"; ``search_radius`` (template only)
    restricts each correlation to a window around the tile's home.
    ``checkpoint`` is a :class:`..utils.checkpoint.ChunkStore`: chunks it
    holds are loaded, the others run and are saved.

    With ``mesh``, each chunk (a multiple of ``mesh.size`` frames) is cut
    into one contiguous shard a mesh entry and each shard runs on its
    device: the frame-0 template bank is built once a device, and the
    incremental reference of a shard's first frame is the previous shard's
    last frame (for the first shard, the previous chunk's), moved to the
    shard's device.

    Returns (metrics tree with a leading T axis, as numpy;
    (dx_abs, dy_abs, dx_inc, dy_inc), each (T, 3, 3) float32)."""
    placements = shard_loaders(stack, device, mesh)
    T, H, W = (int(v) for v in stack.shape)
    width = -(-chunk_width(T, frame_chunk, mesh) // len(placements))
    bank, step = _stack_step(
        H, W, grid_slices, groups=groups, mode=mode, sat=sat, eps=eps, flip=flip, method=method,
        subpixel=subpixel, track_eps=track_eps, search_radius=search_radius,
        int_range=int_value_hint(stack.dtype),
    )
    host_stack = not isinstance(stack, torch.Tensor)
    frame_bytes = H * W * stack.dtype.itemsize if host_stack else 0
    perf = {"upload_s": 0.0, "dispatch_s": 0.0, "pull_wait_s": 0.0, "upload_io_s": 0.0,
            "upload_bytes": 0, "pull_bytes": 0, "chunks": 0}
    if not host_stack:
        perf["resident"] = True
    copies: dict = {}  # device -> [(start, end)]: CUDA events around each chunk upload

    track_out = np.empty((4, T, 9), np.float32)  # dy_a, dx_a, dy_i, dx_i
    pieces: dict[int, dict] = {}
    pending = None
    frame0 = None
    tpl0: dict = {}  # the frame-0 bank, one a device
    prev = None  # the incremental reference of the chunk's first frame

    def store(c0, c1, metrics, tr):
        pieces[c0] = metrics
        track_out[:, c0:c1] = tr

    def collect(c0, c1, shards):
        t0 = time.perf_counter()
        out = chunk_from_shards(shards)
        perf["pull_wait_s"] += time.perf_counter() - t0
        tr = np.stack([out.pop(f"track\0{i}") for i in range(4)])
        if checkpoint is not None:
            checkpoint.save(c0, {"metrics": unflatten_leaves(out), "track": dict(zip(_TRACK_KEYS, tr))})
        store(c0, c1, out, tr)

    chunk_starts = chunk_layout_signature(T, frame_chunk, mesh)
    for c0, c1 in zip(chunk_starts, (*chunk_starts[1:], T)):
        if checkpoint is not None and checkpoint.has(c0):
            piece = checkpoint.load(c0)
            store(c0, c1, dict(_leaves(piece["metrics"])),
                  np.stack([piece["track"][k] for k in _TRACK_KEYS]))
            prev = None
            continue
        if frame0 is None:  # read once, before the predecessor (a file view caches one frame)
            frame0 = placements[0][1](0, 1)[0]
        if prev is None:  # the predecessor of frame 0 is frame 0 itself
            prev = placements[0][1](max(c0 - 1, 0), max(c0, 1))[0]
        shards = []
        for (a, b), (dev, load) in zip(shard_bounds(c0, c1, len(placements), width), placements):
            if a == b:  # the tail chunk leaves the last shards empty
                continue
            if dev not in tpl0:
                tpl0[dev] = bank(frame0.to(dev))
            timed_copy = host_stack and dev.type == "cuda"
            if timed_copy:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record(torch.cuda.current_stream(dev))
            t0 = time.perf_counter()
            frames = load(a, b)
            t1 = time.perf_counter()
            if timed_copy:
                ev[1].record(torch.cuda.current_stream(dev))
                copies.setdefault(dev, []).append(ev)
            if host_stack:
                perf["upload_s"] += t1 - t0
                perf["upload_bytes"] += (b - a) * frame_bytes
            result = step(frames, prev, tpl0[dev])
            prev = frames[-1]
            # one vector per shard leaves the device
            flat, spec = pack_leaves(result, b - a, frames.dtype)
            shards.append((*pull_to_host(flat, dev), spec))
            perf["dispatch_s"] += time.perf_counter() - t1
            perf["pull_bytes"] += flat.numel() * flat.element_size()
        perf["chunks"] += 1
        if pending is not None:
            collect(*pending)
        pending = (c0, c1, shards)
    if pending is not None:
        collect(*pending)
    if copies:  # every copy precedes a result pull that collect waited for
        perf["upload_io_s"] = max(sum(a.elapsed_time(b) for a, b in evs) for evs in copies.values()) / 1e3
    else:
        perf["upload_io_s"] = perf["upload_s"]
    LAST_RUN_PERF.clear()
    LAST_RUN_PERF.update(perf)

    ordered = [pieces[c0] for c0 in sorted(pieces)]
    metrics = {path: np.concatenate([p[path] for p in ordered]) for path in ordered[0]}
    dy_a, dx_a, dy_i, dx_i = (a.reshape(T, 3, 3) for a in track_out)
    return unflatten_leaves(metrics), (dx_a, dy_a, dx_i, dy_i)


def _probed_frames(T: int, H: int, W: int, frame_chunk: int, itemsize: int) -> int:
    """Frames the probe holds resident: at most 2 GiB of compute-dtype
    frames (never less than one chunk), rounded down to a multiple of the
    chunk B = min(frame_chunk, T)."""
    B = max(1, min(int(frame_chunk), T))
    cap = max(B, (2 << 30) // (H * W * itemsize) // B * B)
    return min(T, cap) // B * B


def device_compute_probe(
    stack,
    grid_slices,
    *,
    groups: set,
    mode: str,
    sat: float | None,
    eps: float,
    flip: bool,
    method: str = "template",
    subpixel: bool = True,
    track_eps: float = 1e-9,
    frame_chunk: int = 4,
    search_radius: int | None = None,
    device=None,
) -> dict:
    """Throughput of the stack loop's per-chunk step with no uploads.

    The probed frames are made resident first, in their compute dtype: a
    host stack is uploaded to ``device`` (``None`` means the card), a tensor
    stack stays on its own device. At most 2 GiB of them are probed, and
    their count is rounded down to a multiple of B = min(``frame_chunk``,
    T), as in the JAX package. One warm pass builds the kernels and the FFT
    plans; then three passes over the chunks are timed on the host clock:
    metrics and tracking, metrics alone, tracking alone. Each pass keeps
    every chunk's packed results on the device and ends with one pull of
    them and a synchronize.

    On the card every chunk step still pays its launches from Python, so
    this is not a device-only time where the loop is launch-bound.

    Returns {"elapsed_s", "metrics_only_s", "tracking_only_s", "frames",
    "mpix_s"}; raises ``RuntimeError`` if the tracking is not finite."""
    T, H, W = (int(v) for v in stack.shape)
    is_tensor = isinstance(stack, torch.Tensor)
    f64 = stack.dtype == (torch.float64 if is_tensor else np.float64)
    T = _probed_frames(T, H, W, frame_chunk, 8 if f64 else 4)
    B = max(1, min(int(frame_chunk), T))
    if is_tensor:
        frames = to_compute(stack[:T])
    else:
        frames = upload(np.asarray(stack[:T]), resolve_device(device))
    bank, step = _stack_step(
        H, W, grid_slices, groups=groups, mode=mode, sat=sat, eps=eps, flip=flip, method=method,
        subpixel=subpixel, track_eps=track_eps, search_radius=search_radius,
        int_range=int_value_hint(stack.dtype),
    )

    def run_all(*, metrics: bool = True, tracking: bool = True):
        tpl0 = bank(frames[0]) if tracking else None
        prev = frames[0]  # the predecessor of frame 0 is frame 0 itself
        flats = []
        for c0 in chunk_layout_signature(T, B):
            chunk = frames[c0 : c0 + B]
            flat, spec = pack_leaves(step(chunk, prev, tpl0, metrics=metrics, tracking=tracking),
                                     B, frames.dtype)
            flats.append(flat)
            prev = chunk[-1]
        host = torch.cat(flats).cpu()
        if frames.device.type == "cuda":
            torch.cuda.synchronize(frames.device)
        return unpack_leaves(host.numpy(), [(p, (T, *shape[1:])) for p, shape in spec])

    def timed(**kw):
        t0 = time.perf_counter()
        out = run_all(**kw)
        return time.perf_counter() - t0, out

    run_all()  # warm: builds the kernels and the FFT plans
    elapsed, out = timed()
    metrics_s, _ = timed(tracking=False)
    tracking_s, _ = timed(metrics=False)
    if not all(np.all(np.isfinite(out[f"track\0{i}"])) for i in range(4)):
        raise RuntimeError("device_compute_probe: non-finite tracking output")
    return {
        "elapsed_s": elapsed,
        "metrics_only_s": metrics_s,
        "tracking_only_s": tracking_s,
        "frames": T,
        "mpix_s": (T * H * W / 1e6) / elapsed if elapsed > 0 else float("inf"),
    }
