# SPDX-License-Identifier: CECILL-2.1
"""The speckle stack's step: per-frame metrics and abs/inc tracking
(counterpart of ``barc4dip_tpu/metrics/stack_fused.py``), run a shard at a
time by :func:`.common.run_chunks`, the chunk loop of every stack path
(uploads, shards, pulls one chunk behind, checkpoints, stage timings).

- the metric step and the tracker read the shard's one copy of its frames
  (a tensor stack's slice gives exactly the host stack's results); the
  tracker sees them as they are, the metric step after the display-origin
  flip;
- on a card the metric step replays as CUDA graphs from its second chunk of
  a shape in the process (``speckles_device.metric_step``), and the tracker
  runs eagerly;
- the frame-0 template bank is built once a device; a shard's last frame
  stays on the device as the next shard's incremental-tracking reference,
  read from the stack again after a chunk loaded from a checkpoint.

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

from ..config import device_constant, resolve_device, to_compute, upload
from ..ops import ncc as ncc_ops
from ..ops import phasecorr as pc_ops
from ..utils.profiling import annotate
from . import common
from .common import chunk_layout_signature, frame_loader, pack_leaves, unpack_leaves
from .speckles_device import GRAPH_COUNTS, int_value_hint, metric_step, speckle_device_fn
from .tracking_batch import _extract_tiles, _grid_geometry

__all__ = ["LAST_RUN_PERF", "device_compute_probe", "run_fused_speckle_stack"]

#: Per-stage split of the last :func:`run_fused_speckle_stack` call: the
#: chunk loop's record (:func:`.common.run_chunks`), with the JAX package's
#: keys ``upload_s``, ``upload_io_s``, ``dispatch_s`` (here the metric and
#: tracking steps' enqueue and the result pull), ``pull_wait_s``,
#: ``upload_bytes``, ``pull_bytes``, ``chunks`` and ``resident: True`` for a
#: tensor stack; and how the metric step ran (``speckles_device.GRAPH_COUNTS``
#: over the run): ``graph_replays`` (shards replayed as CUDA graphs),
#: ``graph_captures`` (keys captured, in a shard that is also replayed) and
#: ``eager_steps`` (shards run eagerly: every shard off a card, and on a
#: card a key's first shard in the process). ``speckle_stack_stats`` adds
#: ``frame0_s`` (host-clock seconds of ``tracking_grid_from_frame0``) and
#: ``k1_cluster_launches`` (the call's K1 pass-1 launches on the cluster
#: route, ``cuda_fftp.LAUNCHES["cols_cluster"]``).
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
    cy = device_constant(starts[:, 0] + half, frames.dtype, frames.device)
    cx = device_constant(starts[:, 1] + half, frames.dtype, frames.device)
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
    oy = device_constant(wy0 - starts[:, 0], frames.dtype, frames.device)
    ox = device_constant(wx0 - starts[:, 1], frames.dtype, frames.device)
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
    chunk's (n, L) result vector and its spec (:func:`pack_leaves`): the
    metric tree of the frames after the display-origin flip
    (:func:`..speckles_device.metric_step`, CUDA graphs on a card), then
    under ``"track"`` their four trajectories against ``tpl0`` and against
    each frame's predecessor (``prev`` for the first frame), tracked
    eagerly."""
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

    def step(frames, prev, tpl0, *, metrics: bool = True, tracking: bool = True):
        parts = []
        if metrics:
            with annotate("step.metrics"):
                parts.append(metric_step(metric_fn, frames, flip=flip, int_range=int_range))
        if tracking:
            with annotate("track"):
                prevs = torch.cat([prev.to(frames.device)[None], frames[:-1]])
                tracked = {"track": dict(enumerate(track(frames, prevs, tpl0)))}
                parts.append(pack_leaves(tracked, frames.shape[0], frames.dtype))
        if len(parts) == 1:
            return parts[0]
        return torch.cat([flat for flat, _ in parts], dim=1), [p for _, spec in parts for p in spec]

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
    T, H, W = (int(v) for v in stack.shape)
    bank, step = _stack_step(
        H, W, grid_slices, groups=groups, mode=mode, sat=sat, eps=eps, flip=flip, method=method,
        subpixel=subpixel, track_eps=track_eps, search_radius=search_radius,
        int_range=int_value_hint(stack.dtype),
    )
    _, load = frame_loader(stack, device, mesh)
    # a chunk checkpoint's keys: the metric leaves under "metrics", the tracks by name
    paths = {f"track\0{i}": f"track\0{k}" for i, k in enumerate(_TRACK_KEYS)}
    frame0 = None
    tpl0: dict = {}  # the frame-0 bank, one a device

    def open_shard(dev, first, prev):
        nonlocal frame0
        if frame0 is None:  # read once, before the predecessor (a file view caches one frame)
            frame0 = load(0, 1)[0]
        if prev is None:  # the predecessor of frame 0 is frame 0 itself
            prev = load(max(first - 1, 0), max(first, 1))[0]
        if dev not in tpl0:
            tpl0[dev] = bank(frame0.to(dev))

        def enqueue(shard):
            frames = shard.pop()
            flat, spec = step(frames, prev, tpl0[dev])
            spec = [(paths.get(p, f"metrics\0{p}"), shape) for p, shape in spec]
            return flat, spec, frames[-1].clone()  # not a view that keeps the whole chunk

        return enqueue

    ran = dict(GRAPH_COUNTS)
    tree, record = common.run_chunks(
        stack, open_shard, frame_chunk=frame_chunk, mesh=mesh, checkpoint=checkpoint, device=device
    )
    LAST_RUN_PERF.clear()
    LAST_RUN_PERF.update(record, **{k: GRAPH_COUNTS[k] - ran[k] for k in GRAPH_COUNTS})
    dy_a, dx_a, dy_i, dx_i = (tree["track"][k].astype(np.float32).reshape(T, 3, 3) for k in _TRACK_KEYS)
    return tree["metrics"], (dx_a, dy_a, dx_i, dy_i)


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
            flat, spec = step(chunk, prev, tpl0, metrics=metrics, tracking=tracking)
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
