#!/usr/bin/env python3
# SPDX-License-Identifier: CECILL-2.1
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, one line each with its wall time:

1. device: needs CUDA (no CPU fallback); prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles kernels K1 (``csrc/fftp_corr.cu``), K2
   (``csrc/median3x3.cu``) and K3 (``csrc/densetrack_sums.cu``) of
   ``barc4dip_tpu_torch`` from this checkout into ``build/kernels/``, one
   ``nvcc`` per source, all started together; prints their ptxas lines;
3. kernels: each K1 wrapper against its plain PyTorch version on the card,
   at the main path's shapes (2048^2 frames, 29-px templates), timed with
   CUDA events (median of 10 single calls) beside the library call (cuFFT's
   irfft2 of the products formed beforehand), then all three split by
   kernel: the device time of each pass from 10 calls under torch.profiler,
   and the time per call of 10 calls queued back to back (host enqueue
   overlapped);
4. slice: ``speckle_stack_stats`` at the JAX package's defaults (lazy
   grain maps on) on a 16 x 2048^2 uint16 spiral stack (Config D), run
   twice; the second run is counted and timed. Checks the K1 launch counts
   (one K1a a chunk for the full-frame grain, two K1b), the tracking error
   against the known motion (<= 0.05 px), then reads the maps of frames 0
   and 1 by index (exactly two more K1a);
   values: the frame 0-1 ``full``/``tiles`` leaves, those two maps
   included, against a float64 run of the same frames on the card (rtol
   1e-4) and, where the frames' key is in ``.bench_metric_golden.json``,
   against that golden (maps in its strided-sample form);
5. speckle-stats: ``speckle_stats`` on frame 0 (all groups, tiles), run
   twice, the second counted: K1a launches; leaves against a float64 run on
   the card (rtol 1e-4); reading the lazy map launches K1a once more and
   matches the float64 map;
6. resident: the stack as a CUDA tensor, run twice, the second counted and
   timed (MP/s): K1b launches, every leaf against the host stack's counted
   run, exactly;
7. options, on frames 0-7: ``tracking_search_radius=16`` (the search area,
   trajectories within 1e-3 px of the full search, the 0.05 px gate,
   ``PLAIN_BY_SHAPE`` growing only by the window shape); phase tracking
   (``roi_grain_factor=12``) on a 512^2 float32 spiral stack within 0.5 px
   (Config D's frames are logged, not gated: phase correlation does not
   lock on to them, in either package); ``checkpoint_dir`` run twice: the
   second run loads every chunk, launches no K1 and equals the first;
8. full-step: ``models.full_step_fn`` at B = 4 on 2048^2 (flat-field of
   frames 1-4 against their predecessors) on the card: K1a launches;
   metrics at rtol 1e-4 and shifts within 0.05 px of its float64 run,
   shifts within 0.05 px of the known motion;
9. data-xst: a 2048^2 reference speckle (grain 3 px) and 6 frames warped by
   a parabolic wavefront (R = 100 m, 1 um pixels, 0.5 m) plus a spiral
   shift, as raw uint16 with flats, darks and 0.1% dead pixels;
10. kernels-2: K2 against its plain version on the flat-field's own input
    at (2048, 2048) and (6, 2048, 2048), exactly equal; K3 against its
    plain version at Config F (33-px tiles, step 16, radius 10: 15,625
    nodes) and on 4 frames, within 1e-5 of each output's max, and its s1
    and s2 (sliding box sums) against float64 sums of the same windows at
    the same tolerance; timed as K1 is (K2's single-call event time is
    mostly the wrapper's host cost; its device time and queued time per call
    stand beside it), K3 beside the library call for its numerator (one
    grouped cuDNN ``conv2d``, TF32 off);
11. xst: ``flat_field_correction(bad_pixel_removal=True)`` then
    ``WavefrontScanPipeline`` on the card, run twice; the second run is
    counted and timed, and one ``track_displacement_field`` at Config F is
    timed. Checks the K2/K3 launch counts (no uncovered call), the
    flat-field against a numpy float32 version of the formula (rtol 1e-6,
    exact at repaired pixels), the field against ``method="fft"`` on the
    card, the per-frame tracking medians against the known motion
    (<= 0.05 px) and the wavefront against the parabola (relative error
    < 0.15, curvature radius within 10%);
12. with ``--profile``: the metric step and the tracker of one Config D
    chunk timed apart, then the Config D slice and one XST pass under
    torch.profiler (device busy time, device time by op and kernel).

Every time printed names the card and its power limit (the nvidia-smi
line, printed first and again before the result); the kernel phases also
print the card's SM clock, power draw and temperature as they start and
end. Prints the kernel table
as one JSON line: a row per kernel and shape with ``max_abs_err``,
``ms`` (event median), ``plain_ms``, ``device_ms`` (torch.profiler),
``bound_ms`` and ``bound_by`` (the larger of the bytes each input and
output must move at 3.35 TB/s and the float32 operations these inputs need
at 67 TFLOP/s, the published H100 SXM peaks), ``library_ms`` (null for K2,
which has no one-call equivalent) and ``launches`` (the counted run of its
path), after a line of K1 launches by path. Then, as its last line,
``{"ok": true, "device": {...}}`` for the one card it used. Any failed
phase exits non-zero. Imports nothing of JAX.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
T_FRAMES, SIDE, GRAIN_PX, MEAN_COUNTS, SEED = 16, 2048, 8.0, 8000.0, 1234
FRAME_CHUNK = 4
GOLDEN_K = 2
RTOL = 1e-4
TRACK_GATE_PX = 0.05
KERNEL_ATOL_REL = 2e-5
REPEATS = 10
# the XST slice (Config F geometry; the flat-field half of Config E)
XST_T, XST_SEED, XST_GRAIN_PX, XST_MEAN_COUNTS = 6, 4321, 3.0, 2000.0
XST_PIXEL, XST_DIST, XST_R = 1e-6, 0.5, 100.0
XST_TILE, XST_STEP, XST_RADIUS = 33, 16, 10
XST_BATCH = 4
K3_ATOL_REL = 1e-5
FIELD_ATOL_PX, FIELD_ATOL_PEAK, SAME_PEAK_MIN = 5e-4, 1e-4, 0.999
WAVEFRONT_REL, RADIUS_REL = 0.15, 0.10
# the speckle API's other paths: options on frames 0..OPT_T-1, phase
# tracking on its own stack, full_step_fn at B = FULL_STEP_B
OPT_T, OPT_RADIUS, WINDOW_ATOL_PX = 8, 16, 1e-3
PHASE_SIDE, PHASE_GRAIN_PX, PHASE_GATE_PX = 512, 6.0, 0.5
FULL_STEP_B = 4
# published H100 SXM peaks at 700 W: device memory, float32 outside the
# tensor cores
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        log(f"[phase {self.name}] {status} in {time.perf_counter() - self.t0:.2f} s")
        return False


def make_stack() -> np.ndarray:
    """Config D input, as ``bench.make_stack`` builds it."""
    from barc4dip_tpu_torch.utils import speckle_stack, spiral_motion

    dys, dxs = spiral_motion(T_FRAMES)
    return speckle_stack(
        T_FRAMES, (SIDE, SIDE), grain_px=GRAIN_PX, mean_counts=MEAN_COUNTS,
        dys=dys, dxs=dxs, seed=np.random.default_rng(SEED), dtype=np.uint16,
    )


# -- metric-leaf comparison: the semantics of bench.py's value gate ----------

def metric_leaves(out: dict, k: int | None = None) -> dict:
    """``full`` + ``tiles`` numeric leaves of the first ``k`` frames (all of
    a single image's leaves for ``k=None``). A lazy map stack is read by
    frame, frames 0..k-1 only: reading it whole would compute every frame's
    map."""
    from barc4dip_tpu_torch.utils import LazyMapStack

    leaves: dict = {}

    def walk(path: str, node) -> None:
        if isinstance(node, dict):
            for key, v in node.items():
                walk(f"{path}.{key}", v)
            return
        if isinstance(node, LazyMapStack):
            node = np.stack([node[t] for t in range(min(k, len(node)))])
        arr = np.asarray(node)
        if arr.dtype.kind not in "fiu":
            return
        if k is not None and arr.ndim >= 1 and arr.shape[0] >= k:
            arr = arr[:k]
        leaves[path] = np.asarray(arr, np.float64)

    for section in ("full", "tiles"):
        if section in out:
            walk(section, out[section])
    return leaves


def golden_form(leaves: dict) -> dict:
    """The leaves as ``bench.py`` stores them in its golden: a leaf of more
    than 8192 values (a map) becomes a strided sample of 4096 values and
    its finite mean, RMS and max |value|."""
    out = {}
    for path, arr in leaves.items():
        if arr.size <= 8192:
            out[path] = arr
            continue
        flat = arr.ravel()
        finite = flat[np.isfinite(flat)]
        out[path + ".sample4096"] = flat[np.linspace(0, flat.size - 1, 4096).astype(np.int64)]
        out[path + ".summary"] = np.array([
            finite.mean() if finite.size else np.nan,
            np.sqrt(np.mean(finite**2)) if finite.size else np.nan,
            np.max(np.abs(finite)) if finite.size else np.nan,
        ])
    return out


def leaf_rel_err(a, b, absolute: bool = False) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return 1e30
    fa, fb = np.isfinite(a), np.isfinite(b)
    if not np.array_equal(fa, fb):
        return 1e30
    if not fa.any():
        return 0.0
    a, b = a[fa], b[fb]
    if absolute:
        return float(np.max(np.abs(a - b)))
    denom = max(float(np.max(np.abs(a))), float(np.max(np.abs(b))))
    return 0.0 if denom == 0.0 else float(np.max(np.abs(a - b))) / denom


def compare_leaves(run: dict, ref: dict) -> tuple[str | None, float, int]:
    """(worst leaf, its error, leaves compared) over the leaves both hold.
    SNRdB compares absolutely (a log unit); a ``.std`` leaf is scaled by its
    ``.mean`` sibling, as bench.py's gate does."""
    worst, worst_err, n = None, -1.0, 0

    def scale(path):
        vals = [np.abs(v[np.isfinite(v)]) for v in (ref.get(path), run.get(path)) if v is not None]
        return max((float(v.max()) for v in vals if v.size), default=0.0)

    for path, rv in ref.items():
        if path not in run:
            continue
        n += 1
        err = leaf_rel_err(run[path], rv)
        if ".SNRdB" in path and err < 1e29:
            err = leaf_rel_err(run[path], rv, absolute=True) * (np.log(10.0) / 20.0)
        elif path.endswith(".std") and err < 1e29:
            parent, own = scale(path[: -len(".std")] + ".mean"), scale(path)
            if parent > own > 0.0:
                err *= own / parent
        if err > worst_err:
            worst, worst_err = path, err
    return worst, worst_err, n


def golden_key(stack: np.ndarray, k: int) -> str:
    h = hashlib.sha256(np.ascontiguousarray(stack[:k]).tobytes())
    return f"{stack.shape[1]}x{stack.shape[2]}-k{k}-{stack.dtype.name}-{h.hexdigest()[:16]}"


# -- phases -------------------------------------------------------------------

def time_ms(torch, fn) -> float:
    """Median of REPEATS CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def queued_ms(torch, fn) -> float:
    """Device time per call of REPEATS calls queued back to back (CUDA
    events around the run): the host's enqueue overlaps the device."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPEATS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPEATS


def kernel_ms(torch, fn) -> dict:
    """Device time per call (ms) of each kernel ``fn`` launches, summed by
    kernel name over REPEATS calls under torch.profiler."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation or not e.self_device_time_total:
            continue
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key).split("(")[0][:60]
        out[name] = out.get(name, 0.0) + e.self_device_time_total / REPEATS / 1e3
    return out


def log_device_split(torch, label: str, fn) -> float:
    """Log the queued time per call and the device time per call by kernel;
    return the device time per call (ms)."""
    split = kernel_ms(torch, fn)
    device = sum(split.values())
    parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
    log(f"  {label}: queued {queued_ms(torch, fn):.4f} ms/call; device {device:.4f} "
        f"ms/call = {parts}")
    return device


def card_state() -> str:
    """The card's SM clock, its maximum, power draw and temperature now: a
    clock below its maximum (power or heat) slows every kernel alike."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_F32_FLOP_S * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def nbytes(*tensors) -> int:
    """Bytes of the distinct tensors among ``tensors`` (an input passed
    twice, as an autocorrelation's spectrum is, is read once)."""
    seen = {}
    for t in tensors:
        seen[(t.data_ptr(), t.numel() * t.element_size())] = t.numel() * t.element_size()
    return sum(seen.values())


def fft_flops(n: int) -> float:
    """Operations of one real inverse FFT of n points: 2.5 n log2 n."""
    return 2.5 * n * np.log2(n)


def check_kernels(torch, dev, stack, starts, s, card: str) -> list[dict]:
    """K1a and K1b against their plain versions at the main path's shapes."""
    from barc4dip_tpu_torch.config import upload
    from barc4dip_tpu_torch.metrics.tracking_batch import _extract_tiles
    from barc4dip_tpu_torch.ops import cuda_fftp, ncc
    from barc4dip_tpu_torch.ops.phasecorr import argmax2d

    frames = upload(stack[:FRAME_CHUNK], dev)
    H, W = frames.shape[-2:]
    rows = []
    log(f"card state (SM clock, max SM clock, power, temperature): {card_state()}")

    # K1a: the autocorrelation of each frame (corrcore.autocorr2d_core)
    for nf in (1, FRAME_CHUNK):
        a = frames[:nf] - frames[:nf].mean(dim=(-2, -1), keepdim=True)
        Fa = torch.fft.rfft2(a)
        got = cuda_fftp.corr_from_rfft(Fa, Fa[:, None], s=(H, W))
        want = cuda_fftp.corr_from_rfft_plain(Fa, Fa[:, None], s=(H, W))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= KERNEL_ATOL_REL * scale:
            raise AssertionError(f"K1a B={nf}: max|kernel-plain| {err:.3e} > {KERNEL_ATOL_REL:g}*{scale:.3e}")
        ms = time_ms(torch, lambda: cuda_fftp.corr_from_rfft(Fa, Fa[:, None], s=(H, W)))
        plain_ms = time_ms(torch, lambda: cuda_fftp.corr_from_rfft_plain(Fa, Fa[:, None], s=(H, W)))
        # the library call: cuFFT's irfft2 of the product formed beforehand
        prod = Fa[:, None] * Fa[:, None].conj()
        library_ms = time_ms(torch, lambda: torch.fft.irfft2(prod, s=(H, W)))
        log(f"K1a corr_from_rfft planes={nf} {H}x{W}: max_abs_err {err:.3e} "
            f"(max|plain| {scale:.3e}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library irfft2 {library_ms:.3f} ms; {card}")
        device_ms = log_device_split(torch, "kernel", lambda: cuda_fftp.corr_from_rfft(Fa, Fa[:, None], s=(H, W)))
        log_device_split(torch, "plain", lambda: cuda_fftp.corr_from_rfft_plain(Fa, Fa[:, None], s=(H, W)))
        log_device_split(torch, "library", lambda: torch.fft.irfft2(prod, s=(H, W)))
        flops = nf * (6 * Fa.shape[-2] * Fa.shape[-1] + fft_flops(H * W))
        rows.append({"name": f"corr_from_rfft B={nf}", "route": "cuda",
                     "source": "barc4dip_tpu_torch/csrc/fftp_corr.cu",
                     "replaces": "barc4dip_tpu/ops/pallas_fftp.py:313",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
                     **bound(nbytes(Fa, Fa[:, None], got), flops), "library_ms": library_ms})

    # K1b: the tracker's NCC bank (ncc.ncc_bank_masked_peaks), frame-0
    # templates against later frames
    bank = ncc.prep_template(_extract_tiles(frames[0], starts, s), H, W)
    for nf in (1, FRAME_CHUNK):
        prep = ncc.zncc_prepare_image(frames[FRAME_CHUNK - nf:], s, s, eps=1e-9)
        var_full = torch.nn.functional.pad(prep["var_sum"], (0, s - 1, 0, s - 1))
        args = (prep["F"], bank["Ft"], var_full, bank["energy"])
        kw = dict(valid_hw=(H - s + 1, W - s + 1), eps=1e-9, s=(H, W))
        maps, iy, ix = cuda_fftp.ncc_masked_peaks(*args, **kw)
        pmaps, piy, pix = cuda_fftp.ncc_masked_peaks_plain(*args, **kw)
        torch.cuda.synchronize()
        fin = torch.isfinite(pmaps)
        if not torch.equal(torch.isfinite(maps), fin):
            raise AssertionError("K1b: finite masks differ")
        err = float((maps[fin] - pmaps[fin]).abs().max())
        scale = float(pmaps[fin].abs().max())
        if not err <= KERNEL_ATOL_REL * scale:
            raise AssertionError(f"K1b B={9 * nf}: max|kernel-plain| {err:.3e} > {KERNEL_ATOL_REL:g}*{scale:.3e}")
        ai, aj = argmax2d(maps)
        if not (torch.equal(iy, ai) and torch.equal(ix, aj)):
            raise AssertionError("K1b: kernel peaks differ from argmax2d of its own maps")
        if not (torch.equal(iy, piy) and torch.equal(ix, pix)):
            raise AssertionError("K1b: kernel peaks differ from the plain path's")
        ms = time_ms(torch, lambda: cuda_fftp.ncc_masked_peaks(*args, **kw))
        plain_ms = time_ms(torch, lambda: cuda_fftp.ncc_masked_peaks_plain(*args, **kw))
        # the library call: cuFFT's irfft2 of the 9 products a frame, formed
        # beforehand (the NCC epilogue and the peak are not in it)
        prod = args[0][:, None] * args[1][None].conj()
        library_ms = time_ms(torch, lambda: torch.fft.irfft2(prod, s=(H, W)))
        log(f"K1b ncc_masked_peaks planes={9 * nf} {H}x{W} tpl {s}px: max_abs_err {err:.3e} "
            f"(max|plain| {scale:.3e}), peaks equal, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library irfft2 {library_ms:.3f} ms; {card}")
        device_ms = log_device_split(torch, "kernel", lambda: cuda_fftp.ncc_masked_peaks(*args, **kw))
        log_device_split(torch, "plain", lambda: cuda_fftp.ncc_masked_peaks_plain(*args, **kw))
        log_device_split(torch, "library", lambda: torch.fft.irfft2(prod, s=(H, W)))
        planes = prod.shape[0] * prod.shape[1]
        flops = planes * (6 * prod.shape[-2] * prod.shape[-1] + fft_flops(H * W) + 4 * H * W)
        rows.append({"name": f"ncc_masked_peaks B={9 * nf}", "route": "cuda",
                     "source": "barc4dip_tpu_torch/csrc/fftp_corr.cu",
                     "replaces": "barc4dip_tpu/ops/pallas_fftp.py:398",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
                     **bound(nbytes(*args, maps, iy, ix), flops), "library_ms": library_ms})
    log(f"card state (SM clock, max SM clock, power, temperature): {card_state()}")
    return rows


def run_slice(torch, dev, stack, card: str) -> dict:
    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.ops import cuda_fftp

    kw = dict(metrics="all", tiles=True, frame_chunk=FRAME_CHUNK, verbose=False, device=dev)
    t0 = time.perf_counter()
    port.speckle_stack_stats(stack, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    cuda_fftp.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = port.speckle_stack_stats(stack, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = dict(cuda_fftp.LAUNCHES)
    plain = dict(cuda_fftp.PLAIN_BY_SHAPE)
    log(f"K1 launches in the counted run: {json.dumps(launches)}; "
        f"plain by shape: {json.dumps(plain)}")

    T, H, W = stack.shape
    mp = T * H * W / 1e6
    log(f"slice end to end: first run {cold_s:.3f} s, counted run {warm_s:.3f} s = "
        f"{T / warm_s:.2f} frames/s = {mp / warm_s:.2f} MP/s "
        f"({T} x {H}x{W} uint16, frame_chunk {FRAME_CHUNK}; {card})")

    # a chunk: one K1a for its full-frame grain, two K1b (abs, inc); maps unread
    chunks = -(-T // FRAME_CHUNK)
    want = {"cols": 3 * chunks, "rows": chunks, "rows_ncc": 2 * chunks}
    if launches != want:
        raise AssertionError(f"K1 launches {launches} != {want} on the main path")
    if not set(plain) <= subtile_plain_keys(H, W):
        raise AssertionError(f"unexpected plain-path shapes {sorted(set(plain) - subtile_plain_keys(H, W))}")

    for sec, shape in (("full", (T,)), ("tiles", (T, 3, 3)), ("temporal", (T,))):
        for g, block in out[sec].items():
            if g == "qc":
                continue
            for f, leaf in block.items():
                if f in ("autocorr", "xlag", "ylag"):  # the lazy maps stay unread here
                    want = (T, H, W) if f == "autocorr" else (T, W)
                    if tuple(leaf.shape) != want:
                        raise AssertionError(f"{sec}.{g}.{f}: shape {leaf.shape} != {want}")
                    continue
                arrs = leaf.values() if isinstance(leaf, dict) else [leaf]
                for a in arrs:
                    if np.asarray(a).shape != shape:
                        raise AssertionError(f"{sec}.{g}.{f}: shape {np.asarray(a).shape} != {shape}")
                if sec != "tiles" and not np.all(np.isfinite(leaf)):
                    raise AssertionError(f"{sec}.{g}.{f}: non-finite values")

    err = spiral_error(out)
    log(f"tracking: max |abs trajectory - spiral| = {err:.4f} px (gate {TRACK_GATE_PX} px)")
    if not err <= TRACK_GATE_PX:
        raise AssertionError(f"tracking error {err:.4f} px > {TRACK_GATE_PX} px")

    # the lazy maps of frames 0..GOLDEN_K-1, read by index: one K1a each
    cuda_fftp.reset_counts()
    maps = [out["full"]["grain"]["autocorr"][t] for t in range(GOLDEN_K)]
    map_launches = dict(cuda_fftp.LAUNCHES)
    log(f"K1 launches reading the maps of frames 0-{GOLDEN_K - 1}: {json.dumps(map_launches)}")
    if map_launches != {"cols": GOLDEN_K, "rows": GOLDEN_K, "rows_ncc": 0}:
        raise AssertionError(f"reading {GOLDEN_K} maps launched K1 {map_launches}")
    if not all(m.shape == (H, W) and m.dtype == np.float32 and np.isfinite(m).all() for m in maps):
        raise AssertionError("lazy maps: wrong shape, dtype or non-finite values")
    return {"out": out, "launches": launches, "map_launches": map_launches,
            "warm_s": warm_s, "cold_s": cold_s}


def subtile_plain_keys(H: int, W: int) -> set:
    """``PLAIN_BY_SHAPE`` keys of the 9x9 subtile autocorrelations K1 does
    not cover (227/228 px at 2048^2)."""
    from barc4dip_tpu_torch.metrics.common import tile_plan
    from barc4dip_tpu_torch.ops import cuda_fftp

    sub = {max(th, tw) for th, tw, _ in tile_plan(H, W, 9)}
    return {f"corr:{n}x{n}:complex64" for n in sub if not cuda_fftp.supported((n, n))}


def spiral_error(out: dict) -> float:
    """Max over frames of |abs trajectory - the spiral| (px)."""
    from barc4dip_tpu_torch.utils import spiral_motion

    dys, dxs = spiral_motion(len(out["temporal"]["abs"]["dy"]))
    return float(np.max(np.hypot(out["temporal"]["abs"]["dy"] - dys, out["temporal"]["abs"]["dx"] - dxs)))


def check_values(dev, stack, out) -> None:
    import barc4dip_tpu_torch as port

    run = metric_leaves(out, GOLDEN_K)
    ref64 = port.speckle_stack_stats(
        stack[:GOLDEN_K].astype(np.float64), metrics="all", tiles=True,
        frame_chunk=FRAME_CHUNK, verbose=False, device=dev,
    )
    ref = metric_leaves(ref64, GOLDEN_K)
    worst, err, n = compare_leaves(run, ref)
    map_err = leaf_rel_err(run["full.grain.autocorr"], ref["full.grain.autocorr"])
    log(f"values vs float64 run on the card: {n} leaves (the frame 0-{GOLDEN_K - 1} autocorrelation "
        f"maps among them: max rel err {map_err:.3e}), max rel err {err:.3e} on {worst} (rtol {RTOL:g})")
    if not err <= RTOL:
        raise AssertionError(f"float64 check: {worst} rel err {err:.3e} > {RTOL:g}")

    path = REPO / ".bench_metric_golden.json"
    key = golden_key(stack, GOLDEN_K)
    entry = json.loads(path.read_text()).get(key) if path.exists() else None
    if entry is None:
        log(f"values vs bench golden: not run (key {key} not in {path.name})")
        return
    golden = {p: np.asarray(v, np.float64) for p, v in entry["leaves"].items()}
    worst, err, n = compare_leaves(golden_form(run), golden)
    absent = sorted(set(golden) - set(golden_form(run)))
    log(f"values vs bench golden {key}: {n} leaves, max rel err {err:.3e} on {worst} "
        f"(rtol {RTOL:g}); absent here: {absent}")
    if not err <= RTOL:
        raise AssertionError(f"golden check: {worst} rel err {err:.3e} > {RTOL:g}")


# -- the speckle API's other paths ---------------------------------------------

def run_speckle_stats(torch, dev, stack, card: str) -> dict:
    """``speckle_stats`` on frame 0, run twice, the second counted; its
    leaves and its lazy map against a float64 run on the card."""
    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.ops import cuda_fftp

    frame = stack[0]
    kw = dict(metrics="all", tiles=True, verbose=False, device=dev)
    port.speckle_stats(frame, **kw)
    cuda_fftp.reset_counts()
    t0 = time.perf_counter()
    out = port.speckle_stats(frame, **kw)  # returns host floats: synchronised
    ms = (time.perf_counter() - t0) * 1e3
    launches, plain = dict(cuda_fftp.LAUNCHES), dict(cuda_fftp.PLAIN_BY_SHAPE)
    log(f"speckle_stats {frame.shape} {frame.dtype}, all groups, 9x9 subtiles: {ms:.2f} ms (counted "
        f"run); K1 launches {json.dumps(launches)}; plain by shape {json.dumps(plain)}; {card}")
    if launches != {"cols": 1, "rows": 1, "rows_ncc": 0}:
        raise AssertionError(f"speckle_stats launched K1 {launches}: one K1a wanted")
    if not set(plain) <= subtile_plain_keys(*frame.shape):
        raise AssertionError(f"unexpected plain-path shapes {sorted(plain)}")

    cuda_fftp.reset_counts()
    amap = np.asarray(out["full"]["grain"]["autocorr"])
    map_launches = dict(cuda_fftp.LAUNCHES)
    if map_launches != {"cols": 1, "rows": 1, "rows_ncc": 0}:
        raise AssertionError(f"reading the map launched K1 {map_launches}: one K1a wanted")
    ref = port.speckle_stats(frame.astype(np.float64), **kw)
    worst, err, n = compare_leaves(metric_leaves(out), metric_leaves(ref))
    map_err = leaf_rel_err(amap, np.asarray(ref["full"]["grain"]["autocorr"]))
    log(f"speckle_stats vs float64 run on the card: {n} leaves, max rel err {err:.3e} on {worst}; "
        f"the lazy map {amap.shape} (one more K1a: {json.dumps(map_launches)}) max rel err "
        f"{map_err:.3e} (rtol {RTOL:g})")
    if not (err <= RTOL and map_err <= RTOL):
        raise AssertionError(f"speckle_stats float64 check: {worst} {err:.3e}, map {map_err:.3e}")
    return {"launches": launches, "map_launches": map_launches}


def _data_leaves(out: dict) -> dict:
    """Every eager leaf of full/tiles/temporal (lazy maps left out)."""
    from barc4dip_tpu_torch.utils import LazyMapStack

    leaves = {}

    def walk(path, node):
        if isinstance(node, dict):
            for key, v in node.items():
                walk(f"{path}.{key}", v)
        elif not isinstance(node, LazyMapStack) and np.asarray(node).dtype.kind in "fiu":
            leaves[path] = np.asarray(node)

    for sec in ("full", "tiles", "temporal"):
        walk(sec, out[sec])
    return leaves


def max_leaf_diff(a: dict, b: dict) -> tuple[str | None, float]:
    """(leaf, max |a - b|) over the eager leaves of two results, NaN equal to
    NaN; inf where shapes, dtypes or NaN positions differ."""
    la, lb = _data_leaves(a), _data_leaves(b)
    if la.keys() != lb.keys():
        return "keys", float("inf")
    worst, worst_d = None, 0.0
    for k in la:
        x, y = la[k], lb[k]
        if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(np.isnan(x), np.isnan(y)):
            return k, float("inf")
        d = float(np.nanmax(np.abs(x - y))) if x.size and not np.isnan(x).all() else 0.0
        if d > worst_d:
            worst, worst_d = k, d
    return worst, worst_d


def run_resident(torch, dev, stack, host_out: dict, card: str) -> dict:
    """The Config D stack as a CUDA tensor: no uploads, the same per-chunk
    math; every leaf against the host stack's counted run."""
    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.ops import cuda_fftp

    st = torch.from_numpy(stack).to(dev)
    kw = dict(metrics="all", tiles=True, frame_chunk=FRAME_CHUNK, verbose=False)
    port.speckle_stack_stats(st, **kw)
    cuda_fftp.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = port.speckle_stack_stats(st, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches, plain = dict(cuda_fftp.LAUNCHES), dict(cuda_fftp.PLAIN_BY_SHAPE)
    T, H, W = stack.shape
    log(f"resident stack ({T} x {H}x{W} {st.dtype} on the card): counted run {warm_s:.3f} s = "
        f"{T * H * W / 1e6 / warm_s:.2f} MP/s end to end; K1 launches {json.dumps(launches)}; {card}")
    if not (launches["rows_ncc"] > 0 and set(plain) <= subtile_plain_keys(H, W)):
        raise AssertionError(f"resident run: K1 launches {launches}, plain {sorted(plain)}")
    worst, d = max_leaf_diff(out, host_out)
    map_d = float(np.abs(out["full"]["grain"]["autocorr"][0] - host_out["full"]["grain"]["autocorr"][0]).max())
    log(f"resident vs host-stack run: max |diff| {d:.3e} over every leaf (worst {worst}), "
        f"frame-0 map {map_d:.3e}")
    if d != 0.0 or map_d != 0.0:
        raise AssertionError(f"resident run differs from the host-stack run: {worst} {d:.3e}, map {map_d:.3e}")
    return {"launches": launches, "warm_s": warm_s}


def run_options(torch, dev, stack, card: str) -> dict:
    """The windowed search, phase tracking and checkpoints on frames
    0..OPT_T-1 (phase on its own stack, see the module docstring)."""
    import tempfile

    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.ops import cuda_fftp
    from barc4dip_tpu_torch.utils import speckle_stack, spiral_motion

    sub = stack[:OPT_T]
    kw = dict(metrics="all", tiles=True, frame_chunk=FRAME_CHUNK, verbose=False, device=dev)
    res: dict = {}

    def counted(**extra):
        port.speckle_stack_stats(sub, **kw, **extra)
        cuda_fftp.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = port.speckle_stack_stats(sub, **kw, **extra)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(cuda_fftp.LAUNCHES), dict(cuda_fftp.PLAIN_BY_SHAPE)

    full, full_s, _, _ = counted()
    win, win_s, launches, plain = counted(tracking_search_radius=OPT_RADIUS)
    w = win["meta"]["tracking"]["roi_size_yx"][0] + 2 * OPT_RADIUS
    window_key = f"corr:{w}x{w}:complex64"
    diff = max(float(np.abs(win["temporal"][b][c] - full["temporal"][b][c]).max())
               for b in ("abs", "inc") for c in ("dy", "dx"))
    err = spiral_error(win)
    log(f"windowed search r={OPT_RADIUS} ({win['meta']['tracking']['search_area']}, {w}-px windows): "
        f"{OPT_T} frames in {win_s:.3f} s against {full_s:.3f} s for the full search; trajectories "
        f"within {diff:.3e} px of the full search; max |abs - spiral| {err:.4f} px; K1 launches "
        f"{json.dumps(launches)}; plain by shape {json.dumps(plain)}; {card}")
    if win["meta"]["tracking"]["search_area"] != f"window_r{OPT_RADIUS}px":
        raise AssertionError(f"search_area {win['meta']['tracking']['search_area']}")
    if not (diff <= WINDOW_ATOL_PX and err <= TRACK_GATE_PX):
        raise AssertionError(f"windowed search: {diff:.3e} px from the full search, {err:.4f} px from the spiral")
    if not (window_key in plain and set(plain) <= subtile_plain_keys(*sub.shape[1:]) | {window_key}):
        raise AssertionError(f"windowed search: plain by shape {sorted(plain)}")
    res["windowed"] = launches

    pk = dict(metrics="stats", tiles=False, tracking_method="phase", roi_grain_factor=12.0,
              frame_chunk=FRAME_CHUNK, verbose=False, device=dev)
    dys, dxs = spiral_motion(OPT_T)
    pst = speckle_stack(OPT_T, (PHASE_SIDE, PHASE_SIDE), grain_px=PHASE_GRAIN_PX, mean_counts=1000.0,
                        dys=dys, dxs=dxs, seed=np.random.default_rng(SEED), dtype=np.float32)
    ph = port.speckle_stack_stats(pst, **pk)
    err = spiral_error(ph)
    on_d = spiral_error(port.speckle_stack_stats(sub, **pk))
    log(f"phase tracking (roi_grain_factor 12, ROI {ph['meta']['tracking']['roi_size_yx'][0]} px) on "
        f"{OPT_T} x {PHASE_SIDE}^2 float32 spiral frames: max |abs - spiral| {err:.4f} px (gate "
        f"{PHASE_GATE_PX} px); on Config D's frames (not gated) {on_d:.3f} px")
    if not err <= PHASE_GATE_PX:
        raise AssertionError(f"phase tracking error {err:.4f} px > {PHASE_GATE_PX} px")

    with tempfile.TemporaryDirectory() as tmp:
        ck = dict(kw, checkpoint_dir=tmp)
        first = port.speckle_stack_stats(sub, **ck)
        n_files = len(list(Path(tmp).glob("*.npz")))
        cuda_fftp.reset_counts()
        second = port.speckle_stack_stats(sub, **ck)
        launches = dict(cuda_fftp.LAUNCHES)
    worst, d = max_leaf_diff(second, first)
    log(f"checkpoint: {n_files} chunk files; the resumed run launched K1 {json.dumps(launches)} and "
        f"differs from the first by {d:.3e} (worst {worst})")
    if n_files != -(-OPT_T // FRAME_CHUNK) or any(launches.values()) or d != 0.0:
        raise AssertionError(f"checkpoint resume: {n_files} files, launches {launches}, diff {d:.3e}")
    res["checkpoint resumed"] = launches
    return res


def run_full_step(torch, dev, stack, starts, s: int, card: str) -> dict:
    """``full_step_fn`` at B = FULL_STEP_B on the card: frames 1..B
    flat-fielded and tracked against frame 0's templates and their
    predecessors, against its float64 run (per tile) and the known motion
    (the 9 tiles' mean, as the slice's gate)."""
    from barc4dip_tpu_torch.models import full_step_fn
    from barc4dip_tpu_torch.ops import cuda_fftp
    from barc4dip_tpu_torch.utils import spiral_motion

    B = FULL_STEP_B
    rng = np.random.default_rng(SEED + 1)
    gain = rng.normal(1.0, 0.02, size=stack.shape[1:]).astype(np.float32)
    dark = rng.normal(100.0, 2.0, size=stack.shape[1:]).astype(np.float32)
    flat = gain + dark
    # half the counts: no pixel near saturation, whose float32/float64
    # threshold count (frac_sat) would differ by rounding alone
    raw = 0.5 * stack[: B + 1].astype(np.float32) * gain + dark
    corrected0 = (raw[0] - dark) / (flat - dark)
    tpl0 = np.stack([corrected0[y : y + s, x : x + s] for y, x in starts])
    step = full_step_fn(s, starts)

    def args(dtype):
        return tuple(torch.from_numpy(a.astype(dtype)).to(dev) for a in (raw[1:], raw[:-1], flat, dark, tpl0))

    a32 = args(np.float32)
    step(*a32)
    cuda_fftp.reset_counts()
    out = step(*a32)
    torch.cuda.synchronize()
    launches = dict(cuda_fftp.LAUNCHES)
    ms = time_ms(torch, lambda: step(*a32))
    ref = step(*args(np.float64))
    m_worst, m_err = None, -1.0
    for g in ("amplitude", "grain", "stats"):
        for k, v in ref[g].items():
            e = leaf_rel_err(out[g][k].cpu().numpy(), v.cpu().numpy(), absolute=(k == "SNRdB"))
            if k == "SNRdB":
                e *= np.log(10.0) / 20.0
            if e > m_err:
                m_worst, m_err = f"{g}.{k}", e
    keys = ("dy_abs", "dx_abs", "dy_inc", "dx_inc")
    s_err = max(float((out[k].double() - ref[k]).abs().max()) for k in keys)
    dys, dxs = spiral_motion(B + 1)  # the stack's first B + 1 positions
    truth = {"dy_abs": dys[1:], "dx_abs": dxs[1:], "dy_inc": np.diff(dys), "dx_inc": np.diff(dxs)}
    # the trajectory as speckle_stack_stats reports it: the mean over the 9 tiles
    t_err = max(float(np.abs(out[k].mean(-1).cpu().numpy() - truth[k]).max()) for k in keys)
    log(f"full_step_fn B={B} {raw.shape[1]}x{raw.shape[2]} on the card: {ms:.3f} ms a step "
        f"(CUDA events, median of {REPEATS}) = {B * raw[0].size / 1e6 / ms * 1e3:.2f} MP/s; K1 launches "
        f"{json.dumps(launches)}; vs float64: metrics max rel err {m_err:.3e} on {m_worst}, shifts "
        f"{s_err:.3e} px; vs the known motion {t_err:.4f} px; {card}")
    if not (launches["rows"] > 0 and m_err <= RTOL and s_err <= TRACK_GATE_PX and t_err <= TRACK_GATE_PX):
        raise AssertionError(f"full_step_fn: launches {launches}, metrics {m_err:.3e}, shifts {s_err:.3e}, "
                             f"motion {t_err:.4f}")
    return {"launches": launches}


def profile_slice(torch, dev, stack) -> None:
    """Where the time goes: the metric step and the tracker of one chunk
    timed apart, then the whole slice under torch.profiler (device busy
    time, device time by op and kernel)."""
    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.config import upload
    from barc4dip_tpu_torch.metrics import stack_fused
    from barc4dip_tpu_torch.metrics.common import apply_display_origin
    from barc4dip_tpu_torch.metrics.speckles import tracking_grid_from_frame0
    from barc4dip_tpu_torch.metrics.speckles_device import speckle_device_fn
    from barc4dip_tpu_torch.metrics.tracking_batch import _grid_geometry
    grid, *_ = tracking_grid_from_frame0(stack)
    starts, _, s = _grid_geometry(grid)
    frames = upload(stack[:FRAME_CHUNK], dev)
    H, W = frames.shape[-2:]
    tpl0 = stack_fused._build_tpl0(frames[0], starts, s, H, W)
    metric_fn = speckle_device_fn(frozenset({"amplitude", "grain", "stats", "bandwidth"}),
                                  "subtiles_9x9", 65535.0, 1e-6)
    steps = {
        "metrics": lambda: metric_fn(apply_display_origin(frames, display_origin="lower"),
                                     int_range=(0, 65535)),
        "tracking": lambda: stack_fused._track_chunk(frames, frames, tpl0, starts, s, True, 1e-9),
    }
    for name, fn in steps.items():
        host = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
        log(f"chunk of {FRAME_CHUNK}: {name} enqueue {np.median(host) * 1e3:.2f} ms (host), "
            f"{time_ms(torch, fn):.2f} ms to completion (CUDA events), median of {REPEATS}")

    kw = dict(metrics="all", tiles=True, frame_chunk=FRAME_CHUNK, verbose=False, device=dev)
    port.speckle_stack_stats(stack, **kw)
    profiled(torch, "slice", lambda: port.speckle_stack_stats(stack, **kw))


def profiled(torch, label: str, fn) -> None:
    """Run ``fn`` once under torch.profiler: wall time, device busy time and
    the device time by op and kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in kernels)
    log(f"profiled {label}: wall {wall * 1e3:.1f} ms (profiler on), device busy "
        f"{dev_us / 1e3:.1f} ms in {sum(e.count for e in kernels)} kernels and copies")
    log(events.table(sort_by="self_device_time_total", row_limit=30, max_name_column_width=70))


# -- the XST slice: flat-field with bad-pixel repair, dense tracking ---------

def parabola_displacement(y, x, side: int):
    """Displacement [px] of a spherical wavefront of radius XST_R at (y, x)."""
    c = side / 2
    return (y - c) * XST_DIST / XST_R, (x - c) * XST_DIST / XST_R


def make_xst_data() -> dict:
    """Reference and T sample frames as raw uint16 counts, with flats,
    darks and the dead-pixel mask."""
    from scipy.ndimage import map_coordinates

    from barc4dip_tpu_torch.utils import speckle_field, spiral_motion

    rng = np.random.default_rng(XST_SEED)
    ref = speckle_field((SIDE, SIDE), grain_px=XST_GRAIN_PX, mean_counts=XST_MEAN_COUNTS,
                        seed=rng, dtype=np.float64)
    yy, xx = np.mgrid[0:SIDE, 0:SIDE].astype(np.float64)
    py, px = parabola_displacement(yy, xx, SIDE)
    sy, sx = spiral_motion(XST_T)
    frames = [map_coordinates(ref, [yy - py - sy[t], xx - px - sx[t]], order=3, mode="reflect")
              for t in range(XST_T)]
    gain = rng.normal(2.0, 0.1, size=(SIDE, SIDE))
    dead = rng.random((SIDE, SIDE)) < 1e-3
    gain_eff = np.where(dead, 0.0, gain)
    flats = (gain * 10000.0 + 100.0 + rng.normal(0.0, 3.0, size=(4, SIDE, SIDE))).astype(np.float32)
    flats[:, dead] = 90.0  # flat <= dark: dead
    darks = (100.0 + rng.normal(0.0, 2.0, size=(4, SIDE, SIDE))).astype(np.float32)

    def counts(x):
        return np.clip(np.round(x * gain_eff + 100.0), 0, 65535).astype(np.uint16)

    return {"ref": counts(ref), "stack": np.stack([counts(f) for f in frames]),
            "flats": flats, "darks": darks, "dead": dead, "shifts": (sy, sx)}


def _median_lerp(v: np.ndarray) -> np.float32:
    """The exact linear-interpolation median as the packages compute it."""
    xs = np.sort(v.ravel())
    rank = 0.5 * (xs.size - 1)
    lo, hi = int(np.floor(rank)), int(np.ceil(rank))
    return xs[lo] + np.float32(rank - lo) * (xs[hi] - xs[lo])


def ffc_numpy(raw, flats, darks) -> tuple[np.ndarray, np.ndarray]:
    """The flat-field formula in numpy float32 (scale flat_median, eps from
    the median gain, repair by scipy's 3x3 median): (out, bad)."""
    from scipy.ndimage import median_filter

    flat = flats.mean(axis=0)
    dark = darks.mean(axis=0)
    den = flat - dark
    med = _median_lerp(den)
    eps = np.float32(1e-6) * med if med > 0 else np.float32(1e-6)
    bad = den <= eps
    out = (raw.astype(np.float32) - dark) / np.where(bad, np.float32(1.0), den)
    out = out * _median_lerp(den[~bad])
    out = np.where(bad, np.float32(0.0), out)
    size = (1, 3, 3) if out.ndim == 3 else 3
    return np.where(bad, median_filter(out, size=size, mode="reflect"), out), bad


def check_kernels_xst(torch, dev, data, card: str) -> list[dict]:
    """K2 and K3 against their plain versions at the XST slice's shapes."""
    from barc4dip_tpu_torch.config import upload
    from barc4dip_tpu_torch.ops import cuda_densetrack, cuda_median, densetrack
    from barc4dip_tpu_torch.ops.ncc import window_sums
    from barc4dip_tpu_torch.preprocessing import flat_field_correction

    rows = []
    log(f"card state (SM clock, max SM clock, power, temperature): {card_state()}")
    ff = dict(flats=data["flats"], darks=data["darks"], bad_pixel_removal=False)
    # K2's input on the main path: the flat-field's zeroed output
    zeroed = flat_field_correction(upload(data["stack"], dev), **ff)
    for x in (zeroed[0].contiguous(), zeroed):
        got = cuda_median.median3x3(x)
        want = cuda_median.median3x3_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            n = int((got != want).sum())
            raise AssertionError(f"K2 {tuple(x.shape)}: {n} pixels differ from the plain version")
        ms = time_ms(torch, lambda: cuda_median.median3x3(x))
        plain_ms = time_ms(torch, lambda: cuda_median.median3x3_plain(x))
        log(f"K2 median3x3 {tuple(x.shape)}: exactly equal to plain, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms; {card}")
        # single-call event time = host enqueue + device; the split shows each
        device_ms = log_device_split(torch, "kernel", lambda: cuda_median.median3x3(x))
        # 19 compare-exchanges (two operations each) per output pixel
        rows.append({"name": f"median3x3 {'x'.join(map(str, x.shape))}", "route": "cuda",
                     "source": "barc4dip_tpu_torch/csrc/median3x3.cu",
                     "replaces": "barc4dip_tpu/ops/pallas_median.py:79",
                     "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
                     **bound(nbytes(x, got), 38 * x.numel()), "library_ms": None})

    ff["bad_pixel_removal"] = True
    ref = densetrack._zscore(flat_field_correction(upload(data["ref"], dev), **ff), 1e-9)
    frames = densetrack._zscore(flat_field_correction(upload(data["stack"][:XST_BATCH], dev), **ff), 1e-9)
    y0s, x0s = densetrack.grid_starts(SIDE, SIDE, XST_TILE, XST_RADIUS, XST_STEP)
    args = (y0s, x0s, XST_TILE, XST_RADIUS)
    for nf in (1, XST_BATCH):
        fr = frames[:nf].contiguous()
        got = cuda_densetrack.ncc_sums(ref, fr, *args)
        want = cuda_densetrack.ncc_sums_plain(*cuda_densetrack.grid_windows(ref, fr, *args), XST_RADIUS)
        torch.cuda.synchronize()
        errs = []
        for name, g, w in zip(("num", "s1", "s2"), got, want):
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            if not err <= K3_ATOL_REL * scale:
                raise AssertionError(f"K3 {name} F={nf}: max|kernel-plain| {err:.3e} > "
                                     f"{K3_ATOL_REL:g}*{scale:.3e}")
            errs.append(f"{name} {err:.3e} (max {scale:.3e})")
        # the kernel's s1 and s2 slide along rows and columns: against
        # float64 sums of the same windows
        w64 = cuda_densetrack.grid_windows(ref.double(), fr.double(), *args)[1]
        for name, g, w in zip(("s1", "s2"), got[1:], (window_sums(w64, XST_TILE, XST_TILE),
                                                      window_sums(w64 * w64, XST_TILE, XST_TILE))):
            err, scale = float((g.double() - w).abs().max()), float(w.abs().max())
            if not err <= K3_ATOL_REL * scale:
                raise AssertionError(f"K3 {name} F={nf}: max|kernel-float64| {err:.3e} > "
                                     f"{K3_ATOL_REL:g}*{scale:.3e}")
            errs.append(f"{name} vs float64 {err:.3e} ({err / scale:.2e} of max)")
        del w64
        ms = time_ms(torch, lambda: cuda_densetrack.ncc_sums(ref, fr, *args))
        plain_ms = time_ms(torch, lambda: cuda_densetrack.ncc_sums_plain(
            *cuda_densetrack.grid_windows(ref, fr, *args), XST_RADIUS))
        nodes = len(y0s) * len(x0s)
        # the library call: the numerator alone as the `conv` method's one
        # cuDNN call (TF32 off), on windows extracted beforehand
        t, wins = cuda_densetrack.grid_windows(ref, fr, *args)
        wins = wins.reshape(nf, nodes, *wins.shape[-2:])

        def conv():
            return torch.nn.functional.conv2d(wins, t[:, None], groups=nodes)

        library_ms = time_ms(torch, conv)
        lib_err = float((conv().reshape(want[0].shape) - want[0]).abs().max())
        log(f"K3 ncc_sums {nf} x {nodes} nodes, tile {XST_TILE}, r {XST_RADIUS}: max_abs_err "
            f"{'; '.join(errs)}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library conv2d "
            f"(numerator only, max|conv-plain| {lib_err:.3e}) {library_ms:.3f} ms; {card}")
        device_ms = log_device_split(torch, "kernel", lambda: cuda_densetrack.ncc_sums(ref, fr, *args))
        log_device_split(torch, "library", conv)
        L = 2 * XST_RADIUS + 1
        # the numerator's multiply-adds; s1 and s2 are box sums, O(w L s)
        # a node against the numerator's L^2 s^2, and are not counted
        flops = 2.0 * nf * nodes * L * L * XST_TILE * XST_TILE
        rows.append({"name": f"ncc_sums F={nf}", "route": "cuda",
                     "source": "barc4dip_tpu_torch/csrc/densetrack_sums.cu",
                     "replaces": "barc4dip_tpu/ops/densetrack.py:121",
                     "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                     "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
                     **bound(nbytes(ref, fr, *got), flops), "library_ms": library_ms})
    log(f"card state (SM clock, max SM clock, power, temperature): {card_state()}")
    return rows


def run_xst(torch, dev, data, card: str) -> dict:
    """Flat-field and the wavefront scan on the card, run twice; the second
    run is counted and timed."""
    from barc4dip_tpu_torch.config import upload
    from barc4dip_tpu_torch.models import WavefrontScanPipeline
    from barc4dip_tpu_torch.ops import cuda_densetrack, cuda_median
    from barc4dip_tpu_torch.preprocessing import flat_field_correction
    from barc4dip_tpu_torch.signal import track_displacement_field

    pipe = WavefrontScanPipeline(pixel_size=XST_PIXEL, distance=XST_DIST, wavelength=1e-10,
                                 tile_size=XST_TILE, step=XST_STEP, search_radius=XST_RADIUS)
    ff = dict(flats=data["flats"], darks=data["darks"], bad_pixel_removal=True)
    T = XST_T

    def one_pass():
        t0 = time.perf_counter()
        ref_d, st_d = upload(data["ref"], dev), upload(data["stack"], dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref_c = flat_field_correction(ref_d, **ff)
        st_c = flat_field_correction(st_d, **ff)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = pipe(st_c, ref_c)
        t3 = time.perf_counter()
        return out, ref_c, st_c, (t0, t1, t2, t3)

    one_pass()
    cuda_median.reset_counts()
    cuda_densetrack.reset_counts()
    out, ref_c, st_c, (t0, t1, t2, t3) = one_pass()
    launches = {**cuda_median.LAUNCHES, **cuda_densetrack.LAUNCHES}
    plain = {**cuda_median.PLAIN_BY_SHAPE, **cuda_densetrack.PLAIN_BY_SHAPE}
    log(f"K2/K3 launches in the counted run: {json.dumps(launches)}; plain by shape: {json.dumps(plain)}")
    if not (launches["median3x3"] > 0 and launches["ncc_sums"] > 0):
        raise AssertionError(f"a K2/K3 kernel never launched on the XST slice: {launches}")
    if plain:
        raise AssertionError(f"uncovered K2/K3 calls on the XST slice: {plain}")

    gy, gx = out["meta"]["grid_shape"]
    kw = dict(tile_size=XST_TILE, step=XST_STEP, search_radius=XST_RADIUS)
    track_displacement_field(st_c[0], ref_c, **kw)
    torch.cuda.synchronize()
    tt = time.perf_counter()
    field = track_displacement_field(st_c[0], ref_c, **kw)
    track_s = time.perf_counter() - tt
    host = []
    for _ in range(3):  # the host part of one call: the stacked calibration means
        th = time.perf_counter()
        data["flats"].mean(axis=0), data["darks"].mean(axis=0)
        host.append(time.perf_counter() - th)
    log(f"xst flat-field: {(t2 - t1) / (T + 1) * 1e3:.3f} ms per frame on the card "
        f"({T} frames + reference, {SIDE}^2, repair on; upload {(t1 - t0) * 1e3:.1f} ms; "
        f"of each of the 2 calls, {np.median(host) * 1e3:.1f} ms is the host mean of "
        f"{len(data['flats'])} flats + {len(data['darks'])} darks); {card}")
    log(f"xst tracking: {track_s * 1e3:.3f} ms per frame = {gy * gx / track_s:.4e} ZNCCs/s "
        f"({gy}x{gx} nodes, tile {XST_TILE}, step {XST_STEP}, r {XST_RADIUS}, "
        f"method {field['meta']['method']}); {card}")
    log(f"xst pipeline end to end (upload, flat-field, tracking, wavefront): {t3 - t0:.4f} s = "
        f"{T / (t3 - t0):.3f} frames/s; tracking + wavefront {(t3 - t2) / T * 1e3:.3f} ms per "
        f"frame; {card}")

    # flat-field against the formula in numpy
    want, bad = ffc_numpy(data["stack"], data["flats"], data["darks"])
    got = st_c.cpu().numpy()
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    if not (np.allclose(got, want, rtol=1e-6, atol=0) and np.array_equal(got[:, bad], want[:, bad])):
        raise AssertionError(f"flat-field vs numpy: max rel err {rel:.3e}, repaired pixels equal "
                             f"{np.array_equal(got[:, bad], want[:, bad])}")
    log(f"flat-field vs numpy float32 formula: max rel err {rel:.3e} (rtol 1e-6); "
        f"{int(bad.sum())} repaired pixels per frame, exactly equal")

    # the K3 path against the fft path on the card
    peaks = {m: track_displacement_field(st_c[0], ref_c, method=m, subpixel=False, **kw)
             for m in ("pallas", "fft")}
    fft = track_displacement_field(st_c[0], ref_c, method="fft", **kw)
    same = (peaks["pallas"]["dy"] == peaks["fft"]["dy"]) & (peaks["pallas"]["dx"] == peaks["fft"]["dx"])
    frac = float(same.mean())
    errs = {k: float(np.abs(field[k] - fft[k])[same].max()) for k in ("dy", "dx", "peak")}
    log(f"pallas vs fft on the card: same integer peak at {int(same.sum())} of {same.size} nodes "
        f"({frac:.5f}); there max |diff| dy {errs['dy']:.3e} dx {errs['dx']:.3e} px, "
        f"peak {errs['peak']:.3e}")
    if not (frac >= SAME_PEAK_MIN and errs["dy"] <= FIELD_ATOL_PX and errs["dx"] <= FIELD_ATOL_PX
            and errs["peak"] <= FIELD_ATOL_PEAK):
        raise AssertionError(f"pallas vs fft: {frac:.5f} same peaks, errors {errs}")

    # tracking against the known motion
    Y, X = np.meshgrid(out["y"], out["x"], indexing="ij")
    py, px = parabola_displacement(Y, X, SIDE)
    sy, sx = data["shifts"]
    inner = (slice(2, -2), slice(2, -2))
    med = [(float(np.median((out["dy"][t] - py - sy[t])[inner])),
            float(np.median((out["dx"][t] - px - sx[t])[inner]))) for t in range(T)]
    worst = max(abs(v) for m in med for v in m)
    log(f"tracking vs known motion: worst per-frame median error {worst:.4f} px (gate {TRACK_GATE_PX})")
    if not worst <= TRACK_GATE_PX:
        raise AssertionError(f"per-frame tracking medians {med}")
    if not all(np.isfinite(out[k]).all() for k in ("dy", "dx", "peak", "wavefront", "phase")):
        raise AssertionError("non-finite XST outputs")
    if out["dy"].shape != (T, gy, gx) or out["wavefront"].shape != (T, gy, gx):
        raise AssertionError(f"XST output shapes {out['dy'].shape}, {out['wavefront'].shape}")

    # the wavefront against the parabola (a uniform shift is a tilt, whose
    # mean gradient the periodic integration drops)
    r2 = ((Y - SIDE / 2) ** 2 + (X - SIDE / 2) ** 2) * XST_PIXEL ** 2
    want_w = r2 / (2 * XST_R)
    want_w = want_w - want_w.mean()
    A = np.vstack([r2[inner].ravel(), np.ones(r2[inner].size)]).T
    rels, fits = [], []
    for t in range(T):
        w = out["wavefront"][t]
        rels.append(float(np.abs(w[inner] - want_w[inner]).max() / np.abs(want_w[inner]).max()))
        coef, *_ = np.linalg.lstsq(A, w[inner].ravel(), rcond=None)
        fits.append(1.0 / (2.0 * coef[0]))
    log(f"wavefront vs parabola: worst interior relative error {max(rels):.4f} (gate {WAVEFRONT_REL}); "
        f"fitted R {min(fits):.3f}..{max(fits):.3f} m (true {XST_R} m)")
    if not (max(rels) < WAVEFRONT_REL and all(abs(f - XST_R) / XST_R < RADIUS_REL for f in fits)):
        raise AssertionError(f"wavefront errors {rels}, fitted radii {fits}")
    return {"launches": launches, "one_pass": one_pass}


def contract_line(name: str) -> dict:
    """The result line: this run drives one card, whatever the host holds."""
    return {"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}


def main() -> int:
    import torch

    with Phase("device"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: {name}")
        log(smi)
    card = f"card: {smi}"
    dev = torch.device("cuda", 0)

    with Phase("build"):
        from concurrent.futures import ThreadPoolExecutor

        from barc4dip_tpu_torch.ops import _nvcc, cuda_densetrack, cuda_fftp, cuda_median

        builds = (cuda_fftp.build, cuda_median.build, cuda_densetrack.build)
        with ThreadPoolExecutor(len(builds)) as pool:
            for fut in [pool.submit(b) for b in builds]:
                fut.result()
        for stem, text in _nvcc.BUILD_LOG.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"  ptxas {stem}: {line.strip()}")

    with Phase("data"):
        from barc4dip_tpu_torch.metrics.speckles import tracking_grid_from_frame0
        from barc4dip_tpu_torch.metrics.tracking_batch import _grid_geometry

        stack = make_stack()
        grid, _labels, roi_side, step, _g0 = tracking_grid_from_frame0(stack)
        starts, _, s = _grid_geometry(grid)
        log(f"stack {stack.shape} {stack.dtype}; tracking ROI {roi_side} px, step {step} px")

    with Phase("kernels"):
        rows = check_kernels(torch, dev, stack, starts, s, card)

    with Phase("slice"):
        res = run_slice(torch, dev, stack, card)

    with Phase("values"):
        check_values(dev, stack, res["out"])

    with Phase("speckle-stats"):
        single = run_speckle_stats(torch, dev, stack, card)

    with Phase("resident"):
        resident = run_resident(torch, dev, stack, res["out"], card)

    with Phase("options"):
        options = run_options(torch, dev, stack, card)

    with Phase("full-step"):
        full_step = run_full_step(torch, dev, stack, starts, s, card)
    by_path = {"slice": res["launches"], "slice map reads": res["map_launches"],
               "speckle_stats": single["launches"], "speckle_stats map read": single["map_launches"],
               "resident": resident["launches"], **options, "full_step_fn": full_step["launches"]}
    log(f"K1 launches by path (counted runs): {json.dumps(by_path)}")

    with Phase("data-xst"):
        data = make_xst_data()
        log(f"xst: reference {data['ref'].shape}, stack {data['stack'].shape} {data['stack'].dtype}, "
            f"{int(data['dead'].sum())} dead pixels")

    with Phase("kernels-2"):
        rows += check_kernels_xst(torch, dev, data, card)

    with Phase("xst"):
        xst = run_xst(torch, dev, data, card)

    if "--profile" in sys.argv[1:]:
        with Phase("profile"):
            profile_slice(torch, dev, stack)
            profiled(torch, "xst pass (upload, flat-field, wavefront scan)", xst["one_pass"])

    for row in rows:
        if row["name"].startswith("median3x3"):
            row["launches"] = xst["launches"]["median3x3"]
        elif row["name"].startswith("ncc_sums"):
            row["launches"] = xst["launches"]["ncc_sums"]
        else:
            key = "rows" if row["name"].startswith("corr_from_rfft") else "rows_ncc"
            row["launches"] = res["launches"][key]
    if "jax" in sys.modules or "barc4dip_tpu" in sys.modules:
        raise RuntimeError("the port pulled in jax or the JAX package")
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps(contract_line(name)))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: non-zero exit, no result line
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        sys.exit(1)
