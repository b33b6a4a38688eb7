#!/usr/bin/env python3
# SPDX-License-Identifier: CECILL-2.1
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, one line each with its wall time:

1. device: needs CUDA (no CPU fallback); prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles kernel K1 (``barc4dip_tpu_torch/csrc/fftp_corr.cu``)
   from this checkout into ``build/kernels/``;
3. kernels: each K1 wrapper against its plain PyTorch version on the card,
   at the main path's shapes (2048^2 frames, 29-px templates), timed with
   CUDA events (median of 10);
4. slice: ``speckle_stack_stats`` on a 16 x 2048^2 uint16 spiral stack
   (Config D), run twice; the second run is counted and timed. Checks the
   K1 launch counts, the tracking error against the known motion
   (<= 0.05 px) and the frame 0-1 ``full``/``tiles`` leaves against a
   float64 run of the same frames on the card (rtol 1e-4) and, where the
   frames' key is in ``.bench_metric_golden.json``, against that golden;
5. with ``--profile``: the metric step and the tracker of one chunk timed
   apart, and the slice under torch.profiler (device time by op and kernel).

Prints the kernel table as one JSON line, then as its last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
Imports nothing of JAX.
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

def metric_leaves(out: dict, k: int) -> dict:
    """``full`` + ``tiles`` numeric leaves of the first ``k`` frames."""
    leaves: dict = {}

    def walk(path: str, node) -> None:
        if isinstance(node, dict):
            for key, v in node.items():
                walk(f"{path}.{key}", v)
            return
        arr = np.asarray(node)
        if arr.dtype.kind not in "fiu":
            return
        if arr.ndim >= 1 and arr.shape[0] >= k:
            arr = arr[:k]
        leaves[path] = np.asarray(arr, np.float64)

    for section in ("full", "tiles"):
        if section in out:
            walk(section, out[section])
    return leaves


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


def check_kernels(torch, dev, stack, starts, s) -> list[dict]:
    """K1a and K1b against their plain versions at the main path's shapes."""
    from barc4dip_tpu_torch.metrics.stack_fused import upload
    from barc4dip_tpu_torch.metrics.tracking_batch import _extract_tiles
    from barc4dip_tpu_torch.ops import cuda_fftp, ncc
    from barc4dip_tpu_torch.ops.phasecorr import argmax2d

    frames = upload(stack[:FRAME_CHUNK], dev)
    H, W = frames.shape[-2:]
    rows = []

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
        log(f"K1a corr_from_rfft planes={nf} {H}x{W}: max_abs_err {err:.3e} "
            f"(max|plain| {scale:.3e}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        rows.append({"name": f"corr_from_rfft B={nf}", "route": "cuda",
                     "source": "barc4dip_tpu_torch/csrc/fftp_corr.cu",
                     "replaces": "barc4dip_tpu/ops/pallas_fftp.py:313",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

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
        log(f"K1b ncc_masked_peaks planes={9 * nf} {H}x{W} tpl {s}px: max_abs_err {err:.3e} "
            f"(max|plain| {scale:.3e}), peaks equal, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        rows.append({"name": f"ncc_masked_peaks B={9 * nf}", "route": "cuda",
                     "source": "barc4dip_tpu_torch/csrc/fftp_corr.cu",
                     "replaces": "barc4dip_tpu/ops/pallas_fftp.py:398",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return rows


def run_slice(torch, dev, stack, card: str) -> dict:
    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.metrics.common import tile_plan
    from barc4dip_tpu_torch.ops import cuda_fftp
    from barc4dip_tpu_torch.utils import spiral_motion

    kw = dict(metrics="all", tiles=True, frame_chunk=FRAME_CHUNK, grain_maps=False,
              verbose=False, device=dev)
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

    if not all(launches[k] > 0 for k in ("cols", "rows", "rows_ncc")):
        raise AssertionError(f"a K1 pass never launched on the main path: {launches}")
    sub = {max(th, tw) for th, tw, _ in tile_plan(H, W, 9)}
    allowed = {f"corr:{n}x{n}:complex64" for n in sub if not cuda_fftp.supported((n, n))}
    if not set(plain) <= allowed:
        raise AssertionError(f"unexpected plain-path shapes {sorted(set(plain) - allowed)}")

    for sec, shape in (("full", (T,)), ("tiles", (T, 3, 3)), ("temporal", (T,))):
        for g, block in out[sec].items():
            if g == "qc":
                continue
            for f, leaf in block.items():
                arrs = leaf.values() if isinstance(leaf, dict) else [leaf]
                for a in arrs:
                    if np.asarray(a).shape != shape:
                        raise AssertionError(f"{sec}.{g}.{f}: shape {np.asarray(a).shape} != {shape}")
                if sec != "tiles" and not np.all(np.isfinite(leaf)):
                    raise AssertionError(f"{sec}.{g}.{f}: non-finite values")

    dys, dxs = spiral_motion(T)
    err = float(np.max(np.hypot(out["temporal"]["abs"]["dy"] - dys, out["temporal"]["abs"]["dx"] - dxs)))
    log(f"tracking: max |abs trajectory - spiral| = {err:.4f} px (gate {TRACK_GATE_PX} px)")
    if not err <= TRACK_GATE_PX:
        raise AssertionError(f"tracking error {err:.4f} px > {TRACK_GATE_PX} px")
    return {"out": out, "launches": launches, "warm_s": warm_s, "cold_s": cold_s}


def check_values(dev, stack, out) -> None:
    import barc4dip_tpu_torch as port

    run = metric_leaves(out, GOLDEN_K)
    ref64 = port.speckle_stack_stats(
        stack[:GOLDEN_K].astype(np.float64), metrics="all", tiles=True,
        frame_chunk=FRAME_CHUNK, grain_maps=False, verbose=False, device=dev,
    )
    worst, err, n = compare_leaves(run, metric_leaves(ref64, GOLDEN_K))
    log(f"values vs float64 run on the card: {n} leaves, max rel err {err:.3e} on {worst} (rtol {RTOL:g})")
    if not err <= RTOL:
        raise AssertionError(f"float64 check: {worst} rel err {err:.3e} > {RTOL:g}")

    path = REPO / ".bench_metric_golden.json"
    key = golden_key(stack, GOLDEN_K)
    entry = json.loads(path.read_text()).get(key) if path.exists() else None
    if entry is None:
        log(f"values vs bench golden: not run (key {key} not in {path.name})")
        return
    golden = {p: np.asarray(v, np.float64) for p, v in entry["leaves"].items()}
    worst, err, n = compare_leaves(run, golden)
    absent = sorted(set(golden) - set(run))
    log(f"values vs bench golden {key}: {n} leaves, max rel err {err:.3e} on {worst} "
        f"(rtol {RTOL:g}); absent here (grain maps off): {absent}")
    if not err <= RTOL:
        raise AssertionError(f"golden check: {worst} rel err {err:.3e} > {RTOL:g}")


def profile_slice(torch, dev, stack) -> None:
    """Where the time goes: the metric step and the tracker of one chunk
    timed apart, then the whole slice under torch.profiler (device busy
    time, device time by op and kernel)."""
    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.metrics import stack_fused
    from barc4dip_tpu_torch.metrics.common import apply_display_origin
    from barc4dip_tpu_torch.metrics.speckles import tracking_grid_from_frame0
    from barc4dip_tpu_torch.metrics.speckles_device import speckle_device_fn
    from barc4dip_tpu_torch.metrics.tracking_batch import _grid_geometry
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    grid, *_ = tracking_grid_from_frame0(stack)
    starts, _, s = _grid_geometry(grid)
    frames = stack_fused.upload(stack[:FRAME_CHUNK], dev)
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

    kw = dict(metrics="all", tiles=True, frame_chunk=FRAME_CHUNK, grain_maps=False,
              verbose=False, device=dev)
    port.speckle_stack_stats(stack, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        port.speckle_stack_stats(stack, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in kernels)
    log(f"profiled slice: wall {wall * 1e3:.1f} ms (profiler on), device busy "
        f"{dev_us / 1e3:.1f} ms in {sum(e.count for e in kernels)} kernels and copies")
    log(events.table(sort_by="self_device_time_total", row_limit=30, max_name_column_width=70))


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
        from barc4dip_tpu_torch.ops import cuda_fftp

        cuda_fftp.build()
        for line in cuda_fftp.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    with Phase("data"):
        from barc4dip_tpu_torch.metrics.speckles import tracking_grid_from_frame0
        from barc4dip_tpu_torch.metrics.tracking_batch import _grid_geometry

        stack = make_stack()
        grid, _labels, roi_side, step, _g0 = tracking_grid_from_frame0(stack)
        starts, _, s = _grid_geometry(grid)
        log(f"stack {stack.shape} {stack.dtype}; tracking ROI {roi_side} px, step {step} px")

    with Phase("kernels"):
        rows = check_kernels(torch, dev, stack, starts, s)

    with Phase("slice"):
        res = run_slice(torch, dev, stack, card)

    with Phase("values"):
        check_values(dev, stack, res["out"])

    if "--profile" in sys.argv[1:]:
        with Phase("profile"):
            profile_slice(torch, dev, stack)

    for row in rows:
        key = "rows" if row["name"].startswith("corr_from_rfft") else "rows_ncc"
        row["launches"] = res["launches"][key]
    if "jax" in sys.modules or "barc4dip_tpu" in sys.modules:
        raise RuntimeError("the port pulled in jax or the JAX package")
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: non-zero exit, no result line
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        sys.exit(1)
