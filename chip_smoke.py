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
   at the main paths' shapes (2048^2 frames, 29-px templates; K1a on 1 and
   4 mean-removed frames as the speckle path sends them and on 8 as
   ``spectral_summary_stack`` does, on 1, 2, 3 and 8 standardized frames:
   the sharpness path's image, chunks and tail, and on one z-scored frame
   against one zero-padded template spectrum as ``template_matching`` sends
   it; then at the sides off the powers of two: K1a B=1 at 1536^2,
   ``autocorr2d``'s layout, B=4 at 3072^2 and B=1 at 8192^2 on frames made on
   the card, K1b's 9-template bank on the coverage stack at 2048 x 2560),
   timed with
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
4a. coverage: K1 at the sides the TPU kernel takes beyond the powers of
   two. ``speckle_stack_stats`` at Config D's settings on 8 frames of 2048 x
   2560 uint16 (a 2048-row window of a 2560-column sCMOS sensor), spiral
   motion, seed 1234, run twice, the second counted: one K1a a chunk (the
   full frame, padded square to 2560^2) and two K1b at 2048 x 2560,
   ``PLAIN_BY_SHAPE`` holding only subtile keys the TPU gate refuses too,
   tracking within 0.05 px of the spiral, frames 0-1 within 1e-4 of a
   float64 run on the card; ``signal.autocorr2d`` of a CUDA tensor at
   1536^2 through K1a (against float64, ns a pixel beside 2048^2 and beside
   the plain path's PR 8 reading), ``spectral_summary_stack`` of 4 x 3072^2
   CUDA frames in one chunk and ``signal.autocorr2d`` at 8192^2: one K1a
   each, no plain call;
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
9. sharpness: ``sharpness_stats`` on frame 0 (uint16, all six groups, 9x9
   subtiles), run twice, the second counted and timed: one K1a for the
   full frame's standardized autocorrelation, ``PLAIN_BY_SHAPE`` growing
   only by the subtile shapes; every leaf against a float64 run on the card
   (rtol 1e-4) and ``eigenvalues`` (subspace iteration at 2048^2, batched
   dense on the tiles) against ``eig_method="dense"``; Config A,
   ``logbook_report(sharpness_stats(frame 0, verbose=False))``, timed;
   ``sharpness_stack_stats`` on frames 0-7 at ``frame_chunk`` 8 and 3 (a
   tail), as a numpy stack and as a CUDA tensor: one K1a a chunk, the
   tensor runs exactly equal to the numpy runs, every frame of both chunk
   sizes within 1e-5 of its own single-image call, a checkpointed rerun that launches nothing and equals
   the first; ``SharpnessScanPipeline`` at its defaults on a through-focus
   scan (frame 0 blurred on the host by a Gaussian whose width is zero at a
   known frame): that frame is ``meta["focus"]["best_frame"]``;
10. files: files in, reports out. The 16 Config D frames written as uint16
   EDF files (one a frame) with the port's ``save_edf`` into a temporary
   directory; the seconds of reading them alone through the native codec
   (``native/dipio.cpp``, built with g++ into ``build/native/``; the phase
   fails with the compiler's words if it does not build) and through the
   Python parser; ``SpeckleStackPipeline(frame_chunk=4).run_files`` run
   twice, the second counted under ``StageTimer``: each file read once, K1
   launches as the in-memory slice's, every leaf exactly equal to
   ``speckle_stack_stats(stack.astype(float32))``, the 0.05 px gate, the
   maps of frames 0-1 read after the call (two more K1a, two more file
   reads), seconds and MP/s with the reads; the same run with
   ``BARC4DIP_TORCH_NATIVE_IO=1``; frames 0-3 as baseline TIFFs (written
   here with ``struct``) through ``read_tiff`` with the codec on and Pillow
   hidden, and ``SharpnessScanPipeline().run_files`` on the focus scan
   written the same way; where ``h5py`` imports, ``save_h5`` of frames 0-7
   and ``run_hdf5`` exactly equal to the in-memory uint16 run;
   ``report.cli.main`` on frame 0 (its stdout against the direct call's
   report, one K1a); ``report.batch_cli.main`` on 8 files (JSON, ``.npz``
   leaves equal to ``run_files``', report), the same as a subprocess with
   no ``--device`` (same JSON, no kernel rebuilt, wall time apart) and with
   a path that does not exist (exit code 2); one chunk under
   ``device_trace`` (the trace names the K1 kernels);
11. signal: the signal layer and the metric extensions, each call run twice
   with the second counted. Config C: ``spectral_summary`` on frame 0 (one
   K1a; its maps and curves against a float64 run on the card at rtol 1e-4 of
   each output's peak; the device time by kernel), the composed form
   ``psd2d`` + ``autocorr2d`` + the two ``maths.radial_mean_*`` with the maps
   left on the device (maps and interpolated curve exactly equal to the
   summary's, the binned curve, whose ring sums add with atomics, within 1e-6
   of its peak), each map to the host whole, as its leading half
   (``pull_centrosymmetric``) and as the half in 16-bit codes (ms, bytes, max
   error), ``spectral_summary_stack`` on the 16 frames at ``frame_chunk`` 8 as
   a numpy stack and as a CUDA tensor (ms a frame, one K1a a chunk, the two
   runs' interpolated curves equal and binned curves within 1e-6, frame 0
   within 1e-5 of the single-image call). Trackers: ``template_matching`` of
   frame 0's centre 29-px ROI, and of an even 32-px one, in frames 1-15
   against the spiral (<= 0.05 px, one K1a a call, ms a call),
   ``track_translation(method="template")`` equal to it;
   ``phase_correlation`` ``"internal"`` and ``"skimage"`` with a 256-px
   template on the 512^2 float32 stack (<= 0.5 px, no K1 launch); the
   upsampled DFT's complex64 products against complex128 on the card.
   Extensions: ``visibility_map`` (window 16) of frame 0 against float64 on
   the card and of the 16-frame stack at stride 4; ``fourier_ring_correlation``
   of frame 0 plus two noise draws against a complex128 evaluation (rings
   1 and up within 1e-4, a finite resolution); ``psnr``, ``ssim`` and
   ``ms_ssim`` of a blurred copy against float64. Last, ``signal.autocorr2d``
   at a side that K1 and the TPU gate both refuse (the 1500^2 centre crop): no
   K1 launch, ``PLAIN_BY_SHAPE`` holding that key alone for the whole phase,
   the result against float64, and its time beside the same call at 2048^2
   (K1a);
11a. preprocess: Config E ``full_with_deconv_2k`` on frame 0 and a flat
   (``flat_field_correction`` -> ``deconvolve_psf(sigma=1.5, "wiener")`` ->
   ``speckle_stats(amplitude, grain, stats)`` -> ``logbook_report``), run
   twice, the second counted: one K1a, its leaves within 1e-4 of the chain
   in float64 on the card; ``deconvolve_psf`` wiener, rl and uw on frame 0
   and on frames 0-7, from numpy and from a CUDA tensor (equal), against
   float64 on the card; ``clahe`` on frame 0 as uint16 and as uint8 against
   the CPU (1 code, 1e-3 of the pixels); ``correct_distortion`` on frame 0
   and frames 0-7 against float64 (1e-6); ``register_stack`` on Config D's
   16 frames before quantization (float32, the same spiral), ``first`` /
   ``mean`` / ``previous``, each with ``fourier`` and ``roll``: drift within
   0.05 px of the spiral (``mean``: the pairwise drift within 0.1 px, as
   the JAX test holds it; ``previous``: each increment within 0.05 px and
   frames 0-4 within 0.08 px), a CUDA tensor stack equal to the numpy one,
   then ``speckle_stack_stats`` of the aligned stack (abs trajectory within
   0.1 px of zero), and Config D's uint16 frames (within 0.2 px: whitened
   phase correlation of quantized band-limited speckle reads ~0.15 px off
   in both packages); ``barc4dip-cuda-batch --register first`` on 8 of the
   float32 frames as EDF files, in process (its JSON's ``registration``
   block against the spiral);
12. data-xst: a 2048^2 reference speckle (grain 3 px) and 6 frames warped by
   a parabolic wavefront (R = 100 m, 1 um pixels, 0.5 m) plus a spiral
   shift, as raw uint16 with flats, darks and 0.1% dead pixels;
13. kernels-2: K2 against its plain version on the flat-field's own input
    at (2048, 2048) and (6, 2048, 2048), exactly equal; K3 against its
    plain version at Config F (33-px tiles, step 16, radius 10: 15,625
    nodes) and on 4 frames, within 1e-5 of each output's max, and its s1
    and s2 (sliding box sums) against float64 sums of the same windows at
    the same tolerance; timed as K1 is (K2's single-call event time is
    mostly the wrapper's host cost; its device time and queued time per call
    stand beside it), K3 beside the library call for its numerator (one
    grouped cuDNN ``conv2d``, TF32 off);
14. xst: ``flat_field_correction(bad_pixel_removal=True)`` then
    ``WavefrontScanPipeline`` on the card, run twice; the second run is
    counted and timed, and one ``track_displacement_field`` at Config F is
    timed. Checks the K2/K3 launch counts (no uncovered call), the
    flat-field against a numpy float32 version of the formula (rtol 1e-6,
    exact at repaired pixels), the field against ``method="fft"`` on the
    card, the per-frame tracking medians against the known motion
    (<= 0.05 px) and the wavefront against the parabola (relative error
    < 0.15, curvature radius within 10%);
15. files-xst: the corrected XST frames and reference written as float32
    EDF files; ``WavefrontScanPipeline.run_files`` exactly equal to the
    in-memory call on the same arrays, with the same K3 launches;
16. with ``--profile``: the metric step and the tracker of one Config D
    chunk timed apart, then the Config D slice, the single-image sharpness
    call (whole, then group by group), ``spectral_summary`` (Config C) and
    one XST pass under torch.profiler
    (device busy time, device time by op and kernel).

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
path: Config D for K1, with ``launches_sharpness`` and ``launches_files``
(the run from EDF files) beside it; K3 with ``launches_files`` too; for a
standardized K1a row the sharpness path named in its ``path``, for the
B = 8 and template rows the signal phase's, for the rows off the powers of
two the coverage phase's path named in their ``path``), after a line of K1
launches by path. Then, as its last line,
``{"ok": true, "device": {...}}`` for the one card it used. Any failed
phase exits non-zero. Imports nothing of JAX.
"""
from __future__ import annotations

import hashlib
import json
import os
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
# the sharpness slice: the stack call on frames 0..SHARP_T-1 at its default
# chunk and at one that leaves a tail; a through-focus scan of SCAN_T frames
# whose blur (SCAN_SIGMA_STEP px a frame) is zero at frame SCAN_BEST
SHARP_T, SHARP_CHUNK, SHARP_TAIL_CHUNK, SHARP_FRAME_RTOL = 8, 8, 3, 1e-5
SCAN_T, SCAN_BEST, SCAN_SIGMA_STEP = 6, 4, 0.8
# the signal phase: Config C's scan series on frames 0..SUMMARY_T-1 at
# frame_chunk SUMMARY_CHUNK; the scalar trackers on frames 1..T-1 (the kernel
# check takes frame TEMPLATE_FRAME); phase correlation with a PHASE_TPL-px
# template on the PHASE_SIDE^2 stack; one side K1 does not cover beside one
# it does
SUMMARY_T, SUMMARY_CHUNK, TEMPLATE_FRAME = 16, 8, 5
EVEN_TPL, PHASE_TPL = 32, 256
UNCOVERED_SIDE, COVERED_SIDE = 1500, 2048
# the coverage phase: K1 at sides off the powers of two. A 2048-row window
# of a 2560-column sCMOS sensor (PCO.edge / Andor Zyla 5.5 class) for Config
# D's stack call; signal.autocorr2d at MID_SIDE^2; a chunk of WIDE_B frames
# at WIDE_SIDE^2 and one frame at HUGE_SIDE^2, the largest side K1 takes
COV_T, COV_SHAPE, COV_CHUNK = 8, (2048, 2560), 4
MID_SIDE, WIDE_SIDE, WIDE_B, HUGE_SIDE = 1536, 3072, 4, 8192
# PR 8's signal.autocorr2d at 1536^2 on the plain path (ns a pixel, NVIDIA
# H100 80GB HBM3, 700.00 W), the number the kernel path is logged beside
PLAIN_1536_NS_PER_PX = 0.4031
# the preprocess phase: Config E's Wiener PSF, a flat as bench_configs'
# _make_flat builds it (normal(2000, 50), seed 0), RL/UW on PRE_T frames,
# the Brown-Conrady coefficients, register_stack's gates (px)
PSF_SIGMA, FLAT_SEED, PRE_T = 1.5, 0, 8
DISTORTION = dict(k1=0.05, k2=-0.01, p1=0.002, p2=-0.001)
DISTORTION_RTOL, CLAHE_FLIP_FRAC = 1e-6, 1e-3
REG_GATE_PX, REG_PREV_GATE_PX, REG_PREV_SPAN, REG_RESIDUAL_PX = 0.05, 0.08, 5, 0.1
REG_MEAN_GATE_PX = 0.1  # against the blurred mean, as tests/test_registration.py holds it
# Config D's uint16 frames: the JAX package's register_stack reads 0.149 px
# off the spiral on them at 512^2 on the CPU, the port the same
REG_U16_GATE_PX = 0.2
BINNED_ATOL_REL, SUMMARY_FRAME_RTOL = 1e-6, 1e-5
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
    kernel name over REPEATS calls under torch.profiler. A window that comes
    back with no device event (seen once, on a 0.2 ms window), or with a
    kernel recorded a number of times that is not a multiple of REPEATS
    (late in a run the profiler kept 1 or 2 of 10 launches, and their sum
    over REPEATS read below the bound), is taken again, twice at most; after
    that the time of the calls queued back to back (CUDA events) stands in,
    under a name that says so."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPEATS):
                fn()
            torch.cuda.synchronize()
        out: dict = {}
        counts: dict = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.is_user_annotation or not e.self_device_time_total:
                continue
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key).split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / REPEATS / 1e3
            counts[name] = counts.get(name, 0) + e.count
        if out and all(c % REPEATS == 0 for c in counts.values()):
            return out
        log(f"  torch.profiler recorded {counts or 'no device time'} in this window of {REPEATS} calls: "
            "taking it again")
    return {"queued back to back (CUDA events: the profiler lost device events)": queued_ms(torch, fn)}


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


def k1a_row(torch, label: str, F, G, planes: int, s, card: str) -> dict:
    """One K1a layout against its plain version on the same spectra (within
    KERNEL_ATOL_REL of the plain result's max), timed by CUDA events, by
    device time under torch.profiler and queued, beside the plain version,
    the library call (cuFFT's irfft2 of the product formed beforehand) and
    the bound: its kernel-table row."""
    from barc4dip_tpu_torch.ops import cuda_fftp

    H, W = (int(v) for v in s)
    got = cuda_fftp.corr_from_rfft(F, G, s=(H, W))
    want = cuda_fftp.corr_from_rfft_plain(F, G, s=(H, W))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= KERNEL_ATOL_REL * scale:
        raise AssertionError(f"K1a {label} {H}x{W}: max|kernel-plain| {err:.3e} > {KERNEL_ATOL_REL:g}*{scale:.3e}")
    del want
    ms = time_ms(torch, lambda: cuda_fftp.corr_from_rfft(F, G, s=(H, W)))
    plain_ms = time_ms(torch, lambda: cuda_fftp.corr_from_rfft_plain(F, G, s=(H, W)))
    prod = (F if F.dim() == 2 else F[:, None]) * G.conj()
    library_ms = time_ms(torch, lambda: torch.fft.irfft2(prod, s=(H, W)))
    log(f"K1a corr_from_rfft {label} {H}x{W}: max_abs_err {err:.3e} "
        f"(max|plain| {scale:.3e}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library irfft2 {library_ms:.3f} ms; {card}")
    device_ms = log_device_split(torch, "kernel", lambda: cuda_fftp.corr_from_rfft(F, G, s=(H, W)))
    log_device_split(torch, "plain", lambda: cuda_fftp.corr_from_rfft_plain(F, G, s=(H, W)))
    log_device_split(torch, "library", lambda: torch.fft.irfft2(prod, s=(H, W)))
    flops = planes * (6 * F.shape[-2] * F.shape[-1] + fft_flops(H * W))
    return {"name": f"corr_from_rfft {label}" + ("" if (H, W) == (SIDE, SIDE) else f" {H}x{W}"),
            "route": "cuda", "source": "barc4dip_tpu_torch/csrc/fftp_corr.cu",
            "replaces": "barc4dip_tpu/ops/pallas_fftp.py:313",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
            **bound(nbytes(F, G, got), flops), "library_ms": library_ms}


def k1b_row(torch, label: str, args, kw, card: str) -> dict:
    """K1b on the tracker's bank layout against its plain version: finite
    masks equal, maps within KERNEL_ATOL_REL of the plain maps' max, peaks
    equal to the plain path's and to argmax2d of the kernel's own maps;
    timed as :func:`k1a_row`, the library call being cuFFT's irfft2 of the
    products formed beforehand (the NCC epilogue and the peak are not in
    it). Its kernel-table row."""
    from barc4dip_tpu_torch.ops import cuda_fftp
    from barc4dip_tpu_torch.ops.phasecorr import argmax2d

    H, W = kw["s"]
    maps, iy, ix = cuda_fftp.ncc_masked_peaks(*args, **kw)
    pmaps, piy, pix = cuda_fftp.ncc_masked_peaks_plain(*args, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(pmaps)
    if not torch.equal(torch.isfinite(maps), fin):
        raise AssertionError(f"K1b {label} {H}x{W}: finite masks differ")
    err = float((maps[fin] - pmaps[fin]).abs().max())
    scale = float(pmaps[fin].abs().max())
    if not err <= KERNEL_ATOL_REL * scale:
        raise AssertionError(f"K1b {label} {H}x{W}: max|kernel-plain| {err:.3e} > {KERNEL_ATOL_REL:g}*{scale:.3e}")
    ai, aj = argmax2d(maps)
    if not (torch.equal(iy, ai) and torch.equal(ix, aj)):
        raise AssertionError(f"K1b {label} {H}x{W}: kernel peaks differ from argmax2d of its own maps")
    if not (torch.equal(iy, piy) and torch.equal(ix, pix)):
        raise AssertionError(f"K1b {label} {H}x{W}: kernel peaks differ from the plain path's")
    del pmaps, fin
    ms = time_ms(torch, lambda: cuda_fftp.ncc_masked_peaks(*args, **kw))
    plain_ms = time_ms(torch, lambda: cuda_fftp.ncc_masked_peaks_plain(*args, **kw))
    prod = args[0][:, None] * args[1][None].conj()
    library_ms = time_ms(torch, lambda: torch.fft.irfft2(prod, s=(H, W)))
    log(f"K1b ncc_masked_peaks {label} {H}x{W}: max_abs_err {err:.3e} "
        f"(max|plain| {scale:.3e}), peaks equal, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library irfft2 {library_ms:.3f} ms; {card}")
    device_ms = log_device_split(torch, "kernel", lambda: cuda_fftp.ncc_masked_peaks(*args, **kw))
    log_device_split(torch, "plain", lambda: cuda_fftp.ncc_masked_peaks_plain(*args, **kw))
    log_device_split(torch, "library", lambda: torch.fft.irfft2(prod, s=(H, W)))
    planes = prod.shape[0] * prod.shape[1]
    flops = planes * (6 * prod.shape[-2] * prod.shape[-1] + fft_flops(H * W) + 4 * H * W)
    return {"name": f"ncc_masked_peaks {label}" + ("" if (H, W) == (SIDE, SIDE) else f" {H}x{W}"),
            "route": "cuda", "source": "barc4dip_tpu_torch/csrc/fftp_corr.cu",
            "replaces": "barc4dip_tpu/ops/pallas_fftp.py:398",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
            **bound(nbytes(*args, maps, iy, ix), flops), "library_ms": library_ms}


def check_kernels(torch, dev, stack, starts, s, card: str) -> list[dict]:
    """K1a and K1b against their plain versions at the main path's shapes."""
    from barc4dip_tpu_torch.config import upload
    from barc4dip_tpu_torch.metrics.tracking_batch import _extract_tiles
    from barc4dip_tpu_torch.ops import corrcore, ncc

    frames = upload(stack[:max(FRAME_CHUNK, SHARP_T, SUMMARY_CHUNK)], dev)
    H, W = frames.shape[-2:]
    rows = []
    log(f"card state (SM clock, max SM clock, power, temperature): {card_state()}")

    # K1a: the autocorrelation of each frame (corrcore.autocorr2d_core): the
    # batches of mean-removed frames (one image and a chunk of the speckle
    # path, a chunk of spectral_summary_stack), then the sharpness path's of
    # standardized ones (one image, a chunk, a tail chunk and what it leaves
    # over)
    plain_sizes = sorted({1, FRAME_CHUNK, SUMMARY_CHUNK})
    sharp_sizes = sorted({1, SHARP_CHUNK, SHARP_TAIL_CHUNK, SHARP_T % SHARP_TAIL_CHUNK} - {0})
    for nf, standardize in [(n, False) for n in plain_sizes] + [(n, True) for n in sharp_sizes]:
        Fa = torch.fft.rfft2(corrcore._precondition(frames[:nf], True, standardize))
        rows.append(k1a_row(torch, f"B={nf} standardized" if standardize else f"B={nf}", Fa, Fa[:, None], nf,
                            (H, W), card))

    # K1a as template_matching sends it (ncc.ncc_valid): the spectrum of one
    # z-scored frame against one template's zero-padded spectrum, F != G
    y0, x0 = (H - s) // 2, (W - s) // 2
    prep = ncc.zncc_prepare_image(frames[TEMPLATE_FRAME], s, s, eps=1e-9)
    tpl = ncc.prep_template(frames[0, y0 : y0 + s, x0 : x0 + s][None], H, W)
    rows.append(k1a_row(torch, "template B=1", prep["F"], tpl["Ft"], 1, (H, W), card))

    # K1b: the tracker's NCC bank (ncc.ncc_bank_masked_peaks), frame-0
    # templates against later frames
    bank = ncc.prep_template(_extract_tiles(frames[0], starts, s), H, W)
    for nf in (1, FRAME_CHUNK):
        prep = ncc.zncc_prepare_image(frames[FRAME_CHUNK - nf:FRAME_CHUNK], s, s, eps=1e-9)
        var_full = torch.nn.functional.pad(prep["var_sum"], (0, s - 1, 0, s - 1))
        args = (prep["F"], bank["Ft"], var_full, bank["energy"])
        kw = dict(valid_hw=(H - s + 1, W - s + 1), eps=1e-9, s=(H, W))
        rows.append(k1b_row(torch, f"B={9 * nf}", args, kw, card))
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
        if sec in out:
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


def make_phase_stack() -> np.ndarray:
    """The OPT_T x PHASE_SIDE^2 float32 spiral stack of the phase-tracking
    checks (phase correlation does not lock on to Config D's frames)."""
    from barc4dip_tpu_torch.utils import speckle_stack, spiral_motion

    dys, dxs = spiral_motion(OPT_T)
    return speckle_stack(OPT_T, (PHASE_SIDE, PHASE_SIDE), grain_px=PHASE_GRAIN_PX, mean_counts=1000.0,
                         dys=dys, dxs=dxs, seed=np.random.default_rng(SEED), dtype=np.float32)


def run_options(torch, dev, stack, card: str) -> dict:
    """The windowed search, phase tracking and checkpoints on frames
    0..OPT_T-1 (phase on its own stack, see the module docstring)."""
    import tempfile

    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.ops import cuda_fftp

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
    ph = port.speckle_stack_stats(make_phase_stack(), **pk)
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


# -- the sharpness slice --------------------------------------------------------

def make_focus_scan(frame: np.ndarray) -> np.ndarray:
    """A through-focus series on the host: ``frame`` blurred by a Gaussian
    of SCAN_SIGMA_STEP * |t - SCAN_BEST| px, back in the frame's dtype."""
    from scipy import ndimage

    base = frame.astype(np.float32)
    return np.stack([
        frame if t == SCAN_BEST
        else np.rint(ndimage.gaussian_filter(base, SCAN_SIGMA_STEP * abs(t - SCAN_BEST))).astype(frame.dtype)
        for t in range(SCAN_T)
    ])


def run_sharpness(torch, dev, stack, card: str) -> dict:
    """The sharpness API on the card (see the module docstring, phase 9)."""
    import tempfile

    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.models import SharpnessScanPipeline
    from barc4dip_tpu_torch.ops import cuda_fftp

    frame = stack[0]
    H, W = frame.shape
    one_k1a = {"cols": 1, "rows": 1, "rows_ncc": 0}
    res: dict = {}

    # one image, all six groups, 9x9 subtiles
    kw = dict(metrics="all", tiles=True, verbose=False, device=dev)
    port.sharpness_stats(frame, **kw)
    cuda_fftp.reset_counts()
    t0 = time.perf_counter()
    out = port.sharpness_stats(frame, **kw)  # returns host floats: synchronised
    ms = (time.perf_counter() - t0) * 1e3
    launches, plain = dict(cuda_fftp.LAUNCHES), dict(cuda_fftp.PLAIN_BY_SHAPE)
    log(f"sharpness_stats {frame.shape} {frame.dtype}, six groups, 9x9 subtiles: {ms:.2f} ms (counted "
        f"run); K1 launches {json.dumps(launches)}; plain by shape {json.dumps(plain)}; {card}")
    if launches != one_k1a:
        raise AssertionError(f"sharpness_stats launched K1 {launches}: one K1a wanted")
    if not set(plain) <= subtile_plain_keys(H, W):
        raise AssertionError(f"unexpected plain-path shapes {sorted(plain)}")
    if sorted(out["full"]) != sorted(port.metrics.sharpness._ALL_SHARPNESS_GROUPS) or \
            out["meta"]["tile_mode"] != "subtiles_9x9":
        raise AssertionError(f"sharpness_stats: groups {sorted(out['full'])}, mode {out['meta'].get('tile_mode')}")
    res["sharpness_stats"] = launches
    res["single_ms"] = ms

    ref = port.sharpness_stats(frame.astype(np.float64), **kw)
    leaves = metric_leaves(out)
    worst, err, n = compare_leaves(leaves, metric_leaves(ref))
    log(f"sharpness_stats vs float64 run on the card: {n} leaves, max rel err {err:.3e} on {worst} "
        f"(rtol {RTOL:g})")
    if not (n == len(leaves) and err <= RTOL):
        raise AssertionError(f"sharpness_stats float64 check: {n}/{len(leaves)} leaves, {worst} {err:.3e}")

    # the eigenvalues group: subspace iteration at 2048^2 against the dense solve
    from barc4dip_tpu_torch.metrics import eigenvalues

    t0 = time.perf_counter()
    dense = eigenvalues(frame, eig_method="dense", device=dev)
    dense_ms = (time.perf_counter() - t0) * 1e3
    e_err = max(abs(out["full"]["eigenvalues"][k] - v) / abs(v) for k, v in dense.items())
    log(f"eigenvalues: subspace iteration (auto at {H} px) within {e_err:.3e} of eig_method='dense' "
        f"({dense_ms:.1f} ms for that one call; rtol {RTOL:g})")
    if not e_err <= RTOL:
        raise AssertionError(f"eigenvalues: subspace vs dense {e_err:.3e} > {RTOL:g}")

    # Config A of bench_configs.py: the report of the call at its defaults
    port.logbook_report(port.sharpness_stats(frame, verbose=False, device=dev))
    cuda_fftp.reset_counts()
    t0 = time.perf_counter()
    report = port.logbook_report(port.sharpness_stats(frame, verbose=False, device=dev))
    a_ms = (time.perf_counter() - t0) * 1e3
    res["config A"] = dict(cuda_fftp.LAUNCHES)
    log(f"Config A logbook_report(sharpness_stats(frame)): {a_ms:.2f} ms (counted run), report of "
        f"{len(report.splitlines())} lines; K1 launches {json.dumps(res['config A'])}; {card}")
    if res["config A"] != one_k1a or len(report.splitlines()) < 10 or "harpness" not in report:
        raise AssertionError(f"Config A: launches {res['config A']}, report {report[:200]!r}")
    res["config_a_ms"] = a_ms

    # the stack call: numpy and CUDA-tensor stacks, two chunk sizes, checkpoints
    sub = stack[:SHARP_T]
    st = torch.from_numpy(sub).to(dev)
    skw = dict(metrics="all", tiles=True, verbose=False)

    def counted(source, chunk, **extra):
        cuda_fftp.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = port.sharpness_stack_stats(source, frame_chunk=chunk, **skw, **extra)
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0, dict(cuda_fftp.LAUNCHES), dict(cuda_fftp.PLAIN_BY_SHAPE)

    def want_chunks(chunk):
        n = -(-SHARP_T // chunk)
        return {"cols": n, "rows": n, "rows_ncc": 0}

    with tempfile.TemporaryDirectory() as tmp:
        first, _, _, _ = counted(sub, SHARP_CHUNK, device=dev, checkpoint_dir=tmp)  # also the warm-up
        n_files = len(list(Path(tmp).glob("*.npz")))
        host, host_s, launches, plain = counted(sub, SHARP_CHUNK, device=dev)
        resumed, _, ck_launches, _ = counted(sub, SHARP_CHUNK, device=dev, checkpoint_dir=tmp)
    mp = SHARP_T * H * W / 1e6
    log(f"sharpness_stack_stats {sub.shape} {sub.dtype}, frame_chunk {SHARP_CHUNK}: counted run "
        f"{host_s:.3f} s = {SHARP_T / host_s:.2f} frames/s = {mp / host_s:.2f} MP/s; K1 launches "
        f"{json.dumps(launches)}; plain by shape {json.dumps(plain)}; {card}")
    if launches != want_chunks(SHARP_CHUNK) or not set(plain) <= subtile_plain_keys(H, W):
        raise AssertionError(f"sharpness stack: K1 launches {launches}, plain {sorted(plain)}")
    res["sharpness stack"] = launches
    res["stack_s"] = host_s
    for sec, shape in (("full", (SHARP_T,)), ("tiles", (SHARP_T, 3, 3))):
        for path, leaf in _data_leaves({sec: host[sec]}).items():
            if leaf.shape != shape or (sec == "full" and not np.isfinite(leaf).all()):
                raise AssertionError(f"sharpness stack {path}: shape {leaf.shape} or non-finite values")
    worst, d = max_leaf_diff(resumed, first)
    worst2, d2 = max_leaf_diff(host, first)
    log(f"checkpoint: {n_files} chunk files; the resumed run launched K1 {json.dumps(ck_launches)} and "
        f"differs from the first by {d:.3e} (worst {worst}); the run without a checkpoint by {d2:.3e}")
    if n_files != -(-SHARP_T // SHARP_CHUNK) or any(ck_launches.values()) or d != 0.0 or d2 != 0.0:
        raise AssertionError(f"sharpness checkpoint: {n_files} files, launches {ck_launches}, diffs {d:.3e} {d2:.3e}")
    res["sharpness checkpoint resumed"] = ck_launches

    tail, tail_s, tail_launches, _ = counted(sub, SHARP_TAIL_CHUNK, device=dev)
    dev_out, dev_s, dev_launches, _ = counted(st, SHARP_CHUNK)
    dev_tail, _, dev_tail_launches, _ = counted(st, SHARP_TAIL_CHUNK)
    worst, d = max_leaf_diff(dev_out, host)
    worst_t, d_t = max_leaf_diff(dev_tail, tail)
    log(f"frame_chunk {SHARP_TAIL_CHUNK} (a tail of {SHARP_T % SHARP_TAIL_CHUNK}): {tail_s:.3f} s, K1 launches "
        f"{json.dumps(tail_launches)}; the stack as a CUDA tensor: {dev_s:.3f} s = {mp / dev_s:.2f} MP/s, "
        f"K1 launches {json.dumps(dev_launches)} / {json.dumps(dev_tail_launches)}; tensor vs numpy "
        f"stack max |diff| {d:.3e} (worst {worst}) / {d_t:.3e} (worst {worst_t}); {card}")
    if tail_launches != want_chunks(SHARP_TAIL_CHUNK) or dev_launches != want_chunks(SHARP_CHUNK) \
            or dev_tail_launches != want_chunks(SHARP_TAIL_CHUNK):
        raise AssertionError(f"sharpness stack launches: {tail_launches} {dev_launches} {dev_tail_launches}")
    if d != 0.0 or d_t != 0.0:
        raise AssertionError(f"tensor stack differs from the numpy stack: {worst} {d:.3e}, {worst_t} {d_t:.3e}")
    res[f"sharpness stack chunk {SHARP_TAIL_CHUNK}"] = tail_launches
    res["sharpness stack resident"] = dev_launches
    res["resident_s"] = dev_s
    # every frame of the stack runs against its own single-image call
    singles = [leaves] + [metric_leaves(port.sharpness_stats(sub[t], **kw)) for t in range(1, SHARP_T)]
    per_frame = {k: np.stack([one[k] for one in singles]) for k in leaves}
    for label, run in ((f"chunk {SHARP_CHUNK}", host), (f"chunk {SHARP_TAIL_CHUNK}", tail)):
        worst, err, n = compare_leaves(metric_leaves(run, SHARP_T), per_frame)
        log(f"frames 0-{SHARP_T - 1} of the stack call ({label}) vs {SHARP_T} single-image calls: {n} "
            f"leaves, max rel err {err:.3e} on {worst} (rtol {SHARP_FRAME_RTOL:g}: float32 sums over "
            f"another batch shape)")
        if not (n == len(leaves) and err <= SHARP_FRAME_RTOL):
            raise AssertionError(f"stack frames vs single-image calls ({label}): {worst} {err:.3e}")

    # the focus scan at the pipeline's defaults
    scan = make_focus_scan(frame)
    pipe = SharpnessScanPipeline()
    pipe(scan)
    cuda_fftp.reset_counts()
    t0 = time.perf_counter()
    focus = pipe(scan)
    scan_s = time.perf_counter() - t0
    res["sharpness scan"] = dict(cuda_fftp.LAUNCHES)
    series = focus["full"]["gradient"]["tenengrad"]
    log(f"SharpnessScanPipeline (gradient,laplacian; focus gradient.tenengrad) on {scan.shape} "
        f"{scan.dtype}: {scan_s:.3f} s = {SCAN_T / scan_s:.2f} frames/s; best_frame "
        f"{focus['meta']['focus']['best_frame']} (blur zero at {SCAN_BEST}); tenengrad "
        f"{np.array2string(series, precision=4)}; K1 launches {json.dumps(res['sharpness scan'])}; {card}")
    if focus["meta"]["focus"]["best_frame"] != SCAN_BEST or any(res["sharpness scan"].values()):
        raise AssertionError(f"focus scan: {focus['meta']['focus']}, launches {res['sharpness scan']}")
    res["scan_s"] = scan_s
    res["scan"] = scan
    return res


def profile_sharpness(torch, dev, stack) -> None:
    """The single-image sharpness call under torch.profiler: whole, then
    each group alone (full frame plus tiles): wall time and device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import barc4dip_tpu_torch as port

    frame = stack[0]
    kw = dict(tiles=True, verbose=False, device=dev)
    port.sharpness_stats(frame, **kw)
    profiled(torch, "sharpness_stats (six groups, 9x9 subtiles)", lambda: port.sharpness_stats(frame, **kw))
    for group in ("stats", "gradient", "laplacian", "spectral", "autocorrelation", "eigenvalues"):
        port.sharpness_stats(frame, metrics=group, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            port.sharpness_stats(frame, metrics=group, **kw)
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        log(f"  sharpness group {group}: wall {wall * 1e3:.2f} ms (profiler on), device busy "
            f"{sum(e.self_device_time_total for e in kernels) / 1e3:.2f} ms in "
            f"{sum(e.count for e in kernels)} kernels and copies")


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


# -- the signal layer and the metric extensions ---------------------------------

def host_ms(torch, fn, repeats: int = 3) -> float:
    """Least host-clock time (ms) of ``repeats`` synchronised calls."""
    best = np.inf
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return float(best)


def run_signal(torch, dev, stack, s: int, card: str) -> dict:
    """The signal layer and the metric extensions on the card (see the
    module docstring, phase 11). Every call runs twice; the second is
    counted."""
    from scipy import ndimage

    from barc4dip_tpu_torch import maths, metrics, signal
    from barc4dip_tpu_torch.metrics import frc as frc_mod
    from barc4dip_tpu_torch.metrics import maps as maps_mod
    from barc4dip_tpu_torch.metrics import perceptual
    from barc4dip_tpu_torch.ops import cuda_fftp, upsampled_dft
    from barc4dip_tpu_torch.signal import tracking
    from barc4dip_tpu_torch.utils import spiral_motion

    frame = stack[0]
    H, W = frame.shape
    none, one_k1a = {"cols": 0, "rows": 0, "rows_ncc": 0}, {"cols": 1, "rows": 1, "rows_ncc": 0}
    res: dict = {}
    plain_seen: dict = {}

    def counted(fn):
        """(result, ms, K1 launches) of the second of two calls."""
        fn()
        cuda_fftp.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in cuda_fftp.PLAIN_BY_SHAPE.items():
            plain_seen[k] = plain_seen.get(k, 0) + v
        return out, ms, dict(cuda_fftp.LAUNCHES)

    def want(label, launches, expected):
        if launches != expected:
            raise AssertionError(f"{label} launched K1 {launches}: {expected} wanted")

    # Config C: the quick-look in one call, against float64 and the composed calls
    summ, c_ms, launches = counted(lambda: signal.spectral_summary(frame, device=dev))
    want("spectral_summary", launches, one_k1a)
    res["spectral_summary"] = launches
    res["config_c_ms"] = c_ms
    ref = signal.spectral_summary(frame.astype(np.float64), device=dev)
    errs = {k: leaf_rel_err(summ[k].cpu().numpy() if k in ("psd", "autocorr") else summ[k],
                            ref[k].cpu().numpy() if k in ("psd", "autocorr") else ref[k])
            for k in ("psd", "autocorr", "radial_binned", "radial_interpolated")}
    log(f"Config C spectral_summary {frame.shape} {frame.dtype}: {c_ms:.2f} ms (counted run); K1 launches "
        f"{json.dumps(launches)}; vs float64 run on the card, rel err of each output's peak: "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} (rtol {RTOL:g}); {card}")
    if not max(errs.values()) <= RTOL:
        raise AssertionError(f"spectral_summary float64 check: {errs}")
    log_device_split(torch, "spectral_summary", lambda: signal.spectral_summary(frame, device=dev))

    def composed():
        P, _, _ = signal.psd2d(frame, device=dev)
        ac, _, _ = signal.autocorr2d(frame, device=dev)
        rb, _ = maths.radial_mean_binned(ac)
        ri, _ = maths.radial_mean_interpolated(ac)
        return P, ac, rb.cpu().numpy(), ri.cpu().numpy()

    (P, ac, rb, ri), comp_ms, launches = counted(composed)
    want("the composed calls", launches, one_k1a)
    res["psd2d + autocorr2d + radial means"] = launches
    binned_err = leaf_rel_err(summ["radial_binned"], rb)
    log(f"composed psd2d + autocorr2d + radial_mean_binned + radial_mean_interpolated (maps left on the "
        f"device): {comp_ms:.2f} ms; maps and interpolated curve equal to spectral_summary's: "
        f"{torch.equal(P, summ['psd'])}, {torch.equal(ac, summ['autocorr'])}, "
        f"{np.array_equal(ri, summ['radial_interpolated'])}; binned curve (atomic ring sums) within "
        f"{binned_err:.3e} of its peak (gate {BINNED_ATOL_REL:g}); {card}")
    if not (torch.equal(P, summ["psd"]) and torch.equal(ac, summ["autocorr"])
            and np.array_equal(ri, summ["radial_interpolated"]) and binned_err <= BINNED_ATOL_REL):
        raise AssertionError("spectral_summary differs from the composed calls")

    # the maps to the host: whole, half (mirrored on the host), half as 16-bit codes
    for name, dmap in (("psd", summ["psd"]), ("autocorr", summ["autocorr"])):
        whole = dmap.cpu().numpy()
        span, peak = float(whole.max() - whole.min()), float(np.abs(whole).max())
        half_rows, eps32 = H // 2 + 1, float(np.finfo(np.float32).eps)
        modes = {
            "whole .cpu()": (lambda: dmap.cpu().numpy(), whole.nbytes, 0.0),
            "half": (lambda: signal.pull_centrosymmetric(dmap), half_rows * W * 4, 200 * eps32 * peak),
            # half a code, and the float32 arithmetic that decodes it on the host
            "half u16": (lambda: signal.pull_centrosymmetric(dmap, quantize="u16"), half_rows * W * 2 + 8,
                         span / (2 * 65535) * 1.001 + 8 * eps32 * peak),
        }
        parts = []
        for mode, (fn, moved, gate) in modes.items():
            err = float(np.abs(fn().astype(np.float64) - whole).max())
            ms = host_ms(torch, fn)
            parts.append(f"{mode} {ms:.2f} ms, {moved} bytes, max abs err {err:.3e} (gate {gate:.3e})")
            res[f"pull_{name}_{mode.split()[-1]}_ms"] = ms
            if not err <= gate:
                raise AssertionError(f"pull of the {name} map, {mode}: max abs err {err:.3e} > {gate:.3e}")
        log(f"{name} map {whole.shape} to the host (peak {peak:.3e}, range {span:.3e}): " + "; ".join(parts)
            + f"; {card}")

    # the scan series: radial curves of SUMMARY_T frames at frame_chunk SUMMARY_CHUNK
    sub = stack[:SUMMARY_T]
    st = torch.from_numpy(sub).to(dev)
    chunks = -(-SUMMARY_T // SUMMARY_CHUNK)
    per_chunk = {"cols": chunks, "rows": chunks, "rows_ncc": 0}
    host, host_series_ms, launches = counted(
        lambda: signal.spectral_summary_stack(sub, frame_chunk=SUMMARY_CHUNK, device=dev))
    want("spectral_summary_stack", launches, per_chunk)
    res["spectral_summary_stack"] = launches
    resident, dev_series_ms, launches = counted(lambda: signal.spectral_summary_stack(st, frame_chunk=SUMMARY_CHUNK))
    want("spectral_summary_stack on a CUDA tensor", launches, per_chunk)
    res["spectral_summary_stack resident"] = launches
    res["series_ms_per_frame"], res["series_resident_ms_per_frame"] = host_series_ms / SUMMARY_T, dev_series_ms / SUMMARY_T
    same_i = np.array_equal(host["radial_interpolated"], resident["radial_interpolated"])
    b_err = leaf_rel_err(host["radial_binned"], resident["radial_binned"])
    f0 = max(leaf_rel_err(host[k][0], summ[k]) for k in ("radial_binned", "radial_interpolated"))
    log(f"spectral_summary_stack {sub.shape} {sub.dtype}, frame_chunk {SUMMARY_CHUNK}: "
        f"{host_series_ms / SUMMARY_T:.2f} ms a frame from a numpy stack, {dev_series_ms / SUMMARY_T:.2f} ms a "
        f"frame from a CUDA tensor; K1 launches {json.dumps(launches)}; numpy vs tensor: interpolated curves "
        f"equal {same_i}, binned within {b_err:.3e} (gate {BINNED_ATOL_REL:g}); frame 0 vs the single-image "
        f"call {f0:.3e} (gate {SUMMARY_FRAME_RTOL:g}); {card}")
    if not (same_i and b_err <= BINNED_ATOL_REL and f0 <= SUMMARY_FRAME_RTOL
            and host["radial_binned"].shape == (SUMMARY_T, H // 2 + 1) and np.isfinite(host["radial_interpolated"]).all()):
        raise AssertionError(f"spectral_summary_stack: equal {same_i}, binned {b_err:.3e}, frame 0 {f0:.3e}")

    # the scalar trackers against the spiral
    dys, dxs = spiral_motion(stack.shape[0])
    y0, x0 = (H - s) // 2, (W - s) // 2
    tpl = frame[y0 : y0 + s, x0 : x0 + s]
    e0 = (H - EVEN_TPL) // 2
    tpl_even = frame[e0 : e0 + EVEN_TPL, e0 : e0 + EVEN_TPL]
    for label, template in ((f"{s}-px", tpl), (f"{EVEN_TPL}-px (even)", tpl_even)):
        worst, times = 0.0, []
        for k in range(1, stack.shape[0]):
            got, ms, launches = counted(lambda: signal.template_matching(template, stack[k], device=dev))
            want(f"template_matching {label}", launches, one_k1a)
            worst = max(worst, float(np.hypot(got[0] - dys[k], got[1] - dxs[k])))
            times.append(ms)
        log(f"template_matching, frame 0's centre {label} ROI in frames 1-{stack.shape[0] - 1}: max |shift - "
            f"spiral| {worst:.4f} px (gate {TRACK_GATE_PX} px), median {np.median(times):.2f} ms a call, K1 "
            f"launches a call {json.dumps(launches)}; last (dy, dx, peak, snr) "
            f"{tuple(float(f'{v:.4f}') for v in got)}; {card}")
        if not worst <= TRACK_GATE_PX:
            raise AssertionError(f"template_matching {label}: {worst:.4f} px > {TRACK_GATE_PX} px")
        res[f"template_{label.split('-')[0]}_ms"] = float(np.median(times))
    res["template_matching"] = launches
    k = TEMPLATE_FRAME
    via, ms, launches = counted(lambda: signal.track_translation(tpl, stack[k], method="template", device=dev))
    direct = signal.template_matching(tpl, stack[k], backend="internal", device=dev)
    want("track_translation(method='template')", launches, one_k1a)
    res["track_translation template"] = launches
    log(f"track_translation(method='template') on frame {k}: {via} in {ms:.2f} ms, equal to "
        f"template_matching: {via == direct}; K1 launches {json.dumps(launches)}")
    if via != direct:
        raise AssertionError(f"track_translation {via} != template_matching {direct}")

    pst = make_phase_stack()
    p0 = (PHASE_SIDE - PHASE_TPL) // 2
    ptpl = pst[0, p0 : p0 + PHASE_TPL, p0 : p0 + PHASE_TPL]
    pdys, pdxs = spiral_motion(OPT_T)
    for backend in ("internal", "skimage"):
        worst, times = 0.0, []
        for k in range(1, OPT_T):
            got, ms, launches = counted(lambda: signal.phase_correlation(ptpl, pst[k], backend=backend, device=dev))
            want(f"phase_correlation {backend}", launches, none)
            worst = max(worst, float(np.hypot(got[0] - pdys[k], got[1] - pdxs[k])))
            times.append(ms)
        log(f"phase_correlation backend={backend!r}, {PHASE_TPL}-px template on {OPT_T - 1} x {PHASE_SIDE}^2 "
            f"float32 frames: max |shift - spiral| {worst:.4f} px (gate {PHASE_GATE_PX} px), median "
            f"{np.median(times):.2f} ms a call, no K1 launch; last {got}; {card}")
        if not worst <= PHASE_GATE_PX or np.isnan(got[2]) != (backend == "skimage"):
            raise AssertionError(f"phase_correlation {backend}: {worst:.4f} px, peak {got[2]}")
        res[f"phase_{backend}_ms"] = float(np.median(times))
    res["phase_correlation"] = launches

    # the upsampled DFT's two complex products (cuBLAS): complex64 against complex128
    img_z, tpl_pad = tracking._embedded_pair(torch.from_numpy(pst[OPT_T - 1]).to(dev), torch.from_numpy(ptpl).to(dev),
                                             tracking._centered_slices(PHASE_SIDE, PHASE_SIDE, PHASE_TPL, PHASE_TPL), 1e-9)
    prod = torch.fft.fft2(img_z) * torch.fft.fft2(tpl_pad).conj()
    prod = prod / torch.clamp_min(prod.abs(), 100 * torch.finfo(torch.float32).eps)
    offsets = torch.tensor([7.0 - 10 * pdys[OPT_T - 1], 7.0 - 10 * pdxs[OPT_T - 1]], device=dev)
    up64 = upsampled_dft.upsampled_dft(prod.conj(), 15, 10, offsets.float())
    up128 = upsampled_dft.upsampled_dft(prod.conj().to(torch.complex128), 15, 10, offsets.double())
    up_err = float((up64 - up128).abs().max() / up128.abs().max())
    log(f"upsampled_dft (two complex matrix products, {PHASE_SIDE}^2 -> 15x15): complex64 within {up_err:.3e} "
        f"of complex128 on the card, relative to the peak (gate {RTOL:g}: TF32 would lose it)")
    if not (up64.dtype == torch.complex64 and up_err <= RTOL):
        raise AssertionError(f"upsampled_dft complex64 vs complex128: {up_err:.3e}")

    # the metric extensions
    vis, vis_ms, launches = counted(lambda: metrics.visibility_map(frame, window=16, device=dev))
    want("visibility_map", launches, none)
    vis64 = maps_mod._visibility_frames(torch.from_numpy(frame.astype(np.float64)).to(dev)[None], 16, 1)[0]
    vis_err = float(np.nanmax(np.abs(vis / vis64.cpu().numpy() - 1.0)))
    _, vstack_ms, _ = counted(lambda: metrics.visibility_map(sub, window=16, stride=4, frame_chunk=SUMMARY_CHUNK, device=dev))
    log(f"visibility_map window 16: {vis.shape} map of frame 0 in {vis_ms:.2f} ms, max rel err {vis_err:.3e} vs "
        f"float64 on the card (gate {RTOL:g}); {SUMMARY_T}-frame stack at stride 4: {vstack_ms / SUMMARY_T:.2f} ms "
        f"a frame; {card}")
    if not (vis.shape == (H - 15, W - 15) and np.isfinite(vis).all() and vis_err <= RTOL):
        raise AssertionError(f"visibility_map: shape {vis.shape}, rel err {vis_err:.3e}")
    res["visibility_ms"], res["visibility_stack_ms_per_frame"] = vis_ms, vstack_ms / SUMMARY_T

    rng = np.random.default_rng(SEED + 2)
    base = frame.astype(np.float32)
    a = base + rng.normal(scale=0.05 * MEAN_COUNTS, size=frame.shape).astype(np.float32)
    b = base + rng.normal(scale=0.05 * MEAN_COUNTS, size=frame.shape).astype(np.float32)
    frc, frc_ms, launches = counted(lambda: metrics.fourier_ring_correlation(a, b, device=dev))
    want("fourier_ring_correlation", launches, none)
    ta, tb = (torch.from_numpy(v.astype(np.float64)).to(dev) for v in (a, b))
    ref_curve = frc_mod._frc_curve(ta - ta.mean(), tb - tb.mean(), complex_dtype=torch.complex128).cpu().numpy()
    frc_err = float(np.abs(frc["frc"][1:] - ref_curve[1:]).max())  # ring 0 is the mean-removed DC bin alone
    log(f"fourier_ring_correlation of frame 0 + two noise draws: {frc_ms:.2f} ms; curve within {frc_err:.3e} of a "
        f"complex128 evaluation on the card (gate {RTOL:g}, rings 1-{len(ref_curve) - 1}); resolution "
        f"{frc['resolution_cyc_per_px']:.5f} cycles/px = {frc['resolution_px']:.3f} px; {card}")
    if not (frc_err <= RTOL and np.isfinite(frc["resolution_px"])):
        raise AssertionError(f"FRC: curve {frc_err:.3e}, resolution {frc['resolution_px']}")
    res["frc_ms"] = frc_ms

    blurred = ndimage.gaussian_filter(base, 1.5)
    parts = []
    for name, fn in (("psnr", perceptual.psnr), ("ssim", perceptual.ssim), ("ms_ssim", perceptual.ms_ssim)):
        val, ms, launches = counted(lambda: fn(blurred, base, device=dev))
        want(name, launches, none)
        val64 = fn(blurred.astype(np.float64), base.astype(np.float64), device=dev)
        err = abs(val - val64) / abs(val64)
        parts.append(f"{name} {val:.6f} in {ms:.2f} ms (float64 {val64:.6f}, rel err {err:.2e})")
        if not err <= RTOL:
            raise AssertionError(f"{name}: {val} vs float64 {val64}")
        res[f"{name}_ms"] = ms
    log(f"frame 0 blurred (sigma 1.5 px) against frame 0, gate {RTOL:g}: " + "; ".join(parts) + f"; {card}")

    # one side K1 does not cover, beside one it does
    if plain_seen:
        raise AssertionError(f"the signal phase took the plain path for {plain_seen} before the uncovered side")
    c0 = (H - UNCOVERED_SIDE) // 2
    crop = torch.from_numpy(frame[c0 : c0 + UNCOVERED_SIDE, c0 : c0 + UNCOVERED_SIDE].copy()).to(dev)
    (ac_u, _, _), _, launches = counted(lambda: signal.autocorr2d(crop))
    key = f"corr:{UNCOVERED_SIDE}x{UNCOVERED_SIDE}:complex64"
    want(f"autocorr2d at {UNCOVERED_SIDE}^2", launches, none)
    if plain_seen != {key: 1}:
        raise AssertionError(f"autocorr2d at {UNCOVERED_SIDE}^2: plain by shape {plain_seen}, {{{key!r}: 1}} wanted")
    res[f"autocorr2d {UNCOVERED_SIDE}"] = launches
    u_err = leaf_rel_err(ac_u.cpu().numpy(), signal.autocorr2d(crop.double())[0].cpu().numpy())
    full = torch.from_numpy(frame).to(dev)
    u_ms = time_ms(torch, lambda: signal.autocorr2d(crop))
    k_ms = time_ms(torch, lambda: signal.autocorr2d(full))
    res["autocorr2d_uncovered_ms"], res["autocorr2d_covered_ms"] = u_ms, k_ms
    log(f"signal.autocorr2d of a CUDA tensor, CUDA events, median of {REPEATS}: {UNCOVERED_SIDE}^2 (plain path, "
        f"counted as {key}, max rel err {u_err:.3e} vs float64) {u_ms:.3f} ms = "
        f"{u_ms / UNCOVERED_SIDE**2 * 1e6:.4f} ns a pixel; {COVERED_SIDE}^2 (K1a) {k_ms:.3f} ms = "
        f"{k_ms / COVERED_SIDE**2 * 1e6:.4f} ns a pixel; {card}")
    if not u_err <= RTOL:
        raise AssertionError(f"autocorr2d at {UNCOVERED_SIDE}^2 vs float64: {u_err:.3e}")
    return res


def device_speckle(torch, dev, n: int, h: int, w: int, seed: int):
    """n (h, w) float32 speckle frames made on the card (|filtered complex
    noise|^2, grain GRAIN_PX, mean MEAN_COUNTS): data for the sides no
    host-made stack has."""
    import math

    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.complex(torch.randn((n, h, w), generator=g, device=dev),
                          torch.randn((n, h, w), generator=g, device=dev))
    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.fftfreq(w, device=dev)[None, :]
    field = torch.fft.ifft2(noise * torch.exp(-((fy**2 + fx**2) * (math.pi * GRAIN_PX) ** 2))).abs() ** 2
    return (field / field.mean(dim=(-2, -1), keepdim=True) * MEAN_COUNTS).float()


def make_coverage_data() -> dict:
    """The coverage phase's stack (COV_T frames of COV_SHAPE uint16, the
    spiral motion, seed SEED) and its tracking grid."""
    from barc4dip_tpu_torch.metrics.speckles import tracking_grid_from_frame0
    from barc4dip_tpu_torch.metrics.tracking_batch import _grid_geometry
    from barc4dip_tpu_torch.utils import speckle_stack, spiral_motion

    dys, dxs = spiral_motion(COV_T)
    stack = speckle_stack(COV_T, COV_SHAPE, grain_px=GRAIN_PX, mean_counts=MEAN_COUNTS, dys=dys, dxs=dxs,
                          seed=np.random.default_rng(SEED), dtype=np.uint16)
    grid, _labels, roi_side, step, _g0 = tracking_grid_from_frame0(stack)
    starts, _, s = _grid_geometry(grid)
    return {"stack": stack, "starts": starts, "s": s, "roi_side": roi_side, "step": step}


def check_kernels_sides(torch, dev, stack, cov: dict, card: str) -> list[dict]:
    """K1 at sides off the powers of two, against the plain versions: K1a
    B=1 at MID_SIDE^2 (frame 0's centre crop, ``signal.autocorr2d``'s
    layout), B=WIDE_B at WIDE_SIDE^2 (a ``spectral_summary_stack`` chunk),
    B=1 at HUGE_SIDE^2; K1b's 9-template bank on the coverage stack. Each
    row names the coverage path whose counted run gives its launches."""
    from barc4dip_tpu_torch.config import upload
    from barc4dip_tpu_torch.metrics.tracking_batch import _extract_tiles
    from barc4dip_tpu_torch.ops import corrcore, ncc

    rows = []
    log(f"card state (SM clock, max SM clock, power, temperature): {card_state()}")
    c0 = (SIDE - MID_SIDE) // 2
    crop = upload(stack[:1, c0 : c0 + MID_SIDE, c0 : c0 + MID_SIDE], dev)
    F = torch.fft.rfft2(corrcore._precondition(crop, True, False))
    rows.append({**k1a_row(torch, "B=1", F, F[:, None], 1, (MID_SIDE, MID_SIDE), card),
                 "path": f"autocorr2d {MID_SIDE}"})
    for nf, side, path in ((WIDE_B, WIDE_SIDE, f"spectral_summary_stack {WIDE_SIDE}"),
                           (1, HUGE_SIDE, f"autocorr2d {HUGE_SIDE}")):
        F = torch.fft.rfft2(corrcore._precondition(device_speckle(torch, dev, nf, side, side, SEED + side), True, False))
        rows.append({**k1a_row(torch, f"B={nf}", F, F[:, None], nf, (side, side), card), "path": path})
        del F
        torch.cuda.empty_cache()

    frames = upload(cov["stack"][:2], dev)
    H, W = frames.shape[-2:]
    s = cov["s"]
    bank = ncc.prep_template(_extract_tiles(frames[0], cov["starts"], s), H, W)
    prep = ncc.zncc_prepare_image(frames[1:2], s, s, eps=1e-9)
    var_full = torch.nn.functional.pad(prep["var_sum"], (0, s - 1, 0, s - 1))
    args = (prep["F"], bank["Ft"], var_full, bank["energy"])
    kw = dict(valid_hw=(H - s + 1, W - s + 1), eps=1e-9, s=(H, W))
    rows.append({**k1b_row(torch, "B=9", args, kw, card), "path": "coverage stack"})
    log(f"card state (SM clock, max SM clock, power, temperature): {card_state()}")
    return rows


def _key_shape(key: str) -> tuple[int, int]:
    """(H, W) of a ``PLAIN_BY_SHAPE`` key "kind:HxW:dtype"."""
    h, w = key.split(":")[1].split("x")
    return int(h), int(w)


def refused_by_both(plain: dict) -> None:
    """Every plain-path key names a shape the TPU gate refuses too."""
    from barc4dip_tpu_torch.ops import cuda_fftp

    covered = sorted(k for k in plain if cuda_fftp.supported(_key_shape(k)) and k.endswith(":complex64"))
    if covered:
        raise AssertionError(f"K1 covers {covered} but they took the plain path")


def run_coverage(torch, dev, cov: dict, card: str) -> dict:
    """K1 at the sides the TPU kernel takes beyond the powers of two (see
    the module docstring, phase 4a). Every call runs twice; the second is
    counted."""
    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch import signal
    from barc4dip_tpu_torch.ops import cuda_fftp

    cst = cov["stack"]
    T, H, W = cst.shape
    kw = dict(metrics="all", tiles=True, frame_chunk=COV_CHUNK, verbose=False, device=dev)
    port.speckle_stack_stats(cst, **kw)
    cuda_fftp.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = port.speckle_stack_stats(cst, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, plain = dict(cuda_fftp.LAUNCHES), dict(cuda_fftp.PLAIN_BY_SHAPE)
    chunks = -(-T // COV_CHUNK)
    log(f"coverage: speckle_stack_stats {cst.shape} {cst.dtype} (Config D settings, frame_chunk {COV_CHUNK}): "
        f"counted run {secs:.3f} s = {T * H * W / 1e6 / secs:.2f} MP/s; K1 launches {json.dumps(launches)}; "
        f"plain by shape {json.dumps(plain)}; {card}")
    want = {"cols": 3 * chunks, "rows": chunks, "rows_ncc": 2 * chunks}
    if launches != want:
        raise AssertionError(f"coverage stack: K1 launches {launches} != {want}")
    refused_by_both(plain)
    if not set(plain) <= subtile_plain_keys(H, W):
        raise AssertionError(f"coverage stack: unexpected plain-path shapes {sorted(plain)}")
    err = spiral_error(out)
    if not err <= TRACK_GATE_PX:
        raise AssertionError(f"coverage stack: tracking error {err:.4f} px > {TRACK_GATE_PX} px")
    run = metric_leaves(out, GOLDEN_K)
    ref = metric_leaves(port.speckle_stack_stats(cst[:GOLDEN_K].astype(np.float64), **kw), GOLDEN_K)
    worst, verr, n = compare_leaves(run, ref)
    log(f"coverage stack: tracking max |abs - spiral| {err:.4f} px (gate {TRACK_GATE_PX}); frames 0-{GOLDEN_K - 1} "
        f"vs a float64 run on the card: {n} leaves (the maps among them), max rel err {verr:.3e} on {worst} "
        f"(rtol {RTOL:g})")
    if not verr <= RTOL:
        raise AssertionError(f"coverage stack float64 check: {worst} {verr:.3e}")
    res = {"coverage stack": launches}

    one_k1a = {"cols": 1, "rows": 1, "rows_ncc": 0}

    def counted(label, fn):
        fn()
        cuda_fftp.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got, seen = dict(cuda_fftp.LAUNCHES), dict(cuda_fftp.PLAIN_BY_SHAPE)
        if got != one_k1a or seen:
            raise AssertionError(f"{label}: K1 launches {got}, plain by shape {seen}; one K1a and no plain call wanted")
        res[label] = got
        return out

    frame = cst[0]
    c0 = (SIDE - MID_SIDE) // 2
    crop = torch.from_numpy(np.ascontiguousarray(frame[c0 : c0 + MID_SIDE, c0 : c0 + MID_SIDE])).to(dev)
    ac = counted(f"autocorr2d {MID_SIDE}", lambda: signal.autocorr2d(crop))[0]
    a_err = leaf_rel_err(ac.cpu().numpy(), signal.autocorr2d(crop.double())[0].cpu().numpy())
    full = torch.from_numpy(np.ascontiguousarray(frame[:, :SIDE])).to(dev)
    m_ms = time_ms(torch, lambda: signal.autocorr2d(crop))
    k_ms = time_ms(torch, lambda: signal.autocorr2d(full))
    res["autocorr2d_1536_ms"], res["autocorr2d_2048_ms"] = m_ms, k_ms
    log(f"signal.autocorr2d of a CUDA tensor, CUDA events, median of {REPEATS}: {MID_SIDE}^2 (K1a, max rel err "
        f"{a_err:.3e} vs float64) {m_ms:.3f} ms = {m_ms / MID_SIDE**2 * 1e6:.4f} ns a pixel (the plain path read "
        f"{PLAIN_1536_NS_PER_PX} ns a pixel, PR 8); {SIDE}^2 {k_ms:.3f} ms = {k_ms / SIDE**2 * 1e6:.4f} ns a pixel; "
        f"{card}")
    if not a_err <= RTOL:
        raise AssertionError(f"autocorr2d at {MID_SIDE}^2 vs float64: {a_err:.3e}")

    wide = device_speckle(torch, dev, WIDE_B, WIDE_SIDE, WIDE_SIDE, SEED + WIDE_SIDE)
    summ = counted(f"spectral_summary_stack {WIDE_SIDE}",
                   lambda: signal.spectral_summary_stack(wide, frame_chunk=WIDE_B))
    w_ms = time_ms(torch, lambda: signal.spectral_summary_stack(wide, frame_chunk=WIDE_B))
    if not (summ["radial_interpolated"].shape[0] == WIDE_B and np.isfinite(summ["radial_interpolated"]).all()):
        raise AssertionError(f"spectral_summary_stack at {WIDE_SIDE}^2: non-finite curves")
    del wide
    huge = device_speckle(torch, dev, 1, HUGE_SIDE, HUGE_SIDE, SEED + HUGE_SIDE)[0]
    hac = counted(f"autocorr2d {HUGE_SIDE}", lambda: signal.autocorr2d(huge))[0]
    h_ms = time_ms(torch, lambda: signal.autocorr2d(huge))
    peak = float(hac[HUGE_SIDE // 2, HUGE_SIDE // 2])
    if not (bool(torch.isfinite(hac).all()) and peak == float(hac.max())):
        raise AssertionError(f"autocorr2d at {HUGE_SIDE}^2: non-finite, or the zero lag is not the peak")
    log(f"spectral_summary_stack of {WIDE_B} x {WIDE_SIDE}^2 CUDA frames at frame_chunk {WIDE_B}: {w_ms:.3f} ms; "
        f"signal.autocorr2d at {HUGE_SIDE}^2: {h_ms:.3f} ms = {h_ms / HUGE_SIDE**2 * 1e6:.4f} ns a pixel, zero lag "
        f"the peak; one K1a each, no plain call; {card}")
    del huge, hac
    torch.cuda.empty_cache()
    return res


def make_flat(shape) -> np.ndarray:
    """Config E's flat, as ``bench_configs._make_flat`` builds it."""
    return np.random.default_rng(FLAT_SEED).normal(2000, 50, size=shape).astype(np.float32)


def _ffc64(frame, flat) -> np.ndarray:
    """flat_field_correction(frame, flats=flat) (scale flat_median, no dark)
    in float64 numpy."""
    img, den = frame.astype(np.float64), flat.astype(np.float64)
    med = np.median(den)
    bad = den <= (1e-6 * med if med > 0 else 1e-6)
    out = img / np.where(bad, 1.0, den) * np.median(den[~bad])
    return np.where(bad, 0.0, out)


def run_preprocess(torch, dev, stack, card: str) -> dict:
    """The rest of preprocessing on the card (see the module docstring,
    phase 11a)."""
    import tempfile

    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch import preprocessing as pre
    from barc4dip_tpu_torch.io import save_edf
    from barc4dip_tpu_torch.ops import cuda_fftp
    from barc4dip_tpu_torch.preprocessing import filters
    from barc4dip_tpu_torch.report import batch_cli
    from barc4dip_tpu_torch.utils import spiral_motion

    res: dict = {}
    frame = stack[0]
    flat = make_flat(frame.shape)
    groups = ("amplitude", "grain", "stats")
    psf = filters._gaussian_psf(PSF_SIGMA, PSF_SIGMA)

    def timed(fn):
        """(result, ms) of the second of two calls; K1 counts the second."""
        fn()
        torch.cuda.synchronize()
        cuda_fftp.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    zero = {"cols": 0, "rows": 0, "rows_ncc": 0}

    def no_k1(label):
        """The call just timed reached no K1 (it reaches no Pallas kernel in
        the JAX package) and no plain correlation."""
        got, seen = dict(cuda_fftp.LAUNCHES), dict(cuda_fftp.PLAIN_BY_SHAPE)
        if got != zero or seen:
            raise AssertionError(f"{label}: K1 launches {got}, plain by shape {seen}; none wanted")
        res["deconvolve_psf, clahe, correct_distortion, register_stack"] = got

    # Config E full_with_deconv_2k: flat-field -> Wiener -> speckle_stats -> logbook_report
    def config_e():
        corrected = pre.flat_field_correction(frame.astype(np.float32), flats=flat, device=dev)
        deconvolved = pre.deconvolve_psf(corrected, sigma=PSF_SIGMA, method="wiener", device=dev)
        stats = port.speckle_stats(deconvolved, metrics=groups, verbose=False, device=dev)
        return stats, port.logbook_report(stats)

    (stats, report), e_ms = timed(config_e)
    launches, plain = dict(cuda_fftp.LAUNCHES), dict(cuda_fftp.PLAIN_BY_SHAPE)
    res["config E"] = launches
    if launches != {"cols": 1, "rows": 1, "rows_ncc": 0}:
        raise AssertionError(f"Config E launched K1 {launches}: one K1a wanted")
    refused_by_both(plain)
    dec64 = filters._deconvolve(torch.from_numpy(_ffc64(frame, flat))[None].to(dev), psf, "wiener", True,
                                0.01, 50, None)[0]
    ref = port.speckle_stats(dec64, metrics=groups, verbose=False)
    worst, err, n = compare_leaves(metric_leaves(stats), metric_leaves(ref))
    log(f"Config E full_with_deconv_2k (flat-field, Wiener sigma {PSF_SIGMA}, speckle_stats {groups}, "
        f"logbook_report) on frame 0 {frame.shape} {frame.dtype}: {e_ms:.2f} ms (counted run); K1 launches "
        f"{json.dumps(launches)}; plain by shape {json.dumps(plain)}; vs the chain in float64 on the card: {n} "
        f"leaves, max rel err {err:.3e} on {worst} (rtol {RTOL:g}); report {len(report.splitlines())} lines; {card}")
    if not (err <= RTOL and "#" in report):
        raise AssertionError(f"Config E float64 check: {worst} {err:.3e}")
    res["config_e_ms"] = e_ms

    # deconvolve_psf rl and uw, one frame and PRE_T frames, numpy and tensor in, against float64
    parts = []
    for method in ("wiener", "rl", "uw"):
        for label, src in (("frame", frame), (f"{PRE_T} frames", stack[:PRE_T])):
            kw = dict(sigma=PSF_SIGMA, method=method, device=dev)
            got, ms = timed(lambda: pre.deconvolve_psf(src, **kw))
            no_k1(f"deconvolve_psf {method}")
            tensor, t_ms = timed(lambda: pre.deconvolve_psf(torch.from_numpy(src).to(dev), **kw))
            no_k1(f"deconvolve_psf {method}")
            src64 = torch.from_numpy(src.astype(np.float64)).to(dev)
            want = filters._deconvolve(src64 if src.ndim == 3 else src64[None], psf, method, True,
                                       0.01 if method == "wiener" else 0.0, 50, None)
            derr = leaf_rel_err(got, want.cpu().numpy().reshape(got.shape))
            same = isinstance(tensor, torch.Tensor) and np.array_equal(tensor.cpu().numpy(), got)
            parts.append(f"{method} {label}: numpy {ms:.2f} ms, tensor {t_ms:.2f} ms, equal {same}, "
                         f"max rel err {derr:.3e}")
            res[f"deconvolve_{method}_{label.split()[0]}_ms"] = ms
            if not (derr <= RTOL and same and got.dtype == np.float32):
                raise AssertionError(f"deconvolve_psf {method} {label}: rel err {derr:.3e}, tensor equal {same}")
    log(f"deconvolve_psf sigma {PSF_SIGMA} (padded side {frame.shape[0] + 2 * (psf.shape[0] // 2)}), vs float64 "
        f"on the card relative to its max (rtol {RTOL:g}): " + "; ".join(parts) + f"; {card}")

    # clahe on uint16 and uint8, against the same call on the CPU
    for label, img in (("uint16", frame), ("uint8", (frame // 257).astype(np.uint8))):
        got, ms = timed(lambda: pre.clahe(img, device=dev))
        no_k1("clahe")
        cpu = pre.clahe(img, device="cpu")
        d = np.abs(got.astype(np.int64) - cpu.astype(np.int64))
        frac = float((d > 0).mean())
        log(f"clahe {img.shape} {label} (8x8 tiles, clip 2): {ms:.2f} ms; vs the CPU: max {int(d.max())} code, "
            f"{frac:.2e} of the pixels differ (gates 1 code, {CLAHE_FLIP_FRAC:g}); {card}")
        res[f"clahe_{label}_ms"] = ms
        if not (got.dtype == img.dtype and d.max() <= 1 and frac <= CLAHE_FLIP_FRAC):
            raise AssertionError(f"clahe {label}: max {d.max()} codes, {frac:.2e} differ")

    # correct_distortion, one frame and PRE_T frames, against float64
    for label, src in (("frame", frame), (f"{PRE_T} frames", stack[:PRE_T])):
        got, ms = timed(lambda: pre.correct_distortion(src, **DISTORTION, device=dev))
        no_k1("correct_distortion")
        want = pre.correct_distortion(src.astype(np.float64), **DISTORTION, device=dev)
        derr = leaf_rel_err(got, want)
        log(f"correct_distortion {src.shape} {src.dtype} {DISTORTION}: {ms:.2f} ms, float32 out, max rel err "
            f"{derr:.3e} vs float64 (gate {DISTORTION_RTOL:g}); {card}")
        res[f"distortion_{label.split()[0]}_ms"] = ms
        if not (got.dtype == np.float32 and derr <= DISTORTION_RTOL):
            raise AssertionError(f"correct_distortion {label}: {derr:.3e}")

    # register_stack on Config D's spiral: the frames before quantization
    # (float32, the same pattern and motion), then Config D's uint16 frames
    from barc4dip_tpu_torch.utils import speckle_stack

    T = stack.shape[0]
    truth = np.stack(spiral_motion(T), axis=1)
    reg = speckle_stack(T, stack.shape[1:], grain_px=GRAIN_PX, mean_counts=MEAN_COUNTS, dys=truth[:, 0],
                        dxs=truth[:, 1], seed=np.random.default_rng(SEED), dtype=np.float32)
    first = None
    for reference in ("first", "mean", "previous"):
        for mode in ("fourier", "roll"):
            (aligned, shifts), ms = timed(lambda: pre.register_stack(
                reg, reference=reference, shift_mode=mode, frame_chunk=PRE_T, device=dev))
            no_k1("register_stack")
            d = np.stack([shifts["dy"], shifts["dx"]], axis=1)
            if reference == "previous":  # each increment is one measurement; their errors add
                errs = {"increments": (np.diff(d, axis=0), np.diff(truth, axis=0), REG_GATE_PX),
                        f"frames 0-{REG_PREV_SPAN - 1}": (d[:REG_PREV_SPAN], truth[:REG_PREV_SPAN], REG_PREV_GATE_PX)}
            elif reference == "mean":
                errs = {"pairwise": (d - d[0], truth - truth[0], REG_MEAN_GATE_PX)}
            else:
                errs = {"drift": (d, truth, REG_GATE_PX)}
            errs = {k: (float(np.hypot(*(a - b).T).max()), g) for k, (a, b, g) in errs.items()}
            cum = float(np.hypot(*(d - truth).T).max())
            log(f"register_stack {reg.shape} float32 reference={reference!r} shift_mode={mode!r}: {ms:.2f} ms = "
                f"{ms / T:.2f} ms a frame; vs the spiral: "
                + ", ".join(f"{k} within {e:.4f} px (gate {g})" for k, (e, g) in errs.items())
                + (f", all {T} frames {cum:.4f} px" if reference == "previous" else "") + f"; {card}")
            res[f"register_{reference}_{mode}_ms"] = ms
            if not (all(e <= g for e, g in errs.values()) and aligned.shape == reg.shape
                    and aligned.dtype == np.float32):
                raise AssertionError(f"register_stack {reference}/{mode}: {errs}")
            if (reference, mode) == ("first", "fourier"):
                first = (aligned, shifts)
    t_aligned, t_shifts = pre.register_stack(torch.from_numpy(reg).to(dev), frame_chunk=PRE_T)
    if not (np.array_equal(t_shifts["dy"], first[1]["dy"]) and np.array_equal(t_aligned.cpu().numpy(), first[0])):
        raise AssertionError("register_stack: a CUDA tensor stack differs from the numpy stack")
    del t_aligned
    chain = port.speckle_stack_stats(np.ascontiguousarray(first[0]), metrics=("grain",), tiles=False,
                                     frame_chunk=FRAME_CHUNK, verbose=False, device=dev)
    resid = float(np.nanmax(np.hypot(chain["temporal"]["abs"]["dy"], chain["temporal"]["abs"]["dx"])))
    (_, u16), u_ms = timed(lambda: pre.register_stack(stack, frame_chunk=PRE_T, device=dev))
    u_err = float(np.hypot(u16["dy"] - truth[:, 0], u16["dx"] - truth[:, 1]).max())
    log(f"speckle_stack_stats of the aligned stack (first, fourier): abs trajectory max |r| {resid:.4f} px "
        f"(gate {REG_RESIDUAL_PX}); a CUDA tensor stack registers to the same shifts and frames; Config D's "
        f"uint16 frames (first, fourier): {u_ms:.2f} ms, drift within {u_err:.4f} px of the spiral (gate "
        f"{REG_U16_GATE_PX}: whitened phase correlation of quantized band-limited speckle, as in the JAX "
        f"package); {card}")
    if not (resid <= REG_RESIDUAL_PX and u_err <= REG_U16_GATE_PX):
        raise AssertionError(f"aligned stack: residual drift {resid:.4f} px; uint16 drift {u_err:.4f} px")

    # barc4dip-cuda-batch --register first on PRE_T EDF files, in process
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for t in range(PRE_T):
            paths.append(str(Path(tmp) / f"scan_{t:03d}.edf"))
            save_edf(reg[t], paths[-1])
        out_json = Path(tmp) / "summary.json"
        cuda_fftp.reset_counts()
        t0 = time.perf_counter()
        rc = batch_cli.main([*paths, "--register", "first", "--frame-chunk", str(FRAME_CHUNK),
                             "--out", str(out_json), "--device", str(dev)])
        b_s = time.perf_counter() - t0
        res["barc4dip-cuda-batch --register"] = dict(cuda_fftp.LAUNCHES)
        summary = json.loads(out_json.read_text()) if rc == 0 else {}
    reg = summary.get("registration", {})
    berr = float(np.hypot(reg.get("final_dy_px", np.inf) - truth[PRE_T - 1, 0],
                          reg.get("final_dx_px", np.inf) - truth[PRE_T - 1, 1]))
    log(f"barc4dip-cuda-batch --register first on {PRE_T} EDF files (in process): exit {rc} in {b_s:.2f} s; "
        f"registration {json.dumps(reg)} (final shift within {berr:.4f} px of the spiral, gate {REG_GATE_PX}); "
        f"tracking max_r_px after it {summary.get('tracking', {}).get('max_r_px')}; {card}")
    if not (rc == 0 and reg.get("reference") == "first" and berr <= REG_GATE_PX
            and summary["tracking"]["max_r_px"] <= REG_RESIDUAL_PX):
        raise AssertionError(f"batch --register: rc {rc}, registration {reg}")
    res["batch_register_s"] = b_s
    return res



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
    return {"launches": launches, "one_pass": one_pass, "st_c": st_c, "ref_c": ref_c}


# -- files in, reports out ---------------------------------------------------------

_STAMP_LINE = "%Y-%m-%d | %H:%M:%S"


def write_baseline_tiff(path, arr: np.ndarray) -> None:
    """One uint16 frame as a baseline TIFF: little-endian, one uncompressed
    strip, BlackIsZero. The layout ``native/dipio.cpp`` decodes; written
    here with ``struct`` so the check needs no Pillow."""
    import struct

    arr = np.ascontiguousarray(arr, dtype="<u2")
    h, w = arr.shape
    tags = [(256, 4, w), (257, 4, h), (258, 3, 16), (259, 3, 1), (262, 3, 1),
            (273, 4, 8 + 2 + 10 * 12 + 4), (277, 3, 1), (278, 4, h), (279, 4, arr.nbytes), (339, 3, 1)]
    ifd = struct.pack("<H", len(tags))
    for tag, typ, value in tags:
        ifd += struct.pack("<HHI", tag, typ, 1) + (struct.pack("<HH", value, 0) if typ == 3
                                                    else struct.pack("<I", value))
    Path(path).write_bytes(struct.pack("<2sHI", b"II", 42, 8) + ifd + struct.pack("<I", 0) + arr.tobytes())


def _without_stamp(report: str) -> list[str]:
    """A report's lines, its date-and-time line left out."""
    def is_stamp(line):
        try:
            time.strptime(line, _STAMP_LINE)
        except ValueError:
            return False
        return True

    return [ln for ln in report.splitlines() if not is_stamp(ln)]


def _native_gate(on: bool) -> None:
    if on:
        os.environ["BARC4DIP_TORCH_NATIVE_IO"] = "1"
    else:
        os.environ.pop("BARC4DIP_TORCH_NATIVE_IO", None)


def run_files(torch, dev, stack, scan, memory_s: float, have: dict, card: str) -> dict:
    """Files in, reports out, on the card (the module docstring's phase
    10): Config D from EDF files, baseline TIFFs through the native codec,
    one HDF5 run where h5py imports, both console scripts, a trace."""
    import contextlib
    import io
    import tempfile
    from unittest import mock

    import barc4dip_tpu_torch as port
    import barc4dip_tpu_torch.io as pio
    from barc4dip_tpu_torch.io import native
    from barc4dip_tpu_torch.models import SharpnessScanPipeline, SpeckleStackPipeline
    from barc4dip_tpu_torch.ops import _nvcc, cuda_fftp
    from barc4dip_tpu_torch.report import batch_cli, cli
    from barc4dip_tpu_torch.utils import spiral_motion
    from barc4dip_tpu_torch.utils.profiling import StageTimer, annotate, device_trace

    T, H, W = stack.shape
    mp = T * H * W / 1e6
    res: dict = {}
    if not native.native_available():
        raise RuntimeError(f"the native codec did not build: {native.load_error()}")
    log(f"native codec: built from native/dipio.cpp into {native.BUILD_DIR.relative_to(REPO)}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- Config D from disk: 16 uint16 EDF files, one a frame
        t0 = time.perf_counter()
        paths = []
        for t, frame in enumerate(stack):
            paths.append(str(tmp / f"scan_{t:04d}.edf"))
            pio.save_edf(frame, paths[-1])
        write_s = time.perf_counter() - t0
        read_s = {}
        for gate in (True, False):
            _native_gate(gate)
            t0 = time.perf_counter()
            frames = [pio.read_edf(p) for p in paths]
            read_s[gate] = time.perf_counter() - t0
            if not all(f.dtype == np.float32 and np.array_equal(f, st) for f, st in zip(frames, stack)):
                raise AssertionError(f"EDF frames read back (native codec {gate}) differ from the stack")
        del frames
        log(f"{T} EDF files of {H}x{W} uint16 ({T * H * W * 2 / 2**20:.0f} MiB) written in {write_s:.3f} s; "
            f"read alone as float32 in {read_s[True]:.3f} s through the native codec (dipio) and "
            f"{read_s[False]:.3f} s through the Python parser")

        f32 = stack.astype(np.float32)
        kw = dict(metrics="all", tiles=True, frame_chunk=FRAME_CHUNK, verbose=False, device=dev)
        want = port.speckle_stack_stats(f32, **kw)  # the twin of a file run: the float32 stack
        pipe = SpeckleStackPipeline(frame_chunk=FRAME_CHUNK)

        # the counted run (the twin's run warmed its path), every file read timed on the host
        timer, read_timer = StageTimer(sync=True), StageTimer(sync=False)
        reads = []
        real_read = pio.read_edf

        def timed_read(path, *a, **k):
            reads.append(path)
            with read_timer.stage("read"):
                return real_read(path, *a, **k)

        pio.read_edf = timed_read
        try:
            cuda_fftp.reset_counts()
            torch.cuda.synchronize()
            with timer.stage("run_files"):
                out = pipe.run_files(paths)
            launches, plain = dict(cuda_fftp.LAUNCHES), dict(cuda_fftp.PLAIN_BY_SHAPE)
            files_s, in_reads = timer.totals["run_files"], read_timer.totals["read"]
            reads_counted = list(reads)
            cuda_fftp.reset_counts()
            maps = [out["full"]["grain"]["autocorr"][t] for t in range(GOLDEN_K)]
            map_launches = dict(cuda_fftp.LAUNCHES)
        finally:
            pio.read_edf = real_read
        log(f"Config D from EDF files (SpeckleStackPipeline(frame_chunk={FRAME_CHUNK}).run_files, Python "
            f"parser, counted run): {files_s:.3f} s = {mp / files_s:.2f} MP/s with the reads "
            f"(the in-memory counted run of this process: {memory_s:.3f} s = {mp / memory_s:.2f} MP/s); "
            f"stages: read {in_reads:.3f} s in {len(reads_counted)} reads = "
            f"{in_reads / files_s:.1%}, metrics+tracking {files_s - in_reads:.3f} s; K1 launches "
            f"{json.dumps(launches)}; {card}")
        chunks = -(-T // FRAME_CHUNK)
        if launches != {"cols": 3 * chunks, "rows": chunks, "rows_ncc": 2 * chunks}:
            raise AssertionError(f"run_files launched K1 {launches}")
        if not set(plain) <= subtile_plain_keys(H, W):
            raise AssertionError(f"run_files: unexpected plain-path shapes {sorted(plain)}")
        if reads_counted != paths:
            raise AssertionError(f"run_files read {len(reads_counted)} files, not each of {T} once in order")
        worst, d = max_leaf_diff(out, want)
        map_d = max(float(np.abs(m - want["full"]["grain"]["autocorr"][t]).max()) for t, m in enumerate(maps))
        err = spiral_error(out)
        log(f"run_files vs speckle_stack_stats(stack.astype(float32)): max |diff| {d:.3e} over every "
            f"leaf (worst {worst}); maps of frames 0-{GOLDEN_K - 1} read after the call: {len(reads) - T} "
            f"more file reads, K1 launches {json.dumps(map_launches)}, max |diff| {map_d:.3e}; tracking "
            f"{err:.4f} px from the spiral (gate {TRACK_GATE_PX})")
        if d != 0.0 or map_d != 0.0 or not err <= TRACK_GATE_PX:
            raise AssertionError(f"run_files differs from the in-memory run: {worst} {d:.3e}, maps {map_d:.3e}, "
                                 f"tracking {err:.4f} px")
        if map_launches != {"cols": GOLDEN_K, "rows": GOLDEN_K, "rows_ncc": 0} or len(reads) != T + GOLDEN_K:
            raise AssertionError(f"map reads: K1 {map_launches}, {len(reads) - T} file reads")
        res.update({"run_files": launches, "run_files map reads": map_launches, "files_s": files_s})

        _native_gate(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        native_out = pipe.run_files(paths)
        torch.cuda.synchronize()
        native_s = time.perf_counter() - t0
        worst, d = max_leaf_diff(native_out, want)
        log(f"the same run with BARC4DIP_TORCH_NATIVE_IO=1: {native_s:.3f} s = {mp / native_s:.2f} MP/s "
            f"with the reads; max |diff| {d:.3e}; {card}")
        if d != 0.0:
            raise AssertionError(f"run_files through the native codec differs: {worst} {d:.3e}")
        del native_out

        # -- baseline TIFFs through the native codec; the focus scan from files
        tiffs = []
        for t in range(4):
            tiffs.append(str(tmp / f"frame_{t}.tif"))
            write_baseline_tiff(tiffs[-1], stack[t])
        with mock.patch.dict(sys.modules, {"PIL": None}):  # a way round the codec would raise ImportError
            got = pio.read_tiff(tiffs)
        if got.dtype != np.uint16 or not np.array_equal(got, stack[:4]):
            raise AssertionError("baseline TIFFs read through the native codec differ from the frames")
        scan_paths = []
        for t, frame in enumerate(scan):
            scan_paths.append(str(tmp / f"focus_{t}.tif"))
            write_baseline_tiff(scan_paths[-1], frame)
        spipe = SharpnessScanPipeline()
        focus_mem = spipe(scan.astype(np.float32))
        t0 = time.perf_counter()
        focus = spipe.run_files(scan_paths)
        scan_s = time.perf_counter() - t0
        worst, d = max_leaf_diff(focus, focus_mem)
        log(f"baseline TIFF: frames 0-3 through read_tiff with the codec on (Pillow hidden) equal the "
            f"stack; SharpnessScanPipeline().run_files on {len(scan_paths)} TIFFs: {scan_s:.3f} s, "
            f"best_frame {focus['meta']['focus']['best_frame']}, max |diff| to the in-memory float32 scan "
            f"{d:.3e}; {card}")
        if focus["meta"]["focus"] != focus_mem["meta"]["focus"] or d != 0.0 \
                or focus["meta"]["focus"]["best_frame"] != SCAN_BEST:
            raise AssertionError(f"focus scan from TIFFs: {focus['meta']['focus']} vs {focus_mem['meta']['focus']}, "
                                 f"{worst} {d:.3e}")
        _native_gate(False)

        # -- HDF5: frames 0-7 as stored (uint16)
        sub = stack[:OPT_T]
        if have["h5py"]:
            t0 = time.perf_counter()
            pio.save_h5(sub, tmp / "run.h5")
            save_s = time.perf_counter() - t0
            mem = port.speckle_stack_stats(sub, **kw)
            cuda_fftp.reset_counts()
            mem = port.speckle_stack_stats(sub, **kw)
            mem_launches = dict(cuda_fftp.LAUNCHES)
            cuda_fftp.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h5 = pipe.run_hdf5(str(tmp / "run.h5"))
            torch.cuda.synchronize()
            h5_s = time.perf_counter() - t0
            res["run_hdf5"] = dict(cuda_fftp.LAUNCHES)
            worst, d = max_leaf_diff(h5, mem)
            map_d = float(np.abs(h5["full"]["grain"]["autocorr"][1] - mem["full"]["grain"]["autocorr"][1]).max())
            log(f"HDF5: save_h5 of {sub.shape} {sub.dtype} in {save_s:.3f} s (gzip-4); run_hdf5 "
                f"{h5_s:.3f} s = {OPT_T * H * W / 1e6 / h5_s:.2f} MP/s with the reads; K1 launches "
                f"{json.dumps(res['run_hdf5'])} (the in-memory uint16 run: {json.dumps(mem_launches)}); "
                f"max |diff| {d:.3e}, a map read after the call {map_d:.3e}; {card}")
            if res["run_hdf5"] != mem_launches or d != 0.0 or map_d != 0.0:
                raise AssertionError(f"run_hdf5 vs the in-memory uint16 run: launches {res['run_hdf5']} vs "
                                     f"{mem_launches}, {worst} {d:.3e}, map {map_d:.3e}")
            del h5, mem
        else:
            log("HDF5: h5py does not import on this machine, so run_hdf5 is not driven here; "
                "tests/test_torch_run_files.py holds it on the CPU")

        # -- barc4dip-cuda-speckles, in process
        def speckles_cli():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["-s", paths[0], "--all"])
            return rc, buf.getvalue()

        speckles_cli()
        cuda_fftp.reset_counts()
        t0 = time.perf_counter()
        rc, text = speckles_cli()
        cli_s = time.perf_counter() - t0
        res["barc4dip-cuda-speckles"] = dict(cuda_fftp.LAUNCHES)
        direct = port.logbook_report(port.speckle_stats(
            pio.read_image(paths[0]), metrics="all", tiles=True, verbose=False))
        log(f"barc4dip-cuda-speckles -s frame0.edf --all, in process: {cli_s:.3f} s (counted run), "
            f"{len(text.splitlines())} lines, K1 launches {json.dumps(res['barc4dip-cuda-speckles'])}; {card}")
        if rc != 0 or _without_stamp(text) != _without_stamp(direct) or len(text.splitlines()) < 10 \
                or res["barc4dip-cuda-speckles"] != {"cols": 1, "rows": 1, "rows_ncc": 0}:
            raise AssertionError(f"speckles CLI: rc {rc}, K1 {res['barc4dip-cuda-speckles']}, "
                                 f"report equal {_without_stamp(text) == _without_stamp(direct)}")

        # -- barc4dip-cuda-batch: in process, then as a subprocess with no --device
        argv = [*paths[:OPT_T], "--frame-chunk", str(FRAME_CHUNK)]
        j, z, r = tmp / "summary.json", tmp / "full.npz", tmp / "run.md"
        missing = subprocess.Popen(
            [sys.executable, "-m", "barc4dip_tpu_torch.report.batch_cli", str(tmp / "no_such_file.edf")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            cuda_fftp.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = batch_cli.main([*argv, "--out", str(j), "--npz", str(z), "--report", str(r)])
            batch_s = time.perf_counter() - t0
            res["barc4dip-cuda-batch"] = dict(cuda_fftp.LAUNCHES)
            summary = json.loads(j.read_text())
            dys, dxs = spiral_motion(T)
            want_r = float(np.hypot(dys[:OPT_T], dxs[:OPT_T]).max())
            direct = SpeckleStackPipeline(frame_chunk=FRAME_CHUNK).run_files(paths[:OPT_T])
            flat = batch_cli._flatten_npz({k: v for k, v in direct.items() if k != "meta"})
            with np.load(z) as npz:
                same = sorted(npz.files) == sorted(flat) and all(
                    np.array_equal(npz[k], flat[k], equal_nan=True) for k in flat)
                n_leaves = len(npz.files)
            log(f"barc4dip-cuda-batch on {OPT_T} EDF files (--frame-chunk {FRAME_CHUNK} --out --npz --report), "
                f"in process: {batch_s:.3f} s; tracking.max_r_px {summary['tracking']['max_r_px']:.4f} "
                f"(the spiral's {want_r:.4f}); {n_leaves} .npz leaves equal to run_files': {same}; report "
                f"of {len(r.read_text().splitlines())} lines; K1 launches "
                f"{json.dumps(res['barc4dip-cuda-batch'])}; {card}")
            n = -(-OPT_T // FRAME_CHUNK)  # the summary, the .npz and the report read no lazy map
            if rc != 0 or abs(summary["tracking"]["max_r_px"] - want_r) > TRACK_GATE_PX or not same \
                    or not r.read_text().strip() or summary["n_frames"] != OPT_T \
                    or res["barc4dip-cuda-batch"] != {"cols": 3 * n, "rows": n, "rows_ncc": 2 * n}:
                raise AssertionError(f"batch CLI: rc {rc}, summary {summary.get('tracking')}, npz equal {same}, "
                                     f"K1 {res['barc4dip-cuda-batch']}")

            built = sorted(p.name for p in _nvcc.BUILD_DIR.iterdir())
            j2 = tmp / "summary_subprocess.json"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "barc4dip_tpu_torch.report.batch_cli", *argv, "--out", str(j2)],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            sub_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"batch CLI as a subprocess: exit {proc.returncode}: {proc.stderr[-2000:]}")
            rebuilt = sorted(p.name for p in _nvcc.BUILD_DIR.iterdir()) != built
            log(f"python -m barc4dip_tpu_torch.report.batch_cli (a subprocess, no --device): exit 0 in "
                f"{sub_s:.3f} s wall, import + CUDA context + kernel load from build/kernels + run "
                f"(the run alone, in process: {batch_s:.3f} s); same JSON: "
                f"{json.loads(j2.read_text()) == summary}; kernels rebuilt: {rebuilt}; {card}")
            if json.loads(j2.read_text()) != summary or rebuilt:
                raise AssertionError("the subprocess gave another summary or rebuilt a kernel")
            _out, err_text = missing.communicate(timeout=300)
        finally:
            if missing.poll() is None:
                missing.kill()
                missing.wait()
        log(f"a path that does not exist: exit code {missing.returncode}; stderr: {err_text.strip()}")
        if missing.returncode != 2 or "not found" not in err_text:
            raise AssertionError(f"missing input: exit {missing.returncode}, stderr {err_text!r}")

        # -- one chunk under device_trace
        with device_trace(str(tmp / "trace")) as trace_path, annotate("one-chunk-from-files"):
            SpeckleStackPipeline(frame_chunk=FRAME_CHUNK).run_files(paths[:FRAME_CHUNK])
        trace = Path(trace_path).read_text()
        named = [k for k in ("corr_cols_inverse", "corr_rows_c2r", "one-chunk-from-files") if k in trace]
        log(f"device_trace of one chunk from files: {Path(trace_path).name}, {len(trace) / 2**20:.1f} MiB; "
            f"K1 kernels and the annotated span named in it: {named}")
        if len(named) != 3:
            raise AssertionError(f"the trace names only {named}")
    return res


def run_files_xst(torch, dev, xst: dict, card: str) -> dict:
    """The corrected XST frames written as float32 EDF, then
    ``WavefrontScanPipeline.run_files`` against the in-memory call."""
    import tempfile

    import barc4dip_tpu_torch.io as pio
    from barc4dip_tpu_torch.models import WavefrontScanPipeline
    from barc4dip_tpu_torch.ops import cuda_densetrack

    frames, ref = xst["st_c"].cpu().numpy(), xst["ref_c"].cpu().numpy()
    pipe = WavefrontScanPipeline(pixel_size=XST_PIXEL, distance=XST_DIST, wavelength=1e-10,
                                 tile_size=XST_TILE, step=XST_STEP, search_radius=XST_RADIUS)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for t, frame in enumerate(frames):
            paths.append(str(Path(tmp) / f"xst_{t:04d}.edf"))
            pio.save_edf(frame, paths[-1])
        pio.save_edf(ref, Path(tmp) / "reference.edf")
        cuda_densetrack.reset_counts()
        want = pipe(frames, ref)
        mem_launches = dict(cuda_densetrack.LAUNCHES)
        cuda_densetrack.reset_counts()
        t0 = time.perf_counter()
        out = pipe.run_files(paths, reference_path=str(Path(tmp) / "reference.edf"))
        files_s = time.perf_counter() - t0
        launches, plain = dict(cuda_densetrack.LAUNCHES), dict(cuda_densetrack.PLAIN_BY_SHAPE)
    diffs = {k: float(np.abs(out[k] - want[k]).max()) for k in ("dy", "dx", "peak", "wavefront", "phase")}
    log(f"XST from disk: WavefrontScanPipeline.run_files on {len(paths)} float32 EDF files + reference: "
        f"{files_s:.3f} s with the reads = {len(paths) / files_s:.2f} frames/s; K3 launches "
        f"{json.dumps(launches)} (the in-memory call: {json.dumps(mem_launches)}); max |diff| "
        f"{json.dumps(diffs)}; {card}")
    if launches != mem_launches or not launches["ncc_sums"] > 0 or plain or any(diffs.values()):
        raise AssertionError(f"XST from disk: launches {launches} vs {mem_launches}, plain {plain}, diffs {diffs}")
    return {"launches": launches}


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
        smi_version = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
        log(f"torch {torch.__version__} cuda {torch.version.cuda}, driver_version {smi_version}; "
            f"device 0: {name}")
        log(smi)
        have = {}
        for module in ("h5py", "PIL"):
            try:
                __import__(module)
                have[module] = True
            except ImportError:
                have[module] = False
        log(f"optional packages on this machine: h5py {'imports' if have['h5py'] else 'is absent'}, "
            f"Pillow (PIL) {'imports' if have['PIL'] else 'is absent'}")
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
        cov = make_coverage_data()
        log(f"coverage stack {cov['stack'].shape} {cov['stack'].dtype}; tracking ROI {cov['roi_side']} px, "
            f"step {cov['step']} px")

    with Phase("kernels"):
        rows = check_kernels(torch, dev, stack, starts, s, card)
        rows += check_kernels_sides(torch, dev, stack, cov, card)

    with Phase("slice"):
        res = run_slice(torch, dev, stack, card)

    with Phase("coverage"):
        coverage = run_coverage(torch, dev, cov, card)
        del cov

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

    with Phase("sharpness"):
        sharp = run_sharpness(torch, dev, stack, card)

    with Phase("files"):
        files = run_files(torch, dev, stack, sharp["scan"], res["warm_s"], have, card)

    with Phase("signal"):
        sig = run_signal(torch, dev, stack, s, card)

    with Phase("preprocess"):
        prep = run_preprocess(torch, dev, stack, card)
    by_path = {"slice": res["launches"], "slice map reads": res["map_launches"],
               "speckle_stats": single["launches"], "speckle_stats map read": single["map_launches"],
               "resident": resident["launches"], **options, "full_step_fn": full_step["launches"],
               **{k: v for k, v in sharp.items() if isinstance(v, dict)},
               **{k: v for k, v in files.items() if isinstance(v, dict)},
               **{k: v for k, v in sig.items() if isinstance(v, dict)},
               **{k: v for k, v in coverage.items() if isinstance(v, dict)},
               **{k: v for k, v in prep.items() if isinstance(v, dict)}}
    log(f"K1 launches by path (counted runs): {json.dumps(by_path)}")

    with Phase("data-xst"):
        data = make_xst_data()
        log(f"xst: reference {data['ref'].shape}, stack {data['stack'].shape} {data['stack'].dtype}, "
            f"{int(data['dead'].sum())} dead pixels")

    with Phase("kernels-2"):
        rows += check_kernels_xst(torch, dev, data, card)

    with Phase("xst"):
        xst = run_xst(torch, dev, data, card)

    with Phase("files-xst"):
        files_xst = run_files_xst(torch, dev, xst, card)

    if "--profile" in sys.argv[1:]:
        with Phase("profile"):
            profile_slice(torch, dev, stack)
            profile_sharpness(torch, dev, stack)
            from barc4dip_tpu_torch import signal

            profiled(torch, "spectral_summary (Config C)", lambda: signal.spectral_summary(stack[0], device=dev))
            profiled(torch, "xst pass (upload, flat-field, wavefront scan)", xst["one_pass"])

    for row in rows:
        if row["name"].startswith("median3x3"):
            row["launches"] = xst["launches"]["median3x3"]
        elif row["name"].startswith("ncc_sums"):
            row["launches"] = xst["launches"]["ncc_sums"]
            row["launches_files"] = files_xst["launches"]["ncc_sums"]
        elif row.get("path") in coverage:  # a side of the coverage phase only
            key = "rows" if row["name"].startswith("corr_from_rfft") else "rows_ncc"
            row["launches"] = coverage[row["path"]][key]
        else:
            key = "rows" if row["name"].startswith("corr_from_rfft") else "rows_ncc"
            row["launches"] = res["launches"][key]
            row["launches_files"] = files["run_files"][key]
            row["launches_sharpness"] = sharp["sharpness_stats"][key]
            if row["name"].endswith(f"B={SUMMARY_CHUNK}") or "template" in row["name"]:  # shapes of the signal phase only
                row["path"] = "template_matching" if "template" in row["name"] else "spectral_summary_stack"
                row["launches"] = sig[row["path"]][key]
            elif row["name"].endswith("standardized"):  # a shape of the sharpness paths only
                nf = int(row["name"].split("=")[1].split()[0])
                row["path"] = ("sharpness_stats" if nf == 1 else "sharpness stack" if nf == SHARP_CHUNK
                               else f"sharpness stack chunk {SHARP_TAIL_CHUNK}")
                row["launches"] = sharp[row["path"]][key]
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
