"""Roofline share of the correlation stage of a Config D call: the least
time the card could take for the stage's work, over the device time of the
kernels launched inside ``ops.corrcore.autocorr2d_core`` (the grain
autocorrelations of each frame and of its 81 subtiles; kernel K1a on the
full frame) and ``ops.ncc.ncc_bank_masked_peaks`` (the tracker's two banks of
nine templates a frame; kernel K1b).

The least time is the larger of the stage's bytes at the card's memory rate
and its float32 operations at the card's float32 peak, counted from the
cell's shapes for the frames of the attributed sub-window:
- an autocorrelation of an n x n square: the image read once and the map
  written once, 2 n^2 float32; a real forward and inverse FFT, 2.5 n^2
  log2(n^2) operations each, and the 6 operations of |F|^2 a spectrum bin;
- a bank of K templates against a frame's spectrum (H x (W/2+1) complex64):
  the frame's spectrum and its (H, W) float32 window energies read once, the
  templates' spectra read once (the frame-0 bank once a chunk, the previous
  frames' banks once a frame), K maps of (H, W) float32 written once; a plane
  costs 6 operations a bin for the product, an inverse real FFT, and 4 a
  pixel for the NCC epilogue (``chip_smoke.py``'s arithmetic).
"""
from __future__ import annotations

import math

from perfbench.peaks import PEAK_BYTES_S, PEAK_F32_FLOP_S
from perfbench.reference.common import split_edges, tiling_mode

FUNCTIONS = (("barc4dip_tpu_torch/ops/corrcore.py", "autocorr2d_core"),
             ("barc4dip_tpu_torch/ops/ncc.py", "ncc_bank_masked_peaks"))
TEMPLATES = 9  # the 3x3 ROI grid


def fft_flops(n: int) -> float:
    """Operations of one real FFT of n points: 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


def autocorr_work(n: int) -> tuple[float, float]:
    return 2 * n * n * 4, 2 * fft_flops(n * n) + 6 * n * (n // 2 + 1)


def frame_work(H: int, W: int, tiles: bool, chunk: int) -> tuple[float, float]:
    """(bytes, operations) of the stage for one frame."""
    nbytes, flops = autocorr_work(max(H, W))
    mode = tiling_mode(H, W, tiles)
    if mode != "off":
        n = 9 if mode == "subtiles_9x9" else 3
        for y0, y1 in split_edges(H, n):
            for x0, x1 in split_edges(W, n):
                b, f = autocorr_work(max(y1 - y0, x1 - x0))
                nbytes, flops = nbytes + b, flops + f
    spec = H * (W // 2 + 1) * 8
    for bank_bytes in (TEMPLATES * spec / chunk, TEMPLATES * spec):  # frame-0 bank, previous frame's
        nbytes += spec + H * W * 4 + bank_bytes + TEMPLATES * H * W * 4
        flops += TEMPLATES * (6 * H * (W // 2 + 1) + fft_flops(H * W) + 4 * H * W)
    return nbytes, flops


def read(record):
    tr = record["attributed"]
    own = None if tr is None else tr.attributed_device_s(FUNCTIONS)
    if not own:
        record["log"]("k1_roofline_pct: no kernel launched inside the correlation stage in the attributed sub-window")
        return None
    det, args = record["config"]["detector"], record["traffic"]["args"]
    nbytes, flops = frame_work(int(det["height"]), int(det["width"]), bool(args.get("tiles", True)),
                               int(args.get("frame_chunk", 4)))
    least = max(tr.frames * nbytes / PEAK_BYTES_S, tr.frames * flops / PEAK_F32_FLOP_S)
    record["log"](f"k1_roofline_pct: least {least:.6f} s ({tr.frames} frames) over {own:.6f} s of device time")
    return 100.0 * least / own
