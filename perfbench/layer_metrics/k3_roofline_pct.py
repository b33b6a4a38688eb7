"""Roofline share of the dense tracker's correlation stage in an XST scan
call: the least time the card could take for kernel K3's work, over the
device time of the kernels launched inside ``ops.densetrack._pallas_corr``
(the reference's centred tiles and energies, K3's windowed sums, the NCC
from them), attributed sub-window.

The least time is the larger of the stage's float32 operations at the
card's float32 peak and its bytes at the card's memory rate, counted from
the cell's shapes for the frames of the sub-window:
- operations: every node's s x s tile against each of the L^2 offsets of
  its window, a multiply and an add a pixel: 2 N L^2 s^2 a frame (the
  window sums are box sums, O(w L s) a node, and are not counted);
- bytes: each frame read once and its (N, L, L) float32 NCC map written
  once, and the reference read once a batch of ``frame_batch`` frames.
"""
from __future__ import annotations

import numpy as np

from perfbench.peaks import PEAK_BYTES_S, PEAK_F32_FLOP_S

FUNCTIONS = (("barc4dip_tpu_torch/ops/densetrack.py", "_pallas_corr"),)
FRAME_BATCH = 4  # track_displacement_stack's default, which the pipeline keeps


def nodes(H: int, W: int, tile: int, radius: int, step: int) -> int:
    """Grid nodes: tile starts from radius to side - tile - radius by step."""
    return len(np.arange(radius, H - tile - radius + 1, step)) * len(np.arange(radius, W - tile - radius + 1, step))


def frame_work(H: int, W: int, tile: int, radius: int, step: int) -> tuple[float, float]:
    """(bytes, operations) of the stage for one frame."""
    N, L = nodes(H, W, tile, radius, step), 2 * radius + 1
    nbytes = H * W * 4 * (1 + 1 / FRAME_BATCH) + N * L * L * 4
    return nbytes, 2.0 * N * L * L * tile * tile


def read(record):
    tr = record["attributed"]
    own = None if tr is None else tr.attributed_device_s(FUNCTIONS)
    if not own:
        record["log"]("k3_roofline_pct: no kernel launched inside densetrack._pallas_corr in the attributed sub-window")
        return None
    det, p = record["config"]["detector"], record["traffic"]["args"]["pipeline"]
    nbytes, flops = frame_work(int(det["height"]), int(det["width"]), int(p["tile_size"]),
                               int(p["search_radius"]), int(p["step"]))
    least = max(tr.frames * nbytes / PEAK_BYTES_S, tr.frames * flops / PEAK_F32_FLOP_S)
    record["log"](f"k3_roofline_pct: least {least:.6f} s ({tr.frames} frames) over {own:.6f} s of device time")
    return 100.0 * least / own
