"""Roofline share of kernel K2, the flat-field's 3x3 median repair, in an
XST scan call: the least time the card could take, each repaired frame (the
reference and every scan frame) read once and written once in float32 at
the card's memory rate, over the device time of the kernels launched
inside ``ops.rank.median_filter2d``, attributed sub-window."""
from __future__ import annotations

from perfbench.peaks import PEAK_BYTES_S

FUNCTIONS = (("barc4dip_tpu_torch/ops/rank.py", "median_filter2d"),)


def call_bytes(H: int, W: int, T: int) -> float:
    """Bytes of one call's repairs: (T + 1) frames of H x W float32, in and out."""
    return (T + 1) * H * W * 4 * 2


def read(record):
    tr = record["attributed"]
    own = None if tr is None else tr.attributed_device_s(FUNCTIONS)
    if not own:
        record["log"]("k2_roofline_pct: no kernel launched inside rank.median_filter2d in the attributed sub-window")
        return None
    det = record["config"]["detector"]
    nbytes = call_bytes(int(det["height"]), int(det["width"]), int(record["traffic"]["frames"]))
    least = tr.calls * nbytes / PEAK_BYTES_S
    record["log"](f"k2_roofline_pct: least {least:.6f} s ({tr.calls} calls) over {own:.6f} s of device time")
    return 100.0 * least / own
