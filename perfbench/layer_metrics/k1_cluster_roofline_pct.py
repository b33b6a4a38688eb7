"""Roofline share of kernel K1's pass 1 on its cluster route, the route
every pass-1 launch above ``CLUSTER_ABOVE`` = 2048 rows takes
(``corr_cols_cluster`` in ``csrc/fftp_corr.cu``): the least time the card
could take for the route's bytes, over the device time of the kernels
launched inside ``ops.cuda_fftp._cols_cluster`` (attributed sub-window).

Pass 1 reads each plane's frame spectrum and template spectrum once and
writes its H x W/2 complex64 mid plane once (``chip_smoke.py``'s pass-1
rate); its operations, a column FFT of each plane, take under half the
time of those bytes, so the bytes bound it. They are counted from the
cell's shapes, with ``k1_roofline_pct``'s conventions, for the frames of
the attributed sub-window, for each launch whose rows exceed 2048:
- K1a, the full frame's autocorrelation on its n x n square (n the larger
  side): its spectrum, read once as image and template, and its mid plane;
- K1b, the tracker's two banks: the frame's spectrum for each bank, the
  frame-0 bank's spectra once a chunk, the previous frame's once a frame,
  and nine mid planes for each.

No reading where the calls outside the sub-windows carry no
``k1_cluster_launches`` (a program that does not count the route, or a
detector of 2048 rows or fewer, whose pass 1 never takes it).
"""
from __future__ import annotations

from perfbench.layer_metrics.k1_roofline_pct import TEMPLATES
from perfbench.peaks import PEAK_BYTES_S

FUNCTIONS = (("barc4dip_tpu_torch/ops/cuda_fftp.py", "_cols_cluster"),)
CLUSTER_ABOVE = 2048  # rows; ops.cuda_fftp.CLUSTER_ABOVE


def spectrum_bytes(h: int, w: int) -> int:
    return h * (w // 2 + 1) * 8


def mid_bytes(h: int, w: int) -> int:
    return h * (w // 2) * 8


def frame_bytes(H: int, W: int, chunk: int) -> float:
    """Pass-1 bytes of one frame's cluster-route launches."""
    nbytes = 0.0
    n = max(H, W)
    if n > CLUSTER_ABOVE:
        nbytes += spectrum_bytes(n, n) + mid_bytes(n, n)
    if H > CLUSTER_ABOVE:
        spec = spectrum_bytes(H, W)
        for bank_bytes in (TEMPLATES * spec / chunk, TEMPLATES * spec):  # frame-0 bank, previous frame's
            nbytes += spec + bank_bytes + TEMPLATES * mid_bytes(H, W)
    return nbytes


def read(record):
    calls = [c for c in record["calls"] if not c["profiled"] and c["counters"]
             and c["counters"].get("k1_cluster_launches")]
    if not calls:
        record["log"]("k1_cluster_roofline_pct: no unprofiled call carried k1_cluster_launches")
        return None
    tr = record["attributed"]
    own = None if tr is None else tr.attributed_device_s(FUNCTIONS)
    if not own:
        record["log"]("k1_cluster_roofline_pct: no kernel launched inside _cols_cluster in the attributed sub-window")
        return None
    det, args = record["config"]["detector"], record["traffic"]["args"]
    least = tr.frames * frame_bytes(int(det["height"]), int(det["width"]), int(args.get("frame_chunk", 4))) \
        / PEAK_BYTES_S
    launches = sorted({c["counters"]["k1_cluster_launches"] for c in calls})
    record["log"](f"k1_cluster_roofline_pct: least {least:.6f} s ({tr.frames} frames) over {own:.6f} s of "
                  f"device time; cluster launches a call {launches}")
    return 100.0 * least / own
