# SPDX-License-Identifier: CECILL-2.1
"""Wall-clock timing and text progress helpers (the port's own copy of
``barc4dip_tpu/utils/time.py``; host only).

Behavioural parity with the reference utilities (reference:
src/barc4dip/utils/time.py:13-104): ``elapsed_time`` prints a
human-formatted duration and returns seconds; ``progress_update`` /
``progress_done`` render a 10-bucket carriage-return progress bar. The
duration formatter is table-driven here (one rule per magnitude) rather
than an if-cascade, and always returns the float (the reference's
early-return-None quirk is deliberately not reproduced).
"""
from __future__ import annotations

import time as _time

__all__ = ["now", "elapsed_time", "progress_update", "progress_done"]

_BUCKETS = 10


def now() -> float:
    """Current wall-clock time in seconds since the epoch."""
    return _time.time()


def _format_duration(seconds: float) -> str:
    """Human form at the coarsest nonzero unit (ms / s / min / h)."""
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f} ms"
    full_min, secs = divmod(seconds, 60.0)
    hours, mins = divmod(int(full_min), 60)
    if hours:
        return f"{hours} h {mins} min {secs:.2f} s"
    if mins:
        return f"{mins} min {secs:.2f} s"
    return f"{secs:.2f} s"


def elapsed_time(t_start: float, verbose: bool = True) -> float:
    """Seconds since ``t_start``; ``verbose`` prints the formatted line."""
    delta = _time.time() - t_start
    if verbose:
        print(f">> Total elapsed time: {_format_duration(delta)}")
    return delta


def progress_update(loop_name: str, t: int, T: int, last_bucket: int) -> int:
    """Render the 10-bucket bar when ``t`` crosses into a new bucket;
    returns the bucket to pass back on the next call (quantisation keeps
    long loops from spamming one line per iteration)."""
    bucket = (_BUCKETS * t) // max(1, T - 1)
    if bucket == last_bucket:
        return last_bucket
    filled = "#" * bucket
    empty = "-" * (_BUCKETS - bucket)
    print(
        f"\r{loop_name}: [{filled}{empty}] {_BUCKETS * bucket:3d}%",
        end="", flush=True,
    )
    return bucket


def progress_done(loop_name: str) -> None:
    """Terminate the bar with its full 100% line."""
    print(f"\r{loop_name}: [{'#' * _BUCKETS}] 100%", flush=True)
