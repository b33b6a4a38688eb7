# SPDX-License-Identifier: CECILL-2.1
"""Tracing and per-stage timing (counterpart of
``barc4dip_tpu/utils/profiling.py``).

- :func:`device_trace` — context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a card is present) that writes a
  Chrome trace (``chrome://tracing``, Perfetto) into a directory;
- :class:`StageTimer` — lightweight named-stage wall-clock accumulator for
  pipeline runs (host side; device work is synchronized at stage ends);
- :class:`annotate` — the port's one span: a named
  ``torch.profiler.record_function`` range while a profiler records, so
  pipeline stages show up by name inside device traces, on the trace's own
  clock; one flag check otherwise.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from dataclasses import dataclass, field

import torch

logger = logging.getLogger(__name__)

__all__ = ["device_trace", "StageTimer", "annotate"]


@contextlib.contextmanager
def device_trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Capture a profile of the enclosed work into
    ``log_dir/trace-<pid>-<ns>.json`` (Chrome trace format); yields that
    path. ``create_perfetto_link`` has no counterpart here: ``True`` raises
    ``ValueError``."""
    if create_perfetto_link:
        raise ValueError(
            "create_perfetto_link has no counterpart in torch.profiler: open the "
            "trace file in Perfetto or chrome://tracing instead"
        )
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(str(log_dir), f"trace-{os.getpid()}-{time.time_ns()}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)


if hasattr(torch.autograd.profiler, "_is_profiler_enabled"):
    def _recording() -> bool:
        return torch.autograd.profiler._is_profiler_enabled
else:
    _recording = torch._C._autograd._profiler_enabled


class annotate:
    """Name a region inside a device trace: ``with annotate(name):``, or
    ``@annotate(name)`` on a function for each of its calls.

    While a profiler records, the region is a ``record_function`` range, so
    it lands in the trace beside the operators, launches and kernels it
    encloses, and nests in the ranges open around it on its thread. With no
    profiler recording, entering and leaving costs one flag check and makes
    no range."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _recording():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(*exc)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return spanned


@dataclass
class StageTimer:
    """Accumulate wall-clock time per named pipeline stage.

    Usage::

        timer = StageTimer()
        with timer.stage("metrics"):
            ...
        with timer.stage("tracking"):
            ...
        timer.report()
    """

    sync: bool = True
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            # only a process that has used a card has device work to wait for
            if self.sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, *, log: bool = True) -> dict[str, float]:
        """Return {stage: seconds}; optionally log one line per stage."""
        if log:
            for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
                logger.info(
                    "> stage %-20s %8.3f s  (%d calls)",
                    name, total, self.counts[name],
                )
        return dict(self.totals)
