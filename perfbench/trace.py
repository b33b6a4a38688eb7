"""The traced run's two profiled sub-windows, and the reading of their traces.

A sub-window is a few calls of the cell under ``torch.profiler`` with CPU and
CUDA activities, between a ``perfbench.window`` span that marks its wall
time. The *plain* one runs without the Python tracer: its trace gives the
device's busy time, the launch calls and the idle gaps. The *attributed*
one runs with ``with_stack=True``, so the trace also holds an event for every
Python function call; a kernel is attributed to a function of the program
when one of that function's events, on the thread that made the launch call,
encloses the launch call, which the trace ties to the kernel by correlation
id.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

#: Runtime and driver calls that launch a kernel.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench.window"


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip_total(merged, lo, hi) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


class Trace:
    """The events of one sub-window's Chrome trace (times in seconds)."""

    def __init__(self, events: list, frames: int, calls: int):
        self.frames, self.calls = frames, calls
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
        if win:
            lo = min(float(e["ts"]) for e in win)
            hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in win)
        else:  # no span: the whole trace
            ts = [float(e["ts"]) for e in events if "ts" in e and e.get("ph") == "X"]
            lo, hi = (min(ts), max(ts)) if ts else (0.0, 0.0)
        self.lo, self.hi = lo * 1e-6, hi * 1e-6
        self.device = []  # (start, end, name, correlation)
        self.kernels = 0
        self.launches = []  # (ts, tid, correlation)
        self.python = defaultdict(list)  # name -> [(tid, start, end)]
        self.host_ops = []  # (start, end, name) of CPU ops
        for e in events:
            if e.get("ph") != "X" or "ts" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            s = float(e["ts"]) * 1e-6
            end = s + float(e.get("dur", 0)) * 1e-6
            if cat in DEVICE_CATS:
                self.kernels += cat == "kernel"
                self.device.append((s, end, name, (e.get("args") or {}).get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver") and name in LAUNCH_CALLS:
                self.launches.append((s, e.get("tid"), (e.get("args") or {}).get("correlation")))
            elif cat == "python_function":
                self.python[name].append((e.get("tid"), s, end))
            elif cat == "cpu_op":
                self.host_ops.append((s, end, name))
        self.busy_merged = _union((s, e) for s, e, _, _ in self.device)

    @property
    def wall_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return _clip_total(self.busy_merged, self.lo, self.hi)

    @property
    def device_s(self) -> float:
        """Summed time of the device's operations."""
        return sum(e - s for s, e, _, _ in self.device)

    def functions(self, patterns) -> list[str]:
        """Names of the Python function events that match any (file, function)
        pattern: the event is named ``<path>(<line>): <function>``."""
        out = []
        for name in self.python:
            head, _, fn = name.rpartition("): ")
            if any(fn == f and head.replace("\\", "/").split("(")[0].endswith(path) for path, f in patterns):
                out.append(name)
        return out

    def inside(self, patterns) -> list[tuple[float, float]]:
        """Merged wall intervals (any thread) of the functions matching ``patterns``."""
        return _union((s, e) for n in self.functions(patterns) for _, s, e in self.python[n])

    def attributed_device_s(self, patterns) -> float | None:
        """Device time of the kernels launched inside the functions that match
        ``patterns``; None where no such function ran in the sub-window."""
        names = self.functions(patterns)
        if not names:
            return None
        spans = defaultdict(list)
        for n in names:
            for tid, s, e in self.python[n]:
                spans[tid].append((s, e))
        merged = {tid: _union(v) for tid, v in spans.items()}
        starts = {tid: [s for s, _ in m] for tid, m in merged.items()}
        owned = set()
        for ts, tid, corr in self.launches:
            m = merged.get(tid)
            if not m:
                continue
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and m[i][0] <= ts <= m[i][1]:
                owned.add(corr)
        return sum(e - s for s, e, _, corr in self.device if corr in owned)

    def top_device_ops(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for s, e, name, _ in self.device:
            tot[name] += e - s
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches of the sub-window with nothing on the
        device, each named by the host operation running at its middle."""
        edges = [(self.lo, self.lo)] + [(s, e) for s, e in self.busy_merged if e > self.lo and s < self.hi]
        edges.append((self.hi, self.hi))
        gaps = []
        for (_, e0), (s1, _) in zip(edges, edges[1:]):
            if s1 > e0:
                gaps.append((s1 - e0, (e0 + s1) / 2))
        gaps.sort(reverse=True)
        ops = sorted(self.host_ops)
        out = []
        for length, mid in gaps[:n]:
            running = [name for s, e, name in ops if s <= mid <= e]
            out.append([running[-1] if running else "host (no operator)", length])
        return out


def profile_calls(run_calls, *, attributed: bool) -> Trace:
    """Run ``run_calls()`` (a few calls of the cell, returning their records,
    each with its ``frames``) under the profiler and read its trace, which
    is written to ``TMPDIR`` and deleted."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, with_stack=attributed) as prof:
        with torch.profiler.record_function(WINDOW):
            records = run_calls()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        tr = Trace(events, sum(r["frames"] for r in records), len(records))
        tr.file_bytes, tr.read_s = size, time.perf_counter() - t0
    finally:
        os.unlink(path)
    return tr

