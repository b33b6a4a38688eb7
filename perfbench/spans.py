"""The port's spans in a traced run of one cell (not run by the benchmark).

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

The port marks its layer boundaries with spans (``utils/profiling.annotate``:
a ``record_function`` range while a profiler records), so a sub-window's
Chrome trace holds them beside the launch calls and the kernels, on the
trace's own clock. This runs the cell as ``run.py --trace 1`` does
(``run.run_cell``: the same window, sub-windows, readers and check) with the
sub-windows' traces read as :class:`SpanTrace`, which also keeps the
program's spans, and adds to the result line what the spans of the plain
sub-window (no Python tracer) give:

- the metrics of :data:`METRICS`, in the cells each names;
- ``breakdown["idle_spans"]``: the longest idle gaps, each named by the
  innermost program span open at its middle, or ``outside the program``;
- on standard error, one row per span name: its self host time (its length
  less its child spans'), the device time it launched, its launch calls a
  frame, and the device's idle time under it.

It prints the line, one JSON line, last on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench import trace  # noqa: E402
from perfbench.peaks import PEAK_BYTES_S, PEAK_F32_FLOP_S  # noqa: E402
from perfbench.run import forbidden_modules, load_cell, load_module, log, run_cell, set_environment  # noqa: E402

OUTSIDE = "outside the program"

#: metric -> (what it reads, the spans it reads, the cells it is reported in).
#: "wall": the plain sub-window's wall time inside the spans, in %;
#: "device": the device time of the kernels launched inside the spans over
#: all device time, in %; "k1": ``k1_roofline_pct``'s least time of the
#: correlation stage over the device time launched inside the spans, in %.
METRICS = {
    "validate_pct": ("wall", ("entry.validate",), ("speckle_2k.image", "sharpness_2k.image")),
    "frame0_pct": ("wall", ("entry.frame0",), ("speckle_2k.stack100",)),
    "pin_pct": ("wall", ("upload.pin",), ("speckle_2k.stack100", "sharpness_2k.scan11")),
    "pull_wait_pct": ("wall", ("pull.wait",), ("speckle_2k.stack100", "sharpness_2k.scan11")),
    "upload_span_pct": ("wall", ("upload",), ("speckle_2k.stack100", "sharpness_2k.scan11")),
    "eig_span_pct": ("device", ("eig",), ("sharpness_2k.image",)),
    "k1_span_roofline_pct": ("k1", ("k1.autocorr", "k1.ncc"), ("speckle_2k.stack100",)),
}


def _overlap(a, b) -> float:
    """Total length shared by two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class SpanTrace(trace.Trace):
    """A sub-window's :class:`trace.Trace`, with the program's spans: the
    ``user_annotation`` events but the sub-window's own, as ``spans``
    [(start, end, tid, name)] in seconds, sorted. Every reading of the base
    class is left as it is."""

    def __init__(self, events: list, frames: int, calls: int):
        super().__init__(events, frames, calls)
        self.spans = sorted(
            (float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6, e.get("tid"), e["name"])
            for e in events
            if e.get("ph") == "X" and "ts" in e and e.get("cat") == "user_annotation" and e.get("name") != trace.WINDOW)
        self._open = None

    def span_names(self) -> set[str]:
        return {n for _, _, _, n in self.spans}

    def span_inside(self, names) -> list:
        """Merged wall intervals (any thread) of the spans named ``names``."""
        return trace._union((s, e) for s, e, _, n in self.spans if n in names)

    def span_wall_s(self, names) -> float:
        return trace._clip_total(self.span_inside(names), self.lo, self.hi)

    def _by_thread(self) -> dict:
        """{tid: [(start, -end, name)]}, sorted: on a thread, spans nest, as
        ``record_function`` ranges do, and a parent sorts before its
        children."""
        by_tid = defaultdict(list)
        for s, e, tid, n in self.spans:
            by_tid[tid].append((s, -e, n))
        return {tid: sorted(v) for tid, v in by_tid.items()}

    def _launch_spans(self) -> dict:
        """{correlation: the names of the spans open, on the launching
        thread, at the launch call}, by one sweep a thread."""
        if self._open is None:
            by_tid = self._by_thread()
            launches = defaultdict(list)
            for ts, tid, corr in self.launches:
                launches[tid].append((ts, corr))
            self._open = {}
            for tid, pts in launches.items():
                spans = by_tid.get(tid, [])
                stack, i = [], 0
                for ts, corr in sorted(pts, key=lambda p: p[0]):
                    while i < len(spans) and spans[i][0] <= ts:
                        s, neg_e, n = spans[i]
                        while stack and stack[-1][0] < s:
                            stack.pop()
                        stack.append((-neg_e, n))
                        i += 1
                    while stack and stack[-1][0] < ts:
                        stack.pop()
                    self._open[corr] = {n for _, n in stack}
        return self._open

    def span_device_s(self, names) -> float | None:
        """Device time of the kernels, copies and memsets launched inside
        the spans named ``names`` on the thread that made the launch call
        (the rule of ``attributed_device_s``); None where no such span ran
        in the sub-window."""
        names = set(names)
        if not names & self.span_names():
            return None
        owned = {corr for corr, open_ in self._launch_spans().items() if open_ & names}
        return sum(e - s for s, e, _, corr in self.device if corr in owned)

    def _gaps(self) -> list:
        """(start, end) of every stretch of the sub-window with nothing on
        the device, as ``idle_gaps`` finds them."""
        edges = [(self.lo, self.lo)] + [(s, e) for s, e in self.busy_merged if e > self.lo and s < self.hi]
        edges.append((self.hi, self.hi))
        return [(e0, s1) for (_, e0), (s1, _) in zip(edges, edges[1:]) if s1 > e0]

    def idle_spans(self, n: int = 10) -> list:
        """The ``n`` longest idle gaps, longest first, as [name, seconds],
        each named by the innermost program span open at its middle (the
        latest started), or :data:`OUTSIDE`."""
        out = []
        for e0, s1 in sorted(self._gaps(), key=lambda g: g[0] - g[1])[:n]:
            mid = (e0 + s1) / 2
            open_ = [(s, -e, name) for s, e, _, name in self.spans if s <= mid <= e]
            out.append([max(open_)[2] if open_ else OUTSIDE, s1 - e0])
        return out

    def span_table(self) -> dict:
        """{span name: {"calls", "self_s", "device_s", "launches", "idle_s"}}:
        its count, its host time less its child spans' on its thread, the
        device time and the launch calls made inside it (a nested span's
        count in its parents' too), and the idle time of the device under
        it, all within the sub-window."""
        rows = defaultdict(lambda: {"calls": 0, "self_s": 0.0, "device_s": 0.0, "launches": 0, "idle_s": 0.0})
        for spans in self._by_thread().values():
            stack = []  # [end, name, self]
            for s, neg_e, n in spans + [(float("inf"), 0.0, None)]:
                while stack and stack[-1][0] <= s:
                    end, name, own = stack.pop()
                    rows[name]["self_s"] += own
                if n is None:
                    break
                length = -neg_e - s
                if stack:
                    stack[-1][2] -= length
                stack.append([-neg_e, n, length])
                rows[n]["calls"] += 1
        open_at = self._launch_spans()
        for corr, names in open_at.items():
            for name in names:
                rows[name]["launches"] += 1
        dev = defaultdict(float)
        for s, e, _, corr in self.device:
            dev[corr] += e - s
        for corr, names in open_at.items():
            for name in names:
                rows[name]["device_s"] += dev.get(corr, 0.0)
        gaps = self._gaps()
        for name in rows:
            rows[name]["idle_s"] = _overlap(gaps, self.span_inside({name}))
        return dict(rows)


def read(metric: str, record: dict) -> float | None:
    """One metric of :data:`METRICS` from ``record`` (as ``run.py`` gives its
    readers, with ``plain`` a :class:`SpanTrace`); None, with the reason
    logged, where its spans are not in the plain sub-window."""
    kind, names, _ = METRICS[metric]
    tr = record["plain"]
    if tr is None or not set(names) & tr.span_names():
        record["log"](f"{metric}: no {' or '.join(names)} span in the plain sub-window")
        return None
    if kind == "wall":
        return 100.0 * tr.span_wall_s(names) / tr.wall_s
    own = tr.span_device_s(names)
    if not own or tr.device_s <= 0:
        record["log"](f"{metric}: no device time launched inside {' or '.join(names)} in the plain sub-window")
        return None
    if kind == "device":
        return 100.0 * own / tr.device_s
    det, args = record["config"]["detector"], record["traffic"]["args"]
    nbytes, flops = load_module("layer_metrics", "k1_roofline_pct").frame_work(
        int(det["height"]), int(det["width"]), bool(args.get("tiles", True)), int(args.get("frame_chunk", 4)))
    least = max(tr.frames * nbytes / PEAK_BYTES_S, tr.frames * flops / PEAK_F32_FLOP_S)
    record["log"](f"{metric}: least {least:.6f} s ({tr.frames} frames) over {own:.6f} s of device time")
    return 100.0 * least / own


def log_table(tr: SpanTrace) -> None:
    log(f"spans of the plain sub-window ({tr.calls} calls, {tr.frames} frames, {tr.wall_s:.6f} s): "
        "name, count, self host s, device s launched, launch calls a frame, idle s under it")
    for name, r in sorted(tr.span_table().items(), key=lambda kv: -kv[1]["self_s"]):
        log(f"  {name:<32} {r['calls']:>6} {r['self_s']:.6f} {r['device_s']:.6f} "
            f"{r['launches'] / max(tr.frames, 1):.3f} {r['idle_s']:.6f}")


def traced_line(cell: str, seed: int, seconds: float, device, *, overrides=None) -> dict:
    """``run.run_cell``'s traced line of ``cell``, with the span-read
    metrics and ``idle_spans`` of its plain sub-window added."""
    kept = {}
    original = trace.profile_calls

    def keeping(run_calls, *, attributed):
        tr = kept["attributed" if attributed else "plain"] = original(run_calls, attributed=attributed)
        return tr

    with ExitStack() as patches:
        patches.enter_context(mock.patch.object(trace, "Trace", SpanTrace))
        patches.enter_context(mock.patch.object(trace, "profile_calls", keeping))
        line = run_cell(cell, seed, seconds, True, device, overrides=overrides)
    spec = load_cell(cell)
    config, traffic = spec["config"], spec["traffic"]
    for key, val in (overrides or {}).items():  # as run_cell applies them
        (traffic if key == "traffic" else config.setdefault(key, {})).update(val)
    plain = kept.get("plain")
    record = {"plain": plain, "config": config, "traffic": traffic, "log": log}
    for metric, (_, _, cells) in METRICS.items():
        if cell in cells:
            value = read(metric, record)
            if value is not None:
                line["metrics"][metric] = {"value": float(value), "unit": "%"}
    if plain is not None:
        line.setdefault("breakdown", {})["idle_spans"] = plain.idle_spans()
        log_table(plain)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    set_environment()

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: no result")
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    line = traced_line(a.workload, a.seed, a.seconds, "cuda")
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {', '.join(bad)}: no result")
        return 3
    log(f"correct: {line['correct']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
