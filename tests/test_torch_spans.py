# SPDX-License-Identifier: CECILL-2.1
"""The port's spans (``utils/profiling.annotate``) at its layer boundaries,
read from a CPU ``torch.profiler`` Chrome trace: each instrumented path
emits the spans named in ``PERF.md`` §3, each nested in its parent, every
span of a call inside the call's one entry span, and the chunk loop's spans
inside the ``LAST_RUN_PERF`` intervals that bracket the same statements.
With no profiler recording, a span makes no ``record_function`` at all."""
import json
import re

import numpy as np
import pytest
import torch

import barc4dip_tpu_torch as port
from barc4dip_tpu_torch.metrics import stack_fused
from barc4dip_tpu_torch.utils import profiling, speckle_field, speckle_stack

torch.set_num_threads(2)

IMAGE = speckle_field((384, 384), grain_px=5.0, mean_counts=1000.0, seed=5).astype(np.uint16)
STACK = speckle_stack(4, (160, 160), grain_px=5.0, mean_counts=1000.0, seed=6).astype(np.uint16)
GROUPS_SPECKLE = ("amplitude", "grain", "stats", "bandwidth")
GROUPS_SHARP = ("stats", "gradient", "laplacian", "spectral", "autocorrelation", "eigenvalues")
SCAN = ("gradient", "laplacian", "spectral")


def _with_report(stats):
    """The stats and their report, less its time stamp."""
    report = port.logbook_report(stats)
    return {"stats": stats, "report": [line for line in report.splitlines() if not re.search(r"\d\d:\d\d:\d\d", line)]}


def _image_spans(entry, groups):
    spans = {entry: {None}, "entry.validate": {entry}, "upload": {entry}, "step.metrics": {entry},
             "pull.wait": {entry}, "entry.assemble": {entry}}
    spans.update({f"group.{g}": {"step.metrics"} for g in groups})
    return spans


#: path -> (call, {span name: the names its parent may have; None: a root})
PATHS = {
    "speckle_stats": (
        lambda: port.speckle_stats(IMAGE, device="cpu", verbose=False),
        {**_image_spans("entry.speckle_stats", GROUPS_SPECKLE), "k1.autocorr": {"group.grain"}},
    ),
    "speckle_stack_stats": (
        lambda: port.speckle_stack_stats(STACK, device="cpu", verbose=False, tiles=False, frame_chunk=2,
                                         grain_maps=False, tracking_method="template"),
        {"entry.speckle_stack_stats": {None}, "entry.frame0": {"entry.speckle_stack_stats"},
         "k1.autocorr": {"entry.frame0", "group.grain"}, "chunk": {"entry.speckle_stack_stats"},
         "upload": {"chunk"}, "chunk.enqueue": {"chunk"}, "step.metrics": {"chunk.enqueue"},
         **{f"group.{g}": {"step.metrics"} for g in GROUPS_SPECKLE},
         "track": {"chunk.enqueue"}, "k1.ncc": {"track"},
         "pull.wait": {"chunk", "entry.speckle_stack_stats"}, "entry.assemble": {"entry.speckle_stack_stats"}},
    ),
    "sharpness_report": (
        lambda: _with_report(port.sharpness_stats(IMAGE, device="cpu", verbose=False)),
        {**_image_spans("entry.sharpness_stats", GROUPS_SHARP), "k1.autocorr": {"group.autocorrelation"},
         "eig": {"group.eigenvalues"}, "entry.logbook_report": {None}},
    ),
    "sharpness_stack_stats": (
        lambda: port.sharpness_stack_stats(STACK, device="cpu", verbose=False, metrics=",".join(SCAN),
                                           tiles=False, frame_chunk=2),
        {"entry.sharpness_stack_stats": {None}, "chunk": {"entry.sharpness_stack_stats"}, "upload": {"chunk"},
         "chunk.enqueue": {"chunk"}, "step.metrics": {"chunk.enqueue"},
         **{f"group.{g}": {"step.metrics"} for g in SCAN},
         "pull.wait": {"chunk", "entry.sharpness_stack_stats"}, "entry.assemble": {"entry.sharpness_stack_stats"}},
    ),
}


def _traced_spans(call, tmp_path):
    """[(start, end, tid, name, parent)] of the program's spans in a CPU
    trace of ``call()``, the parent being the innermost span around it on
    its thread."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    raw = sorted((e["ts"], -(e["ts"] + e["dur"]), e["tid"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    out, open_ = [], {}
    for ts, neg_end, tid, name in raw:
        stack = open_.setdefault(tid, [])
        while stack and stack[-1][1] <= ts:
            stack.pop()
        out.append((ts, -neg_end, tid, name, stack[-1][0] if stack else None))
        stack.append((name, -neg_end))
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_path_emits_its_spans_nested(path, tmp_path):
    call, expected = PATHS[path]
    spans = _traced_spans(call, tmp_path)
    assert {name for _, _, _, name, _ in spans} == set(expected)
    for _, _, _, name, parent in spans:
        assert parent in expected[name], (name, parent)
    roots = [(s, e) for s, e, _, _, parent in spans if parent is None]
    assert len(roots) == sum(None in v for v in expected.values())  # one span a call of each entry
    for s, e, _, name, parent in spans:
        if parent is not None:
            assert sum(r0 <= s and e <= r1 for r0, r1 in roots) == 1, name
    if path == "speckle_stack_stats":
        # the counters bracket the statements of their spans
        total = {n: sum(e - s for s, e, _, name, _ in spans if name == n) * 1e-6 for n in ("chunk.enqueue", "pull.wait")}
        perf = stack_fused.LAST_RUN_PERF
        assert 0 < total["chunk.enqueue"] <= perf["dispatch_s"] * 1.01 + 1e-4
        assert 0 < total["pull.wait"] <= perf["pull_wait_s"] * 1.01 + 1e-4
        assert sum(name == "chunk" for *_, name, _ in spans) == perf["chunks"] == 2


def _assert_same(want, got):
    if isinstance(want, dict):
        assert set(want) == set(got)
        for k in want:
            _assert_same(want[k], got[k])
    elif isinstance(want, (np.ndarray, float, int, list)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_profiler_no_record_function(path, monkeypatch):
    """With no profiler recording, the spans open no range: a
    ``record_function`` that raises is never reached, and the results are
    those of a traced call."""

    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with no profiler recording")

    call, _ = PATHS[path]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        want = call()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    got = call()
    _assert_same(want, got)
    timer = profiling.StageTimer(sync=False)
    with timer.stage("a"):
        call()
    with timer.stage("a"):
        pass
    assert timer.counts == {"a": 2} and timer.totals["a"] > 0


def test_annotate_as_decorator_keeps_the_function():
    @profiling.annotate("span.of.f")
    def f(x, *, y=2):
        """doc of f"""
        return x * y

    assert f(3) == 6 and f(3, y=4) == 12
    assert f.__name__ == "f" and f.__doc__ == "doc of f"
    assert port.speckle_stats.__name__ == "speckle_stats" and port.speckle_stats.__wrapped__
    with pytest.raises(KeyError):
        with profiling.annotate("raises"):
            raise KeyError("x")
