# SPDX-License-Identifier: CECILL-2.1
"""``perfbench/spans.py``: the span-read metrics, ``idle_spans`` and the
per-span table on a synthetic Chrome trace, each metric's ``None`` with a
reason where its span is absent; the benchmark's own readers, ``idle_gaps``
and ``top_device_ops`` read the same values with and without the program's
spans in the trace; and the tool's traced run of each cell on the CPU at a
tiny size (no measurement: the CPU has no device trace)."""
import pytest

from perfbench import run, spans
from perfbench.trace import Trace

PORT = "/x/barc4dip_tpu_torch"


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


#: a 1000 us sub-window: Python function events (the attributed rule),
#: host operators, launch calls (one on another thread) and their kernels
BASE = [
    ev("user_annotation", "perfbench.window", 0, 1000),
    ev("python_function", f"{PORT}/ops/corrcore.py(75): autocorr2d_core", 400, 100),
    ev("python_function", f"{PORT}/metrics/estimators.py(241): eigenvalues_core", 520, 130),
    ev("python_function", f"{PORT}/config.py(71): upload", 200, 100),
    ev("cuda_runtime", "cudaLaunchKernel", 410, 5, corr=1),
    ev("cuda_driver", "cuLaunchKernel", 450, 5, corr=2),
    ev("cuda_runtime", "cudaLaunchKernel", 530, 5, corr=3),
    ev("cuda_runtime", "cudaLaunchKernel", 810, 5, corr=6),
    ev("cuda_runtime", "cudaLaunchKernel", 900, 5, corr=4),
    ev("cuda_runtime", "cudaLaunchKernel", 450, 5, tid=2, corr=5),
    ev("kernel", "corr_cols", 415, 10, corr=1),
    ev("kernel", "corr_rows", 455, 30, corr=2),
    ev("kernel", "syevd", 540, 200, corr=3),
    ev("kernel", "ncc", 815, 20, corr=6),
    ev("gpu_memcpy", "Memcpy HtoD", 905, 60, corr=4),
    ev("kernel", "thread2", 300, 40, corr=5),
    ev("cpu_op", "aten::sort", 20, 100),
    ev("cpu_op", "aten::cat", 600, 250),
]
#: the program's spans on thread 1, nested as record_function ranges are
SPANS = [
    ev("user_annotation", "entry.x", 10, 950),
    ev("user_annotation", "entry.validate", 20, 100),
    ev("user_annotation", "entry.frame0", 130, 50),
    ev("user_annotation", "upload", 200, 100),
    ev("user_annotation", "upload.pin", 210, 50),
    ev("user_annotation", "k1.autocorr", 400, 100),
    ev("user_annotation", "eig", 520, 130),
    ev("user_annotation", "pull.wait", 700, 50),
    ev("user_annotation", "k1.ncc", 800, 50),
]
DEVICE_S = (10 + 30 + 200 + 20 + 60 + 40) * 1e-6


def record(tr, log):
    return {"plain": tr, "attributed": tr, "calls": [{"seconds": 2.0, "profiled": False, "counters": {"dispatch_s": 1.0}}],
            "log": log.append, "config": {"detector": {"height": 2048, "width": 2048}},
            "traffic": {"args": {"tiles": True, "frame_chunk": 4}}}


def test_span_metrics_on_a_synthetic_trace():
    tr = spans.SpanTrace(BASE + SPANS, frames=2, calls=1)
    log = []
    rec = record(tr, log)
    got = {m: spans.read(m, rec) for m in spans.METRICS}
    k1 = run.load_module("layer_metrics", "k1_roofline_pct")
    nbytes, flops = k1.frame_work(2048, 2048, True, 4)
    least = max(2 * nbytes / 3.35e12, 2 * flops / 67e12)
    assert got == pytest.approx({
        "validate_pct": 10.0, "frame0_pct": 5.0, "pin_pct": 5.0, "pull_wait_pct": 5.0, "upload_span_pct": 10.0,
        "eig_span_pct": 100 * 200e-6 / DEVICE_S,
        # the launch on thread 2, inside k1.autocorr's time, is not its own
        "k1_span_roofline_pct": 100 * least / 60e-6,
    })
    assert tr.span_device_s(("k1.autocorr",)) == pytest.approx(40e-6)
    assert tr.span_device_s(("track",)) is None


@pytest.mark.parametrize("metric", sorted(spans.METRICS))
def test_each_metric_is_none_with_a_reason_without_its_span(metric):
    names = spans.METRICS[metric][1]
    tr = spans.SpanTrace(BASE + [e for e in SPANS if e["name"] not in names], frames=2, calls=1)
    log = []
    assert spans.read(metric, record(tr, log)) is None
    assert len(log) == 1 and metric in log[0] and names[0] in log[0]


def test_idle_spans_name_each_gap_by_its_innermost_span():
    tr = spans.SpanTrace(BASE + SPANS, frames=2, calls=1)
    got = tr.idle_spans(10)
    assert [name for name, _ in got] == [
        "entry.frame0",  # 0-300 us, middle 150 us: inside entry.x and entry.frame0
        "entry.x", "entry.x", "entry.x", "entry.x",  # 340-415, 740-815, 835-905, 485-540 us
        spans.OUTSIDE,  # 965-1000 us: entry.x ended at 960 us
        "k1.autocorr",  # 425-455 us
    ]
    assert [s for _, s in got] == pytest.approx([300e-6, 75e-6, 75e-6, 70e-6, 55e-6, 35e-6, 30e-6])
    assert spans.SpanTrace(BASE, frames=2, calls=1).idle_spans(1) == [[spans.OUTSIDE, pytest.approx(300e-6)]]


def test_span_table_self_time_launches_and_idle():
    table = spans.SpanTrace(BASE + SPANS, frames=2, calls=1).span_table()
    assert set(table) == {e["name"] for e in SPANS}
    assert table["entry.x"]["calls"] == 1
    assert table["entry.x"]["self_s"] == pytest.approx((950 - 100 - 50 - 100 - 100 - 130 - 50 - 50) * 1e-6)
    assert table["upload"]["self_s"] == pytest.approx(50e-6)
    assert table["entry.x"]["launches"] == 5 and table["k1.autocorr"]["launches"] == 2
    assert table["entry.x"]["device_s"] == pytest.approx(DEVICE_S - 40e-6)
    assert table["eig"]["device_s"] == pytest.approx(200e-6)
    # idle under eig: 485-540 us of its 520-650 us
    assert table["eig"]["idle_s"] == pytest.approx(20e-6)
    assert table["entry.frame0"]["idle_s"] == pytest.approx(50e-6)


READERS = ["dispatch_pct", "upload_pct", "launches_per_frame", "eig_device_pct", "k1_roofline_pct", "device_idle_pct"]


@pytest.mark.parametrize("reading", READERS + ["idle_gaps", "top_device_ops", "busy_s"])
def test_benchmark_readings_do_not_see_the_spans(reading):
    """The program's spans change no reading of the benchmark: on the same
    trace with and without them, read by ``Trace`` and by ``SpanTrace``."""

    def value(tr):
        if reading in READERS:
            return run.load_module("layer_metrics", reading).read(record(tr, []))
        attr = getattr(tr, reading)
        return attr() if callable(attr) else attr

    want = value(Trace(BASE, frames=2, calls=1))
    assert want is not None and want != []
    for tr in (Trace(BASE + SPANS, frames=2, calls=1), spans.SpanTrace(BASE + SPANS, frames=2, calls=1)):
        assert value(tr) == want


SMALL = {"detector": {"height": 384, "width": 384}}
TINY = {
    "speckle_2k.stack100": {"frames": 6, "pool": 2, "warmup_calls": 1},
    "speckle_2k.image": {"pool": 3, "warmup_calls": 1, "trace": {"plain": 2, "attributed": 1}},
    "sharpness_2k.image": {"pool": 2, "warmup_calls": 1, "trace": {"plain": 1, "attributed": 1}},
    "sharpness_2k.scan11": {"frames": 7, "pool": 2, "warmup_calls": 1, "trace": {"plain": 2, "attributed": 1}},
}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_line_adds_the_span_metrics_on_the_cpu(cell):
    line = spans.traced_line(cell, 2**33 + 7, 0.0, "cpu", overrides={**SMALL, "traffic": TINY[cell]})
    assert line["correct"] is True and line["failed"] == 0
    # the CPU trace has no kernel, no launch and no pinning copy: only the
    # wall shares of the spans that run on the CPU can be read
    on_cpu = {m for m, (kind, names, cells) in spans.METRICS.items()
              if cell in cells and kind == "wall" and names != ("upload.pin",)}
    assert on_cpu and on_cpu <= set(line["metrics"])
    assert all(0 < line["metrics"][m]["value"] < 100 for m in on_cpu)
    gaps = line["breakdown"]["idle_spans"]
    assert gaps and all(name != spans.OUTSIDE for name, _ in gaps)
