"""Each per-layer reader on a small recorded trace and counter record, and
its ``None`` where its function, counter or device work is absent."""
import pytest

from perfbench import run
from perfbench.trace import Trace

PORT = "/x/barc4dip_tpu_torch"


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def attributed_trace():
    """1000 us window: an autocorr2d_core call launching two kernels, an
    eigenvalues_core call launching one, an upload, and a stray kernel."""
    events = [
        ev("user_annotation", "perfbench.window", 0, 1000),
        ev("python_function", f"{PORT}/ops/corrcore.py(75): autocorr2d_core", 100, 200),
        ev("cuda_runtime", "cudaLaunchKernel", 120, 5, corr=1),
        ev("cuda_driver", "cuLaunchKernel", 150, 5, corr=2),
        ev("python_function", f"{PORT}/metrics/estimators.py(241): eigenvalues_core", 400, 300),
        ev("cuda_runtime", "cudaLaunchKernel", 450, 5, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 800, 5, corr=4),
        ev("cuda_runtime", "cudaLaunchKernel", 450, 5, tid=2, corr=5),  # another thread
        ev("python_function", f"{PORT}/config.py(71): upload", 900, 50),
        ev("kernel", "corr_cols", 130, 10, corr=1),
        ev("kernel", "corr_rows", 160, 30, corr=2),
        ev("kernel", "syevd", 460, 200, corr=3),
        ev("kernel", "other", 810, 60, corr=4),
        ev("kernel", "thread2", 700, 40, corr=5),
        ev("cpu_op", "aten::sort", 200, 150),
    ]
    return Trace(events, frames=2, calls=1)


def record(**kw):
    log = []
    rec = {"plain": None, "attributed": None, "calls": [], "log": log.append,
           "config": {"detector": {"height": 2048, "width": 2048}},
           "traffic": {"args": {"tiles": True, "frame_chunk": 4}}}
    rec.update(kw)
    return rec, log


def read(name, rec):
    return run.load_module("layer_metrics", name).read(rec)


def test_trace_times_and_attribution():
    tr = attributed_trace()
    assert tr.wall_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx((10 + 30 + 200 + 40 + 60) * 1e-6)
    assert tr.kernels == 5 and len(tr.launches) == 5
    assert tr.attributed_device_s((("ops/corrcore.py", "autocorr2d_core"),)) == pytest.approx(40e-6)
    assert tr.attributed_device_s((("ops/ncc.py", "ncc_bank_masked_peaks"),)) is None
    assert tr.top_device_ops(2) == [["syevd", pytest.approx(200e-6)], ["other", pytest.approx(60e-6)]]
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(270e-6) and gaps[0][0] == "aten::sort"


def test_readers_on_a_recorded_trace():
    tr = attributed_trace()
    rec, _ = record(plain=tr, attributed=tr, calls=[
        {"seconds": 2.0, "profiled": False, "counters": {"dispatch_s": 1.5}},
        {"seconds": 2.0, "profiled": False, "counters": {"dispatch_s": 1.0}},
        {"seconds": 9.0, "profiled": True, "counters": {"dispatch_s": 0.0}}])
    assert read("dispatch_pct", rec) == pytest.approx(62.5)
    assert read("upload_pct", rec) == pytest.approx(5.0)
    assert read("launches_per_frame", rec) == 2.5
    assert read("device_idle_pct", rec) == pytest.approx(66.0)
    assert read("eig_device_pct", rec) == pytest.approx(100 * 200 / 340)
    k1 = read("k1_roofline_pct", rec)
    mod = run.load_module("layer_metrics", "k1_roofline_pct")
    nbytes, flops = mod.frame_work(2048, 2048, True, 4)
    least = max(2 * nbytes / 3.35e12, 2 * flops / 67e12)
    assert k1 == pytest.approx(100 * least / 40e-6)


def test_readers_return_none_with_a_reason():
    empty = Trace([ev("user_annotation", "perfbench.window", 0, 100)], frames=1, calls=1)
    rec, log = record(plain=empty, attributed=empty, calls=[{"seconds": 1.0, "profiled": False, "counters": None}])
    names = ["dispatch_pct", "upload_pct", "launches_per_frame", "device_idle_pct", "eig_device_pct", "k1_roofline_pct"]
    assert all(read(n, rec) is None for n in names)
    assert len(log) == len(names) and all(log)
    rec, log = record()
    assert all(read(n, rec) is None for n in names)


def test_k1_stage_work_counts_frame_tiles_and_banks():
    mod = run.load_module("layer_metrics", "k1_roofline_pct")
    full = mod.autocorr_work(2048)
    nbytes, flops = mod.frame_work(2048, 2048, False, 4)
    spec = 2048 * 1025 * 8
    banks = 2 * (spec + 2048 * 2048 * 4 + 9 * 2048 * 2048 * 4) + 9 * spec / 4 + 9 * spec
    assert nbytes == pytest.approx(full[0] + banks)
    tiled = mod.frame_work(2048, 2048, True, 4)
    assert tiled[0] > nbytes and tiled[1] > flops
