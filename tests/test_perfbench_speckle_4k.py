# SPDX-License-Identifier: CECILL-2.1
"""The 4096^2 Config D cell of the benchmark (``speckle_4k.stack16``) on the
CPU at a small size: its configuration and traffic against their
``BENCHMARK.json`` entries, the cell's ``correct`` against the plain
reference (``perfbench/reference/``) at the cell's own limits, the bfloat16
control refused, the stack entry's two counters of frame-0 sizing and of
K1's cluster route, and the cell's two per-layer readers.

Small size: 4 frames of 512^2 a stack, a pool of 2; the 4096^2 frames, the
cluster route and every device time run only on the card."""
import json
import random

import numpy as np
import pytest
import torch

from barc4dip_tpu_torch.metrics import stack_fused
from perfbench import run
from perfbench.reference.common import Precision
from perfbench.trace import Trace

torch.set_num_threads(2)
CELL = "speckle_4k.stack16"
SEED = 2**33 + 41
SMALL = {"detector": {"height": 512, "width": 512}}
TINY = {"frames": 4, "pool": 2, "warmup_calls": 1}
BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


def tiny_run(trace=False):
    return run.run_cell(CELL, SEED, 0.0, trace, "cpu", overrides={**SMALL, "traffic": TINY})


@pytest.fixture(scope="module")
def untraced():
    line = tiny_run()
    return line, dict(stack_fused.LAST_RUN_PERF)


# -- the files ---------------------------------------------------------------------


def test_config_and_traffic_match_their_entries():
    spec = run.load_cell(CELL)
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    config, traffic = spec["config"], spec["traffic"]
    assert cell == {**cell, "config": "speckle_4k", "traffic": "speckle_stack16", "chips": 1}
    assert conf["file"] == "perfbench/configs/speckle_4k.json" and conf["reduced"] == []
    assert config["name"] == conf["name"] and config["source"] == conf["source"] and config["reduced"] == {}
    assert config["detector"] == {"height": 4096, "width": 4096, "dtype": "uint16"}
    assert config["stack_frames"] == traffic["frames"] == 16
    assert set(config["assumed"]) == {"detector", "series", "content"}
    # the content and the analysis are speckle_2k's: only the detector and the series differ
    two = run.load_cell("speckle_2k.stack100")
    for key in ("content", "analysis", "precision"):
        assert config[key] == two["config"][key], key
    assert {k: v for k, v in traffic.items() if k not in ("frames", "limits")} == \
        {k: v for k, v in two["traffic"].items() if k not in ("frames", "limits")}
    assert traffic["args"] == {"metrics": "all", "tiles": True, "frame_chunk": 4, "verbose": False}
    assert traffic["pool"] == 2 and traffic["warmup_calls"] == 2 and traffic["input"] == "stack"
    assert set(traffic["limits"]) == set(two["traffic"]["limits"])
    assert traffic["limits"]["spiral_gap_px"] == 0.05


def test_the_cell_reports_its_metrics():
    spec = run.load_cell(CELL)
    assert [m["name"] for m in spec["end_to_end"]] == ["mpix_s", "peak_mem_gib", "setup_s"]
    layer = {m["name"]: m for m in spec["per_layer"]}
    assert {"k1_cluster_roofline_pct", "frame0_host_pct"} <= set(layer)
    assert layer["k1_cluster_roofline_pct"]["layer"] == "kernel K1, cluster route"
    assert layer["frame0_host_pct"]["layer"] == "entries: frame-0 sizing"
    assert all(m["moves"] == "mpix_s" for m in layer.values())
    for name in layer:
        assert callable(run.load_module("layer_metrics", name).read)


# -- the cell on the CPU -----------------------------------------------------------


def test_the_cell_is_correct_on_the_cpu(untraced):
    line, _ = untraced
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == set(run.load_cell(CELL)["traffic"]["limits"])
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_a_cpu_call_counts_frame0_and_no_cluster_launch(untraced):
    _, perf = untraced
    assert perf["frame0_s"] > 0.0 and perf["k1_cluster_launches"] == 0
    assert perf["chunks"] == 1  # 4 frames, chunks of 4


def test_the_bfloat16_control_is_refused():
    spec = run.load_cell(CELL)
    config, traffic = spec["config"], {**spec["traffic"], **TINY}
    config["detector"].update(SMALL["detector"])
    pool = run.load_module("gen", "stack").make_pool(SEED, config, traffic, torch.device("cpu"))
    entry = run.load_module("entries", traffic["entry"])
    numbers = entry.control(pool, traffic["args"], "cpu", Precision("bfloat16"), random.Random(1), config)
    limits = traffic["limits"]
    assert set(numbers) == set(limits)
    assert any(not np.isfinite(v) or v > limits[n] for n, v in numbers.items()), numbers


def test_traced_line_reads_frame0_and_no_cluster_route_on_the_cpu():
    """The CPU has no device trace and no cluster launch: the frame-0 share
    reads, the cluster route's roofline does not."""
    line = tiny_run(trace=True)
    assert line["correct"] is True
    assert 0.0 < line["metrics"]["frame0_host_pct"]["value"] < 100.0
    assert "k1_cluster_roofline_pct" not in line["metrics"]


# -- the per-layer readers ---------------------------------------------------------


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


PORT = "/x/barc4dip_tpu_torch"
EVENTS = [
    _ev("user_annotation", "perfbench.window", 0, 2000),
    _ev("python_function", f"{PORT}/ops/cuda_fftp.py(274): _cols_cluster", 100, 300),
    _ev("cuda_runtime", "cudaLaunchKernelExC", 110, 5, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 500, 5, corr=2),
    _ev("kernel", "corr_cols_cluster", 120, 800, corr=1),
    _ev("kernel", "corr_rows_c2r", 930, 300, corr=2),
]


def _record(tr, calls, detector=(4096, 4096)):
    log = []
    spec = run.load_cell(CELL)
    spec["config"]["detector"].update(height=detector[0], width=detector[1])
    return {"plain": tr, "attributed": tr, "calls": calls, "config": spec["config"],
            "traffic": spec["traffic"], "log": log.append}, log


def _calls(**counters):
    return [{"seconds": 2.0, "profiled": False, "counters": dict(counters)},
            {"seconds": 9.0, "profiled": True, "counters": {k: 9.0 for k in counters}},
            {"seconds": 2.0, "profiled": False, "counters": dict(counters)}]


def test_cluster_pass1_bytes_from_the_shapes():
    k1c = run.load_module("layer_metrics", "k1_cluster_roofline_pct")
    spec, mid = 4096 * 2049 * 8, 4096 * 2048 * 8
    # K1a: spectrum and mid plane; K1b: two banks of nine, the frame-0 bank a quarter a frame at chunks of 4
    want = (spec + mid) + (spec + 9 * spec / 4 + 9 * mid) + (spec + 9 * spec + 9 * mid)
    assert k1c.frame_bytes(4096, 4096, 4) == want
    assert k1c.frame_bytes(2048, 2048, 4) == 0.0  # pass 1 never takes the cluster route there
    # a 2560-column sensor on its side: only K1a's square frame is above 2048 rows
    assert k1c.frame_bytes(2048, 2560, 4) == 2560 * 1281 * 8 + 2560 * 1280 * 8


def test_cluster_roofline_reads_the_cluster_launches_only():
    k1c = run.load_module("layer_metrics", "k1_cluster_roofline_pct")
    tr = Trace(EVENTS, frames=16, calls=1)
    rec, log = _record(tr, _calls(k1_cluster_launches=12))
    want = 100.0 * 16 * k1c.frame_bytes(4096, 4096, 4) / 3.35e12 / 800e-6
    assert k1c.read(rec) == pytest.approx(want)
    assert "[12]" in log[-1]


@pytest.mark.parametrize("why", ["no counter", "no cluster launch", "no function", "no attributed window"])
def test_cluster_roofline_is_none_with_a_reason(why):
    k1c = run.load_module("layer_metrics", "k1_cluster_roofline_pct")
    tr = Trace(EVENTS, frames=16, calls=1)
    calls = {"no counter": _calls(dispatch_s=0.5), "no cluster launch": _calls(k1_cluster_launches=0)}.get(
        why, _calls(k1_cluster_launches=12))
    if why == "no function":  # the parent's port: pass 1 runs in no _cols_cluster
        tr = Trace([e for e in EVENTS if e["cat"] != "python_function"], frames=16, calls=1)
    rec, log = _record(None if why == "no attributed window" else tr, calls)
    assert k1c.read(rec) is None
    assert len(log) == 1 and log[0].startswith("k1_cluster_roofline_pct:")


def test_frame0_share_reads_the_unprofiled_calls():
    f0 = run.load_module("layer_metrics", "frame0_host_pct")
    rec, _ = _record(None, _calls(frame0_s=0.5))
    assert f0.read(rec) == pytest.approx(25.0)
    # the parent's entry carries no frame0_s: no reading, and no error
    rec, log = _record(None, _calls(dispatch_s=0.5) + [{"seconds": 1.0, "profiled": False, "counters": None}])
    assert f0.read(rec) is None and len(log) == 1 and "frame0_s" in log[0]
