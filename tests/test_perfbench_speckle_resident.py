# SPDX-License-Identifier: CECILL-2.1
"""The benchmark's Config D cell on a stack held on the card
(``speckle_2k.stack64_resident``) on the CPU at a small size: its files
against their ``BENCHMARK.json`` entries, the input kind ``stack_resident``
(a float32 tensor equal to its host copy, off whole counts, made from the
seed), the cell's ``correct`` against the plain reference
(``perfbench/reference/``) at the cell's own limits, the bfloat16 control
refused, the entry's one rule of its own (a tile spread of a field whose
scale is 0 judged against itself), and the cell's reader ``card_wait_pct``.

Small size: 4 frames of 384^2 a stack, a pool of 2; the 2048^2 frames on the
card and every device time run only there."""
import json
import random

import numpy as np
import pytest
import torch

from perfbench import compare, run
from perfbench.reference.common import Precision

torch.set_num_threads(2)
CELL = "speckle_2k.stack64_resident"
SEED = 2**33 + 25
SMALL = {"detector": {"height": 384, "width": 384}}
TINY = {"frames": 4, "pool": 2, "warmup_calls": 1}
BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


def small_cell():
    spec = run.load_cell(CELL)
    spec["config"]["detector"].update(SMALL["detector"])
    spec["traffic"].update(TINY)
    return spec["config"], spec["traffic"]


def small_pool(seed=SEED):
    config, traffic = small_cell()
    return run.load_module("gen", "stack_resident").make_pool(seed, config, traffic, torch.device("cpu"))


def tiny_run(trace=False):
    return run.run_cell(CELL, SEED, 0.0, trace, "cpu", overrides={**SMALL, "traffic": TINY})


# -- the files ---------------------------------------------------------------------


def test_the_entries_name_existing_files_on_one_chip():
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert cell == {**cell, "config": "speckle_2k_resident", "traffic": "speckle_stack64_resident", "chips": 1}
    assert len(cell["why"]) <= 200
    spec = run.load_cell(CELL)
    traffic = spec["traffic"]
    assert (run.BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (run.BENCH / "gen" / f"{traffic['input']}.py").is_file()
    assert (run.BENCH / "entries" / f"{traffic['entry']}.py").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        kind = "end_to_end" if m in spec["end_to_end"] else "layer_metrics"
        assert (run.BENCH / kind / f"{m['name']}.py").is_file(), m["name"]
    # a deployment of its own with speckle_2k's detector, content and analysis: only the stack's
    # place, dtype and length differ
    conf = next(c for c in BENCH["configs"] if c["name"] == "speckle_2k_resident")
    assert conf["file"] == "perfbench/configs/speckle_2k_resident.json" and conf["reduced"] == []
    assert len(conf["source"]) <= 200 and len(conf["why"]) <= 200
    assert conf["source"] not in {c["source"] for c in BENCH["configs"] if c is not conf}
    two = run.load_cell("speckle_2k.stack100")
    own = {"name", "deployment", "source", "input", "stack_frames", "assumed"}
    assert spec["config"]["name"] == "speckle_2k_resident" and spec["config"]["reduced"] == {}
    assert set(spec["config"]) == set(two["config"]) | {"input"}
    assert {k: v for k, v in spec["config"].items() if k not in own} == \
        {k: v for k, v in two["config"].items() if k not in own}
    assert spec["config"]["input"]["dtype"] == "float32" and spec["config"]["stack_frames"] == traffic["frames"]
    assert traffic["args"] == two["traffic"]["args"] == {"metrics": "all", "tiles": True, "frame_chunk": 4,
                                                          "verbose": False}
    assert traffic["frames"] == 64 and traffic["pool"] == 2 and traffic["warmup_calls"] == 2
    assert traffic["input"] == "stack_resident" and traffic["offset"] == [-0.5, 0.5]
    assert traffic["trace"] == {"plain": 1, "attributed": 1}
    assert set(traffic["limits"]) == set(two["traffic"]["limits"])
    assert traffic["limits"]["spiral_gap_px"] == 0.05


def test_the_cell_reports_its_metrics():
    spec = run.load_cell(CELL)
    assert [m["name"] for m in spec["end_to_end"]] == ["mpix_s", "peak_mem_gib", "setup_s"]
    layer = {m["name"]: m for m in spec["per_layer"]}
    assert set(layer) == {"dispatch_pct", "launches_per_frame", "k1_roofline_pct", "device_idle_pct",
                          "frame0_host_pct", "card_wait_pct"}
    assert layer["card_wait_pct"] == {
        "name": "card_wait_pct", "unit": "%", "better": "lower", "source": "program_counter",
        "layer": "chunk loop: resident stack, waiting on the card", "moves": "mpix_s", "workloads": [CELL]}
    assert BENCH["per_layer"][-1]["name"] == "card_wait_pct"


# -- the input kind ----------------------------------------------------------------


def test_the_pool_is_a_float32_tensor_equal_to_its_host_copy():
    pool = small_pool()
    assert len(pool) == 2
    for item in pool:
        stack = item["stack"]
        assert isinstance(stack, torch.Tensor) and stack.dtype == torch.float32 and stack.is_contiguous()
        assert tuple(stack.shape) == (4, 384, 384)
        assert item["data"].dtype == np.float32
        np.testing.assert_array_equal(stack.numpy(), item["data"])
        assert np.mean(item["data"] != np.round(item["data"])) > 0.99  # calibrated, not whole counts
        assert (item["data"] < 0).any()  # a pixel of no count, less half a count, falls below zero
        assert set(item["truth"]) == {"dy", "dx"} and len(item["truth"]["dy"]) == 4
    assert not np.array_equal(pool[0]["data"], pool[1]["data"])


def test_the_pool_is_the_stack_kinds_counts_plus_the_offset():
    config, traffic = small_cell()
    counts = run.load_module("gen", "stack").make_pool(SEED, config, dict(traffic, input="stack"),
                                                       torch.device("cpu"))[0]["data"]
    # the first stack draws from the generator as the stack kind's first does
    diff = small_pool()[0]["data"].astype(np.float64) - counts
    assert diff.min() >= -0.5 and diff.max() <= 0.5 and abs(diff.mean()) < 0.01


def test_the_pool_is_made_from_the_seed():
    a, b, c = small_pool(), small_pool(), small_pool(SEED + 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["data"], y["data"])
    assert not np.array_equal(a[0]["data"], c[0]["data"])


# -- the cell on the CPU -----------------------------------------------------------


def test_the_cell_is_correct_on_the_cpu():
    line = tiny_run()
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == set(run.load_cell(CELL)["traffic"]["limits"])
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_the_bfloat16_control_is_refused():
    config, traffic = small_cell()
    pool = small_pool()
    entry = run.load_module("entries", traffic["entry"])
    numbers = entry.control(pool, traffic["args"], "cpu", Precision("bfloat16"), random.Random(1), config)
    limits = traffic["limits"]
    assert set(numbers) == set(limits)
    assert any(not np.isfinite(v) or v > limits[n] for n, v in numbers.items()), numbers


def test_the_entry_passes_the_tensor_and_counts_its_pixels():
    entry = run.load_module("entries", "speckle_stack_stats_resident")
    item = small_pool()[0]
    seen = {}

    class Port:
        def speckle_stack_stats(self, stack, **kw):
            seen.update(stack=stack, kw=kw)
            return {}

    entry.call(Port(), item, {"frame_chunk": 4}, "cpu")
    assert seen["stack"] is item["stack"] and seen["kw"] == {"frame_chunk": 4}
    assert entry.frames(item) == 4 and entry.pixels(item) == 4 * 384 * 384


def test_traced_line_reads_the_card_wait_on_the_cpu():
    """The CPU has no device trace: the counters' shares read, the trace's do not."""
    line = tiny_run(trace=True)
    assert line["correct"] is True
    for name in ("card_wait_pct", "frame0_host_pct", "dispatch_pct"):
        assert 0.0 <= line["metrics"][name]["value"] < 100.0, name
    assert "k1_roofline_pct" not in line["metrics"] and "device_idle_pct" not in line["metrics"]


def test_a_spread_of_a_zero_scale_field_is_judged_against_itself():
    """``frac_zero`` off whole counts: 0 in every frame and tile but one,
    where one pixel of a 227^2 subtile lies within eps of zero. Its spread,
    off by float32 round-off, reads infinite against the field's scale of 0
    and 1e-7 against itself; off by a pixel's share it reads large. Fields
    of nonzero scale keep ``compare``'s rule."""
    entry = run.load_module("entries", "speckle_stack_stats_resident")
    share = 1.0 / 227**2
    mean, std = np.zeros((2, 3, 3)), np.zeros((2, 3, 3))
    mean[1, 0, 2], std[1, 0, 2] = share / 9, share * 8**0.5 / 9
    ref = {"full/stats/frac_zero": np.zeros(2), "tiles/stats/frac_zero/mean": mean,
           "tiles/stats/frac_zero/std": std, "full/stats/mean": np.array([8000.0, 8001.0]),
           "tiles/stats/mean/mean": np.full((2, 3, 3), 8000.0), "tiles/stats/mean/std": np.full((2, 3, 3), 40.0)}
    prog = {**ref, "tiles/stats/frac_zero/std": std * (1 + 1e-7), "tiles/stats/mean/std": np.full((2, 3, 3), 40.004)}
    key = "tiles/stats/frac_zero/std"
    assert compare.value_gaps(prog, ref)[key].max() == np.inf
    got = entry.gaps(prog, ref)
    assert got[key].max() == pytest.approx(1e-7, rel=1e-3) and got[key][0].max() == 0.0
    want = compare.value_gaps(prog, ref)
    for k in ref:
        if k != key:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert entry.judge([(prog, ref)])["leaf_gap"] == pytest.approx(0.004 / 8000.0)
    moved = {**prog, key: std + share / 9}
    assert entry.gaps(moved, ref)[key].max() > 0.1
    assert entry.gaps({**prog, key: std[:1]}, ref)[key].min() == np.inf  # a leaf of another shape


# -- the reader --------------------------------------------------------------------


def _record(calls):
    log = []
    return {"plain": None, "attributed": None, "calls": calls, "log": log.append}, log


def test_card_wait_reads_the_unprofiled_resident_calls():
    cw = run.load_module("layer_metrics", "card_wait_pct")
    calls = [{"seconds": 2.0, "profiled": False, "counters": {"pull_wait_s": 0.5, "resident_frames": 64}},
             {"seconds": 9.0, "profiled": True, "counters": {"pull_wait_s": 9.0, "resident_frames": 64}},
             {"seconds": 2.0, "profiled": False, "counters": {"pull_wait_s": 1.5, "resident_frames": 64}},
             {"seconds": 4.0, "profiled": False, "counters": {"pull_wait_s": 4.0, "resident_frames": 0}}]
    rec, log = _record(calls)
    assert cw.read(rec) == pytest.approx(50.0) and not log


@pytest.mark.parametrize("counters", [{"pull_wait_s": 0.5}, {"pull_wait_s": 0.5, "resident_frames": 0}, None],
                         ids=["parent", "host stack", "no counters"])
def test_card_wait_is_none_without_resident_frames(counters):
    """The parent's chunk loop counts no resident frames: no reading, and no error."""
    cw = run.load_module("layer_metrics", "card_wait_pct")
    rec, log = _record([{"seconds": 1.0, "profiled": False, "counters": counters}])
    assert cw.read(rec) is None
    assert len(log) == 1 and log[0].startswith("card_wait_pct:") and "resident_frames" in log[0]
