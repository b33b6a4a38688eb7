"""Every configuration, traffic mix, entry and metric loads by the name
that BENCHMARK.json gives it, and the file keeps to the benchmark's
contract: names, units, keys, lengths and the chip-time budget."""
import json
import re

import pytest

from perfbench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_budget():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"] == ["python3", "perfbench/run.py"]
    n = len(BENCH["workloads"])
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check with the 24 cells a benchmark may grow to: runs, compiles, spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= n <= 24 and sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, n // 4)
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen)), group
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for text in [c["source"] for c in BENCH["configs"]] + [e["why"] for e in BENCH["configs"] + BENCH["workloads"]] \
            + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_keys_bounds_and_cells():
    keys_e2e = {"name", "unit", "better", "bound", "source"}
    keys_layer = {"name", "unit", "better", "source", "layer", "moves"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == keys_e2e and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == keys_layer and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # every cell that reports it reports the metric it moves
        for cell in m.get("workloads", CELLS):
            assert run.applies(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in CELLS:
        spec = run.load_cell(cell)
        names = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    spec = run.load_cell(cell)
    cfg = next(c for c in BENCH["configs"] if c["name"] == spec["cell"]["config"])
    assert cfg["file"].startswith("perfbench/configs/") and spec["config"]["name"] == cfg["name"]
    assert set(cfg["reduced"]) <= set(spec["config"]["reduced"])
    traffic = spec["traffic"]
    assert {"entry", "input", "pool", "args", "warmup_calls", "trace", "limits"} <= set(traffic)
    entry = run.load_module("entries", traffic["entry"])
    for fn in ("call", "frames", "pixels", "counters", "check", "control"):
        assert callable(getattr(entry, fn))
    for m in spec["end_to_end"]:
        assert callable(run.load_module("end_to_end", m["name"]).read)
    for m in spec["per_layer"]:
        assert callable(run.load_module("layer_metrics", m["name"]).read)
    assert spec["cell"]["chips"] == 1


def test_each_config_is_used_and_has_its_own_file():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
