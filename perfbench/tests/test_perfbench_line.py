"""The result line: its keys and their order, no result without a card or
without the program, and a run of each cell's control flow on the CPU at a
tiny size (the CPU run is no measurement: the harness prints nothing for it)."""
import json
import shutil
import subprocess
import sys

import pytest

from perfbench import run

SMALL = {"detector": {"height": 384, "width": 384}}
TINY = {
    "speckle_2k.stack100": {"frames": 6, "pool": 2, "warmup_calls": 1},
    "speckle_2k.image": {"pool": 3, "warmup_calls": 1, "trace": {"plain": 2, "attributed": 1}},
    "sharpness_2k.image": {"pool": 2, "warmup_calls": 1, "trace": {"plain": 1, "attributed": 1}},
    "sharpness_2k.scan11": {"frames": 7, "pool": 2, "warmup_calls": 1, "trace": {"plain": 2, "attributed": 1}},
}


def tiny_run(cell, trace=False, seed=2**33 + 3):
    return run.run_cell(cell, seed, 0.0, trace, "cpu", overrides={**SMALL, "traffic": TINY[cell]})


@pytest.mark.parametrize("cell", sorted(TINY))
def test_line_keys_on_the_cpu(cell):
    line = tiny_run(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert [m["name"] for m in run.load_cell(cell)["end_to_end"]] == list(line["metrics"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert set(line["checks"]) == set(run.load_cell(cell)["traffic"]["limits"])
    json.dumps(line)


def test_traced_line_keys_on_the_cpu():
    line = tiny_run("speckle_2k.stack100", trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no device metric can be read; the counters' metrics can
    assert set(line["metrics"]) <= {"dispatch_pct", "upload_pct"}


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "speckle_2k.image", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run fails and prints no result."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'perfbench'); import run; "
            "print(run.run_cell('speckle_2k.image', 1, 0.0, False, 'cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "barc4dip_tpu_torch" in proc.stderr


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    """On the card: a short run of the image cell, correct, naming the card."""
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "speckle_2k.image", "--seed",
                           "5000000001", "--seconds", "3", "--trace", "0"],
                          cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    import torch

    assert line["correct"] and line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
