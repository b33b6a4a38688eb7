"""Each input kind is the file ``gen/<input>.py``, found by its name: the
three kinds make the pools that ``gen.speckle`` makes, byte for byte; an input
with no file stops a run before its first call; a kind that only a new file
defines is found with no edit to the harness."""
import hashlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.gen import speckle

CPU = torch.device("cpu")
CONFIG = {"detector": {"height": 96, "width": 128},
          "content": {"grain_px": 6.0, "mean_counts": 4000.0, "spiral_amplitude": 0.35,
                      "spiral_omega": 0.7, "blur_sigma_step_px": 0.8}}
KINDS = {"stack": {"frames": 3, "pool": 2}, "frame": {"pool": 3}, "focus_scan": {"frames": 5, "pool": 2}}
SMALL = {"detector": {"height": 384, "width": 384}}
MISSING = "no_such_kind"


def digests(value):
    """sha256 of every array in a pool, with its dtype and shape; other
    values as they are."""
    if isinstance(value, np.ndarray):
        return (value.dtype.str, value.shape, hashlib.sha256(np.ascontiguousarray(value).tobytes()).hexdigest())
    if isinstance(value, dict):
        return {k: digests(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [digests(v) for v in value]
    return value


@pytest.mark.parametrize("seed", [2**33 + 5, 7])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_each_kind_file_makes_the_pool_of_gen_speckle(kind, seed):
    traffic = {"input": kind, **KINDS[kind]}
    mine = run.load_module("gen", kind).make_pool(seed, CONFIG, dict(traffic), CPU)
    theirs = speckle.make_pool(seed, CONFIG, dict(traffic), CPU)
    assert len(mine) == KINDS[kind]["pool"]
    assert digests(mine) == digests(theirs)
    assert all(isinstance(item["data"], np.ndarray) for item in mine)


def test_an_input_with_no_file_stops_the_run_before_any_call(monkeypatch):
    calls = []
    load = run.load_module

    def counting(kind, name):
        mod = load(kind, name)
        if kind == "entries":
            call = mod.call
            mod.call = lambda *a, **kw: (calls.append(1), call(*a, **kw))[1]
        return mod

    monkeypatch.setattr(run, "load_module", counting)
    path = run.BENCH / "gen" / f"{MISSING}.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        run.run_cell("speckle_2k.image", 1, 0.0, False, "cpu",
                     overrides={**SMALL, "traffic": {"input": MISSING, "pool": 2, "warmup_calls": 1}})
    assert calls == []


DRIVE_MISSING = """
import sys
import torch
sys.path.insert(0, {root!r})
from perfbench import run
# a card as far as the harness's look goes: the run must stop at set-up anyway
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.get_device_name = lambda *a: "a card"
load_cell = run.load_cell


def missing_input(cell):
    spec = load_cell(cell)
    spec["traffic"]["input"] = {missing!r}
    return spec


run.load_cell = missing_input
sys.exit(run.main(["--workload", "speckle_2k.image", "--seed", "1", "--seconds", "1", "--trace", "0"]))
"""


def test_an_input_with_no_file_exits_non_zero_with_no_result_line():
    proc = subprocess.run([sys.executable, "-c", DRIVE_MISSING.format(root=str(run.ROOT), missing=MISSING)],
                          capture_output=True, text=True, timeout=300, cwd=run.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert str(run.BENCH / "gen" / f"{MISSING}.py") in proc.stderr


NEW_KIND = '''
from pathlib import Path

from perfbench.gen import speckle


def make_pool(seed, config, traffic, device):
    Path(__file__).with_name("made").write_text(str(seed))
    items = speckle.make_pool(seed, config, dict(traffic, input="frame"), device)
    return [dict(item, index=k) for k, item in enumerate(items)]
'''


def test_a_kind_defined_only_by_a_new_file_is_found(tmp_path, monkeypatch):
    """A benchmark folder whose ``gen/`` holds one more file than the
    repo's: a cell whose traffic names it runs on its pool, correct."""
    for sub in ("traffic", "entries", "end_to_end", "layer_metrics"):
        (tmp_path / sub).symlink_to(run.BENCH / sub, target_is_directory=True)
    (tmp_path / "gen").mkdir()
    (tmp_path / "gen" / "numbered_frames.py").write_text(NEW_KIND)
    monkeypatch.setattr(run, "BENCH", tmp_path)
    seed = 2**33 + 11
    line = run.run_cell("speckle_2k.image", seed, 0.0, False, "cpu", min_calls=2,
                        overrides={**SMALL, "traffic": {"input": "numbered_frames", "pool": 2, "warmup_calls": 1}})
    assert (tmp_path / "gen" / "made").read_text() == str(seed)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    with pytest.raises(FileNotFoundError, match="stack.py"):
        run.load_module("gen", "stack")  # the repo's own kinds are not in this folder
