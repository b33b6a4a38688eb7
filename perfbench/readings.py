"""Readings from which a cell's limits are set (not run by the benchmark).

    python3 perfbench/readings.py --workload <cell> --seeds 1 2 3 ... \\
        [--control bfloat16|tf32|float32 --control-seeds 7 8 9] [--out file.jsonl]

For each seed of ``--seeds``: a run of the cell (``run.run_cell``) with no
timed window, in which every pool item is called once after the cell's
warm-up, and its numbers compared: the lower readings. For each seed of
``--control-seeds``: the reference, computed at the ``--control`` precision,
is put in the program's place: the upper readings. One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.run import load_cell, load_module, log, run_cell, set_environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    set_environment()

    import torch

    from perfbench.reference.common import Precision

    spec = load_cell(a.workload)
    config, traffic = spec["config"], spec["traffic"]
    out = open(a.out, "a") if a.out else None

    def emit(row: dict) -> None:
        text = json.dumps(row)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    for seed in a.seeds:
        t0 = time.perf_counter()
        line = run_cell(a.workload, seed, 0.0, False, a.device, min_calls=int(traffic["pool"]))
        emit({"cell": a.workload, "side": "program", "seed": seed, "failed": line["failed"],
              "numbers": {n: c["value"] for n, c in line["checks"].items()},
              "seconds": time.perf_counter() - t0})
    entry = load_module("entries", traffic["entry"])
    gen = load_module("gen", traffic["input"])
    for seed in a.control_seeds:
        t0 = time.perf_counter()
        pool = gen.make_pool(seed, config, traffic, torch.device(a.device))
        numbers = entry.control(pool, traffic["args"], a.device, Precision(a.control), random.Random(seed), config, log)
        emit({"cell": a.workload, "side": f"control {a.control}", "seed": seed, "numbers": numbers,
              "seconds": time.perf_counter() - t0})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
