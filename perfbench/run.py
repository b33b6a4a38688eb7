"""Run one cell of the benchmark of ``barc4dip_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is found by name: ``BENCHMARK.json`` names its
configuration and traffic mix; ``perfbench/configs/<config>.json`` holds the
detector, the content and the analysis settings; ``perfbench/traffic/<mix>.json``
the entry it drives, the call's arguments, the kind and pool of inputs, the
traced sub-windows and the limits of the comparison;
``perfbench/gen/<input>.py`` how to make that kind of input;
``perfbench/entries/<entry>.py`` how to call the entry and how to judge its
results;
``perfbench/end_to_end/<metric>.py`` and ``perfbench/layer_metrics/<metric>.py``
one reader each.

A run makes its inputs on the card from ``--seed``, warms up every shape
the cell uses (set-up), then calls the entry in a closed loop, one caller,
for ``--seconds``; a call that ends after the window closes counts whole.
Then it reads the peak memory, checks the results against the plain
reference, prints each number compared beside its limit on standard error,
and prints one JSON line last on standard output. With ``--trace 1`` two
short profiled sub-windows run inside the window and the line carries the
per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
#: Top-level modules that no run may load: JAX, and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "barc4dip_tpu")

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def set_environment() -> None:
    """Build caches at fixed places inside the checkout, so that only a
    cell's first run in a checkout builds (the port's nvcc kernels go to
    ``build/kernels``), and no library loads JAX's Flax on its own."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(cell: str) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    return {
        "cell": work,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads((BENCH / "traffic" / f"{work['traffic']}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, cell)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, cell)],
    }


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, *, overrides=None,
             min_calls: int = 0) -> dict:
    """One run of ``cell`` on ``device``: set-up, window, check. Returns the
    result line's fields. ``overrides`` ({"detector": {...}, "traffic":
    {...}}) shrink a cell for the CPU tests; the window makes at least
    ``min_calls`` calls."""
    import torch

    from perfbench.trace import profile_calls

    spec = load_cell(cell)
    config, traffic = spec["config"], spec["traffic"]
    for key, val in (overrides or {}).items():
        (traffic if key == "traffic" else config.setdefault(key, {})).update(val)
    gen = load_module("gen", traffic["input"])
    cuda = torch.device(device).type == "cuda"
    import barc4dip_tpu_torch as port

    entry = load_module("entries", traffic["entry"])
    args = traffic["args"]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    pool = gen.make_pool(seed, config, traffic, torch.device(device))
    for k in range(int(traffic["warmup_calls"])):
        entry.call(port, pool[k % len(pool)], args, device)
    gc.collect()
    sync()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START

    results, calls, failed = [], [], 0

    def one(k: int, profiled: bool) -> dict | None:
        nonlocal failed
        item = pool[k % len(pool)]
        t0 = time.perf_counter()
        try:
            out = entry.call(port, item, args, device)
            sync()
        except Exception:  # a failed call is counted, and the run goes on
            failed += 1
            log(traceback.format_exc())
            return None
        rec = {"seconds": time.perf_counter() - t0, "frames": entry.frames(item),
               "pixels": entry.pixels(item), "counters": entry.counters(port), "profiled": profiled}
        results.append((k % len(pool), out))
        calls.append(rec)
        # the results kept for the check go where the collector no longer
        # walks them, so that keeping them costs the calls nothing
        gc.freeze()
        return rec

    # a traced run profiles calls 1.. (plain), then, one call later, the
    # attributed sub-window; the calls around them run untraced
    plan = traffic["trace"]
    starts = {1: "plain", 2 + int(plan["plain"]): "attributed"} if trace else {}
    sub = {"plain": None, "attributed": None}
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds or k <= max(starts, default=0) or k < min_calls:
        if k in starts:
            kind = starts[k]
            n, first = int(plan[kind]), k

            def several(n=n, first=first):
                return [r for r in (one(first + j, True) for j in range(n)) if r is not None]

            tr = sub[kind] = profile_calls(several, attributed=kind == "attributed")
            log(f"{kind} sub-window: {tr.calls} calls, {tr.frames} frames, {tr.wall_s:.6f} s; "
                f"{len(tr.launches)} launch calls, {tr.kernels} kernels seen; "
                f"trace {tr.file_bytes} bytes read in {tr.read_s:.3f} s")
            k += n
            continue
        one(k, False)
        k += 1
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()
    secs = sorted(c["seconds"] for c in calls if not c["profiled"])
    if secs:
        log(f"{len(secs)} untraced calls in {window_s:.3f} s: seconds min {secs[0]:.4f}, "
            f"quartiles {secs[len(secs) // 4]:.4f} / {secs[len(secs) // 2]:.4f} / {secs[3 * len(secs) // 4]:.4f}, "
            f"max {secs[-1]:.4f}")

    window = {"setup_s": setup_s, "window_s": window_s, "peak_bytes": peak,
              "calls": [c for c in calls if not c["profiled"]]}
    line: dict = {"correct": False, "attempted": k, "failed": failed, "metrics": {}}
    if trace:
        record = {"plain": sub["plain"], "attributed": sub["attributed"], "calls": calls,
                  "config": config, "traffic": traffic, "log": log}
        for m in spec["per_layer"]:
            value = load_module("layer_metrics", m["name"]).read(record)
            if value is not None:
                line["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            value = load_module("end_to_end", m["name"]).read(window)
            line["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
    line["device"] = {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                      "count": int(spec["cell"]["chips"]), "memory_peak_bytes": int(peak)}
    if trace and sub["plain"] is not None:
        tr = sub["plain"]
        line["device"].update(busy_s=tr.busy_s, window_s=tr.wall_s)
        line["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}

    # the program's device memory goes back before the reference runs; the
    # pool and the results are on the host
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    numbers = entry.check(results, pool, args, device, random.Random(seed), log, traffic["limits"], config)
    log(f"check took {time.perf_counter() - t1:.3f} s")
    limits = traffic["limits"]
    checks = {n: {"value": float(v), "limit": float(limits[n])} for n, v in numbers.items()}
    line["correct"] = failed == 0 and bool(results) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    set_environment()

    import torch

    chips = int(load_cell(a.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x {torch.cuda.device_count()}")
    line = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {', '.join(bad)}: no result")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    log(f"correct: {line['correct']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
