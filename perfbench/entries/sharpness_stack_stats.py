"""``sharpness_stack_stats`` on a host uint16 focus scan: the upstream
focus-scan example's first step.

Judged after the window: every frame's leaves of every call against the
reference on the same frames, and the scan's sharpest frame (the largest
Tenengrad) against the frame the scan was made in focus at.
"""
from __future__ import annotations

import numpy as np

from perfbench import compare
from perfbench.reference.common import Precision
from perfbench.reference.sharpness import sharpness_leaves

BLOCK = 4  # frames a reference step holds


def call(port, item, args, device):
    return port.sharpness_stack_stats(item["data"], device=device, **args)


def frames(item) -> int:
    return int(item["data"].shape[0])


def pixels(item) -> int:
    return int(item["data"].size)


def counters(port):
    return None


def _groups(args) -> tuple:
    return tuple(g.strip() for g in args["metrics"].split(","))


def reference(item, args, device, prec: Precision) -> dict:
    data = item["data"]
    return compare.concat([
        sharpness_leaves(prec.frames(data[t:t + BLOCK], device), prec, groups=_groups(args),
                         tiles=args.get("tiles", True))
        for t in range(0, data.shape[0], BLOCK)
    ])


def best_frame(leaves: dict) -> int:
    return int(np.argmax(leaves["full/gradient/tenengrad"]))


def check(results, pool, args, device, rng, log, limits, config) -> dict:
    prec = Precision("float64")
    refs = {i: reference(pool[i], args, device, prec) for i in sorted({i for i, _ in results})}
    got = [(i, compare.program_leaves(out)) for i, out in results]
    numbers = compare.judge(((leaves, refs[i]) for i, leaves in got), log)
    numbers["best_frame_misses"] = sum(best_frame(leaves) != pool[i]["truth"]["best_frame"]
                                       for i, leaves in got)
    return numbers


def control(pool, args, device, prec: Precision, rng, config, log=None) -> dict:
    hi = Precision("float64")
    low = [reference(it, args, device, prec) for it in pool]
    numbers = compare.judge(zip(low, (reference(it, args, device, hi) for it in pool)), log)
    numbers["best_frame_misses"] = sum(best_frame(lv) != it["truth"]["best_frame"]
                                       for lv, it in zip(low, pool))
    return numbers
