"""``speckle_stats`` on one host uint16 frame: the single-image quick start.

Judged after the window: the full and tile leaves of every call against the
reference on the same frame, and the lazy autocorrelation map of a call
drawn from the seed against the reference's map.
"""
from __future__ import annotations

import numpy as np

from perfbench import compare
from perfbench.reference.common import Precision
from perfbench.reference.speckle import grain_map, speckle_leaves


def call(port, item, args, device):
    return port.speckle_stats(item["data"], device=device, **args)


def frames(item) -> int:
    return 1


def pixels(item) -> int:
    return int(item["data"].size)


def counters(port):
    return None


def reference(item, args, device, prec: Precision) -> dict:
    return speckle_leaves(prec.frames(item["data"][None], device), prec, tiles=args.get("tiles", True))


def check(results, pool, args, device, rng, log, limits, config) -> dict:
    prec = Precision("float64")
    refs = {i: reference(pool[i], args, device, prec) for i in sorted({i for i, _ in results})}
    numbers = compare.judge(((compare.program_leaves(out), refs[i]) for i, out in results), log)
    i, out = results[rng.randrange(len(results))]
    got = np.asarray(out["full"]["grain"]["autocorr"], np.float64)
    want = grain_map(prec.frames(pool[i]["data"], device), prec)
    log(f"grain map read: call on pool item {i}")
    numbers["map_gap"] = float(np.max(np.abs(got - want)))
    return numbers


def control(pool, args, device, prec: Precision, rng, config, log=None) -> dict:
    hi = Precision("float64")
    numbers = compare.judge(((reference(it, args, device, prec), reference(it, args, device, hi)) for it in pool), log)
    it = pool[rng.randrange(len(pool))]
    numbers["map_gap"] = float(np.max(np.abs(grain_map(prec.frames(it["data"], device), prec)
                                             - grain_map(hi.frames(it["data"], device), hi))))
    return numbers
