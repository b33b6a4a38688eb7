"""``speckle_stack_stats`` on a host uint16 stack: the Config D call.

Judged after the window: every frame's full and tile leaves of every call
against the reference on the same frames; the abs / inc trajectories (the
mean and std over the 3x3 ROI grid, and of the distance, that the result
carries) against the reference tracker's on the same frames
(``track_gap_px``), and against the spiral the frames were made with, a
truth that needs no program (``spiral_gap_px``); and one lazily read grain
map, of a call and a frame drawn from the seed, against the reference's map.
"""
from __future__ import annotations

import math

import numpy as np

from perfbench import compare
from perfbench.reference.common import Precision
from perfbench.reference.speckle import grain_map, speckle_leaves
from perfbench.reference.tracking import temporal, track_stack

BLOCK = 8  # frames a reference step holds


def call(port, item, args, device):
    return port.speckle_stack_stats(item["data"], device=device, **args)


def frames(item) -> int:
    return int(item["data"].shape[0])


def pixels(item) -> int:
    return int(item["data"].size)


def counters(port) -> dict:
    from barc4dip_tpu_torch.metrics import stack_fused

    return dict(stack_fused.LAST_RUN_PERF)


def reference(item, args, device, prec: Precision) -> dict:
    data = item["data"]
    return compare.concat([
        speckle_leaves(prec.frames(data[t:t + BLOCK], device), prec, tiles=args.get("tiles", True))
        for t in range(0, data.shape[0], BLOCK)
    ])


def reference_track(item, config, device, prec: Precision) -> dict:
    """The reference tracker's aggregates of a stack item."""
    a = config["analysis"]
    return temporal(track_stack(item["data"], device, prec, grain_factor=float(a["roi_grain_factor"]),
                                step_factor=float(a["roi_step_factor"])))


def track_gap(got: dict, want: dict) -> float:
    """Largest distance [px] between two sets of per-frame aggregates, over
    abs and inc and every field; infinity where one side is not finite."""
    gap = 0.0
    for kind, fields in want.items():
        for f, w in fields.items():
            d = np.abs(np.asarray(got[kind][f], np.float64) - w)
            gap = max(gap, float(np.max(d)) if np.all(np.isfinite(d)) else math.inf)
    return gap


def truth_gap(out: dict, truth: dict) -> float:
    """Largest distance [px] between the trajectories and the spiral, abs
    (from frame 0) and inc (from the frame before)."""
    dy, dx = np.asarray(truth["dy"]), np.asarray(truth["dx"])
    want = {"abs": (dy - dy[0], dx - dx[0]),
            "inc": (np.diff(dy, prepend=dy[0]), np.diff(dx, prepend=dx[0]))}
    gap = 0.0
    for kind, (wy, wx) in want.items():
        got = out["temporal"][kind]
        d = np.hypot(np.asarray(got["dy"], np.float64) - wy, np.asarray(got["dx"], np.float64) - wx)
        gap = max(gap, float(np.max(d)) if np.all(np.isfinite(d)) else math.inf)
    return gap


def check(results, pool, args, device, rng, log, limits, config) -> dict:
    """{number: reading} of the calls made in the window."""
    prec = Precision("float64")
    used = sorted({i for i, _ in results})
    refs = {i: reference(pool[i], args, device, prec) for i in used}
    numbers = compare.judge(((compare.program_leaves(out), refs[i]) for i, out in results), log)
    tracks = {i: reference_track(pool[i], config, device, prec) for i in used}
    numbers["track_gap_px"] = max(track_gap(out["temporal"], tracks[i]) for i, out in results)
    numbers["spiral_gap_px"] = max(truth_gap(out, pool[i]["truth"]) for i, out in results)
    i, out = results[rng.randrange(len(results))]
    t = rng.randrange(frames(pool[i]))
    got = np.asarray(out["full"]["grain"]["autocorr"][t], np.float64)
    want = grain_map(prec.frames(pool[i]["data"][t], device), prec)
    log(f"grain map read: call on pool item {i}, frame {t}")
    numbers["map_gap"] = float(np.max(np.abs(got - want)))
    return numbers


def control(pool, args, device, prec: Precision, rng, config, log=None) -> dict:
    """The readings of the reference at ``prec`` put in the program's place."""
    hi = Precision("float64")
    numbers = compare.judge(((reference(it, args, device, prec), reference(it, args, device, hi)) for it in pool), log)
    low = [reference_track(it, config, device, prec) for it in pool]
    numbers["track_gap_px"] = max(track_gap(lo, reference_track(it, config, device, hi)) for lo, it in zip(low, pool))
    numbers["spiral_gap_px"] = max(truth_gap({"temporal": lo}, it["truth"]) for lo, it in zip(low, pool))
    it = pool[rng.randrange(len(pool))]
    t = rng.randrange(frames(it))
    numbers["map_gap"] = float(np.max(np.abs(grain_map(prec.frames(it["data"][t], device), prec)
                                             - grain_map(hi.frames(it["data"][t], device), hi))))
    return numbers
