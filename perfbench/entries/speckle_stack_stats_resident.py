"""``speckle_stack_stats`` on a float32 stack held on the card: Config D on
the corrected stack that a flat-field left there. The call receives the CUDA
tensor, and the chunk loop slices it on the card with no upload.

Judged as the host stack entry (``speckle_stack_stats.py``) judges, on the
host copy of the exact float32 values the call received (``item["data"]``):
every frame's full and tile leaves, the abs / inc trajectories against the
reference tracker and against the spiral, and one lazily read grain map.

One rule differs, in :func:`gaps`: a tile spread (``/std``) of a field whose
scale is 0 is judged against its own value. Frames off whole counts have a
pixel within ``eps`` of zero about once in a thousand frames, so
``frac_zero`` is 0 in nearly every frame and tile, its scale (``compare``'s
median magnitude) is 0, and where one such pixel falls the spread of its
3x3 block of subtile shares, a few millionths, would read an infinite gap at
any float32 round-off. The program counts the same pixels as the reference:
the spread is judged like a full-frame value, relative to itself."""
from __future__ import annotations

import math

import numpy as np

from perfbench import compare
from perfbench.entries import speckle_stack_stats as host
from perfbench.reference.common import Precision
from perfbench.reference.speckle import grain_map

counters = host.counters
reference = host.reference


def call(port, item, args, device):
    return port.speckle_stack_stats(item["stack"], **args)


def frames(item) -> int:
    return int(item["stack"].shape[0])


def pixels(item) -> int:
    return int(item["stack"].numel())


def gaps(prog: dict, ref: dict) -> dict:
    """``compare.value_gaps``, with a tile spread of a field of scale 0
    judged as ``|program - reference| / |reference|`` (0 where both are 0)."""
    out = compare.value_gaps(prog, ref)
    scales = compare.field_scales(ref)
    for key, r in ref.items():
        field = "/".join(key.split("/")[1:3])
        p = prog.get(key)
        if not key.endswith("/std") or scales.get(field) != 0.0 or p is None or np.shape(p) != np.shape(r):
            continue
        r, p = np.asarray(r, np.float64), np.asarray(p, np.float64)
        fin_p, fin_r = np.isfinite(p), np.isfinite(r)
        d = np.where(fin_r & fin_p, np.abs(p - np.where(fin_r, r, 0.0)), 0.0)
        denom = np.abs(np.where(fin_r, r, 0.0))
        gap = np.where(denom > 0, d / np.where(denom > 0, denom, 1.0), np.where(d > 0, math.inf, 0.0))
        out[key] = np.where(fin_p == fin_r, gap, math.inf)
    return out


def judge(pairs, log=None) -> dict:
    """``compare.judge`` with :func:`gaps`."""
    w = compare.Widest()
    for prog, ref in pairs:
        w.add(gaps(prog, ref))
    return w.numbers(log)


def check(results, pool, args, device, rng, log, limits, config) -> dict:
    """{number: reading} of the calls made in the window."""
    prec = Precision("float64")
    used = sorted({i for i, _ in results})
    refs = {i: reference(pool[i], args, device, prec) for i in used}
    numbers = judge(((compare.program_leaves(out), refs[i]) for i, out in results), log)
    tracks = {i: host.reference_track(pool[i], config, device, prec) for i in used}
    numbers["track_gap_px"] = max(host.track_gap(out["temporal"], tracks[i]) for i, out in results)
    numbers["spiral_gap_px"] = max(host.truth_gap(out, pool[i]["truth"]) for i, out in results)
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
    numbers = judge(((reference(it, args, device, prec), reference(it, args, device, hi)) for it in pool), log)
    low = [host.reference_track(it, config, device, prec) for it in pool]
    numbers["track_gap_px"] = max(host.track_gap(lo, host.reference_track(it, config, device, hi))
                                  for lo, it in zip(low, pool))
    numbers["spiral_gap_px"] = max(host.truth_gap({"temporal": lo}, it["truth"]) for lo, it in zip(low, pool))
    it = pool[rng.randrange(len(pool))]
    t = rng.randrange(frames(it))
    numbers["map_gap"] = float(np.max(np.abs(grain_map(prec.frames(it["data"][t], device), prec)
                                             - grain_map(hi.frames(it["data"][t], device), hi))))
    return numbers
