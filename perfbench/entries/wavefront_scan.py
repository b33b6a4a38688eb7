"""A raw XST wavefront scan, as a user chains the port's public API on
detector data: ``flat_field_correction`` of the reference and of the scan's
frames (dead pixels repaired by the 3x3 median, kernel K2), then
``WavefrontScanPipeline`` on the corrected frames against the corrected
reference (dense tracking, kernel K3; the slopes integrated on the host).

The corrected stack (0.5 GB a call) cannot be kept for the check, so the
call gathers, on the card, the corrected reference and frames at the
item's fixed pixel sample (``gen/xst_scan.py``: 32,768 pixels a frame, every
dead pixel among them) and pulls that sample with the result; only the
arrays the check reads are kept.

Judged after the window, each call against the plain reference
(``reference/xst.py``, float64 on the card) on its scan:

- ``ffc_gap_rel``: the largest gap of a sampled corrected pixel, over the
  larger of its reference value and the sample's median magnitude (so that
  a pixel whose counts barely clear the dark level is judged in the units
  of the image, as ``compare.py`` judges a value near zero);
- ``repair_misses``: sampled pixels whose class differs from the
  reference's: a pixel reads *repaired* where its value lies nearer the 3x3
  median of its zeroed neighbourhood than to what no repair leaves (0 at a
  bad pixel, the formula at a good one); pixels where those two candidates
  lie within 1e-3 of the sample's median magnitude of each other tell
  nothing and are not counted;
- ``node_moved_pct``: nodes whose integer peak differs from the
  reference's, in % of all nodes; the program returns no integer peak, so
  it is read as the offset, among the reference's peak and its eight
  neighbours, from which the reference's own Newton step lands nearest the
  program's answer (ties go to the peak): the step is a function of its
  start, and steps from neighbouring starts differ by ~1e-2 px where
  float32 moves one by ~1e-5 px;
- ``field_gap_px`` / ``peak_gap``: the largest |d dy|, |d dx| / |d peak|
  over the other nodes;
- ``wavefront_gap_rel``: the program's wavefront against the reference
  integrator applied to the program's own slopes, over the largest |w|;
- ``truth_gap_px``: the worst per-frame median, over the interior nodes
  (two nodes of border left out), of dy and dx less the motion the frames
  were made with, a truth that needs no program;
- ``radius_gap_rel``: the curvature radius fitted to each interior
  wavefront (``w = r^2 / 2R + c``) against the R the frames were made with.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import xst as ref_xst
from perfbench.reference.common import Precision

#: counters of the last call: the two flat-field calls' summed, and the tracking's
_LAST: dict = {}
AMBIGUOUS = 1e-3  # of the sample's median magnitude: repair candidates this close tell nothing
BORDER = 2  # nodes of border left out of the truth and the radius fit


def call(port, item, args, device):
    from barc4dip_tpu_torch.models import WavefrontScanPipeline
    from barc4dip_tpu_torch.preprocessing import normalize
    from barc4dip_tpu_torch.signal import xst

    kw = dict(flats=item["flats"], darks=item["darks"], as_numpy=False, device=device, **args["flat_field"])
    ref = normalize.flat_field_correction(item["ref"], **kw)
    ffc_perf = [dict(getattr(normalize, "LAST_RUN_PERF", None) or {})]
    stack = normalize.flat_field_correction(item["stack"], **kw)
    ffc_perf.append(dict(getattr(normalize, "LAST_RUN_PERF", None) or {}))
    out = WavefrontScanPipeline(device=device, **args["pipeline"])(stack, ref)
    idx = item["sample"]
    sample = torch.cat([ref.reshape(1, -1)[:, idx], stack.reshape(stack.shape[0], -1)[:, idx]]).cpu().numpy()
    _LAST.clear()
    track_perf = getattr(xst, "LAST_RUN_PERF", None)
    if all(ffc_perf) and track_perf:
        _LAST.update({k: ffc_perf[0][k] + ffc_perf[1][k] for k in ffc_perf[0]}, **track_perf)
    return {"dy": out["dy"], "dx": out["dx"], "peak": out["peak"], "wavefront": out["wavefront"],
            "y": out["y"], "x": out["x"], "ffc": sample}


def frames(item) -> int:
    return int(item["stack"].shape[0])


def pixels(item) -> int:
    return int(item["stack"].size)


def counters(port):
    return dict(_LAST) if _LAST else None


def reference(item, args, device, prec: Precision) -> dict:
    """The reference's answers for one scan: the flat-field's candidates at
    the sample, the tracked fields, and the geometry."""
    p = args["pipeline"]
    cal = ref_xst.calibration(item["flats"], item["darks"], prec, device)
    idx = item["sample"].to(device)
    r = ref_xst.flat_field(item["ref"], cal, prec, device, idx)
    parts = [ref_xst.flat_field(item["stack"][t:t + 8], cal, prec, device, idx)
             for t in range(0, item["stack"].shape[0], 8)]
    ffc = {k: torch.cat([r[k][None]] + [q[k] for q in parts]).double().cpu().numpy()
           for k in ("value", "repaired", "left")}
    ffc["bad"] = cal["bad"].flatten()[idx].cpu().numpy()
    frames_ = torch.cat([q.pop("frames") for q in parts])
    fields = ref_xst.track(frames_, r["frames"], prec, tile=p["tile_size"], step=p["step"], radius=p["search_radius"],
                           subpixel=p["subpixel"])
    del frames_
    return {"ffc": ffc, **fields}


def _slopes(out, p):
    scale = p["pixel_size"] / p["distance"]
    return np.asarray(out["dy"], np.float64) * scale, np.asarray(out["dx"], np.float64) * scale


def truth_field(ys, xs, truth, t: int):
    """The displacement [px] of the tile centred at (ys, xs) of the
    reference in frame t: the point p with p - d(p) = y, d(p) = (p - c) k + s."""
    k, (cy, cx) = truth["k"], truth["centre"]
    ty = (ys - cy * k + truth["drift_dy"][t]) / (1.0 - k) - ys
    tx = (xs - cx * k + truth["drift_dx"][t]) / (1.0 - k) - xs
    return ty, tx


def numbers(out, want, item, args, device) -> dict:
    """The comparison of one call (or of the control's answers) with the
    reference's answers ``want`` on the same scan."""
    p = args["pipeline"]
    ffc, got = want["ffc"], np.asarray(out["ffc"], np.float64)
    mag = float(np.median(np.abs(ffc["value"])))
    gap = np.abs(got - ffc["value"]) / np.maximum(np.abs(ffc["value"]), mag)
    repaired = np.abs(got - ffc["repaired"]) < np.abs(got - ffc["left"])
    telling = np.abs(ffc["repaired"] - ffc["left"]) > AMBIGUOUS * mag
    res = {"ffc_gap_rel": float(np.max(gap)) if np.all(np.isfinite(got)) else math.inf,
           "repair_misses": float(np.count_nonzero((repaired != ffc["bad"][None]) & telling))}

    dy, dx, pk = (np.asarray(out[k], np.float64) for k in ("dy", "dx", "peak"))
    if dy.shape != want["dy"].shape or not all(np.all(np.isfinite(a)) for a in (dy, dx, pk)):
        return {**res, **{n: math.inf for n in ("node_moved_pct", "field_gap_px", "peak_gap", "wavefront_gap_rel",
                                                "truth_gap_px", "radius_gap_rel")}}
    d2 = (dy[..., None] - want["start_dy"]) ** 2 + (dx[..., None] - want["start_dx"]) ** 2
    moved = d2[..., 4] > d2.min(-1)
    same = ~moved
    res["node_moved_pct"] = 100.0 * float(moved.mean())
    res["field_gap_px"] = float(max(np.abs(dy - want["dy"])[same].max(initial=0.0),
                                    np.abs(dx - want["dx"])[same].max(initial=0.0)))
    res["peak_gap"] = float(np.abs(pk - want["peak"])[same].max(initial=0.0))

    gy, gx = _slopes(out, p)
    w = np.asarray(out["wavefront"], np.float64)
    w_ref = ref_xst.integrate(gy, gx, p["step"] * p["pixel_size"], Precision("float64"), device)
    res["wavefront_gap_rel"] = float(np.max(np.abs(w - w_ref)) / np.max(np.abs(w_ref)))

    inner = (slice(BORDER, -BORDER), slice(BORDER, -BORDER))
    Y, X = np.meshgrid(np.asarray(out["y"], np.float64), np.asarray(out["x"], np.float64), indexing="ij")
    truth = item["truth"]
    worst = 0.0
    r2 = ((Y - truth["centre"][0]) ** 2 + (X - truth["centre"][1]) ** 2) * p["pixel_size"] ** 2
    A = np.stack([r2[inner].ravel(), np.ones(r2[inner].size)], axis=1)
    radius_gap = 0.0
    for t in range(dy.shape[0]):
        ty, tx = truth_field(Y, X, truth, t)
        worst = max(worst, abs(float(np.median((dy[t] - ty)[inner]))), abs(float(np.median((dx[t] - tx)[inner]))))
        coef = np.linalg.lstsq(A, w[t][inner].ravel(), rcond=None)[0]
        fit = 1.0 / (2.0 * coef[0]) if coef[0] != 0 else math.inf
        radius_gap = max(radius_gap, abs(fit - truth["radius_m"]) / truth["radius_m"])
    res["truth_gap_px"], res["radius_gap_rel"] = worst, float(radius_gap)
    return res


def _widest(rows) -> dict:
    out: dict = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def check(results, pool, args, device, rng, log, limits, config) -> dict:
    """{number: the widest reading over the calls made in the window}."""
    prec = Precision("float64")
    refs = {i: reference(pool[i], args, device, prec) for i in sorted({i for i, _ in results})}
    rows = [numbers(out, refs[i], pool[i], args, device) for i, out in results]
    res = _widest(rows)
    log("widest readings: " + ", ".join(f"{k} {v:.4g}" for k, v in res.items()))
    return res


def control(pool, args, device, prec: Precision, rng, config, log=None) -> dict:
    """The readings of the reference at ``prec`` put in the program's place:
    its flat-field sample, its fields, its own integration of its slopes."""
    hi = Precision("float64")
    p = args["pipeline"]
    rows = []
    for item in pool:
        low = reference(item, args, device, prec)
        H, W = item["ref"].shape
        y0s, x0s = ref_xst.grid_starts(H, W, p["tile_size"], p["search_radius"], p["step"])
        half = (p["tile_size"] - 1) / 2.0
        gy, gx = _slopes(low, p)
        out = {"dy": low["dy"], "dx": low["dx"], "peak": low["peak"], "ffc": low["ffc"]["value"],
               "wavefront": ref_xst.integrate(gy, gx, p["step"] * p["pixel_size"], prec, device),
               "y": y0s + half, "x": x0s + half}
        rows.append(numbers(out, reference(item, args, device, hi), item, args, device))
    res = _widest(rows)
    if log:
        log(f"control {prec.name}: " + ", ".join(f"{k} {v:.4g}" for k, v in res.items()))
    return res
