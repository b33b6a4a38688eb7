"""The comparison that decides ``correct``: leaves of the program against
leaves of the reference, each gap in the units of its own field.

A leaf is ``full/<group>/<field>`` (one value a frame) or
``tiles/<group>/<field>/<mean|std>`` (a 3x3 grid a frame). A field's scale is
the median magnitude of the reference's full-frame values and tile means of
that field, so that a value near zero (a skewness, a tile's spread) is judged
against the size of the quantity and not against itself. A gap is
``|program - reference| / max(|reference|, scale)``; the tile spread (std)
and leaves in decibels, whose absolute difference is already a relative one,
are judged as ``|program - reference| / scale`` and ``|dB| ln(10) / 20``. A
leaf that is finite on one side only reads infinity.
"""
from __future__ import annotations

import math

import numpy as np

DECIBEL_FIELDS = ("SNRdB",)
#: Fields that take discrete values: the 95% energy radius is the root of
#: an integer radius class over N, so a rounding can move it a whole class.
#: They are judged by the share of values that moved at all.
DISCRETE_FIELDS = ("bandwidth/f95",)
MOVED = 1e-5  # float32 round-off of a discrete value, far under one class


def _field(key: str) -> str:
    parts = key.split("/")
    return f"{parts[1]}/{parts[2]}"


def field_scales(ref: dict) -> dict:
    vals: dict = {}
    for key, v in ref.items():
        if key.startswith("full/") or key.endswith("/mean"):
            vals.setdefault(_field(key), []).append(np.abs(np.asarray(v, np.float64)).ravel())
    return {f: float(np.nanmedian(np.concatenate(v))) for f, v in vals.items()}


def value_gaps(prog: dict, ref: dict) -> dict:
    """{leaf: the gap of each of its values} for every leaf of ``ref``; a
    leaf that ``prog`` lacks, or holds in another shape, reads infinity."""
    scales = field_scales(ref)
    out = {}
    for key, r in ref.items():
        r = np.asarray(r, np.float64)
        p = prog.get(key)
        if p is None or np.shape(p) != r.shape:
            out[key] = np.full(r.shape, math.inf)
            continue
        p = np.asarray(p, np.float64)
        fin_p, fin_r = np.isfinite(p), np.isfinite(r)
        d = np.where(fin_r, np.abs(p - np.where(fin_r, r, 0.0)), 0.0)
        field = _field(key)
        if field.split("/")[1] in DECIBEL_FIELDS:
            gap = d * math.log(10.0) / 20.0
        else:
            scale = scales.get(field, 0.0)
            denom = np.full(r.shape, scale) if key.endswith("/std") else np.maximum(np.abs(np.where(fin_r, r, 0.0)), scale)
            gap = np.where(denom > 0, d / np.where(denom > 0, denom, 1.0), np.where(d > 0, math.inf, 0.0))
        out[key] = np.where(fin_p == fin_r, gap, math.inf)
    return out


class Widest:
    """Over several comparisons: the widest gap of the continuous leaves
    (``leaf_gap``), and the share of the discrete fields' values, full
    frame and tile means, that moved by more than round-off
    (``f95_moved_pct``), with where each was read."""

    def __init__(self):
        self.leaf = {}  # continuous leaf -> its widest gap
        self.moved, self.seen = 0, 0

    def add(self, gaps: dict) -> None:
        for key, g in gaps.items():
            if _field(key) in DISCRETE_FIELDS:
                if not key.endswith("/std"):
                    self.moved += int(np.count_nonzero(g > MOVED))
                    self.seen += g.size
            elif g.size:
                self.leaf[key] = max(self.leaf.get(key, 0.0), float(g.max()))

    def numbers(self, log=None) -> dict:
        out = {"leaf_gap": max(self.leaf.values(), default=0.0)}
        if self.seen:
            out["f95_moved_pct"] = 100.0 * self.moved / self.seen
        if log:
            top = sorted(self.leaf.items(), key=lambda kv: -kv[1])[:6]
            log("widest leaf gaps: " + ", ".join(f"{k} {v:.3g}" for k, v in top))
            if self.seen:
                log(f"f95_moved_pct: {self.moved} of {self.seen} values moved")
        return out


def judge(pairs, log=None) -> dict:
    """The numbers of (program leaves, reference leaves) pairs."""
    w = Widest()
    for prog, ref in pairs:
        w.add(value_gaps(prog, ref))
    return w.numbers(log)


def program_leaves(out: dict) -> dict:
    """The ``full`` and ``tiles`` leaves of a program result in the
    reference's names; maps and lag axes are left out."""
    flat = {}
    for group, fields in out.get("full", {}).items():
        for f, v in fields.items():
            if f not in ("autocorr", "xlag", "ylag"):
                flat[f"full/{group}/{f}"] = np.atleast_1d(np.asarray(v, np.float64))
    for group, fields in (out.get("tiles") or {}).items():
        for f, ms in fields.items():
            for stat in ("mean", "std"):
                v = np.asarray(ms[stat], np.float64)
                flat[f"tiles/{group}/{f}/{stat}"] = v if v.ndim == 3 else v[None]
    return flat


def concat(parts: list[dict]) -> dict:
    """Leaves of consecutive blocks of frames joined along the frame axis."""
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
