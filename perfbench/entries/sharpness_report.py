"""``logbook_report(sharpness_stats(frame))`` on one host uint16 frame: the
last step of the focus-scan example (Config A).

Judged after the window: the six groups' full and tile leaves of every call
against the reference on the same frame, and every value on the report's
summary lines against the reference's value, to its printed digits: one unit
in the last printed place, plus the leaf limit's share of the value.
"""
from __future__ import annotations

import math

from perfbench import compare
from perfbench.reference.common import Precision
from perfbench.reference.sharpness import sharpness_leaves

#: Summary-line labels of the report -> the leaf they print.
LABELS = {
    "mean": "stats/mean", "std": "stats/std", "var": "stats/variance", "skew": "stats/skewness",
    "kurt": "stats/kurtosis", "SNR": "stats/SNRdB",
    "tenengrad": "gradient/tenengrad", "ex": "gradient/ex", "ey": "gradient/ey", "ex/ey": "gradient/re",
    "laplacian variance": "laplacian/laplacian_variance",
    "spectral_entropy": "spectral/spectral_entropy",
    "sx": "autocorrelation/sx", "sy": "autocorrelation/sy", "seq": "autocorrelation/seq",
    "r(lx/ly)": "autocorrelation/r",
    "eigenvalues": "eigenvalues/eigenvalues", "e1": "eigenvalues/e1", "e2": "eigenvalues/e2",
    "e1/e2": "eigenvalues/re",
}


def call(port, item, args, device):
    stats = port.sharpness_stats(item["data"], device=device, **args)
    return {"stats": stats, "report": port.logbook_report(stats)}


def frames(item) -> int:
    return 1


def pixels(item) -> int:
    return int(item["data"].size)


def counters(port):
    return None


def reference(item, args, device, prec: Precision) -> dict:
    return sharpness_leaves(prec.frames(item["data"][None], device), prec, tiles=args.get("tiles", True))


def summary_values(report: str) -> list[tuple[str, float, int]]:
    """(label, value, digits after the point) of every item on the report's
    ``> `` summary lines."""
    out = []
    for line in report.splitlines():
        if not line.startswith("> "):
            continue
        for item in line[2:].split(" | "):
            sep = "=" if "=" in item else ": "
            label, _, text = item.partition(sep)
            text = text.strip().removesuffix(" dB")
            try:
                value = float(text)
            except ValueError:
                continue
            digits = len(text.split(".")[1]) if "." in text else 0
            out.append((label.strip(), value, digits))
    return out


def report_misses(report: str, ref: dict, limit: float) -> int:
    """Summary items that do not print the reference's value."""
    misses = 0
    for label, value, digits in summary_values(report):
        key = LABELS.get(label)
        if key is None:
            continue
        want = float(ref[f"full/{key}"][0])
        allowed = 10.0 ** -digits + abs(want) * limit
        if not (math.isfinite(value) == math.isfinite(want) and (not math.isfinite(want) or abs(value - want) <= allowed)):
            misses += 1
    return misses


def check(results, pool, args, device, rng, log, limits, config) -> dict:
    prec = Precision("float64")
    refs = {i: reference(pool[i], args, device, prec) for i in sorted({i for i, _ in results})}
    numbers = compare.judge(((compare.program_leaves(out["stats"]), refs[i]) for i, out in results), log)
    numbers["report_misses"] = sum(report_misses(out["report"], refs[i], limits["leaf_gap"])
                                   for i, out in results)
    return numbers


def control(pool, args, device, prec: Precision, rng, config, log=None) -> dict:
    hi = Precision("float64")
    return compare.judge(((reference(it, args, device, prec), reference(it, args, device, hi)) for it in pool), log)
