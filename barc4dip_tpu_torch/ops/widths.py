# SPDX-License-Identifier: CECILL-2.1
"""Peak-width estimators (counterpart of ``barc4dip_tpu/ops/widths.py``).

Profiles are (..., n) tensors; the walk-outs are masked reductions. Both
functions return ``(value, hit_edge)`` with the fallback ``float(n)`` when
the threshold is never crossed.
"""
from __future__ import annotations

import torch

__all__ = ["width_at_fraction_core", "distance_at_fraction_core"]


def _take(p, i):
    return p.gather(-1, i[..., None])[..., 0]


def _interp_cross(p, i0, i1, thr, fallback):
    """x where the segment (i0, p[i0]) -> (i1, p[i1]) crosses thr;
    ``fallback`` on a flat segment."""
    y0 = _take(p, i0)
    y1 = _take(p, i1)
    flat = y1 == y0
    denom = torch.where(flat, 1.0, y1 - y0)
    x = i0 + (thr - y0) / denom
    return torch.where(flat, fallback, x)


def width_at_fraction_core(profile, *, fraction: float, center_index=None):
    """Full width of a peak at ``fraction`` of its value at
    ``center_index`` (default: the argmax). Walk-left takes the largest
    index <= c below threshold, walk-right the smallest index >= c;
    crossings interpolate linearly."""
    p = profile
    n = p.shape[-1]
    idx = torch.arange(n, device=p.device)
    c = p.argmax(-1) if center_index is None else center_index
    c = c.clamp(0, n - 1)

    thr = _take(p, c) * fraction
    below = p < thr[..., None]
    left_mask = below & (idx <= c[..., None])
    right_mask = below & (idx >= c[..., None])
    ok = left_mask.any(-1) & right_mask.any(-1)

    i_left = torch.where(left_mask, idx, -1).amax(-1)
    i_right = torch.where(right_mask, idx, n).amin(-1)
    il = i_left.clamp(0, n - 1)
    ir = i_right.clamp(0, n - 1)

    x_left = _interp_cross(p, il, (il + 1).clamp_max(n - 1), thr, il.to(p.dtype))

    # the reference indexes p[i_right - 1] with Python semantics, so
    # i_right == 0 reads the LAST element while keeping coordinate -1
    j0 = (ir - 1) % n
    y0 = _take(p, j0)
    y1 = _take(p, ir)
    flat = y1 == y0
    denom = torch.where(flat, 1.0, y1 - y0)
    x_right = torch.where(
        flat, ir.to(p.dtype), (ir - 1).to(p.dtype) + (thr - y0) / denom
    )
    width = torch.where(ok, x_right - x_left, float(n))
    return width, ~ok


def distance_at_fraction_core(profile, *, fraction: float, peak_index: int = 0):
    """One-sided distance from ``peak_index`` to the first crossing below
    ``fraction * peak`` toward increasing index (radial profiles)."""
    p = profile
    n = p.shape[-1]
    idx = torch.arange(n, device=p.device)
    k0 = min(max(int(peak_index), 0), n - 1)
    thr = p[..., k0] * fraction

    mask = (p < thr[..., None]) & (idx >= k0)
    found = mask.any(-1)
    i_cross = torch.where(mask, idx, n).amin(-1)

    ic = i_cross.clamp(1, n - 1)
    x_cross = _interp_cross(p, ic - 1, ic, thr, ic.to(p.dtype))
    dist = torch.where(i_cross == k0, 0.0, x_cross - k0)
    dist = torch.where(found, dist, float(n))
    return dist, ~found
