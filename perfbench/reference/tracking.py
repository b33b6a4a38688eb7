"""Plain reference of the stack tracker: template matching of a 3x3 ROI grid
by zero-normalised cross-correlation, abs (against frame 0) and inc (against
the frame before), with the Newton subpixel step.

Definitions (upstream barc4dip ``speckle_stack_stats`` with
``tracking_method="template"``, ``subpixel=True``):

- the ROI side is the odd integer at or above ``ceil(roi_grain_factor * l)``
  (at least 3), with ``l`` the largest of frame 0's grain widths lx, ly, leq;
  the grid's step is ``round(roi_step_factor * side)`` (Python's rounding,
  halves to even), and the nine ROIs are centred on the frame's centre
  (H // 2, W // 2) and its eight neighbours at that step, row-major;
- a frame is z-scored over all its pixels; a template is the ROI of the
  source frame (frame 0, or the frame before) with its mean removed;
- ``ncc[u, v] = sum(t * z[u:u+s, v:v+s]) / sqrt(sum((z_w - mean(z_w))^2) * sum(t^2))``
  over the valid positions (0 <= u <= H - s, 0 <= v <= W - s), 0 where the
  denominator is at most 1e-9;
- the peak is the first largest value in row-major order; the subpixel step
  is the Newton step of the 3x3 neighbourhood's central differences, zero
  on the valid region's border or where the Hessian's determinant is zero;
- a ROI's displacement is its peak, plus the step, minus its start; the
  result carries the mean and the population std over the nine ROIs.

Everything runs in the working dtype of a :class:`.common.Precision`; the
correlation is one FFT product a frame and a bank. It imports nothing of
the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import INV_E, Precision, autocorr, pad_square_mean, widths

EPS = 1e-9  # the NCC's degenerate-denominator threshold


def odd_side(n: float, min_size: int = 3) -> int:
    return max(math.ceil(n), min_size) | 1


def roi_grid(frame0, prec: Precision, grain_factor: float, step_factor: float):
    """(starts (9, 2) int, side) of the grid sized from (H, W) frame 0."""
    lx, ly, leq = widths(autocorr(pad_square_mean(frame0[None]), prec), prec, INV_E)
    grain = max(float(v) for v in (lx[0], ly[0], leq[0]) if math.isfinite(float(v)))
    side = odd_side(math.ceil(grain_factor * grain))
    step = int(max(1, round(step_factor * side)))
    H, W = frame0.shape
    cy, cx, half = H // 2, W // 2, side // 2
    starts = np.array([(cy + (r - 1) * step - half, cx + (c - 1) * step - half)
                       for r in range(3) for c in range(3)], np.int64)
    if starts.min() < 0 or (starts[:, 0] + side).max() > H or (starts[:, 1] + side).max() > W:
        raise ValueError("the ROI grid leaves the frame")
    return starts, side


def _window_var_sums(z, s: int):
    """sum over each valid (s, s) window of (z - window mean)^2: (Vh, Vw)."""
    def box(a):
        ii = torch.nn.functional.pad(a.cumsum(-2).cumsum(-1), (1, 0, 1, 0))
        return ii[s:, s:] - ii[:-s, s:] - ii[s:, :-s] + ii[:-s, :-s]
    s1, s2 = box(z), box(z * z)
    return (s2 - s1 * s1 / float(s * s)).clamp_min(0.0)


def bank(frame, starts, s: int, prec: Precision) -> dict:
    """The nine mean-removed (s, s) templates of ``frame`` at ``starts``:
    their spectra zero-padded to the frame, and their energies."""
    H, W = frame.shape
    tiles = torch.stack([frame[y:y + s, x:x + s] for y, x in starts])
    t = prec.q(tiles - tiles.mean(dim=(-2, -1), keepdim=True))
    return {"Ft": prec.q(torch.fft.rfft2(t, s=(H, W))), "energy": prec.q((t * t).sum(dim=(-2, -1))), "side": s}


def _newton(m, i, j):
    """(di, dj) of each (Vh, Vw) map of ``m`` about its peak (i, j)."""
    Vh, Vw = m.shape[-2:]
    ic, jc = i.clamp(1, Vh - 2), j.clamp(1, Vw - 2)
    k = torch.arange(m.shape[0], device=m.device)

    def at(a, b):
        return m[k, ic + a, jc + b]

    dy = (at(1, 0) - at(-1, 0)) / 2.0
    dx = (at(0, 1) - at(0, -1)) / 2.0
    dyy = at(1, 0) + at(-1, 0) - 2.0 * at(0, 0)
    dxx = at(0, 1) + at(0, -1) - 2.0 * at(0, 0)
    dxy = (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1)) / 4.0
    det = dxx * dyy - dxy * dxy
    safe = torch.where(det == 0, 1.0, det)
    di, dj = -(dxx * dy - dxy * dx) / safe, -(dyy * dx - dxy * dy) / safe
    bad = (i <= 0) | (i >= Vh - 1) | (j <= 0) | (j >= Vw - 1) | (det == 0)
    return torch.where(bad, 0.0, di), torch.where(bad, 0.0, dj)


def displacements(z, Fz, tpl: dict, starts, prec: Precision):
    """(dy, dx), each (9,) float64 on the host, of a :func:`bank` in the
    z-scored frame ``z`` (H, W), whose rfft2 is ``Fz``."""
    H, W = z.shape
    s = tpl["side"]
    Vh, Vw = H - s + 1, W - s + 1
    corr = prec.q(torch.fft.irfft2(prec.q(Fz[None] * tpl["Ft"].conj()), s=(H, W)))[:, :Vh, :Vw]
    var = prec.q(_window_var_sums(z, s))
    denom = torch.sqrt(var[None] * tpl["energy"][:, None, None])
    ncc = prec.q(torch.where(denom > EPS, corr / torch.where(denom > EPS, denom, 1.0), 0.0))
    flat = ncc.flatten(-2).argmax(-1)
    i, j = flat // Vw, flat % Vw
    di, dj = _newton(ncc, i, j)
    st = torch.as_tensor(starts, device=z.device)
    dy = i.to(ncc.dtype) + di - st[:, 0].to(ncc.dtype)
    dx = j.to(ncc.dtype) + dj - st[:, 1].to(ncc.dtype)
    return dy.double().cpu().numpy(), dx.double().cpu().numpy()


def track_stack(data, device, prec: Precision, *, grain_factor: float = 3.0, step_factor: float = 0.5):
    """Per-ROI trajectories of a host (T, H, W) stack: {"abs": (dy, dx),
    "inc": (dy, dx)}, each (T, 9) float64."""
    T = int(data.shape[0])
    frame0 = prec.frames(data[0], device)
    starts, s = roi_grid(frame0, prec, grain_factor, step_factor)
    out = {kind: (np.empty((T, 9)), np.empty((T, 9))) for kind in ("abs", "inc")}
    bank0 = bank(frame0, starts, s, prec)
    prev = frame0
    for t in range(T):
        f = prec.frames(data[t], device)
        z = prec.q((f - f.mean()) / f.std(correction=0))
        Fz = prec.q(torch.fft.rfft2(z))
        for kind, tpl in (("abs", bank0), ("inc", bank(prev, starts, s, prec))):
            dy, dx = displacements(z, Fz, tpl, starts, prec)
            out[kind][0][t], out[kind][1][t] = dy, dx
        prev = f
    return out


def temporal(tracks: dict) -> dict:
    """The per-frame aggregates the program reports, from per-ROI
    trajectories: {kind: {"dx", "dy", "r", "std_dx", "std_dy", "std_r"}}."""
    out = {}
    for kind, (dy, dx) in tracks.items():
        r = np.hypot(dx, dy)
        out[kind] = {"dx": dx.mean(1), "dy": dy.mean(1), "r": r.mean(1),
                     "std_dx": dx.std(1), "std_dy": dy.std(1), "std_r": r.std(1)}
    return out
