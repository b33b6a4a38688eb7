"""Plain reference of the speckle metrics: amplitude, grain, intensity
statistics and bandwidth of each frame, on the full frame and on tiles, and
the grain autocorrelation map of a frame as the program displays it.

Definitions (upstream barc4dip ``metrics/speckles.py``): visibility is
std/mean and contrast (p99.95 - p0.05)/(p99.95 + p0.05) of the frame's
values (linear interpolation between order statistics); grain widths are
the 1/e widths of the peak-normalised autocorrelation of the frame padded to
a square with its mean (axis cuts, and twice the 1/e distance of the radial
mean); bandwidth is taken from the mean-removed, DC-zeroed power spectrum of
that square over the inscribed frequency circle: RMS radial and per-axis
frequencies, their ratio, the radius holding 95% of the energy, and the
participation ratio 1/sum(p^2).
"""
from __future__ import annotations

import torch

from .common import (
    INV_E,
    Precision,
    autocorr,
    flip_rows,
    leaves,
    moments,
    pad_square_mean,
    percentile,
    safe_div,
    tiles_3x3,
    tiling_mode,
    widths,
)

GROUPS = ("amplitude", "grain", "stats", "bandwidth")


def amplitude(x, prec: Precision) -> dict:
    v = x.flatten(-2)
    mu = prec.q(v.mean(-1))
    sd = prec.q(torch.sqrt(((v - mu[..., None]) ** 2).mean(-1)))
    lo, hi = (prec.q(percentile(v, p)) for p in (0.05, 99.95))
    return {"visibility": sd / mu, "contrast": (hi - lo) / (hi + lo)}


def grain(x, prec: Precision) -> dict:
    lx, ly, leq = widths(autocorr(pad_square_mean(x), prec), prec, INV_E)
    return {"lx": lx, "ly": ly, "leq": leq, "r": safe_div(lx, ly)}


def bandwidth(x, prec: Precision) -> dict:
    d = pad_square_mean(x)
    d = prec.q(d - d.mean(dim=(-2, -1), keepdim=True))
    N = d.shape[-1]
    F = prec.q(torch.fft.fftshift(torch.fft.fft2(d), dim=(-2, -1)))
    P = prec.q((F.real**2 + F.imag**2) / float(N * N))
    P[..., N // 2, N // 2] = 0.0
    i = torch.arange(N, device=x.device) - N // 2
    iy, ix = i[:, None].expand(N, N), i[None, :].expand(N, N)
    fx, fy = ix.to(P.dtype) / N, iy.to(P.dtype) / N
    fr = torch.sqrt(fx * fx + fy * fy)
    inside = fr <= max(N // 2, N - 1 - N // 2) / N
    Pm = torch.where(inside, P, 0.0).flatten(-2)
    total = Pm.sum(-1)
    sig_fx = torch.sqrt((fx.flatten() ** 2 * Pm).sum(-1) / total)
    sig_fy = torch.sqrt((fy.flatten() ** 2 * Pm).sum(-1) / total)
    feq = torch.sqrt((fr.flatten() ** 2 * Pm).sum(-1) / total)
    # the energy reaches 95% first at some radius class s = ix^2 + iy^2
    s = (ix * ix + iy * iy).flatten()
    rows = Pm.reshape(-1, N * N).double()
    n_s = int(s.max()) + 1
    ids = (s[None, :] + n_s * torch.arange(rows.shape[0], device=x.device)[:, None]).flatten()
    cum = torch.bincount(ids, weights=rows.flatten(), minlength=rows.shape[0] * n_s)
    cum = torch.cumsum(cum.reshape(-1, n_s), -1)
    k = torch.searchsorted(cum, 0.95 * total.reshape(-1, 1).double())[:, 0]
    f95 = (torch.sqrt(k.double()) / N).to(P.dtype).reshape(total.shape)
    p = Pm / total[..., None]
    return {"feq": prec.q(feq), "f95": f95, "sig_fx": prec.q(sig_fx), "sig_fy": prec.q(sig_fy),
            "rf": prec.q(sig_fx / sig_fy), "spr": prec.q(1.0 / (p * p).sum(-1))}


def _groups(x, prec: Precision) -> dict:
    return {"amplitude": amplitude(x, prec), "grain": grain(x, prec),
            "stats": moments(x, prec), "bandwidth": bandwidth(x, prec)}


def speckle_leaves(frames, prec: Precision, *, tiles: bool = True, flip: bool = True) -> dict:
    """The full-frame and tile leaves of (B, H, W) frames of the working
    dtype, as :func:`.common.leaves` names them."""
    x = flip_rows(frames) if flip else frames
    mode = tiling_mode(*x.shape[-2:], tiles)

    def per_tile(t):
        return {f"{g}/{f}": v for g, d in _groups(t, prec).items() for f, v in d.items()}

    return leaves(_groups(x, prec), None if mode == "off" else tiles_3x3(x, mode, per_tile))


def grain_map(frame, prec: Precision, *, flip: bool = True):
    """The peak-normalised autocorrelation map of one (H, W) frame, padded
    to a square, after the display-origin flip: (N, N) float64 on the host."""
    x = flip_rows(frame) if flip else frame
    return autocorr(pad_square_mean(x[None]), prec)[0].double().cpu().numpy()
