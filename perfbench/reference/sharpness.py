"""Plain reference of the sharpness metrics (upstream barc4dip
``metrics/sharpness.py``; operators after Pertuz et al., Pattern Recognition
46(5) 2013): intensity statistics; Sobel gradient energy (GRA6) and
Laplacian variance (LAP4), both with the edge sample repeated at the border
as SciPy's ``mode="reflect"`` does; the normalised Shannon entropy of the
unpadded, mean-removed, DC-zeroed power spectrum; the inverse 1/e widths of
the standardised autocorrelation; and the top five eigenvalues of the image
covariance (STA2): squared singular values of the energy-normalised,
mean-removed image over (M N - 1), here from its (M, M) Gram matrix in
float64.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (
    INV_E,
    Precision,
    autocorr,
    flip_rows,
    leaves,
    moments,
    pad_square_mean,
    safe_div,
    tiles_3x3,
    tiling_mode,
    widths,
)

GROUPS = ("stats", "gradient", "laplacian", "spectral", "autocorrelation", "eigenvalues")


def _stencil(x, taps: dict, prec: Precision):
    """Correlation of (..., H, W) images with a 3x3 stencil given as
    {(dy, dx): weight}, the border sample repeated."""
    H, W = x.shape[-2:]
    p = F.pad(x.reshape(-1, 1, H, W), (1, 1, 1, 1), mode="replicate").reshape(*x.shape[:-2], H + 2, W + 2)
    out = sum(w * p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W] for (dy, dx), w in taps.items())
    return prec.q(out)


_SOBEL_X = {(-1, -1): -1.0, (0, -1): -2.0, (1, -1): -1.0, (-1, 1): 1.0, (0, 1): 2.0, (1, 1): 1.0}
_SOBEL_Y = {(dx, dy): w for (dy, dx), w in _SOBEL_X.items()}
_LAPLACE = {(-1, 0): 1.0, (1, 0): 1.0, (0, -1): 1.0, (0, 1): 1.0, (0, 0): -4.0}


def gradient(x, prec: Precision) -> dict:
    gx, gy = _stencil(x, _SOBEL_X, prec), _stencil(x, _SOBEL_Y, prec)
    ex = prec.q((gx * gx).mean(dim=(-2, -1)))
    ey = prec.q((gy * gy).mean(dim=(-2, -1)))
    return {"tenengrad": ex + ey, "ex": ex, "ey": ey, "re": ex / (ey + 1e-12)}


def laplacian(x, prec: Precision) -> dict:
    lap = _stencil(x, _LAPLACE, prec)
    d = prec.q(lap - lap.mean(dim=(-2, -1), keepdim=True))
    return {"laplacian_variance": prec.q((d * d).mean(dim=(-2, -1)))}


def spectral(x, prec: Precision) -> dict:
    a = prec.q(x - x.mean(dim=(-2, -1), keepdim=True))
    Fa = prec.q(torch.fft.fft2(a))
    P = prec.q(Fa.real**2 + Fa.imag**2)
    P[..., 0, 0] = 0.0  # the DC bin, wherever a shift would put it
    s = P.sum(dim=(-2, -1))
    p = prec.q(P.flatten(-2) / s[..., None]).clamp(min=1e-30)
    M = P.shape[-2] * P.shape[-1] - 1
    return {"spectral_entropy": prec.q(-(p * torch.log(p)).sum(-1) / math.log(M))}


def inverse_widths(x, prec: Precision) -> dict:
    lx, ly, leq = widths(autocorr(pad_square_mean(x), prec, standardize=True), prec, INV_E)
    return {"sx": safe_div(1.0, lx), "sy": safe_div(1.0, ly), "seq": safe_div(1.0, leq),
            "r": safe_div(lx, ly)}


def eigenvalues(x, prec: Precision, k: int = 5) -> dict:
    energy = torch.sqrt((x * x).sum(dim=(-2, -1), keepdim=True))
    J = prec.q(x / energy)
    J = prec.q(J - J.mean(dim=(-2, -1), keepdim=True))
    M, N = J.shape[-2:]
    with prec.matmul():
        G = prec.q(J @ J.mT)
    ev = torch.linalg.eigvalsh(G).flip(-1)[..., :max(k, 2)]
    ev = prec.q(ev / float(M * N - 1)).clamp(min=0.0)
    e1, e2 = ev[..., 0], ev[..., 1]
    return {"eigenvalues": ev[..., :k].sum(-1), "e1": e1, "e2": e2, "re": e1 / (e2 + 1e-30)}


_FNS = {"stats": moments, "gradient": gradient, "laplacian": laplacian, "spectral": spectral,
        "autocorrelation": inverse_widths, "eigenvalues": eigenvalues}


def sharpness_leaves(frames, prec: Precision, *, groups=GROUPS, tiles: bool = True,
                     flip: bool = True) -> dict:
    """The full-frame and tile leaves of the ``groups`` of (B, H, W) frames
    of the working dtype, as :func:`.common.leaves` names them."""
    x = flip_rows(frames) if flip else frames
    mode = tiling_mode(*x.shape[-2:], tiles)

    def run(t):
        return {g: _FNS[g](t, prec) for g in groups}

    def per_tile(t):
        return {f"{g}/{f}": v for g, d in run(t).items() for f, v in d.items()}

    return leaves(run(x), None if mode == "off" else tiles_3x3(x, mode, per_tile))
