# SPDX-License-Identifier: CECILL-2.1
"""Speckle and sharpness estimator cores (counterpart of
``barc4dip_tpu/metrics/estimators.py``).

Each core takes a batch of images (..., h, w) and returns a dict of (...)
tensors. Degenerate images give NaN/Inf instead of raising.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import device_cache
from ..geometry.masks import square_embed_slices
from ..ops import cuda_symeig
from ..ops.corrcore import autocorr2d_core
from ..ops.eig import topk_eigvalsh_subspace
from ..ops.fftcore import psd2d_core
from ..ops.momentscore import distribution_moments_core, nanmean2d, nanstd2d
from ..ops.quantile import nanpercentiles_exact
from ..ops.radialcore import (
    binned_geometry,
    interpolated_geometry,
    radial_mean_binned_core,
    radial_mean_interpolated_core,
)
from ..ops.stencils import laplace as laplace_op
from ..ops.stencils import sobel_x, sobel_y
from ..ops.widths import distance_at_fraction_core, width_at_fraction_core
from ..signal.common import lag_axis_from_step
from ..utils.profiling import annotate

__all__ = [
    "amplitude_core",
    "bandwidth_core",
    "distribution_moments_core",
    "eigenvalues_core",
    "grain_core",
    "grain_from_autocorr",
    "grain_map_core",
    "inverse_autocorr_width_core",
    "laplacian_variance_core",
    "spectral_entropy_core",
    "tenengrad_core",
]

_INV_E = float(1.0 / np.e)


def _pad_to_square_mean(img):
    """Center (..., H, W) in (..., N, N), N = max(H, W), filling with each
    image's mean."""
    H, W = img.shape[-2], img.shape[-1]
    sy, sx, N = square_embed_slices((H, W))
    if N == H and N == W:
        return img
    fill = img.mean(dim=(-2, -1))
    out = fill[..., None, None].expand(*img.shape[:-2], N, N).clone()
    out[..., sy, sx] = img
    return out


def amplitude_core(img, *, p_low: float = 0.05, p_high: float = 99.95, integer_range=None) -> dict:
    """Visibility (nanstd/nanmean) and Michelson contrast from the
    [p_low, p_high] nan-percentile range."""
    mu = nanmean2d(img)
    visibility = nanstd2d(img) / mu
    q = nanpercentiles_exact(img, (p_low, p_high), integer_range=integer_range)
    vmin, vmax = q[..., 0], q[..., 1]
    denom = vmax + vmin
    contrast = torch.where(
        denom > 0, (vmax - vmin) / torch.where(denom > 0, denom, 1.0), np.nan
    )
    visibility = torch.where(mu > 0, visibility, np.nan)
    return {"visibility": visibility, "contrast": contrast}


def _autocorr_widths(img, *, fraction: float, standardize: bool, radial_method: str):
    """pad -> autocorrelation -> widths (see :func:`_widths_from_autocorr`).
    Returns (lx, ly, leq, ac)."""
    ac = autocorr2d_core(
        _pad_to_square_mean(img), remove_mean=True, standardize=standardize, normalize="peak"
    )
    lx, ly, leq = _widths_from_autocorr(ac, fraction=fraction, radial_method=radial_method)
    return lx, ly, leq, ac


def _widths_from_autocorr(ac, *, fraction: float, radial_method: str):
    """peak -> axis cuts -> widths -> radial fraction distance of
    peak-normalized autocorrelation maps. Returns (lx, ly, leq)."""
    N = ac.shape[-1]
    flat = ac.flatten(-2).argmax(-1)
    iy, ix = flat // N, flat % N
    y_cut = ac.gather(-1, ix[..., None, None].expand(*ac.shape[:-1], 1))[..., 0]
    x_cut = ac.gather(-2, iy[..., None, None].expand(*ac.shape[:-2], 1, N))[..., 0, :]
    ly, _ = width_at_fraction_core(y_cut, fraction=fraction, center_index=iy)
    lx, _ = width_at_fraction_core(x_cut, fraction=fraction, center_index=ix)

    if radial_method == "binned":
        rad, _ = radial_mean_binned_core(ac)
        *_rest, r_np = binned_geometry((int(N), int(N)), None, 1.0)
    elif radial_method == "interpolated":
        # the peak-normalized autocorrelation is centro-symmetric about N//2:
        # the half-ring mean is the full-ring mean
        rad, _ = radial_mean_interpolated_core(ac, centrosymmetric=True)
        *_rest, r_np = interpolated_geometry((int(N), int(N)), None, None, None)
    else:
        raise ValueError("radial_method must be 'binned' or 'interpolated'.")
    dr = float(r_np[1] - r_np[0])
    dist, _ = distance_at_fraction_core(rad, fraction=fraction, peak_index=0)
    return lx, ly, 2.0 * dist * dr


def grain_from_autocorr(ac, *, fraction: float = _INV_E, radial_method: str = "interpolated") -> dict:
    """Speckle grain sizes lx, ly, leq and the anisotropy r = lx/ly of
    peak-normalized autocorrelation maps (..., N, N) (:func:`grain_map_core`)."""
    lx, ly, leq = _widths_from_autocorr(ac, fraction=fraction, radial_method=radial_method)
    r = torch.where(ly != 0, lx / torch.where(ly != 0, ly, 1.0), np.inf)
    return {"lx": lx, "ly": ly, "leq": leq, "r": r}


def grain_core(
    img, *, fraction: float = _INV_E, radial_method: str = "interpolated", with_map: bool = True
) -> dict:
    """Speckle grain sizes from the autocorrelation peak: lx, ly, leq and
    the anisotropy r = lx/ly, plus the peak-normalized autocorrelation map
    (..., N, N) and its lag axes (N,) unless ``with_map=False``."""
    ac = grain_map_core(img)
    out = grain_from_autocorr(ac, fraction=fraction, radial_method=radial_method)
    if with_map:
        lag = torch.as_tensor(lag_axis_from_step(ac.shape[-1], 1.0), dtype=ac.dtype, device=ac.device)
        out.update(autocorr=ac, xlag=lag, ylag=lag)
    return out


def grain_map_core(img):
    """The peak-normalized, fftshifted autocorrelation map of the
    mean-padded square image, (..., N, N): what a lazy map leaf computes
    when it is read."""
    return autocorr2d_core(_pad_to_square_mean(img), remove_mean=True, normalize="peak")


def inverse_autocorr_width_core(
    img, *, fraction: float = _INV_E, radial_method: str = "interpolated"
) -> dict:
    """Sharpness from the inverse widths of the standardized
    autocorrelation peak: sx, sy, seq = 1/lx, 1/ly, 1/leq (inf at width 0)
    and the width-domain anisotropy r = lx/ly.

    ``radial_method`` is honoured, as in the JAX package (the original
    barc4dip routes "binned" to the interpolated estimator)."""
    lx, ly, leq, _ = _autocorr_widths(
        img, fraction=fraction, standardize=True, radial_method=radial_method
    )

    def _inv(v):
        return torch.where(v != 0, 1.0 / torch.where(v != 0, v, 1.0), np.inf)

    r = torch.where(ly != 0, lx / torch.where(ly != 0, ly, 1.0), np.inf)
    return {"sx": _inv(lx), "sy": _inv(ly), "seq": _inv(leq), "r": r}


def bandwidth_core(img) -> dict:
    """RMS radial bandwidth, 95% encircled-energy radius, per-axis RMS
    bandwidths, spectral anisotropy and participation ratio of the
    mean-removed, DC-zeroed PSD over the inscribed frequency circle."""
    data = _pad_to_square_mean(img)
    data = data - nanmean2d(data)[..., None, None]
    return _bandwidth_from_psd(psd2d_core(data, step_x=1.0, step_y=1.0, scale=True))


@device_cache(32)
def _freq_plan(N: int, dt, dev):
    """Flattened shifted-frequency fields and the integer radius class
    s = ix^2 + iy^2 of every position of an (N, N) fftshifted spectrum."""
    i = torch.arange(N, dtype=torch.int32, device=dev) - (N // 2)
    ixi = i[None, :].expand(N, N)
    iyi = i[:, None].expand(N, N)
    FX = ixi.to(dt) / N
    FY = iyi.to(dt) / N
    FR = torch.sqrt(FX * FX + FY * FY)
    f_max = float(max(N // 2, N - 1 - N // 2)) / N
    s = (ixi * ixi + iyi * iyi).reshape(-1)
    return FX.reshape(-1), FY.reshape(-1), FR.reshape(-1), (FR <= f_max).reshape(-1), s


def _bandwidth_from_psd(P) -> dict:
    """Bandwidth statistics of fftshifted scaled PSDs (..., N, N)."""
    N = int(P.shape[-1])
    P = torch.nan_to_num(P, nan=0.0, posinf=0.0, neginf=0.0)
    P[..., N // 2, N // 2] = 0.0
    dt = P.dtype
    fxm, fym, frm, inside, s_flat = _freq_plan(N, dt, P.device)

    Pm = torch.where(inside, P.flatten(-2), 0.0)
    total = Pm.sum(-1)
    tsafe = torch.where(total > 0, total, 1.0)
    feq = torch.sqrt((frm * frm * Pm).sum(-1) / tsafe)
    sig_fx = torch.sqrt((fxm * fxm * Pm).sum(-1) / tsafe)
    sig_fy = torch.sqrt((fym * fym * Pm).sum(-1) / tsafe)
    rf = torch.where(sig_fy != 0, sig_fx / torch.where(sig_fy != 0, sig_fy, 1.0), np.inf)

    # f95 by exact integer-radius classes: shifted frequencies are
    # (i - N//2)/N, so FR groups by s = ix^2 + iy^2 and the crossing radius
    # is the smallest s whose inclusive mass reaches 0.95 of the total,
    # found by bisection on s (masked sums, deterministic)
    smax = (N // 2) ** 2
    target = torch.tensor(0.95, dtype=dt) * tsafe
    lo = torch.zeros(total.shape, dtype=torch.int32, device=P.device)
    hi = torch.full(total.shape, smax, dtype=torch.int32, device=P.device)
    for _ in range(max(1, int(np.ceil(np.log2(smax + 1)))) + 1):
        mid = (lo + hi) // 2
        reached = torch.where(s_flat <= mid[..., None], Pm, 0.0).sum(-1) >= target
        lo, hi = torch.where(reached, lo, mid + 1), torch.where(reached, mid, hi)
    f95 = torch.sqrt(hi.to(dt)) / N

    p = Pm / tsafe[..., None]
    spr_denom = (p * p).sum(-1)
    spr = torch.where(spr_denom > 0, 1.0 / torch.where(spr_denom > 0, spr_denom, 1.0), np.nan)

    bad = ~(torch.isfinite(total) & (total > 0))
    out = {"feq": feq, "f95": f95, "sig_fx": sig_fx, "sig_fy": sig_fy, "rf": rf, "spr": spr}
    return {k: torch.where(bad, np.nan, v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# sharpness operators
# ---------------------------------------------------------------------------

def _finite_count(img):
    """(finite mask, number of finite pixels per image, at least 1)."""
    finite = torch.isfinite(img)
    return finite, finite.sum(dim=(-2, -1)).clamp(min=1).to(img.dtype)


def tenengrad_core(img, *, eps: float = 1e-12) -> dict:
    """(GRA6) Sobel gradient energy: ex, ey, their sum, anisotropy
    ex/(ey+eps).

    The mean runs over positions where the *input* is finite; NaNs in the
    stencil output propagate as in NumPy."""
    finite, n = _finite_count(img)
    gx = sobel_x(img)
    gy = sobel_y(img)
    ex = torch.where(finite, gx * gx, 0.0).sum(dim=(-2, -1)) / n
    ey = torch.where(finite, gy * gy, 0.0).sum(dim=(-2, -1)) / n
    return {"tenengrad": ex + ey, "ex": ex, "ey": ey, "re": ex / (ey + eps)}


def laplacian_variance_core(img) -> dict:
    """(LAP4) Population variance of the Laplacian over the positions where
    the input is finite."""
    finite, n = _finite_count(img)
    lap = laplace_op(img)
    mean = torch.where(finite, lap, 0.0).sum(dim=(-2, -1)) / n
    d = torch.where(finite, lap - mean[..., None, None], 0.0)
    return {"laplacian_variance": (d * d).sum(dim=(-2, -1)) / n}


def spectral_entropy_core(
    img, *, remove_mean: bool = True, remove_dc: bool = True, eps: float = 1e-30
) -> dict:
    """Normalized Shannon entropy of the unpadded PSD: the plain mean is
    removed (a NaN pixel gives NaN), the DC bin zeroed, probabilities
    clipped at ``eps`` and the entropy divided by log(ny*nx - 1)."""
    x = img
    if remove_mean:
        x = x - x.mean(dim=(-2, -1), keepdim=True)
    P = psd2d_core(x, step_x=1.0, step_y=1.0, scale=False)
    ny, nx = int(P.shape[-2]), int(P.shape[-1])
    if remove_dc:
        P[..., ny // 2, nx // 2] = 0.0
    s = P.sum(dim=(-2, -1))
    p = P.flatten(-2) / torch.where(s > 0, s, 1.0)[..., None]
    M = (ny * nx - 1) if remove_dc else (ny * nx)
    p = p.clamp(min=eps)
    Hn = -(p * torch.log(p)).sum(-1) / float(np.log(float(M)))
    return {"spectral_entropy": torch.where(s > 0, Hn, np.nan)}


@annotate("eig")
def eigenvalues_core(img, *, k: int = 5, eps: float = 1e-30, eig_method: str = "auto") -> dict:
    """(STA2) Sum of the top-k eigenvalues of the image covariance, from
    the (M, M) Gram matrix J J^T of the energy-normalized, mean-removed
    image (its eigenvalues are the squared singular values of J), plus the
    two largest (e1, e2) and e1/(e2+eps).

    ``eig_method``: "auto" (subspace iteration from 1024 px, dense below),
    "dense" (always the whole spectrum: :func:`..ops.cuda_symeig.eigvalsh`,
    kernel K4 for CUDA float32 up to 238 px, ``torch.linalg.eigvalsh``
    otherwise) or "subspace" (always iterative; see
    :func:`..ops.eig.topk_eigvalsh_subspace` for its accuracy on flat
    spectra). The Gram product is a plain matmul in the image's dtype (TF32
    is off, :mod:`..config`)."""
    if eig_method not in ("auto", "dense", "subspace"):
        raise ValueError("eig_method must be 'auto', 'dense' or 'subspace'.")
    energy = torch.sqrt((img * img).sum(dim=(-2, -1)))
    x = img / torch.where(energy > 0, energy, 1.0)[..., None, None]
    J = x - x.mean(dim=(-2, -1), keepdim=True)
    M, N = int(J.shape[-2]), int(J.shape[-1])
    bad = ~(torch.isfinite(energy) & (energy > 0))
    # a non-finite image reads NaN below; its solve runs on zeros, because
    # torch's eigen-solvers raise on non-finite input
    G = torch.where(bad[..., None, None], 0.0, J @ J.mT)

    n_eig = min(M, N)
    k_use = min(int(k), n_eig)
    k_want = max(k_use, 2)  # e1/e2 ride along even when k < 2
    if eig_method == "subspace" or (eig_method == "auto" and n_eig >= 1024 and k_want <= 32):
        ev = topk_eigvalsh_subspace(G, k_want)
    else:
        ev = cuda_symeig.eigvalsh(G).flip(-1)[..., :k_want]
    ev = (ev / float(M * N - 1)).clamp(min=0.0)

    val = ev[..., :k_use].sum(-1)
    e1 = ev[..., 0]
    e2 = ev[..., 1] if ev.shape[-1] >= 2 else torch.zeros_like(e1)
    out = {"eigenvalues": val, "e1": e1, "e2": e2, "re": e1 / (e2 + eps)}
    return {key: torch.where(bad, np.nan, v) for key, v in out.items()}
