# SPDX-License-Identifier: CECILL-2.1
"""PSF deconvolution: Wiener, Richardson-Lucy, unsupervised Wiener
(counterpart of ``barc4dip_tpu/preprocessing/filters.py``).

- "wiener": ``x = F^-1[conj(H) Y / (|H|^2 + balance |L|^2)]`` with the
  Laplacian regulariser L (one FFT round trip).
- "rl": Richardson-Lucy, two FFT convolutions an iteration, the loop on
  the device with no host sync.
- "uw": unsupervised Wiener, the noise and prior precisions estimated by a
  variational-Bayes fixed point of 30 iterations on device scalars.

Each frame is reflect-padded by the PSF half-size, divided by its max|x|
(``clip=True`` clips to [-1, 1]), restored, rescaled and cropped, as in the
JAX package. The Gaussian PSF and the transfer functions are built on the
host in float64 (this module's own copies of the JAX package's helpers);
the work is float32 with complex64 transfer functions, as the JAX package
casts it. The transforms are ``torch.fft`` (cuFFT on the card), where the
JAX package runs ``jnp.fft``: no Pallas kernel is on this path.
"""
from __future__ import annotations

import logging
from functools import lru_cache
from typing import Literal, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..metrics.common import frame_loader
from ..utils.time import elapsed_time, now

logger = logging.getLogger(__name__)
_DeconvMethod = Literal["wiener", "rl", "uw"]

__all__ = ["deconvolve_psf"]


# ---------------------------------------------------------------------------
# PSF construction (host)
# ---------------------------------------------------------------------------

def _parse_sigma(sigma) -> tuple[float, float]:
    if isinstance(sigma, (int, float, np.floating)):
        sy = sx = float(sigma)
    else:
        s = list(sigma)
        if len(s) != 2:
            raise ValueError("sigma must be a float or a length-2 sequence (sy, sx).")
        sy, sx = float(s[0]), float(s[1])
    if not (np.isfinite(sy) and np.isfinite(sx)):
        raise ValueError("sigma values must be finite.")
    if sy <= 0 or sx <= 0:
        raise ValueError("sigma values must be > 0.")
    return sy, sx


def _odd(n: int) -> int:
    n = int(n)
    return n if n % 2 == 1 else n + 1


def _gaussian_psf(sy: float, sx: float, *, min_size: int = 5) -> np.ndarray:
    """Normalized Gaussian kernel, size odd(max(min_size, ceil(6*sigma)))."""
    ky = _odd(max(min_size, int(np.ceil(6.0 * sy))))
    kx = _odd(max(min_size, int(np.ceil(6.0 * sx))))

    y = np.arange(ky, dtype=np.float64) - (ky - 1) / 2.0
    x = np.arange(kx, dtype=np.float64) - (kx - 1) / 2.0
    yy, xx = np.meshgrid(y, x, indexing="ij")
    psf = np.exp(-0.5 * ((yy / sy) ** 2 + (xx / sx) ** 2))
    s = float(psf.sum())
    if not np.isfinite(s) or s <= 0:
        raise ValueError("Failed to build a valid Gaussian PSF (sum<=0).")
    return (psf / s).astype(np.float32)


@lru_cache(maxsize=32)
def _transfer_functions(shape: tuple[int, int], psf_key: bytes, psf_shape: tuple[int, int]):
    """(H, L) transfer functions for a PSF on a padded shape: the PSF is
    zero-embedded with its center rolled to the origin (circular convolution
    convention), L is the discrete Laplacian [[0,-1,0],[-1,4,-1],[0,-1,0]]."""
    psf = np.frombuffer(psf_key, dtype=np.float32).reshape(psf_shape)

    ir = np.zeros(shape, dtype=np.float64)
    kh, kw = psf.shape
    ir[:kh, :kw] = psf
    ir = np.roll(ir, (-(kh // 2), -(kw // 2)), axis=(0, 1))
    H = np.fft.rfft2(ir)

    lap = np.zeros(shape, dtype=np.float64)
    lap[:3, :3] = np.array([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]])
    lap = np.roll(lap, (-1, -1), axis=(0, 1))
    L = np.fft.rfft2(lap)
    return H, L


@lru_cache(maxsize=8)
def _device_transfer_functions(shape, psf_key, psf_shape, dtype: torch.dtype, device: torch.device):
    """:func:`_transfer_functions` rounded once to ``dtype`` (complex64 for
    float32 work) and uploaded: one upload per padded shape and device."""
    H, L = _transfer_functions(shape, psf_key, psf_shape)
    return (torch.from_numpy(H).to(device=device, dtype=dtype),
            torch.from_numpy(L).to(device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# device cores on (B, Hp, Wp) padded, normalised frames
# ---------------------------------------------------------------------------

def _wiener_core(work, H, L, balance: float, clip: bool):
    Y = torch.fft.rfft2(work)
    den = H.abs() ** 2 + balance * L.abs() ** 2
    x = torch.fft.irfft2(H.conj() * Y / den, s=work.shape[-2:])
    return x.clamp(-1.0, 1.0) if clip else x


def _fft_conv_same(x, otf):
    """Circular convolution by a precomputed OTF (the reflect padding
    upstream makes the wrap-around benign)."""
    return torch.fft.irfft2(torch.fft.rfft2(x) * otf, s=x.shape[-2:])


def _rl_core(work, H, num_iter: int, clip: bool, filter_epsilon):
    Hc = H.conj()
    x = torch.full_like(work, 0.5)
    for _ in range(num_iter):
        denom = _fft_conv_same(x, H)
        if filter_epsilon is not None:
            rel = torch.where(
                denom < filter_epsilon, 0.0, work / torch.where(denom == 0, 1.0, denom)
            )
        else:
            rel = work / denom
        x = x * _fft_conv_same(rel, Hc)
    return x.clamp(-1.0, 1.0) if clip else x


def _uw_core(work, H, L, clip: bool, n_iter: int = 30):
    """Unsupervised Wiener: VB fixed point on (noise precision gn, prior
    precision gx) of each frame; returns the posterior-mean image."""
    Y = torch.fft.rfft2(work)
    aH2 = H.abs() ** 2
    aL2 = L.abs() ** 2
    ny, nx = work.shape[-2:]
    npix = ny * nx

    # rfft half-spectrum multiplicity for Parseval-style sums
    mult = torch.full(aH2.shape, 2.0, dtype=aH2.dtype, device=aH2.device)
    mult[..., 0] = 1.0
    if nx % 2 == 0:
        mult[..., -1] = 1.0

    def spec_sum(a):
        return (mult * a).sum(dim=(-2, -1), keepdim=True) / npix

    Hc = H.conj()
    var = work.var(dim=(-2, -1), keepdim=True, correction=0)  # jnp.var: population
    gn = 1.0 / var.clamp_min(1e-12)
    gx = torch.ones_like(gn)
    for _ in range(n_iter):
        P = gn * aH2 + gx * aL2
        Xhat = gn * Hc * Y / P
        resid = spec_sum((Y - H * Xhat).abs() ** 2) + spec_sum(aH2 / P)
        prior = spec_sum(aL2 * Xhat.abs() ** 2) + spec_sum(aL2 / P)
        gn = npix / resid.clamp_min(1e-12)
        gx = npix / prior.clamp_min(1e-12)

    P = gn * aH2 + gx * aL2
    x = torch.fft.irfft2(gn * Hc * Y / P, s=work.shape[-2:])
    return x.clamp(-1.0, 1.0) if clip else x


def _deconvolve(frames, psf: np.ndarray, method: str, clip: bool, balance: float,
                num_iter: int, filter_epsilon):
    """Restore (B, H, W) frames in their own floating dtype (float32 on the
    public path; float64 with complex128 transfer functions serves as a
    reference)."""
    py, px = psf.shape[0] // 2, psf.shape[1] // 2
    B, h, w = frames.shape
    padded = F.pad(frames[:, None], (px, px, py, py), mode="reflect")[:, 0]
    cdtype = torch.complex128 if frames.dtype == torch.float64 else torch.complex64
    H, L = _device_transfer_functions(
        tuple(padded.shape[-2:]), psf.tobytes(), tuple(psf.shape), cdtype, frames.device
    )
    mag = padded.abs()
    scale = torch.where(torch.isnan(mag), -torch.inf, mag).amax(dim=(-2, -1), keepdim=True)
    ok = (scale > 0) & torch.isfinite(scale)  # all-NaN frames read -inf here, NaN in jnp.nanmax
    safe = torch.where(ok, scale, 1.0)
    work = padded / safe

    if method == "wiener":
        restored = _wiener_core(work, H, L, balance, clip)
    elif method == "rl":
        restored = _rl_core(work, H, num_iter, clip, filter_epsilon)
    else:
        restored = _uw_core(work, H, L, clip)

    restored = torch.where(ok, restored * safe, 0.0)
    return restored[:, py : py + h, px : px + w]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def deconvolve_psf(
    images,
    *,
    sigma: float | Sequence[float],
    method: _DeconvMethod = "wiener",
    clip: bool = True,
    pad_mode: Literal["reflect"] = "reflect",
    balance: float | None = None,
    num_iter: int = 50,
    filter_epsilon: float | None = None,
    reg=None,
    user_params: dict | None = None,
    is_real: bool = True,
    parallel: bool = True,
    n_jobs: int | None = None,
    verbose: bool = False,
    frame_chunk: int = 8,
    device=None,
):
    """Deconvolve a Gaussian detector PSF from a 2D image or (T, H, W) stack.

    ``reg``/``user_params``/``is_real`` and ``parallel``/``n_jobs`` are
    accepted for API parity (the regularizer is the standard Laplacian;
    stack frames batch on the device, ``frame_chunk`` at a time).

    Residence follows the input: numpy in -> numpy out, computed on
    ``device`` (``None``: the card, and an error without one); a tensor in
    -> a tensor out on its own device. The result is float32.
    """
    device_in = isinstance(images, torch.Tensor)
    if not device_in and not isinstance(images, np.ndarray):
        raise TypeError("deconvolve_psf expects a numpy.ndarray or torch.Tensor")
    if images.ndim not in {2, 3}:
        raise ValueError(
            f"images must be 2D (H, W) or 3D (T, H, W); got ndim={images.ndim}"
        )

    sy, sx = _parse_sigma(sigma)
    psf = _gaussian_psf(sy, sx, min_size=5)

    if method not in {"wiener", "rl", "uw"}:
        raise ValueError(f"Unsupported method: {method!r}. Use 'wiener', 'rl', or 'uw'.")
    if pad_mode != "reflect":
        raise ValueError("Only pad_mode='reflect' is supported (by design).")
    if method == "rl" and num_iter < 1:
        raise ValueError("num_iter must be >= 1 for method='rl'.")
    if balance is None and method == "wiener":
        balance = 0.01

    t0 = now()
    is_stack = images.ndim == 3
    frames = images if is_stack else images[None]
    T = int(frames.shape[0])
    device, load = frame_loader(frames, device)
    B = max(1, min(int(frame_chunk), T))
    pieces = []
    for c0 in range(0, T, B):
        chunk = load(c0, min(c0 + B, T)).to(torch.float32)
        out = _deconvolve(
            chunk, psf, str(method), bool(clip), float(balance or 0.0), int(num_iter),
            None if filter_epsilon is None else float(filter_epsilon),
        )
        pieces.append(out if device_in else out.cpu())
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    if not is_stack:
        out = out[0]

    if verbose:
        logger.info(
            "> deconvolve_psf | frames=%d | method=%s | sigma=(%.3f, %.3f) px | kernel=%dx%d | device_batched=yes | elapsed=%.3fs",
            T, method, sy, sx, int(psf.shape[0]), int(psf.shape[1]),
            elapsed_time(t0, verbose=False),
        )
    return out if device_in else out.numpy()
