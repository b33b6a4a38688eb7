# SPDX-License-Identifier: CECILL-2.1
"""Synthetic speckle data with known ground truth (extension).

A numpy-only copy of ``barc4dip_tpu/utils/synthetic.py``: the port must
import without jax, and the same seed gives the same frames in both
packages.

The reference has no data-generation utilities — its examples fetch a
Zenodo dataset — yet every validation task here needs fields whose grain
size, motion, or distortion is known analytically. These generators are
the single implementation used by the test suite, the benchmarks, and the
examples, and they are public because framework users need the same thing
to validate an installation or prototype a pipeline without detector data.

Physics: fully-developed speckle is |smooth complex Gaussian field|².
Low-pass filtering complex white noise with a Gaussian of FWHM
``grain_px`` (in the frequency domain) sets the autocorrelation width —
the ``grain`` metric's lx/ly/leq track ``grain_px`` — and Fourier-shift
theorems give exact subpixel motion for tracking ground truth.

Performance: generation must not dwarf what it feeds (a benchmark, a test)
on a weak host. Two exact algebraic identities carry the cost down ~100x
at 2048² on a throttled single-core VM (measured 2026-08-17: 23 s/frame
-> 0.2 s/frame):

* the 2-D Fourier-shift phase is separable,
  ``exp(-2πi(fy·dy + fx·dx)) = exp(-2πi·fy·dy) ⊗ exp(-2πi·fx·dx)`` — an
  outer product of two 1-D vectors replaces 4M transcendental calls
  (identical to 1.6e-15);
* the FFTs run in complex64 via ``scipy.fft`` (which, unlike ``np.fft``,
  honors single precision) — 4.5e-7 relative field error, invisible to
  any tracking gate, while the random draw stays in float64 so the
  seed-keyed data stream is unchanged. ``precision="double"`` restores
  the full-precision path.
"""
from __future__ import annotations

import os

import numpy as np

try:  # scipy.fft computes complex64 natively; np.fft always upcasts
    import scipy.fft as _sfft
except ImportError:  # pragma: no cover - scipy is in the standard image
    _sfft = None

__all__ = ["speckle_field", "speckle_stack", "spiral_motion"]


def _cplx(precision: str):
    if precision not in ("single", "double"):
        raise ValueError(f"precision must be 'single' or 'double', got {precision!r}")
    return np.complex64 if precision == "single" else np.complex128


def _fft2(x):
    return np.fft.fft2(x) if (_sfft is None or x.dtype == np.complex128) else _sfft.fft2(x)


def _ifft2(x):
    return np.fft.ifft2(x) if (_sfft is None or x.dtype == np.complex128) else _sfft.ifft2(x)


def _filtered_base(rng, ny, nx, grain_px, cplx):
    """fft2(complex white noise) * Gaussian low-pass, in ``cplx`` precision.

    The noise is always drawn in float64 so the rng stream (and therefore
    the generated speckle realization for a given seed) is independent of
    the precision choice. The single-precision path assembles the complex
    array by real/imag assignment and never materializes a complex128
    intermediate: elementwise complex128 arithmetic has been measured
    ~100x slower than complex64 on some throttled VMs.
    """
    ar = rng.normal(size=(ny, nx))
    ai = rng.normal(size=(ny, nx))
    sigma_f = 1.0 / (2.0 * np.pi * (float(grain_px) / 2.355))
    if cplx == np.complex128:
        fy = np.fft.fftfreq(ny)[:, None]
        fx = np.fft.fftfreq(nx)[None, :]
        H = np.exp(-(fx**2 + fy**2) / (2.0 * sigma_f**2))
        return np.fft.fft2(ar + 1j * ai) * H
    # Single precision: the Gaussian is separable (exact), so build it as
    # an outer product of two 1-D exps and keep every 2-D elementwise op
    # in 32-bit.
    a = np.empty((ny, nx), np.complex64)
    a.real = ar
    a.imag = ai
    h_y = np.exp(-np.fft.fftfreq(ny) ** 2 / (2.0 * sigma_f**2)).astype(np.float32)
    h_x = np.exp(-np.fft.fftfreq(nx) ** 2 / (2.0 * sigma_f**2)).astype(np.float32)
    return _fft2(a) * np.outer(h_y, h_x)


def speckle_field(
    shape: tuple[int, int] = (512, 512),
    *,
    grain_px: float = 6.0,
    mean_counts: float = 1000.0,
    seed: int | np.random.Generator = 0,
    dtype=np.float32,
    precision: str = "single",
) -> np.ndarray:
    """One fully-developed speckle pattern with a known grain size [px]."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    ny, nx = (int(v) for v in shape)
    base_F = _filtered_base(rng, ny, nx, grain_px, _cplx(precision))
    field = np.abs(_ifft2(base_F)) ** 2
    field = field / field.mean() * float(mean_counts)
    return field.astype(dtype)


def spiral_motion(T: int, *, amplitude: float = 0.35, omega: float = 0.7):
    """The ex_04-style spiral trajectory: (dys, dxs) arrays of length T [px]."""
    ts = np.arange(int(T))
    return (
        float(amplitude) * ts * np.cos(ts * float(omega)),
        float(amplitude) * ts * np.sin(ts * float(omega)),
    )


def speckle_stack(
    T: int,
    shape: tuple[int, int] = (512, 512),
    *,
    grain_px: float = 6.0,
    dys=None,
    dxs=None,
    mean_counts: float = 1000.0,
    seed: int | np.random.Generator = 0,
    dtype=np.float32,
    precision: str = "single",
) -> np.ndarray:
    """(T, H, W) stack of ONE speckle pattern under known subpixel motion.

    Frame t is the seed pattern Fourier-shifted by (dys[t], dxs[t]) —
    exact periodic translation, so tracking has analytic ground truth.
    Default motion is the ex_04 spiral. ``dtype=np.uint16`` produces
    detector-like integer counts (clipped at 65535).
    """
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    ny, nx = (int(v) for v in shape)
    if dys is None or dxs is None:
        dys, dxs = spiral_motion(T)
    dys = np.asarray(dys, dtype=float)
    dxs = np.asarray(dxs, dtype=float)
    if dys.shape != (int(T),) or dxs.shape != (int(T),):
        raise ValueError(f"dys/dxs must have shape ({T},); got {dys.shape}, {dxs.shape}")

    cplx = _cplx(precision)
    base_F = _filtered_base(rng, ny, nx, grain_px, cplx)
    # 1-D phase factors; the 2-D shift phase is their outer product
    # (separability of exp over the fy·dy + fx·dx sum — exact). Pre-cast
    # to the working precision so the outer product never runs in c128.
    ph_y = np.exp(-2j * np.pi * np.fft.fftfreq(ny)[:, None] * dys[None, :]).astype(cplx)
    ph_x = np.exp(-2j * np.pi * np.fft.fftfreq(nx)[:, None] * dxs[None, :]).astype(cplx)

    out = np.empty((int(T), ny, nx), dtype)

    def _one(t: int) -> None:
        phase = np.outer(ph_y[:, t], ph_x[:, t])
        field = np.abs(_ifft2(base_F * phase)) ** 2
        field = field / field.mean() * float(mean_counts)
        if np.issubdtype(np.dtype(dtype), np.integer):
            info = np.iinfo(dtype)
            field = np.clip(field, info.min, info.max)
        out[t] = field

    # Frames are independent (each derives from the shared base_F), and the
    # hot ops (pocketfft, exp) release the GIL — thread the loop for large
    # stacks. Deterministic: every thread writes only its own out[t].
    if int(T) >= 4 and ny * nx >= 512 * 512 and (os.cpu_count() or 1) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            list(ex.map(_one, range(int(T))))
    else:
        for t in range(int(T)):
            _one(t)
    return out
