# SPDX-License-Identifier: CECILL-2.1
"""Kernel K1: correlation planes and the masked NCC bank from rfft2 spectra
(counterpart of ``barc4dip_tpu/ops/pallas_fftp.py``).

The kernel is ``csrc/fftp_corr.cu``, CUDA C++ for ``sm_90a``, built at
first use and bound with ``ctypes`` by :mod:`._nvcc`; see the source for
its design. Its two passes (columns, then row pairs with the optional NCC
epilogue) run the register-resident Stockham FFT of
``csrc/stockham_fft.cuh``, whose radix plan and float64-built stage
twiddle tables this module makes (:func:`radix_plan`,
:func:`stage_twiddles`, :func:`column_twiddles`).

A side's odd factor m takes one of two routes, fixed by m: every 7-smooth
m (the odd part of every sensor side) runs radix-7/5/3 stages in registers
(:func:`odd_radices`); an m with a prime factor of 11 or more (1408, 1664,
2176, ...) keeps one direct m-term stage. Neither is a fallback for the
other: a CUDA tensor of a covered shape runs its side's route or raises.

Pass 1 takes one of two routes, fixed by H. Up to ``CLUSTER_ABOVE`` = 2048
rows a block transforms 8 to 64 whole columns of length H, and is bound by
its strided reads of 64 B or more of each spectrum row. Above 2048 rows a
whole column would leave 2 to 5 columns a block (16 to 40 B of each row),
so a thread-block cluster of :func:`cluster_ranks` blocks (16, or 8 where
H/16 is not a multiple of 16) owns 8 columns and splits H = Q * L: each
block transforms one residue class of rows at length L, and the blocks
combine through distributed shared memory. Both read the spectra once and
write the mid plane once; the cluster route is bound by those bytes at
64 B a row.

Bank layout: ``F`` holds the image spectra, (H, Wh) or (NF, H, Wh) with
Wh = W//2 + 1. ``G`` holds the template spectra, (K, H, Wh) for a bank
shared by every image or (NF, K, H, Wh) for one bank per image. Results are
(K, H, W) for a 2-D ``F``, else (NF, K, H, W).

Dispatch is decided from device, shape and dtype before any launch, as the
TPU gate is (``use and supported(shape) and dtype == f32``), over the same
shapes: H and W multiples of 128 in [128, 8192] (:func:`supported` accepts
exactly what ``pallas_fftp.supported`` accepts):

- a CPU tensor takes the plain PyTorch version;
- a CUDA tensor of a covered shape with complex64 spectra launches the
  kernel; a build or launch failure raises;
- a CUDA tensor of another shape or dtype takes the plain version and is
  counted in :data:`PLAIN_BY_SHAPE`. Those are calls the TPU gate refuses
  too: the 227/228-px subtile autocorrelations, the windowed search's
  odd-sided windows, any side that is not a multiple of 128, and spectra
  that are not complex64.

:data:`LAUNCHES` counts every kernel launch, by pass; pass 1's cluster
route runs inside :func:`_cols_cluster`, in the span ``k1.cluster``, and
is counted again under ``cols_cluster``.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from ..utils.profiling import annotate
from . import _nvcc
from .phasecorr import argmax2d

__all__ = [
    "CLUSTER_ABOVE",
    "LAUNCHES",
    "PLAIN_BY_SHAPE",
    "build",
    "cluster_ranks",
    "column_twiddles",
    "corr_from_rfft",
    "corr_from_rfft_plain",
    "ncc_masked_peaks",
    "ncc_masked_peaks_plain",
    "odd_radices",
    "radix_plan",
    "reset_counts",
    "sqrt_threshold",
    "stage_twiddles",
    "supported",
]

#: pass 1 above this many rows runs on thread-block clusters
#: (``corr_cols_cluster`` in the source) of :func:`cluster_ranks` blocks
CLUSTER_ABOVE = 2048
#: kernel launches by pass: pass 1 (columns), pass 2, pass 2 with the NCC
#: epilogue; and pass 1's launches on the cluster route, counted in "cols" too
LAUNCHES: dict[str, int] = {"cols": 0, "rows": 0, "rows_ncc": 0, "cols_cluster": 0}
#: CUDA calls that took the plain version because the kernel does not cover
#: their shape or dtype, keyed "corr|ncc:HxW:dtype"
PLAIN_BY_SHAPE: dict[str, int] = {}

_STEM = "fftp_corr"
_LIB = None


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    PLAIN_BY_SHAPE.clear()


def supported(shape) -> bool:
    """(..., H, W) the kernel covers: H and W = 128*k, k = 1..64, as
    ``pallas_fftp.supported``."""
    if len(shape) < 2:
        return False
    return all(int(n) % 128 == 0 and 1 <= int(n) // 128 <= 64 for n in shape[-2:])


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _nvcc.load(_STEM)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fftp_corr_cols.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p]
    lib.fftp_corr_rows.argtypes = [i, p, p, p, i, i, i, i, f, p]
    lib.fftp_corr_rows_ncc.argtypes = [
        i, p, p, p, i, i, i, i, f, p, p, i, i, f, i, i, p, p, p,
    ]
    for fn in (lib.fftp_corr_cols, lib.fftp_corr_rows, lib.fftp_corr_rows_ncc):
        fn.restype = i
    _LIB = lib
    return lib


def odd_radices(m: int) -> list[int] | None:
    """The register route's radices for odd ``m``, as the source factors it
    (``stockham::odd_radix``): 7s, then 5s, then 3s ([] for m = 1); None
    where m has a prime factor of 11 or more, the direct route's m."""
    m = int(m)
    out = []
    for p in (7, 5, 3):
        while m % p == 0:
            out.append(p)
            m //= p
    return out if m == 1 else None


def radix_plan(n: int) -> list[int]:
    """Stage radices of the kernel's length-``n`` transform in the order it
    runs them (``csrc/stockham_fft.cuh``), n = 2^a * m with m odd. The
    power of two: 16 for every stage but the last, whose radix is
    2^(a mod 4) when that is not 1. On the register route (:func:`odd_radices`
    of m is a list) the odd radices run before the last power-of-two stage;
    on the direct route m itself runs last, one stage."""
    a = (int(n) & -int(n)).bit_length() - 1
    m = int(n) >> a
    odd = odd_radices(m)
    pow2 = [16] * (a // 4) + ([1 << (a % 4)] if a % 4 else [])
    if odd is None:
        return pow2 + [m]
    return pow2[:-1] + odd + pow2[-1:]


def stage_twiddles(n: int) -> np.ndarray:
    """The kernel's twiddle table for length ``n`` = 2^a * m, complex128, the
    parts in stage order: for a stage (Ns inputs combined so far, radix R)
    entry (q - 1)*Ns + k of its part is exp(+2*pi*i*q*k/(Ns*R)), k < Ns,
    q = 1..R-1. Parts: each power-of-two stage but stage 0; then, when
    m > 1, on the direct route the n entries exp(+2*pi*i*r/n) (its stage
    twiddle and m-point DFT in one factor). On the register route the last
    power-of-two stage has no part: the odd stages' parts follow the others
    (NP * (m - 1) entries in all, NP the values combined before them), then
    two short tables whose products give the last stage's exp(+2*pi*i*r/n),
    r < n: hi, the n/16 entries exp(+2*pi*i*h*16/n), then lo, the 16
    entries exp(+2*pi*i*l/n)."""
    a = (int(n) & -int(n)).bit_length() - 1
    m = int(n) >> a
    pow2, odd = radix_plan(1 << a), odd_radices(m)
    register = m > 1 and odd is not None

    def part(ns, r):
        q = np.arange(1, r)[:, None]
        k = np.arange(ns)[None, :]
        return np.exp(2j * np.pi * (q * k) / (ns * r)).ravel()

    parts, ns = [np.zeros(0, complex)], 1
    for s, r in enumerate(pow2[:-1] if register else pow2):
        if s:
            parts.append(part(ns, r))
        ns *= r
    if register:
        for r in odd:
            parts.append(part(ns, r))
            ns *= r
        parts += [np.exp(2j * np.pi * np.arange(n // 16) * 16 / n), np.exp(2j * np.pi * np.arange(16) / n)]
    elif m > 1:
        parts.append(np.exp(2j * np.pi * np.arange(n) / n))
    return np.concatenate(parts)


def cluster_ranks(h: int) -> int:
    """Blocks a cluster of pass 1's cluster route at ``h`` rows, as the
    source's ``cluster_ranks``: 16 where L = h/16 is a multiple of 16 (the
    Stockham core's), else 8, the portable size."""
    return 16 if h % 256 == 0 else 8


def column_twiddles(h: int) -> np.ndarray:
    """Pass 1's twiddle table for ``h`` rows, complex128: :func:`stage_twiddles`
    of ``h`` up to CLUSTER_ABOVE rows; above them (the cluster route,
    h = Q * L, Q = :func:`cluster_ranks`) the stage twiddles of length L, then
    the h cross twiddles exp(+2*pi*i*r/h), r < h, that rank j applies to
    output k2 of its length-L transforms as entry j*k2."""
    if h <= CLUSTER_ABOVE:
        return stage_twiddles(h)
    return np.concatenate([stage_twiddles(h // cluster_ranks(h)), np.exp(2j * np.pi * np.arange(h) / h)])


@lru_cache(maxsize=32)
def _twiddles(n: int, device: torch.device, columns: bool = False) -> torch.Tensor:
    """:func:`stage_twiddles` (``columns``: :func:`column_twiddles`), built
    in float64 and rounded once to float32."""
    table = column_twiddles(n) if columns else stage_twiddles(n)
    return torch.from_numpy(table.astype(np.complex64)).to(device)


@lru_cache(maxsize=16)
def sqrt_threshold(eps: float) -> float:
    """The float32 ``t`` with ``sqrt(x) > eps`` exactly when ``x > t``, for
    every float32 ``x`` (sqrt rounded to nearest, as ``torch.sqrt`` is): the
    NCC epilogue's eps guard on ``var * energy`` without a square root."""
    e = np.float32(eps)
    if np.isnan(e) or e == np.inf:
        return float(e)
    if e < 0:  # every x >= -0 passes, every x < 0 (sqrt NaN) fails
        return float(np.nextafter(np.float32(0), np.float32(-1)))
    up, down = np.float32(np.inf), np.float32(-np.inf)
    with np.errstate(over="ignore"):
        t = e * e
        while t > 0 and np.sqrt(t) > e:
            t = np.nextafter(t, down)
        while t < up and np.sqrt(np.nextafter(t, up)) <= e:
            t = np.nextafter(t, up)
    return float(t)


def _layout(F, G):
    """(F as (NF, H, Wh), NF, K, bank shared?, F was 2-D?)."""
    squeeze = F.dim() == 2
    F3 = F[None] if squeeze else F
    NF = F3.shape[0]
    if G.dim() == 3:
        return F3, NF, G.shape[0], True, squeeze
    if G.dim() == 4 and G.shape[0] == NF and not squeeze:
        return F3, NF, G.shape[1], False, squeeze
    raise ValueError(f"template spectra {tuple(G.shape)} do not fit images {tuple(F.shape)}")


def _use_kernel(F, s, kind: str) -> bool:
    if not F.is_cuda:
        return False
    if F.dtype == torch.complex64 and supported(s):
        return True
    key = f"{kind}:{s[0]}x{s[1]}:{str(F.dtype).replace('torch.', '')}"
    PLAIN_BY_SHAPE[key] = PLAIN_BY_SHAPE.get(key, 0) + 1
    return False


def _cols(lib, F3, G, NF, K, shared, H, W):
    """Pass 1: the (NF*K, H, W/2) complex64 mid planes; above
    ``CLUSTER_ABOVE`` rows through :func:`_cols_cluster`."""
    if H > CLUSTER_ABOVE:
        return _cols_cluster(lib, F3, G, NF, K, shared, H, W)
    return _cols_launch(lib, F3, G, NF, K, shared, H, W)


def _cols_cluster(lib, F3, G, NF, K, shared, H, W):
    """Pass 1 on thread-block clusters (``corr_cols_cluster``, which the
    binding picks from H): the binding call of every pass-1 launch, in the
    span ``k1.cluster`` and counted under ``cols_cluster`` too."""
    with annotate("k1.cluster"):
        mid = _cols_launch(lib, F3, G, NF, K, shared, H, W)
    LAUNCHES["cols_cluster"] += 1
    return mid


def _cols_launch(lib, F3, G, NF, K, shared, H, W):
    Wh = W // 2 + 1
    NB = NF * K
    _nvcc.check_tensor(F3, "K1", "F", torch.complex64, (NF, H, Wh))
    _nvcc.check_tensor(G, "K1", "G", torch.complex64, (K, H, Wh) if shared else (NF, K, H, Wh))
    mid = torch.empty((NB, H, W // 2), dtype=torch.complex64, device=F3.device)
    tw = _twiddles(H, F3.device, columns=True)
    rc = lib.fftp_corr_cols(
        F3.device.index, F3.data_ptr(), G.data_ptr(), mid.data_ptr(),
        tw.data_ptr(), tw.numel(), H, W, NB, K, int(shared),
        torch.cuda.current_stream(F3.device).cuda_stream,
    )
    _nvcc.raise_on(lib, _STEM, rc, "K1 corr_cols_inverse")
    LAUNCHES["cols"] += 1
    return mid


def _corr_kernel(F3, G, NF, K, shared, H, W):
    lib = build()
    # the binding switches the runtime to F3's device: the guard puts the
    # caller's current device back after the launch
    with torch.cuda.device(F3.device):
        mid = _cols(lib, F3, G, NF, K, shared, H, W)
        out = torch.empty((NF * K, H, W), dtype=torch.float32, device=F3.device)
        tw = _twiddles(W, F3.device)
        rc = lib.fftp_corr_rows(
            F3.device.index, mid.data_ptr(), out.data_ptr(),
            tw.data_ptr(), tw.numel(), H, W, NF * K, 1.0 / float(H * W),
            torch.cuda.current_stream(F3.device).cuda_stream,
        )
    _nvcc.raise_on(lib, _STEM, rc, "K1 corr_rows_c2r")
    LAUNCHES["rows"] += 1
    return out.view(NF, K, H, W)


def _ncc_kernel(F3, G, var3, energy, NF, K, shared, H, W, vh, vw, eps):
    lib = build()
    _nvcc.check_tensor(var3, "K1", "var_full", torch.float32, (NF, H, W))
    _nvcc.check_tensor(energy, "K1", "energy", torch.float32, (K,) if shared else (NF, K))
    NB = NF * K
    with torch.cuda.device(F3.device):  # as in _corr_kernel
        mid = _cols(lib, F3, G, NF, K, shared, H, W)
        maps = torch.empty((NB, H, W), dtype=torch.float32, device=F3.device)
        rowmax = torch.empty((NB, H), dtype=torch.float32, device=F3.device)
        rowarg = torch.empty((NB, H), dtype=torch.int32, device=F3.device)
        tw = _twiddles(W, F3.device)
        rc = lib.fftp_corr_rows_ncc(
            F3.device.index, mid.data_ptr(), maps.data_ptr(),
            tw.data_ptr(), tw.numel(), H, W, NB, 1.0 / float(H * W),
            var3.data_ptr(), energy.data_ptr(), K, int(shared), sqrt_threshold(float(eps)),
            int(vh), int(vw), rowmax.data_ptr(), rowarg.data_ptr(),
            torch.cuda.current_stream(F3.device).cuda_stream,
        )
    _nvcc.raise_on(lib, _STEM, rc, "K1 corr_rows_c2r_ncc")
    LAUNCHES["rows_ncc"] += 1
    # the first row holding the plane's maximum, then that row's first column
    iy = rowmax.argmax(-1)
    ix = rowarg.gather(-1, iy[:, None])[:, 0].long()
    return maps.view(NF, K, H, W), iy.view(NF, K), ix.view(NF, K)


def corr_from_rfft_plain(F, G, *, s):
    """``irfft2(F * conj(G), s)`` over the bank layout (module docstring)."""
    F3, _NF, _K, _shared, squeeze = _layout(F, G)
    out = torch.fft.irfft2(F3[:, None] * G.conj(), s=s)
    return out[0] if squeeze else out


def corr_from_rfft(F, G, *, s):
    """Real correlation planes ``irfft2(F * conj(G), s)`` of each image
    spectrum against its template bank: K1 on CUDA for covered shapes."""
    F3, NF, K, shared, squeeze = _layout(F, G)
    if _use_kernel(F3, s, "corr"):
        out = _corr_kernel(F3, G, NF, K, shared, int(s[0]), int(s[1]))
    else:
        out = corr_from_rfft_plain(F3, G, s=s)
    return out[0] if squeeze else out


def ncc_masked_peaks_plain(F, G, var_full, energy, *, valid_hw, eps: float = 1e-9, s):
    """The unfused composition: correlation, divide by sqrt(var * energy)
    (0 where that is <= eps), -inf outside the valid window, argmax."""
    F3, _NF, _K, _shared, squeeze = _layout(F, G)
    var3 = var_full[None] if var_full.dim() == 2 else var_full
    en = energy[None] if energy.dim() == 1 else energy
    corr = corr_from_rfft_plain(F3, G, s=s)
    denom = torch.sqrt(var3[:, None] * en[..., None, None])
    safe = denom > eps
    ncc = torch.where(safe, corr / torch.where(safe, denom, 1.0), 0.0)
    H, W = (int(v) for v in s)
    vh, vw = (int(v) for v in valid_hw)
    valid = (torch.arange(H, device=F.device) < vh)[:, None] & (
        torch.arange(W, device=F.device) < vw
    )[None, :]
    maps = torch.where(valid, ncc, -math.inf)
    iy, ix = argmax2d(maps)
    if squeeze:
        return maps[0], iy[0], ix[0]
    return maps, iy, ix


def ncc_masked_peaks(F, G, var_full, energy, *, valid_hw, eps: float = 1e-9, s):
    """Masked NCC maps and their integer peaks for template banks.

    ``var_full`` is the zero-padded window variance plane of each image,
    (H, W) or (NF, H, W); ``energy`` the template energies, (K,) or
    (NF, K). Maps read -inf where row >= Vh or column >= Vw and 0 where the
    denominator is <= eps. Returns (maps, iy, ix) with (iy, ix) the
    row-major first-occurrence argmax of each map (int64)."""
    F3, NF, K, shared, squeeze = _layout(F, G)
    if _use_kernel(F3, s, "ncc"):
        var3 = var_full[None] if var_full.dim() == 2 else var_full
        maps, iy, ix = _ncc_kernel(
            F3, G, var3, energy, NF, K, shared, int(s[0]), int(s[1]),
            valid_hw[0], valid_hw[1], eps,
        )
    else:
        maps, iy, ix = ncc_masked_peaks_plain(
            F3, G, var_full, energy, valid_hw=valid_hw, eps=eps, s=s
        )
    if squeeze:
        return maps[0], iy[0], ix[0]
    return maps, iy, ix
