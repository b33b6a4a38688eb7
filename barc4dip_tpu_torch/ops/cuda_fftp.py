# SPDX-License-Identifier: CECILL-2.1
"""Kernel K1: correlation planes and the masked NCC bank from rfft2 spectra
(counterpart of ``barc4dip_tpu/ops/pallas_fftp.py``).

The kernel is ``csrc/fftp_corr.cu``, CUDA C++ for ``sm_90a``. It is built
with ``nvcc`` at first use into ``build/kernels/`` beside the package
(keyed by a hash of the source) and bound with ``ctypes``; see the source
for its design.

Bank layout: ``F`` holds the image spectra, (H, Wh) or (NF, H, Wh) with
Wh = W//2 + 1. ``G`` holds the template spectra, (K, H, Wh) for a bank
shared by every image or (NF, K, H, Wh) for one bank per image. Results are
(K, H, W) for a 2-D ``F``, else (NF, K, H, W).

Dispatch mirrors the TPU gate (``use and supported(shape) and dtype ==
f32``) and is decided from shape and dtype before any launch:

- a CPU tensor takes the plain PyTorch version;
- a CUDA tensor of a covered shape (complex64 spectra, H and W powers of
  two in [128, 4096]) launches the kernel; a build or launch failure
  raises;
- a CUDA tensor of another shape takes the plain version and is counted in
  :data:`PLAIN_BY_SHAPE`.

:data:`LAUNCHES` counts every kernel launch, by pass.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from .phasecorr import argmax2d

__all__ = [
    "LAUNCHES",
    "PLAIN_BY_SHAPE",
    "build",
    "corr_from_rfft",
    "corr_from_rfft_plain",
    "ncc_masked_peaks",
    "ncc_masked_peaks_plain",
    "reset_counts",
    "supported",
]

#: kernel launches by pass: pass 1 (columns), pass 2, pass 2 with the NCC epilogue
LAUNCHES: dict[str, int] = {"cols": 0, "rows": 0, "rows_ncc": 0}
#: CUDA calls that took the plain version because the kernel does not cover
#: their shape or dtype, keyed "corr|ncc:HxW:dtype"
PLAIN_BY_SHAPE: dict[str, int] = {}

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "fftp_corr.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB = None
#: compiler output of the last build (registers, shared memory, spills)
BUILD_LOG: str = ""


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    PLAIN_BY_SHAPE.clear()


def supported(shape) -> bool:
    """(H, W) the kernel covers: powers of two in [128, 4096]."""
    return all(128 <= int(n) <= 4096 and (int(n) & (int(n) - 1)) == 0 for n in shape[-2:])


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: K1 is built from source at first use")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = _BUILD_DIR / f"libfftp_corr-{digest}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True,
        )
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fftp_corr_error_string.argtypes = [i]
    lib.fftp_corr_error_string.restype = ctypes.c_char_p
    lib.fftp_corr_cols.argtypes = [i, p, p, p, p, i, i, i, i, i, p]
    lib.fftp_corr_rows.argtypes = [i, p, p, p, i, i, i, f, p]
    lib.fftp_corr_rows_ncc.argtypes = [
        i, p, p, p, i, i, i, f, p, p, i, i, f, i, i, p, p, p,
    ]
    for fn in (lib.fftp_corr_cols, lib.fftp_corr_rows, lib.fftp_corr_rows_ncc):
        fn.restype = i
    _LIB = lib
    return lib


@lru_cache(maxsize=16)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(+2*pi*i*m/n), m < n/2: built in float64, rounded once to float32."""
    tw = np.exp(2j * np.pi * np.arange(n // 2) / n).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def _check(t, name: str, dtype, shape) -> None:
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"K1: {name} must be a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)}; got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fftp_corr_error_string(rc).decode()
        raise RuntimeError(f"K1 {what} launch failed: CUDA error {rc} ({msg})")


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
    Wh = W // 2 + 1
    NB = NF * K
    _check(F3, "F", torch.complex64, (NF, H, Wh))
    _check(G, "G", torch.complex64, (K, H, Wh) if shared else (NF, K, H, Wh))
    mid = torch.empty((NB, H, Wh), dtype=torch.complex64, device=F3.device)
    rc = lib.fftp_corr_cols(
        F3.device.index, F3.data_ptr(), G.data_ptr(), mid.data_ptr(),
        _twiddles(H, F3.device).data_ptr(), H, Wh, NB, K, int(shared),
        torch.cuda.current_stream(F3.device).cuda_stream,
    )
    _raise_on(lib, rc, "corr_cols_inverse")
    LAUNCHES["cols"] += 1
    return mid


def _corr_kernel(F3, G, NF, K, shared, H, W):
    lib = build()
    mid = _cols(lib, F3, G, NF, K, shared, H, W)
    out = torch.empty((NF * K, H, W), dtype=torch.float32, device=F3.device)
    rc = lib.fftp_corr_rows(
        F3.device.index, mid.data_ptr(), out.data_ptr(),
        _twiddles(W, F3.device).data_ptr(), H, W, NF * K, 1.0 / float(H * W),
        torch.cuda.current_stream(F3.device).cuda_stream,
    )
    _raise_on(lib, rc, "corr_rows_c2r")
    LAUNCHES["rows"] += 1
    return out.view(NF, K, H, W)


def _ncc_kernel(F3, G, var3, energy, NF, K, shared, H, W, vh, vw, eps):
    lib = build()
    _check(var3, "var_full", torch.float32, (NF, H, W))
    _check(energy, "energy", torch.float32, (K,) if shared else (NF, K))
    mid = _cols(lib, F3, G, NF, K, shared, H, W)
    NB = NF * K
    maps = torch.empty((NB, H, W), dtype=torch.float32, device=F3.device)
    rowmax = torch.empty((NB, H), dtype=torch.float32, device=F3.device)
    rowarg = torch.empty((NB, H), dtype=torch.int32, device=F3.device)
    rc = lib.fftp_corr_rows_ncc(
        F3.device.index, mid.data_ptr(), maps.data_ptr(),
        _twiddles(W, F3.device).data_ptr(), H, W, NB, 1.0 / float(H * W),
        var3.data_ptr(), energy.data_ptr(), K, int(shared), float(eps),
        int(vh), int(vw), rowmax.data_ptr(), rowarg.data_ptr(),
        torch.cuda.current_stream(F3.device).cuda_stream,
    )
    _raise_on(lib, rc, "corr_rows_c2r_ncc")
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
