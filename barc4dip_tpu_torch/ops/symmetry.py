# SPDX-License-Identifier: CECILL-2.1
"""Centro-symmetric map reconstruction (counterpart of
``barc4dip_tpu/ops/symmetry.py``).

The circular autocorrelation of a real signal satisfies c[k] = c[-k]
exactly, and the PSD of a real signal satisfies P[k] = P[-k]; their
fftshifted (N0, N1) maps obey S[i, j] = S[(2*c0 - i) % N0, (2*c1 - j) % N1]
with (c0, c1) = (N0//2, N1//2). A pull of such a map therefore needs rows
0..N0//2 only, which halves the device->host transfer; the host rebuilds the
redundant half here.

Maps computed with full 2D FFTs satisfy the symmetry to dtype epsilon (FFT
rounding), not bit-exactly; the mirrored half is as valid an estimate of
the underlying symmetric quantity as the directly computed one.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["HALF_ROWS", "mirror_centrosymmetric", "pull_centrosymmetric"]


def HALF_ROWS(N: int) -> int:
    """Number of leading rows a pull must carry: N//2 + 1."""
    return N // 2 + 1


def mirror_centrosymmetric(half: np.ndarray, N: int) -> np.ndarray:
    """Rebuild the full (..., N, N1) shifted map from its leading
    (..., N//2+1, N1) rows (N1 = half.shape[-1], any width)."""
    half = np.asarray(half)
    if half.shape[-2] != HALF_ROWS(N):
        raise ValueError(
            f"expected (..., {HALF_ROWS(N)}, N1) half map; got {half.shape}"
        )
    N1 = half.shape[-1]
    full = np.empty(half.shape[:-2] + (N, N1), dtype=half.dtype)
    full[..., : HALF_ROWS(N), :] = half

    twoc0 = 2 * (N // 2)
    twoc1 = 2 * (N1 // 2)
    rows_rest = np.arange(HALF_ROWS(N), N)
    src_rows = (twoc0 - rows_rest) % N  # all fall inside the carried half
    cols_map = (twoc1 - np.arange(N1)) % N1
    full[..., HALF_ROWS(N) :, :] = half[..., src_rows, :][..., cols_map]
    return full


def pull_centrosymmetric(device_map: torch.Tensor, *, quantize: str = "none") -> np.ndarray:
    """Materialise a device-resident fftshifted centro-symmetric map (PSD /
    autocorrelation of real input) on the host, transferring only its
    leading N0//2+1 rows and mirroring the rest host-side.

    The reconstruction matches a full pull to dtype epsilon (see the module
    note). Works for any trailing (N0, N1) shape; leading batch dims pass
    through.

    ``quantize="u16"`` halves the bytes again: the half map is
    min/max-normalised to 16-bit codes on the device and dequantised to
    float32 host-side. Worst-case absolute error is
    ``(max - min) / (2 * 65535)``, about 1.5e-5 for peak-normalised
    autocorrelations: for display and transport, not for metrology-grade
    residuals.
    """
    if quantize not in ("none", "u16"):
        raise ValueError("quantize must be 'none' or 'u16'")
    N0 = int(device_map.shape[-2])
    half = device_map[..., : HALF_ROWS(N0), :]
    if quantize == "u16":
        lo = half.min()
        hi = half.max()
        span = torch.where(hi > lo, hi - lo, 1.0)
        # torch's uint16 supports few operations: the codes are formed as
        # int32, wrapped into int16's range, narrowed last, and read as
        # uint16 on the host
        codes = torch.round((half - lo) * (65535.0 / span)).to(torch.int32)
        codes = (codes - 65536 * (codes >= 32768)).to(torch.int16)
        lo_h, span_h = torch.stack([lo, span]).tolist()
        codes_h = codes.cpu().numpy().view(np.uint16)
        half_h = codes_h.astype(np.float32) * (span_h / 65535.0) + lo_h
    else:
        half_h = half.cpu().numpy()
    return mirror_centrosymmetric(half_h, N0)
