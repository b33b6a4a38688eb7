# SPDX-License-Identifier: CECILL-2.1
"""Kernel K3: the windowed NCC sums of dense speckle tracking (counterpart
of ``barc4dip_tpu/ops/densetrack.py::_pallas_ncc_sums``).

The kernel is ``csrc/densetrack_sums.cu``, CUDA C++ for ``sm_90a``, built
at first use and bound with ``ctypes`` by :mod:`._nvcc`; see the source for
its design. For every grid node n, frame f and offset (u, v) in
[0, 2r]^2 it gives, node-first as (F*N, L, L) float32 with L = 2r + 1::

    num[f*N + n, u, v] = sum win[u:u+s, v:v+s] * (tile - mean(tile))
    s1 [f*N + n, u, v] = sum win[u:u+s, v:v+s]
    s2 [f*N + n, u, v] = sum win[u:u+s, v:v+s] ** 2

where node n's tile is ``ref[y0:y0+s, x0:x0+s]`` and its window in frame f
is ``frames[f, y0-r:y0+s+r, x0-r:x0+s+r]``, (y0, x0) = (y0s[n // gx],
x0s[n % gx]).

Dispatch is decided from device, geometry and dtype before any launch:

- CPU tensors take the plain PyTorch version (:func:`grid_windows` +
  :func:`ncc_sums_plain`);
- CUDA float32 images with ``(s^2 + w^2) * 4`` bytes within the kernel's
  shared memory launch the kernel; a build or launch failure raises;
- any other CUDA call takes the plain version and is counted in
  :data:`PLAIN_BY_SHAPE`.

:data:`LAUNCHES` counts every kernel launch.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import _nvcc
from .ncc import window_sums

__all__ = [
    "LAUNCHES",
    "PLAIN_BY_SHAPE",
    "build",
    "grid_patches",
    "grid_windows",
    "ncc_sums",
    "ncc_sums_plain",
    "reset_counts",
    "supported",
]

#: kernel launches
LAUNCHES: dict[str, int] = {"ncc_sums": 0}
#: CUDA calls that took the plain version, keyed "ncc_sums:s<s>r<r>:dtype"
PLAIN_BY_SHAPE: dict[str, int] = {}

_STEM = "densetrack_sums"
_LIB = None
#: dynamic shared memory the kernel may use: the 48 KB static limit less
#: its 128-byte reduction scratch
_SMEM_BYTES = 48 * 1024 - 128


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    PLAIN_BY_SHAPE.clear()


def supported(s: int, r: int) -> bool:
    """Geometry the kernel covers: tile and window fit its shared memory."""
    w = s + 2 * r
    return (s * s + w * w) * 4 <= _SMEM_BYTES


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(_STEM)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.densetrack_sums.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p]
        lib.densetrack_sums.restype = i
        _LIB = lib
    return _LIB


def grid_patches(image, y0s, x0s, side: int, offset: int = 0):
    """The (side, side) patch at (y0 + offset, x0 + offset) for every grid
    node, node-first: (..., H, W) -> (..., gy * gx, side, side)."""
    ar = torch.arange(side, device=image.device)
    ty = torch.as_tensor(np.asarray(y0s) + offset, device=image.device)[:, None] + ar
    tx = torch.as_tensor(np.asarray(x0s) + offset, device=image.device)[:, None] + ar
    p = image[..., ty[:, None, :, None], tx[None, :, None, :]]  # (..., gy, gx, side, side)
    return p.reshape(*image.shape[:-2], len(y0s) * len(x0s), side, side)


def grid_windows(ref, frames, y0s, x0s, s: int, r: int):
    """The plain version's inputs: mean-centred tiles (N, s, s) from ``ref``
    and windows (F*N, w, w) from ``frames`` (F, H, W), in their dtype."""
    t = grid_patches(ref, y0s, x0s, s)
    t = t - t.mean(dim=(-2, -1), keepdim=True)
    w = s + 2 * r
    return t, grid_patches(frames, y0s, x0s, w, -r).reshape(-1, w, w)


def ncc_sums_plain(tiles, wins, r: int):
    """The three sums of every window against its mean-centred tile, in
    plain PyTorch: the numerator by an rfft2 correlation (the ``fft`` branch
    of ``barc4dip_tpu/ops/densetrack.py``), s1 and s2 by integral images.

    ``tiles`` (N, s, s), ``wins`` (F*N, w, w) with window f*N + n against
    tile n. Returns num, s1, s2, each (F*N, L, L)."""
    N, s = int(tiles.shape[0]), int(tiles.shape[-1])
    w = int(wins.shape[-1])
    L = 2 * r + 1
    Ft = torch.fft.rfft2(F.pad(tiles, (0, w - s, 0, w - s)))
    Fw = torch.fft.rfft2(wins).reshape(-1, N, w, w // 2 + 1)
    num = torch.fft.irfft2(Fw * Ft.conj(), s=(w, w))[..., :L, :L].reshape(-1, L, L)
    return num, window_sums(wins, s, s), window_sums(wins * wins, s, s)


@lru_cache(maxsize=16)
def _starts_on(y0s: tuple, x0s: tuple, device: torch.device):
    return (torch.tensor(y0s, dtype=torch.int32, device=device),
            torch.tensor(x0s, dtype=torch.int32, device=device))


def _use_kernel(ref, s: int, r: int) -> bool:
    if not ref.is_cuda:
        return False
    if ref.dtype == torch.float32 and supported(s, r):
        return True
    key = f"ncc_sums:s{s}r{r}:{str(ref.dtype).replace('torch.', '')}"
    PLAIN_BY_SHAPE[key] = PLAIN_BY_SHAPE.get(key, 0) + 1
    return False


def ncc_sums(ref, frames, y0s, x0s, s: int, r: int):
    """(num, s1, s2), each (F*N, L, L) float32, for ``ref`` (H, W) and
    ``frames`` (F, H, W) or (H, W) on the grid (y0s, x0s): K3 on CUDA for
    covered calls (module docstring)."""
    frames3 = frames[None] if frames.dim() == 2 else frames
    Fn, H, W = (int(v) for v in frames3.shape)
    y0 = np.asarray(y0s, dtype=np.int64)
    x0 = np.asarray(x0s, dtype=np.int64)
    w = s + 2 * r
    if y0.min() - r < 0 or x0.min() - r < 0 or y0.max() + s + r > H or x0.max() + s + r > W:
        raise ValueError(f"K3: a search window of side {w} leaves the ({H}, {W}) frame")
    if not _use_kernel(ref, s, r):
        t, wins = grid_windows(ref, frames3, y0s, x0s, s, r)
        return ncc_sums_plain(t.to(torch.float32), wins.to(torch.float32), r)

    lib = build()
    _nvcc.check_tensor(ref, "K3", "ref", torch.float32, (H, W))
    _nvcc.check_tensor(frames3, "K3", "frames", torch.float32, (Fn, H, W))
    if Fn > 65535:
        raise ValueError(f"K3: at most 65535 frames per launch; got {Fn}")
    ty, tx = _starts_on(tuple(int(v) for v in y0), tuple(int(v) for v in x0), ref.device)
    gy, gx = len(y0), len(x0)
    L = 2 * r + 1
    num, s1, s2 = (torch.empty((Fn * gy * gx, L, L), dtype=torch.float32, device=ref.device)
                   for _ in range(3))
    rc = lib.densetrack_sums(
        ref.device.index, ref.data_ptr(), frames3.data_ptr(), ty.data_ptr(), tx.data_ptr(),
        Fn, H, W, gy, gx, s, r, num.data_ptr(), s1.data_ptr(), s2.data_ptr(),
        torch.cuda.current_stream(ref.device).cuda_stream,
    )
    _nvcc.raise_on(lib, _STEM, rc, "K3 densetrack_sums")
    LAUNCHES["ncc_sums"] += 1
    return num, s1, s2
