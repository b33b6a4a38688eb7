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
- CUDA float32 images of a geometry :func:`supported` accepts (the block's
  threads and shared memory, :func:`layout`) launch the kernel; a build or
  launch failure raises;
- any other CUDA call takes the plain version and is counted in
  :data:`PLAIN_BY_SHAPE`.

:data:`LAUNCHES` counts every kernel launch.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _nvcc
from .ncc import window_sums

__all__ = [
    "LAUNCHES",
    "Layout",
    "PLAIN_BY_SHAPE",
    "build",
    "grid_patches",
    "grid_windows",
    "launch_layout",
    "layout",
    "ncc_sums",
    "ncc_sums_plain",
    "reset_counts",
    "strip_tasks",
    "supported",
]

#: kernel launches
LAUNCHES: dict[str, int] = {"ncc_sums": 0}
#: CUDA calls that took the plain version, keyed "ncc_sums:s<s>r<r>:dtype"
PLAIN_BY_SHAPE: dict[str, int] = {}

_STEM = "densetrack_sums"
_LIB = None
#: offsets a thread accumulates along a window row (the kernel's kStrip)
STRIP = 7
#: window values a sliding strip keeps in registers (the kernel's kRing)
RING = 12
#: parts the numerator's tile rows are split into where the block fits
KSPLIT = 2
#: dynamic shared memory a block may opt in to on Hopper (227 KB), less
#: the kernel's 128-byte static reduction scratch
_SMEM_BYTES = 232448 - 128
_MAX_THREADS = 256


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    PLAIN_BY_SHAPE.clear()


class Layout(NamedTuple):
    """The kernel's block for a geometry (``csrc/densetrack_sums.cu``)."""

    #: strips of STRIP offsets a row of offsets takes, and their width
    nstrip: int
    lp: int
    #: tile row pitch (zero-padded to a multiple of RING), window row pitch
    sp: int
    wp: int
    #: numerator threads a part (one a strip, whole warps), parts the tile
    #: rows are split into (their sums meet in shared memory)
    tpp: int
    ksplit: int
    #: threads a block and its shared memory in bytes (two tiles, the
    #: window, two row-sum planes, numerator parts)
    threads: int
    smem: int


def strip_tasks(L: int) -> tuple[np.ndarray, np.ndarray]:
    """(u, first v) of each numerator strip of a part, by thread: row u =
    t % L of the offsets, columns 7 * (t // L) onwards."""
    t = np.arange(L * -(-L // STRIP))
    return t % L, STRIP * (t // L)


def _bank_conflicts(s: int, L: int, tpp: int, ksplit: int, wp: int) -> int:
    """Shared-memory wavefronts of one numerator window load summed over
    the block's warps: distinct addresses per bank, at most, a warp."""
    u, v0 = strip_tasks(L)
    rows = -(-s // ksplit)
    total = 0
    for k in range(ksplit):
        addr = (u + k * rows) * wp + v0
        for q in range(0, tpp, 32):
            a = np.unique(addr[q:q + 32])
            total += int(np.bincount(a % 32, minlength=32).max()) if a.size else 0
    return total


@lru_cache(maxsize=64)
def layout(s: int, r: int, ksplit: int = KSPLIT) -> Layout:
    """The kernel's block for tile side ``s`` and radius ``r``, with the
    numerator's tile rows in ``ksplit`` parts. The window pitch is the one
    among the 32 from the least the strips read with the fewest bank
    conflicts, the smallest of those."""
    L, w = 2 * r + 1, s + 2 * r
    nstrip = -(-L // STRIP)
    lp = nstrip * STRIP
    sp = -(-s // RING) * RING
    tpp = -(-L * nstrip // 32) * 32
    wmin = lp + sp - 1
    wp = min(range(wmin, wmin + 32), key=lambda p: (_bank_conflicts(s, L, tpp, ksplit, p), p))
    smem = 4 * (2 * s * sp + w * wp + 2 * w * L + (ksplit - 1) * L * L)
    return Layout(nstrip, lp, sp, wp, tpp, ksplit, ksplit * tpp, smem)


def _fits(lay: Layout) -> bool:
    return lay.threads <= _MAX_THREADS and lay.smem <= _SMEM_BYTES


def launch_layout(s: int, r: int) -> Layout:
    """The layout a launch uses: the numerator in KSPLIT parts where that
    block fits, else in one."""
    lay = layout(s, r)
    return lay if _fits(lay) else layout(s, r, 1)


def supported(s: int, r: int) -> bool:
    """Geometry the kernel covers: its block's threads and shared memory fit."""
    return _fits(launch_layout(int(s), int(r)))


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(_STEM)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.densetrack_sums.argtypes = [i, p, p, p, p] + [i] * 13 + [p, p, p, p]
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
    ty, tx = _starts_on(tuple(int(v) for v in y0), tuple(int(v) for v in x0), ref.device)
    gy, gx = len(y0), len(x0)
    L = 2 * r + 1
    lay = launch_layout(s, r)
    num, s1, s2 = (torch.empty((Fn * gy * gx, L, L), dtype=torch.float32, device=ref.device)
                   for _ in range(3))
    # the binding switches the runtime to ref's device: the guard puts the
    # caller's current device back after the launch
    with torch.cuda.device(ref.device):
        rc = lib.densetrack_sums(
            ref.device.index, ref.data_ptr(), frames3.data_ptr(), ty.data_ptr(), tx.data_ptr(),
            Fn, H, W, gy, gx, s, r, lay.sp, lay.wp, lay.tpp, lay.ksplit, lay.threads, lay.smem,
            num.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            torch.cuda.current_stream(ref.device).cuda_stream,
        )
    _nvcc.raise_on(lib, _STEM, rc, "K3 densetrack_sums")
    LAUNCHES["ncc_sums"] += 1
    return num, s1, s2
