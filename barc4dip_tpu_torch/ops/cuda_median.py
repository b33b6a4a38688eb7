# SPDX-License-Identifier: CECILL-2.1
"""Kernel K2: the 3x3 median filter with a symmetric boundary (counterpart
of ``barc4dip_tpu/ops/pallas_median.py``).

The kernel is ``csrc/median3x3.cu``, CUDA C++ for ``sm_90a``, built at
first use and bound with ``ctypes`` by :mod:`._nvcc`; see the source for
its design. It equals ``scipy.ndimage.median_filter(size=3,
mode="reflect")`` on each (H, W) plane, and a NaN anywhere in a pixel's
3x3 neighbourhood gives NaN.

Dispatch is decided from device, shape and dtype before any launch:

- a CPU tensor takes the plain PyTorch version, :func:`median3x3_plain`;
- a CUDA float32 tensor of shape (H, W) or (B, H, W) launches the kernel;
  a build or launch failure raises;
- any other CUDA tensor takes the plain version and is counted in
  :data:`PLAIN_BY_SHAPE`.

:data:`LAUNCHES` counts every kernel launch.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc

__all__ = [
    "LAUNCHES",
    "PLAIN_BY_SHAPE",
    "build",
    "count_plain",
    "median3x3",
    "median3x3_plain",
    "median_filter_plain",
    "reset_counts",
]

#: kernel launches
LAUNCHES: dict[str, int] = {"median3x3": 0}
#: CUDA calls that took a plain version, keyed "medianKxK:shape:dtype"
PLAIN_BY_SHAPE: dict[str, int] = {}

_STEM = "median3x3"
_LIB = None


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    PLAIN_BY_SHAPE.clear()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(_STEM)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.median3x3.argtypes = [i, p, p, i, i, i, p]
        lib.median3x3.restype = i
        _LIB = lib
    return _LIB


def median_filter_plain(x, k: int):
    """Median of the k*k shifted windows of a symmetric pad of (..., H, W),
    k odd (``barc4dip_tpu/ops/rank.py``'s general path). ``torch.median``
    gives NaN where a window holds one, as ``jnp.median`` does."""
    h = k // 2
    H, W = x.shape[-2], x.shape[-1]
    p = _symmetric_pad(x, h)
    windows = torch.stack([p[..., dy:dy + H, dx:dx + W] for dy in range(k) for dx in range(k)])
    return windows.median(dim=0).values


def _symmetric_pad(x, h: int):
    """``np.pad(mode="symmetric")`` of the last two axes by ``h``: edges
    are duplicated (index -1 reads 0, -2 reads 1, ...)."""
    H, W = x.shape[-2], x.shape[-1]

    def idx(n):
        i = torch.arange(-h, n + h, device=x.device)
        period = 2 * n
        i = torch.remainder(i, period)
        return torch.where(i >= n, period - 1 - i, i)

    return x.index_select(-2, idx(H)).index_select(-1, idx(W))


def median3x3_plain(x):
    """The plain PyTorch 3x3 median of (..., H, W): nine shifted views of a
    symmetric pad and their median."""
    return median_filter_plain(x, 3)


def count_plain(x, name: str = "median3x3") -> None:
    """Count a CUDA call that takes a plain version, by name, shape and dtype."""
    key = f"{name}:{'x'.join(str(int(n)) for n in x.shape)}:{str(x.dtype).replace('torch.', '')}"
    PLAIN_BY_SHAPE[key] = PLAIN_BY_SHAPE.get(key, 0) + 1


def _use_kernel(x) -> bool:
    if not x.is_cuda:
        return False
    if x.dtype == torch.float32 and x.dim() in (2, 3) and x.numel() > 0:
        return True
    count_plain(x)
    return False


def median3x3(x):
    """3x3 median of (H, W) or (B, H, W) ``x``: K2 on CUDA for float32."""
    if not _use_kernel(x):
        return median3x3_plain(x)
    lib = build()
    H, W = int(x.shape[-2]), int(x.shape[-1])
    B = 1 if x.dim() == 2 else int(x.shape[0])
    _nvcc.check_tensor(x, "K2", "x", torch.float32, tuple(x.shape))
    if B > 65535:
        raise ValueError(f"K2: at most 65535 planes per launch; got {B}")
    out = torch.empty_like(x)
    rc = lib.median3x3(
        x.device.index, x.data_ptr(), out.data_ptr(), B, H, W,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _nvcc.raise_on(lib, _STEM, rc, "K2 median3x3")
    LAUNCHES["median3x3"] += 1
    return out
