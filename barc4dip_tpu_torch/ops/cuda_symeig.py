# SPDX-License-Identifier: CECILL-2.1
"""Kernel K4: the ascending eigenvalues of a batch of symmetric float32
matrices, the dense eigenvalue route of ``metrics/estimators.eigenvalues_core``.

It replaces no TPU kernel (the JAX package leaves the dense solve to XLA's
``eigh``): it takes the place of ``torch.linalg.eigvalsh``, whose batched
Jacobi made ~59,000 launches for one 2048^2 frame's 81 subtiles. The kernel
is ``csrc/symeig_tridiag.cu`` (block body ``csrc/symeig_tridiag.cuh``),
CUDA C++ for ``sm_90a``, built at first use and bound with ``ctypes`` by
:mod:`._nvcc`; see the sources for its design. One launch computes a
(..., M, M) batch, one block a matrix: Householder tridiagonalisation in
shared memory, then Sturm bisection in float64. Like ``eigvalsh`` it reads
the lower triangle only and returns the whole spectrum, ascending.

Dispatch (:func:`eigvalsh`) is decided from device, dtype and shape before
any launch:

- a CPU tensor takes ``torch.linalg.eigvalsh``, so every CPU result is the
  library's, bit for bit;
- a CUDA float32 tensor with 1 <= M <= :data:`MAX_M` launches K4; a build
  or launch failure raises;
- any other CUDA tensor (M above :data:`MAX_M`, another dtype) takes
  ``torch.linalg.eigvalsh`` and is counted in :data:`LIBRARY_BY_SHAPE`.

:data:`LAUNCHES` counts every kernel launch. :func:`symeig_tridiag_plain`
is K4's arithmetic in PyTorch, step for step, for the CPU tests and the
card's comparison.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.profiling import annotate
from . import _nvcc

__all__ = [
    "LAUNCHES",
    "LIBRARY_BY_SHAPE",
    "MAX_M",
    "build",
    "eigvalsh",
    "reset_counts",
    "smem_bytes",
    "symeig_tridiag",
    "symeig_tridiag_plain",
]

#: kernel launches
LAUNCHES: dict[str, int] = {"symeig": 0}
#: CUDA calls that took ``torch.linalg.eigvalsh``, keyed "eigvalsh:shape:dtype"
LIBRARY_BY_SHAPE: dict[str, int] = {}

_STEM = "symeig_tridiag"
_LIB = None
#: the block body's reductions (four of 32 float64) and vectors, in floats
_RED_FLOATS = 256
#: dynamic shared memory a block may opt in to on Hopper
_SMEM_LIMIT = 232448
#: the bisection's constants: DBL_MIN, DBL_EPSILON, FLT_EPSILON
_F64_TINY, _F64_EPS = float(np.finfo(np.float64).tiny), float(np.finfo(np.float64).eps)
_F32_EPS = float(np.finfo(np.float32).eps)


def smem_bytes(M: int) -> int:
    """Dynamic shared memory of one block (``symeig::smem_floats``): the
    reductions, four vectors of M and the full M x M matrix, float32."""
    return 4 * (_RED_FLOATS + 4 * M + M * M)


#: the largest M the kernel takes: its matrix held whole in shared memory
MAX_M = max(m for m in range(1, 512) if smem_bytes(m) <= _SMEM_LIMIT)


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LIBRARY_BY_SHAPE.clear()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(_STEM)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.symeig_tridiag.argtypes = [i, p, p, i, i, p]
        lib.symeig_tridiag.restype = i
        lib.symeig_tridiag_max_m.argtypes = []
        lib.symeig_tridiag_max_m.restype = i
        if lib.symeig_tridiag_max_m() != MAX_M:
            raise RuntimeError(f"K4: the kernel takes M <= {lib.symeig_tridiag_max_m()}, "
                               f"the wrapper states {MAX_M}")
        _LIB = lib
    return _LIB


def _count_library(G) -> None:
    key = f"eigvalsh:{'x'.join(str(int(n)) for n in G.shape)}:{str(G.dtype).replace('torch.', '')}"
    LIBRARY_BY_SHAPE[key] = LIBRARY_BY_SHAPE.get(key, 0) + 1


def eigvalsh(G):
    """Ascending eigenvalues of the symmetric (..., M, M) ``G`` from its
    lower triangle, as ``torch.linalg.eigvalsh`` gives them: K4 for a CUDA
    float32 batch with M <= :data:`MAX_M`, the library otherwise."""
    if not G.is_cuda:
        return torch.linalg.eigvalsh(G)
    M = int(G.shape[-1])
    if G.dtype == torch.float32 and G.dim() >= 2 and G.shape[-2] == M and 1 <= M <= MAX_M:
        return symeig_tridiag(G.contiguous())
    _count_library(G)
    return torch.linalg.eigvalsh(G)


def symeig_tridiag(G):
    """K4 on a contiguous CUDA float32 (..., M, M) batch, 1 <= M <=
    :data:`MAX_M`: its ascending eigenvalues (..., M). Raises on any other
    input."""
    if G.dim() < 2 or G.shape[-1] != G.shape[-2]:
        raise ValueError(f"K4: G must be (..., M, M); got shape {tuple(G.shape)}")
    M = int(G.shape[-1])
    if not 1 <= M <= MAX_M:
        raise ValueError(f"K4: 1 <= M <= {MAX_M}; got M = {M}")
    if G.dtype != torch.float32:
        raise ValueError(f"K4: G must be float32; got {G.dtype}")
    if not G.is_contiguous():
        raise ValueError("K4: G must be contiguous")
    if not G.is_cuda:
        raise ValueError(f"K4: G must be a CUDA tensor; got one on {G.device}")
    B = G.numel() // (M * M)
    out = torch.empty(G.shape[:-1], dtype=torch.float32, device=G.device)
    if B == 0:
        return out
    lib = build()
    with annotate("k4"):
        # the binding switches the runtime to G's device: the guard puts
        # the caller's current device back after the launch
        with torch.cuda.device(G.device):
            rc = lib.symeig_tridiag(G.device.index, G.data_ptr(), out.data_ptr(), B, M,
                                    torch.cuda.current_stream(G.device).cuda_stream)
    _nvcc.raise_on(lib, _STEM, rc, "K4 symeig_tridiag")
    LAUNCHES["symeig"] += 1
    return out


# -- the plain version ----------------------------------------------------------

def _rank2(A, v, w):
    """a_rc - (v_r w_c + w_r v_c) of (B, n, n) ``A``, each product and the
    sum rounded in float32, as the kernel's ``rank2``."""
    return A - (v[:, :, None] * w[:, None, :] + w[:, :, None] * v[:, None, :])


def _w_of(tau, alpha2, y, v):
    """tau y + alpha2 v in float64, rounded once to float32 (``w_of``)."""
    return (tau[:, None] * y.double() + alpha2[:, None] * v.double()).float()


def _tridiagonalize_plain(A):
    """(d, e) float32 of the symmetric float32 (B, M, M) ``A``, by the
    kernel's Householder steps (in eager order: the kernel's lazy order
    applies the same updates to the same entries)."""
    A = A.clone()
    B, M = int(A.shape[0]), int(A.shape[-1])
    e = A.new_zeros((B, M - 1))
    for i in range(M - 1):
        alpha = A[:, i, i + 1].double()
        xn2 = (A[:, i, i + 2:].double() ** 2).sum(-1)
        has = xn2 > 0
        beta = torch.where(has, -torch.copysign(torch.sqrt(alpha * alpha + xn2), alpha), alpha)
        safe = torch.where(has, beta, 1.0)
        tau = torch.where(has, (beta - alpha) / safe, 0.0)
        scale = torch.where(has, 1.0 / torch.where(has, alpha - beta, 1.0), 0.0)
        v = torch.cat([A.new_ones((B, 1)),
                       (A[:, i, i + 2:].double() * scale[:, None]).float()], dim=1)
        e[:, i] = beta.float()
        T = A[:, i + 1:, i + 1:]
        y = (T @ v[:, :, None])[..., 0]
        dot = (y.double() * v.double()).sum(-1)
        alpha2 = -0.5 * tau * (tau * dot)
        w = _w_of(tau, alpha2, y, v)
        A[:, i + 1:, i + 1:] = _rank2(T, v, w)
    return torch.diagonal(A, dim1=-2, dim2=-1).clone(), e


def _bisect_plain(d, e):
    """Ascending eigenvalues (float32) of the symmetric tridiagonals (d, e)
    by the kernel's Sturm bisection (float64, LAPACK stebz semantics)."""
    d, e = d.double(), e.double()
    B, M = d.shape
    ae = e.abs()
    zero = d.new_zeros((B, 1))
    r = torch.cat([zero, ae], 1) + torch.cat([ae, zero], 1)
    gl, gu = (d - r).amin(-1), (d + r).amax(-1)
    e2 = e * e
    e2max = e2.amax(-1) if M > 1 else d.new_zeros(B)
    tnorm = torch.maximum(gl.abs(), gu.abs())
    pivmin = _F64_TINY * torch.clamp(e2max, min=1.0)
    widen = 2.1 * tnorm * _F64_EPS * M + 2.1 * 2.0 * pivmin
    gl, gu = gl - widen, gu + widen
    tol = torch.maximum(tnorm * _F32_EPS, 2.0 * pivmin)
    halvings = torch.zeros(B, dtype=torch.int64, device=d.device)
    width = gu - gl
    for _ in range(64):
        more = width > tol
        halvings += more.long()
        width = torch.where(more, width * 0.5, width)
    a = gl[:, None].expand(B, M).clone()
    b = gu[:, None].expand(B, M).clone()
    index = torch.arange(M, device=d.device)[None, :]
    piv = pivmin[:, None]
    for h in range(int(halvings.max()) if B else 0):
        x = 0.5 * (a + b)
        q = d[:, :1] - x
        q = torch.where(q.abs() < piv, -piv, q)
        below = (q <= 0).long()
        for k in range(1, M):
            q = (d[:, k:k + 1] - e2[:, k - 1:k] * (1.0 / q)) - x
            q = torch.where(q.abs() < piv, -piv, q)
            below += (q <= 0).long()
        live = (h < halvings)[:, None]
        up = live & (below > index)
        b = torch.where(up, x, b)
        a = torch.where(live & ~up, x, a)
    return (0.5 * (a + b)).float()


def symeig_tridiag_plain(G):
    """K4's arithmetic in PyTorch: the ascending eigenvalues (..., M) of the
    symmetric float32 (..., M, M) ``G`` from its lower triangle, by the
    same Householder tridiagonalisation (float32, its norms and dot
    products in float64) and the same Sturm bisection (float64). A matrix
    with a non-finite entry gives NaN. Runs on ``G``'s device, one PyTorch
    call a step."""
    if G.dim() < 2 or G.shape[-1] != G.shape[-2] or G.shape[-1] == 0:
        raise ValueError(f"G must be (..., M, M), M >= 1; got shape {tuple(G.shape)}")
    M = int(G.shape[-1])
    lead = G.shape[:-2]
    low = torch.tril(G.detach().to(torch.float32).reshape(-1, M, M))
    A = low + torch.tril(low, -1).mT
    finite = torch.isfinite(A).flatten(1).all(-1)
    d, e = _tridiagonalize_plain(torch.where(finite[:, None, None], A, 0.0))
    finite &= torch.isfinite(d).all(-1) & torch.isfinite(e).all(-1)
    ev = _bisect_plain(torch.where(finite[:, None], d, 0.0), torch.where(finite[:, None], e, 0.0))
    ev = torch.where(finite[:, None], ev, float("nan"))
    return ev.reshape(*lead, M)
