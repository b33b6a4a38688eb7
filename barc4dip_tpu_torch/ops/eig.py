# SPDX-License-Identifier: CECILL-2.1
"""Top-k symmetric eigenvalues by blocked subspace iteration (counterpart of
``barc4dip_tpu/ops/eig.py``), batched over leading dimensions.

The STA2 sharpness estimator reads only the top few eigenvalues of the
image covariance. A dense ``eigvalsh`` of the (M, M) Gram matrix computes
the whole spectrum; subspace iteration spends its work in (M, M) @ (M, r)
products instead: power-iterate an r = k + p block, re-orthonormalise, then
solve an (r, r) Rayleigh-Ritz problem.

Convergence: eigenvalue i's error decays like (lambda_{r+1}/lambda_i)^(2q).
With the defaults (p=27, q=16) speckle-like covariance spectra agree with
dense ``eigvalsh`` to float32 resolution. A perfectly flat spectrum (pure
white noise, eigenvalue ratios ~1) defeats any power method, at ~1e-3
relative. Such frames carry no sharpness structure, but callers ranking
near-identical noise-dominated frames should ask for the exact dense path
(``eig_method="dense"`` on the public estimators).

The start block is drawn from a seeded ``torch.Generator`` on the host, in
float64, and rounded to the matrix's dtype: the same start on every device
and run. The JAX package draws its start from its own generator, so the two
agree to the iteration's accuracy and not bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["topk_eigvalsh_subspace"]

_START_SEED = 7


def topk_eigvalsh_subspace(G, k: int, *, oversample: int = 27, iters: int = 16):
    """Top-``k`` eigenvalues (descending) of symmetric positive
    semi-definite matrices ``G`` (..., M, M): ``iters`` rounds of (M, M) @
    (M, r) products with tall-skinny QR re-orthonormalisation, then an
    exact (r, r) Rayleigh-Ritz solve. The start block comes from a fresh
    CPU ``torch.Generator`` with a fixed seed, so results repeat run to
    run."""
    M = int(G.shape[-1])
    r = min(M, int(k) + int(oversample))
    generator = torch.Generator(device="cpu").manual_seed(_START_SEED)
    start = torch.randn((M, r), generator=generator, dtype=torch.float64)
    Q, _ = torch.linalg.qr(start.to(device=G.device, dtype=G.dtype))
    Q = Q.expand(*G.shape[:-2], M, r)
    for _ in range(int(iters)):
        Q, _ = torch.linalg.qr(G @ Q)
    T = Q.mT @ (G @ Q)
    T = 0.5 * (T + T.mT)  # symmetrise Rayleigh-Ritz rounding
    ev = torch.linalg.eigvalsh(T)  # ascending, length r
    return ev.flip(-1)[..., : int(k)]
