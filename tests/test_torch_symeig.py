# SPDX-License-Identifier: CECILL-2.1
"""Kernel K4's module on the CPU (``ops/cuda_symeig.py``): the plain
version (K4's arithmetic in PyTorch) against float64 ``torch.linalg.eigvalsh``
on random symmetric matrices, the sharpness subtiles' Gram matrices and
special spectra; the dispatch of CPU tensors to the library, bit for bit;
the wrapper's input checks; and K4's block body, ``csrc/symeig_tridiag.cuh``,
compiled from its own source with g++ against a stub ``cuda_runtime.h`` (one
OS thread a CUDA thread, ``std::barrier`` for the block's and each warp's
barriers) and run against the plain version. The card's runs are in
``tests/test_torch_cuda_kernels.py``.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from barc4dip_tpu_torch.metrics import estimators
from barc4dip_tpu_torch.ops import _nvcc, cuda_symeig
from barc4dip_tpu_torch.utils import speckle_stack

torch.set_num_threads(2)

# float32 tridiagonalisation: eigenvalues within this share of the spectral
# radius of the float64 ones (backward error ~ sqrt(M) u |G|; 2.6e-7 seen on
# 228^2 subtile Gram matrices, cuSOLVER's float32 Jacobi 1.4e-6 there)
ATOL_REL = 2e-6


def _symmetric(B, M, seed):
    X = torch.from_numpy(np.random.default_rng(seed).normal(size=(B, M, M)).astype(np.float32))
    return torch.tril(X) + torch.tril(X, -1).mT


def _check(got, G, atol_rel=ATOL_REL):
    want = torch.linalg.eigvalsh(G.double())
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float((got.double() - want).abs().max()) if want.numel() else 0.0
    assert err <= atol_rel * scale, (err, scale)
    assert bool((got[..., 1:] >= got[..., :-1]).all()), "not ascending"


def _tiles(rows, cols, n, seed=5):
    """``n`` speckle subtiles (rows, cols) of one frame, as the sharpness
    benchmark's frames (grain 4 px, 1000 counts)."""
    frame = speckle_stack(1, (rows * n, cols), grain_px=4.0, mean_counts=1000.0, seed=seed,
                          dtype=np.uint16)[0].astype(np.float32)
    return torch.from_numpy(frame).reshape(n, rows, cols)


def _gram(img):
    """The Gram matrix of ``eigenvalues_core``: energy-normalised,
    mean-removed J, then J J^T."""
    energy = torch.sqrt((img * img).sum(dim=(-2, -1)))
    x = img / energy[..., None, None]
    J = x - x.mean(dim=(-2, -1), keepdim=True)
    return J @ J.mT


@pytest.mark.parametrize("M", [1, 2, 3, 32, 227, 228, cuda_symeig.MAX_M])
def test_plain_matches_float64_eigvalsh(M):
    G = _symmetric(2, M, seed=M)
    _check(cuda_symeig.symeig_tridiag_plain(G), G)


@pytest.mark.parametrize("rows, cols", [(228, 228), (228, 227), (227, 228), (227, 227)])
def test_plain_on_sharpness_subtile_grams(rows, cols):
    """The four buckets' shapes of a 2048^2 frame's 9x9 subtiles; the top
    five, e1 and e2 within 1e-6 of their float64 values."""
    G = _gram(_tiles(rows, cols, 2))
    got = cuda_symeig.symeig_tridiag_plain(G)
    _check(got, G)
    want = torch.linalg.eigvalsh(_gram(_tiles(rows, cols, 2).double()))
    for sl in (slice(-5, None), slice(-1, None), slice(-2, -1)):
        top, ref = got[..., sl].double().sum(-1), want[..., sl].sum(-1)
        assert float(((top - ref) / ref).abs().max()) <= 1e-6


def test_plain_zero_matrix_gives_zeros():
    """A bad tile is solved on zeros (``eigenvalues_core``) and must give zeros."""
    got = cuda_symeig.symeig_tridiag_plain(torch.zeros(3, 40, 40))
    assert torch.equal(got.abs(), torch.zeros(3, 40))


def test_plain_rank_one():
    u = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 50)).astype(np.float32))
    G = u[:, :, None] * u[:, None, :]
    got = cuda_symeig.symeig_tridiag_plain(G)
    _check(got, G)
    assert float(((got[:, -1] - (u * u).sum(-1)) / (u * u).sum(-1)).abs().max()) <= 1e-6


def test_plain_repeated_eigenvalues():
    Q, _ = torch.linalg.qr(torch.from_numpy(np.random.default_rng(2).normal(size=(60, 60))))
    lam = torch.tensor([1.0] * 20 + [2.0] * 25 + [-3.0] * 15, dtype=torch.float64)
    G = ((Q * lam) @ Q.T).float()[None]
    got = cuda_symeig.symeig_tridiag_plain(G)
    _check(got, G)
    want = torch.sort(lam).values
    assert float((got[0].double() - want).abs().max()) <= ATOL_REL * 3.0


def test_plain_scaled_identity():
    got = cuda_symeig.symeig_tridiag_plain(3.5 * torch.eye(33)[None].repeat(2, 1, 1))
    assert float((got - 3.5).abs().max()) <= 3.5 * float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("B, M", [(1, 228), (81, 16)])
def test_plain_batches(B, M):
    G = _symmetric(B, M, seed=B)
    got = cuda_symeig.symeig_tridiag_plain(G)
    _check(got, G)
    # each matrix solved alone gives the same numbers
    for b in (0, B - 1):
        assert torch.equal(got[b], cuda_symeig.symeig_tridiag_plain(G[b]))


def test_plain_reads_the_lower_triangle_and_nan_gives_nan():
    G = _symmetric(3, 12, seed=4)
    junk = G + torch.triu(torch.full_like(G, 7.0), 1)  # the upper triangle is not read
    assert torch.equal(cuda_symeig.symeig_tridiag_plain(junk), cuda_symeig.symeig_tridiag_plain(G))
    G[1, 5, 2] = float("nan")
    got = cuda_symeig.symeig_tridiag_plain(G)
    assert bool(torch.isnan(got[1]).all()) and bool(torch.isfinite(got[[0, 2]]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_route_of_eigenvalues_core_is_the_library_bit_for_bit(dtype):
    """On the CPU the dense route stays ``torch.linalg.eigvalsh``: the
    parent's code, written out here, gives the same bits; nothing is
    launched or counted."""
    img = _tiles(57, 50, 3).to(dtype)
    cuda_symeig.reset_counts()
    got = estimators.eigenvalues_core(img, eig_method="dense")
    energy = torch.sqrt((img * img).sum(dim=(-2, -1)))
    x = img / torch.where(energy > 0, energy, 1.0)[..., None, None]
    J = x - x.mean(dim=(-2, -1), keepdim=True)
    ev = torch.linalg.eigvalsh(J @ J.mT).flip(-1)[..., :5]
    ev = (ev / float(57 * 50 - 1)).clamp(min=0.0)
    want = {"eigenvalues": ev.sum(-1), "e1": ev[..., 0], "e2": ev[..., 1],
            "re": ev[..., 0] / (ev[..., 1] + 1e-30)}
    for key in want:
        assert torch.equal(got[key], want[key]), key
    G = (J @ J.mT).contiguous()
    assert torch.equal(cuda_symeig.eigvalsh(G), torch.linalg.eigvalsh(G))
    assert cuda_symeig.LAUNCHES == {"symeig": 0} and cuda_symeig.LIBRARY_BY_SHAPE == {}


@pytest.mark.parametrize("case, match", [
    ("dtype", "float32"), ("rank", r"\(\.\.\., M, M\)"), ("strided", "contiguous"), ("cpu", "CUDA"),
    ("large", "M <="),
])
def test_wrapper_raises_before_any_launch(case, match):
    G = {
        "dtype": lambda: torch.zeros(2, 8, 8, dtype=torch.float64),
        "rank": lambda: torch.zeros(8),
        "strided": lambda: torch.zeros(4, 8, 8)[::2],
        "cpu": lambda: torch.zeros(2, 8, 8),
        "large": lambda: torch.zeros(1, cuda_symeig.MAX_M + 1, cuda_symeig.MAX_M + 1),
    }[case]()
    with pytest.raises(ValueError, match=match):
        cuda_symeig.symeig_tridiag(G)


def test_largest_m_fits_the_block():
    """The whole matrix in shared memory: 238 is the largest M within the
    232,448 bytes a Hopper block may opt in to; the subtiles' 228 fits."""
    assert cuda_symeig.MAX_M == 238
    assert cuda_symeig.smem_bytes(238) <= 232448 < cuda_symeig.smem_bytes(239)


# -- the kernel's block body on the CPU -----------------------------------------

_STUB = """#pragma once
#include <atomic>
#include <barrier>
#include <cfloat>
#include <cmath>
#define __host__
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
struct dim3s { unsigned x = 0; };
extern thread_local dim3s threadIdx, blockDim;
struct BlockSync {
  std::barrier<>* block;
  std::barrier<>* warp;  // this thread's warp
  double* slots;         // its warp's 32 exchange slots
  std::atomic<int>* flag;
};
extern thread_local BlockSync g_sync;
inline void __syncthreads() { g_sync.block->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  g_sync.block->arrive_and_wait();
  if (p) g_sync.flag->store(1);
  g_sync.block->arrive_and_wait();
  const int r = g_sync.flag->load();
  g_sync.block->arrive_and_wait();
  if (threadIdx.x == 0) g_sync.flag->store(0);
  return r;
}
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int m) {
  const int lane = threadIdx.x % 32;
  g_sync.warp->arrive_and_wait();
  g_sync.slots[lane] = static_cast<double>(v);
  g_sync.warp->arrive_and_wait();
  return static_cast<T>(g_sync.slots[lane ^ m]);
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __drcp_rn(double a) { return 1.0 / a; }
"""

_HARNESS = """#include <memory>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
#include "symeig_tridiag.cuh"
thread_local dim3s threadIdx, blockDim;
thread_local BlockSync g_sync;

extern "C" int smem_floats(int M) { return symeig::smem_floats(M); }

// one block of nt threads a matrix, the matrices in turn
extern "C" int run(const float* G, float* out, int B, int M, int nt) {
  std::vector<double> smem((symeig::smem_floats(M) + 1) / 2);
  for (int b = 0; b < B; ++b) {
    std::barrier<> block(nt);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w < nt / 32; ++w) warps.emplace_back(new std::barrier<>(32));
    std::vector<double> slots(nt);
    std::atomic<int> flag{0};
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
      th.emplace_back([&, t] {
        threadIdx.x = t;
        blockDim.x = nt;
        g_sync = {&block, warps[t / 32].get(), slots.data() + (t / 32) * 32, &flag};
        symeig::solve(G + static_cast<size_t>(b) * M * M, out + static_cast<size_t>(b) * M, M,
                      reinterpret_cast<float*>(smem.data()));
      });
    for (auto& h : th) h.join();
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K4's block body for the CPU")
    d = tmp_path_factory.mktemp("symeig")
    (d / "cuda_runtime.h").write_text(_STUB)
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libbody.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", f"-I{d}", f"-I{_nvcc.CSRC}",
         "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes = [p, p, i, i, i]
    lib.run.restype = i
    lib.smem_floats.argtypes = [i]
    lib.smem_floats.restype = i
    return lib


def _run_body(lib, G, nt):
    G = G.contiguous()
    B, M = int(G.shape[0]), int(G.shape[-1])
    out = torch.empty(B, M)
    assert lib.run(G.data_ptr(), out.data_ptr(), B, M, nt) == 0
    return out


@pytest.mark.parametrize("M, nt", [(1, 32), (2, 32), (3, 64), (33, 64), (20, 96), (70, 32)])
def test_block_body_matches_plain(body, M, nt):
    """Block sizes of one to three warps, M below and above the block's
    threads (strided loops) and across a warp's columns."""
    G = _symmetric(2, M, seed=100 + M)
    got = _run_body(body, G, nt)
    _check(got, G)
    want = cuda_symeig.symeig_tridiag_plain(G)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= ATOL_REL * scale


def test_block_body_special_spectra(body):
    """Zeros give zeros; a NaN gives NaN; the upper triangle is not read;
    a scaled identity and a subtile's Gram matrix as the plain version."""
    assert torch.equal(_run_body(body, torch.zeros(1, 20, 20), 64).abs(), torch.zeros(1, 20))
    G = _symmetric(2, 20, seed=8)
    junk = G + torch.triu(torch.full_like(G, 7.0), 1)
    assert torch.equal(_run_body(body, junk, 64), _run_body(body, G, 64))
    G[0, 3, 1] = float("inf")
    got = _run_body(body, G, 64)
    assert bool(torch.isnan(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    eye = 3.5 * torch.eye(17)[None]
    assert float((_run_body(body, eye, 32) - 3.5).abs().max()) <= 3.5 * float(np.finfo(np.float32).eps)
    gram = _gram(_tiles(48, 40, 1))
    _check(_run_body(body, gram, 64), gram)


def test_block_body_shared_memory_is_the_wrappers(body):
    for M in (1, 2, 3, 227, 228, 238):
        assert 4 * body.smem_floats(M) == cuda_symeig.smem_bytes(M)
