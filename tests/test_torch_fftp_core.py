# SPDX-License-Identifier: CECILL-2.1
"""K1's FFT core, ``barc4dip_tpu_torch/csrc/stockham_fft.cuh``, compiled
from its own source with g++ and run on the CPU against numpy.

A stub ``cuda_runtime.h`` (written here, into a temporary directory) runs
each CUDA thread of a block as an OS thread, ``__syncthreads`` as a
``std::barrier``. ``stockham::run`` is instantiated at every (2^a, M) that
a side 128*k (k = 1..64) or a cluster length 16*k of pass 1 gives, on both
odd routes (the register radices and the direct stage), and transforms two
interleaved columns (exchange stride 2, as pass 1 runs them) with the
twiddle tables ``cuda_fftp.stage_twiddles`` makes. This checks the C++
index algebra itself; registers, spills and timing show only on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py). Skipped where there is
no g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from barc4dip_tpu_torch.ops import _nvcc, cuda_fftp

# pass 1 up to 2048 rows and pass 2: 128*k; pass 1 above 2048 rows: L = H/Q
LENGTHS = sorted({128 * k for k in range(1, 65)} | {16 * k for k in range(9, 33)}
                 | {16 * k for k in range(17, 64, 2)})
COLUMNS = 2
# float32 round-off of one transform of length <= 8192 (4.3e-7 of the peak
# seen at 8064), with margin
ATOL_REL = 2e-6

_STUB = """#pragma once
#include <barrier>
#define __host__
#define __device__
#define __forceinline__ inline
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
extern thread_local std::barrier<>* g_bar;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
struct dim3s { int x = 0; };
extern thread_local dim3s threadIdx, blockDim;
"""

_HARNESS = """#include <thread>
#include <vector>
#include "cuda_runtime.h"
#include "stockham_fft.cuh"
thread_local std::barrier<>* g_bar;
thread_local dim3s threadIdx, blockDim;

template <int LOGA, int M>
int go(const float2* in, float2* out, const float2* tw, int m, int C) {
  const int n = (M == 0 ? m : M) << LOGA, T = n / 16;
  std::vector<float2> x(stockham::padded(n) * C);
  std::barrier<> bar(T * C);
  std::vector<std::thread> th;
  for (int id = 0; id < T * C; ++id)
    th.emplace_back([&, id] {
      g_bar = &bar;
      const int c = id % C, t = id / C;
      float2 v[16];
      for (int i = 0; i < 16; ++i) v[i] = in[c * n + t + i * T];
      stockham::run<LOGA, M, 0>(v, x.data() + c, tw, t, m, C);
      for (int i = 0; i < 16; ++i) out[c * n + t + i * T] = v[i];
    });
  for (auto& h : th) h.join();
  return 0;
}

extern "C" int tw_count(int loga, int m) { return stockham::tw_count(loga, m); }

extern "C" int run_fft(int loga, int m, const void* in, void* out, const void* tw, int C) {
  const int M = stockham::route_of(m);
  auto* i2 = static_cast<const float2*>(in);
  auto* o2 = static_cast<float2*>(out);
  auto* t2 = static_cast<const float2*>(tw);
CASES
  return -1;
}
"""


def _split(n):
    a = (n & -n).bit_length() - 1
    return a, n >> a


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the FFT core for the CPU")
    d = tmp_path_factory.mktemp("stockham")
    (d / "cuda_runtime.h").write_text(_STUB)
    pairs = set()
    for n in LENGTHS:
        a, m = _split(n)
        pairs.add((a, m if cuda_fftp.odd_radices(m) is not None else 0))
    cases = "\n".join(f"  if (loga == {a} && M == {M}) return go<{a}, {M}>(i2, o2, t2, m, C);"
                      for a, M in sorted(pairs))
    (d / "harness.cpp").write_text(_HARNESS.replace("CASES", cases))
    so = d / "libcore.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", f"-I{d}", f"-I{_nvcc.CSRC}",
         "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.run_fft.argtypes = [i, i, p, p, p, i]
    lib.run_fft.restype = i
    lib.tw_count.argtypes = [i, i]
    lib.tw_count.restype = i
    return lib


@pytest.mark.parametrize("n", LENGTHS)
def test_core_source_matches_ifft(core, n):
    a, m = _split(n)
    tw = np.ascontiguousarray(cuda_fftp.stage_twiddles(n).astype(np.complex64))
    assert tw.size == core.tw_count(a, m)
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(COLUMNS, n)) + 1j * rng.normal(size=(COLUMNS, n))).astype(np.complex64)
    out = np.zeros_like(x)
    assert core.run_fft(a, m, x.ctypes.data, out.ctypes.data, tw.ctypes.data if tw.size else None, COLUMNS) == 0
    want = np.fft.ifft(x.astype(np.complex128)) * n
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL_REL * np.abs(want).max())
