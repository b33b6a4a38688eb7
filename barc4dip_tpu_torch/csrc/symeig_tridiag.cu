// SPDX-License-Identifier: CECILL-2.1
//
// K4: the ascending eigenvalues of a batch of symmetric float32 matrices
// (B, M, M), M <= 238, from their lower triangles: the dense eigenvalue
// route of the sharpness estimator (STA2), whose subtiles give four
// buckets of 16-25 Gram matrices of 227^2 or 228^2 at 2048^2.
//
// Replaces no TPU kernel: the JAX package computes these eigenvalues with
// XLA's eigh (barc4dip_tpu/metrics/estimators.py, eigenvalues_core). The
// port called torch.linalg.eigvalsh, cuSOLVER's batched Jacobi, which
// spent ~0.41 s of device time and ~59,000 launches on one 2048^2 frame's
// 81 subtiles. This kernel is one launch a bucket; the algorithm is in
// symeig_tridiag.cuh (Householder tridiagonalisation in shared memory, then
// Sturm bisection), the same as ops/cuda_symeig.symeig_tridiag_plain.
//
// Design: one block of kThreads a matrix, the whole matrix in dynamic
// shared memory as a full square (smem_floats(M) floats: 230,896 bytes at
// M = 238, the largest that fits the 232,448 a block may opt in to; the
// wrapper routes larger M to the library). Global memory is read once (the
// lower triangle) and written once (the M eigenvalues); there is no
// scratch. The trailing block of step i is read and written once a step,
// a warp a row, each lane's columns of v and w held in registers, so the
// step's update and its matrix-vector product share one pass.
//
// What bounds it on Hopper: latency inside one SM, not the card's rates.
// The useful work is the tridiagonalisation's (4/3) M^3 operations, 15.8
// MFLOP a 228^2 matrix (0.24 us at 67 TFLOP/s); one block is one SM, so a
// launch lasts as long as one block: ~1.3 ms at 228^2 on an H100 (clock64
// per phase): ~70% in the M - 1 steps of the tridiagonalisation, of which
// the trailing block's pass is ~2/3 (some 11 instructions issued an element
// of the update and the product, a warp's rows one after another) and the
// three barriers and float64 scalar chain of each step the rest; ~30% in
// the bisection (~25 counts of M dependent float64 pivots a thread, 228
// threads busy). A batch fills B of the 132 SMs; the buckets are separate
// launches. Measured slower: 256 or 1024 threads a block, rows updated and
// reduced two to four at a time, a row's loads issued before its updates.

#include <cuda_runtime.h>

#include <atomic>

#include "symeig_tridiag.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may opt in to on Hopper

__global__ void __launch_bounds__(kThreads, 1)
    symeig_kernel(const float* __restrict__ G, float* __restrict__ out, int M) {
  extern __shared__ __align__(16) float smem[];
  const size_t b = blockIdx.x;
  symeig::solve(G + b * M * M, out + b * M, M, smem);
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

// the largest dynamic shared memory opted in to so far, per device
constexpr int kMaxDevices = 64;
constexpr int kStaticLimit = 48 * 1024;
std::atomic<int> g_smem_allowed[kMaxDevices];

cudaError_t allow_smem(int device, int smem) {
  if (smem <= kStaticLimit) return cudaSuccess;
  const bool cache = device >= 0 && device < kMaxDevices;
  if (cache && g_smem_allowed[device].load(std::memory_order_acquire) >= smem) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(symeig_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cache) {
    int seen = g_smem_allowed[device].load(std::memory_order_relaxed);
    while (seen < smem && !g_smem_allowed[device].compare_exchange_weak(seen, smem)) {
    }
  }
  return err;
}

}  // namespace

extern "C" {

const char* symeig_tridiag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the largest M a launch takes
int symeig_tridiag_max_m() {
  int M = 1;
  while (4 * symeig::smem_floats(M + 1) <= kMaxSmem) ++M;
  return M;
}

// G (B, M, M) float32, contiguous (its lower triangle is read); out (B, M)
// float32: each matrix's eigenvalues in ascending order.
int symeig_tridiag(int device, const void* G, void* out, int B, int M, void* stream) {
  if (B < 1 || M < 1 || M > symeig_tridiag_max_m()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 4 * symeig::smem_floats(M);
  err = allow_smem(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  symeig_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<float*>(out), M);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
