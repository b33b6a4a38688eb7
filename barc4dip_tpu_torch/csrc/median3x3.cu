// SPDX-License-Identifier: CECILL-2.1
//
// K2: 3x3 median filter with a symmetric (edge-duplicating) boundary, the
// result of scipy.ndimage.median_filter(size=3, mode="reflect").
//
// Replaces the TPU kernel barc4dip_tpu/ops/pallas_median.py
// (median3x3_pallas, kernel body _kernel + _median9). The TPU kernel
// streams 64-row bands through VMEM from three row-shifted copies of a
// padded image; that layout is a TPU artefact and is not kept. The
// contract is: out[b, y, x] = median of x[b, clamp(y+dy), clamp(x+dx)],
// dy, dx in {-1, 0, 1}, where clamp to [0, n-1] equals the symmetric pad
// of width 1.
//
// Design: one thread per output pixel; a block covers a 32 x 8 tile and
// stages the (32+2) x (8+2) halo in shared memory, with the boundary
// reflected by index (no padded copy of the image is written). The median
// is Paeth's 19-exchange network in registers, with the exchanges in the
// order of pallas_median._median9. min/max propagate NaN as jnp.minimum /
// jnp.maximum do (fminf/fmaxf would drop it), so a NaN anywhere in a 3x3
// neighbourhood gives NaN, as on the TPU.
//
// Covered: float32, (B, H, W) contiguous, any H, W >= 1; the grid's z
// dimension is B (B <= 65535).
//
// What bounds it on Hopper: device memory. Each pixel is read about
// (34*10)/(32*8) = 1.33 times (the halo) and written once, against ~40
// min/max per pixel, far below the card's operations-per-byte balance, so
// the kernel streams at a fraction of 3.35 TB/s. Wider tiles, several
// outputs per thread and vector loads are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void sort2(float& lo, float& hi) {
  const float a = lo, b = hi;
  lo = nan_min(a, b);
  hi = nan_max(a, b);
}

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(kBX * kBY)
median3x3_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W) {
  __shared__ float tile[kBY + 2][kBX + 2];
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xb = x + blockIdx.z * plane;
  float* yb = y + blockIdx.z * plane;
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < (kBY + 2) * (kBX + 2); i += kBX * kBY) {
    const int ty = i / (kBX + 2);
    const int tx = i - ty * (kBX + 2);
    const int gy = clampi(y0 + ty - 1, H);
    const int gx = clampi(x0 + tx - 1, W);
    tile[ty][tx] = xb[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();
  const int ox = x0 + threadIdx.x;
  const int oy = y0 + threadIdx.y;
  if (ox >= W || oy >= H) return;

  float v[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) v[3 * dy + dx] = tile[threadIdx.y + dy][threadIdx.x + dx];
  }
  sort2(v[1], v[2]); sort2(v[4], v[5]); sort2(v[7], v[8]);
  sort2(v[0], v[1]); sort2(v[3], v[4]); sort2(v[6], v[7]);
  sort2(v[1], v[2]); sort2(v[4], v[5]); sort2(v[7], v[8]);
  sort2(v[0], v[3]); sort2(v[5], v[8]); sort2(v[4], v[7]);
  sort2(v[3], v[6]); sort2(v[1], v[4]); sort2(v[2], v[5]);
  sort2(v[4], v[7]); sort2(v[4], v[2]); sort2(v[6], v[4]);
  sort2(v[4], v[2]);
  yb[static_cast<size_t>(oy) * W + ox] = v[4];
}

}  // namespace

extern "C" {

const char* median3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (B, H, W) float32, contiguous, distinct buffers.
int median3x3(int device, const void* x, void* y, int B, int H, int W, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, B);
  median3x3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
