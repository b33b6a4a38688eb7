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
// Design: each thread computes 4 adjacent columns of kRows = 4 output rows.
// It fetches its kRows + 2 input rows first, each one 16-byte load (rows
// whose width is a multiple of 4, both buffers 16-byte aligned; others take
// 4 scalar loads), then slides the three rows through registers; nothing
// is staged in shared memory. A row's left and right neighbour columns come
// from the neighbouring lanes by shuffles, and only the warp's two end
// lanes load a scalar for them. The boundary is reflected by clamping the
// row and the column index: no padded copy is written and no index is
// divided. The median shares work between neighbouring outputs: each of the
// 6 input columns' 3 values is sorted once per output row, and the median
// of 9 is med3(max of the column minima, med3 of the column medians, min of
// the column maxima), exact for 9 values. min/max propagate NaN as
// jnp.minimum / jnp.maximum do (fminf/fmaxf would drop it): a NaN in a
// column makes its three sorted values NaN, so a NaN anywhere in a 3x3
// neighbourhood gives NaN, as on the TPU. Outputs are written with
// streaming stores (evict first), so they do not push the input out of L2.
//
// Covered: float32, (B, H, W) contiguous, any H, W >= 1; B <= 65535 (the
// grid's z dimension).
//
// What bounds it on Hopper: device memory. It writes each pixel once and
// reads it once from device memory (the 4 warps of a block stack along y,
// so a band's halo rows mostly hit L1), with ~21 min/max a pixel, far below
// the card's operations-per-byte balance: the bound is 2 * 4 bytes a pixel
// at 3.35 TB/s, 0.010 ms at 2048^2 and 0.060 ms at (6, 2048, 2048).
// On an H100 it reaches about half of that bound (PERF.md). Taller bands
// (8 or 16 rows a thread), 8 warps a block, a 64-register cap and sliding
// instead of up-front row fetches all measured slower.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;    // output rows a thread computes
constexpr int kWarps = 4;   // warps a block, stacked along y
constexpr int kCols = 128;  // columns a warp covers: 4 a lane

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

__device__ __forceinline__ float med3(float a, float b, float c) {
  return nan_max(nan_min(a, b), nan_min(nan_max(a, b), c));
}

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// One input row as a lane loads it: 4 columns x0 .. x0+3 and, for the
// warp's end lanes, the column beside the warp (x0 - 1 or x0 + 4); rows
// and columns clamped.
struct Row {
  float4 q;
  float side;
};

template <bool kVec>
__device__ __forceinline__ Row fetch_row(const float* __restrict__ plane, int y, int H, int W,
                                         int x0) {
  const float* row = plane + static_cast<size_t>(clampi(y, H)) * W;
  Row v;
  if (kVec && x0 + 3 < W) {
    v.q = *reinterpret_cast<const float4*>(row + x0);
  } else {
    v.q = make_float4(row[clampi(x0, W)], row[clampi(x0 + 1, W)], row[clampi(x0 + 2, W)],
                      row[clampi(x0 + 3, W)]);
  }
  const unsigned lane = threadIdx.x;
  v.side = 0.f;
  if (lane == 0 || lane == 31) v.side = row[clampi(lane == 0 ? x0 - 1 : x0 + 4, W)];
  return v;
}

// Columns x0-1 .. x0+4 of a fetched row into v[0..5]: the side columns from
// the neighbouring lanes; all 32 lanes of the warp call it together.
__device__ __forceinline__ void spread(const Row& row, float (&v)[6]) {
  v[1] = row.q.x; v[2] = row.q.y; v[3] = row.q.z; v[4] = row.q.w;
  const unsigned lane = threadIdx.x;
  const float left = __shfl_up_sync(0xffffffffu, row.q.w, 1);
  const float right = __shfl_down_sync(0xffffffffu, row.q.x, 1);
  v[0] = lane == 0 ? row.side : left;
  v[5] = lane == 31 ? row.side : right;
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
median3x3_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W) {
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xb = x + blockIdx.z * plane;
  float* yb = y + blockIdx.z * plane;
  const int x0 = blockIdx.x * kCols + 4 * threadIdx.x;
  const int y0 = (blockIdx.y * kWarps + threadIdx.y) * kRows;
  if (y0 >= H) return;  // whole warps leave together: y0 is warp-uniform

  // the kRows + 2 input rows are all fetched before any is used
  Row in[kRows + 2];
#pragma unroll
  for (int i = 0; i < kRows + 2; ++i) in[i] = fetch_row<kVec>(xb, y0 - 1 + i, H, W, x0);
  float r0[6], r1[6], r2[6];
  spread(in[0], r0);
  spread(in[1], r1);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    spread(in[i + 2], r2);
    float lo[6], md[6], hi[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float a = r0[c], b = r1[c], d = r2[c];
      sort2(a, b);
      sort2(b, d);
      sort2(a, b);
      lo[c] = a; md[c] = b; hi[c] = d;
    }
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float l = nan_max(nan_max(lo[j], lo[j + 1]), lo[j + 2]);
      const float m = med3(md[j], md[j + 1], md[j + 2]);
      const float h = nan_min(nan_min(hi[j], hi[j + 1]), hi[j + 2]);
      out[j] = med3(l, m, h);
    }
    const int oy = y0 + i;
    if (oy < H) {
      float* dst = yb + static_cast<size_t>(oy) * W + x0;
      if (kVec && x0 + 3 < W) {
        __stcs(reinterpret_cast<float4*>(dst), make_float4(out[0], out[1], out[2], out[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (x0 + j < W) dst[j] = out[j];
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      r0[c] = r1[c];
      r1[c] = r2[c];
    }
  }
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

const char* median3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (B, H, W) float32, contiguous, distinct buffers.
int median3x3(int device, const void* x, void* y, int B, int H, int W, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32, kWarps);
  const dim3 grid((W + kCols - 1) / kCols, (H + kRows * kWarps - 1) / (kRows * kWarps), B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte rows: every row start is 16-byte aligned when W % 4 == 0 and
  // both buffers are
  const bool vec = W % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(y) % 16 == 0;
  if (vec) {
    median3x3_kernel<true><<<grid, block, 0, st>>>(static_cast<const float*>(x),
                                                   static_cast<float*>(y), H, W);
  } else {
    median3x3_kernel<false><<<grid, block, 0, st>>>(static_cast<const float*>(x),
                                                    static_cast<float*>(y), H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
