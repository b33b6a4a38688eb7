// SPDX-License-Identifier: CECILL-2.1
//
// K3: the windowed NCC sums of dense speckle tracking. For every grid node
// n, every frame f and every offset (u, v) in [0, 2r]^2:
//
//   num[f*N + n, u, v] = sum_{a,b < s} win[u+a, v+b] * (tile[a, b] - mean(tile))
//   s1 [f*N + n, u, v] = sum_{a,b < s} win[u+a, v+b]
//   s2 [f*N + n, u, v] = sum_{a,b < s} win[u+a, v+b]^2
//
// with tile = ref[y0 : y0+s, x0 : x0+s] and win = frame_f[y0-r : y0+s+r,
// x0-r : x0+s+r] for the node's start (y0, x0) = (y0s[n / gx], x0s[n % gx]).
//
// Replaces the TPU kernel barc4dip_tpu/ops/densetrack.py::_pallas_ncc_sums
// (the inner `kernel`). That kernel takes node-last (s, s, Np) tiles and
// (w, w, Np) windows, a layout built by a patch-extraction convolution
// because lane-varying gathers are slow on the TPU. Here each block reads
// its tile and window straight from the two images by the grid's start
// coordinates, so the (N, w, w) window stack (176 MB at 2048^2, s = 33,
// r = 10) is never written; the mean-centring of the tile (densetrack.py,
// `t_nl - mean`) moves into the kernel.
//
// Design: one block per (node, frame). The tile (s^2 floats) and the
// window (w^2, w = s + 2r) are staged in shared memory; the tile's mean is
// a block reduction. The (2r+1)^2 offsets are spread over the threads in
// row-major order, so a warp reads consecutive window columns; each thread
// accumulates its three sums over s x s in float32 registers, reading the
// tile as a broadcast. Outputs are node-first (F*N, L, L), L = 2r + 1.
//
// Covered: float32 images, (s^2 + w^2) * 4 bytes within 48 KB of shared
// memory (the limit without an opt-in) less the 128-byte reduction scratch
// (w <= 96 or so), frames F <= 65535. A larger geometry
// takes the plain version on CUDA and is counted by the wrapper.
//
// What bounds it on Hopper: shared-memory bandwidth. Each multiply-add
// pair reads one window value per lane (the tile value is a broadcast), so
// a warp executes one shared load per three FMAs: at Config F (15,625 nodes,
// 441 offsets, 33^2 terms) that is 7.5e9 lane-steps, ~2 ms at one shared
// load per SM cycle. Device-memory traffic is small (each block reads
// (s^2 + w^2) * 4 = 15.6 KB, mostly from L2, and writes 3 * 441 * 4 B).
// Register tiling (several offsets per thread sliding along a window row)
// or tensor cores are later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void ncc_sums_kernel(const float* __restrict__ ref,
                                const float* __restrict__ frames,
                                const int* __restrict__ y0s,
                                const int* __restrict__ x0s, int H, int W,
                                int gx, int N, int s, int r,
                                float* __restrict__ num, float* __restrict__ s1,
                                float* __restrict__ s2) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int w = s + 2 * r;
  const int L = 2 * r + 1;
  float* tile = smem;
  float* win = smem + s * s;

  const int n = blockIdx.x;
  const int f = blockIdx.y;
  const int iy = n / gx;
  const int y0 = y0s[iy];
  const int x0 = x0s[n - iy * gx];
  const float* fr = frames + static_cast<size_t>(f) * H * W;

  float part = 0.f;
  for (int i = threadIdx.x; i < s * s; i += blockDim.x) {
    const int a = i / s;
    const float t = ref[static_cast<size_t>(y0 + a) * W + x0 + (i - a * s)];
    tile[i] = t;
    part += t;
  }
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int a = i / w;
    win[i] = fr[static_cast<size_t>(y0 - r + a) * W + x0 - r + (i - a * w)];
  }
  part = warp_sum(part);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (warp == 0) {
    float v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float mean = red[0] / static_cast<float>(s * s);
  for (int i = threadIdx.x; i < s * s; i += blockDim.x) tile[i] -= mean;
  __syncthreads();

  const size_t base = (static_cast<size_t>(f) * N + n) * L * L;
  for (int o = threadIdx.x; o < L * L; o += blockDim.x) {
    const int u = o / L;
    const float* wp = win + u * w + (o - u * L);
    float an = 0.f, a1 = 0.f, a2 = 0.f;
    for (int a = 0; a < s; ++a) {
      const float* wr = wp + a * w;
      const float* tr = tile + a * s;
      for (int b = 0; b < s; ++b) {
        const float x = wr[b];
        an = fmaf(x, tr[b], an);
        a1 += x;
        a2 = fmaf(x, x, a2);
      }
    }
    num[base + o] = an;
    s1[base + o] = a1;
    s2[base + o] = a2;
  }
}

}  // namespace

extern "C" {

const char* densetrack_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ref (H, W), frames (F, H, W) float32; y0s (gy), x0s (gx) int32 with every
// window inside the frame; num, s1, s2 (F * gy * gx, 2r+1, 2r+1) float32.
int densetrack_sums(int device, const void* ref, const void* frames,
                    const void* y0s, const void* x0s, int F, int H, int W,
                    int gy, int gx, int s, int r, void* num, void* s1,
                    void* s2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int w = s + 2 * r;
  const int L = 2 * r + 1;
  const int smem = (s * s + w * w) * static_cast<int>(sizeof(float));
  int threads = ((L * L + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  const dim3 grid(gy * gx, F);
  ncc_sums_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ref), static_cast<const float*>(frames),
      static_cast<const int*>(y0s), static_cast<const int*>(x0s), H, W, gx,
      gy * gx, s, r, static_cast<float*>(num), static_cast<float*>(s1),
      static_cast<float*>(s2));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
