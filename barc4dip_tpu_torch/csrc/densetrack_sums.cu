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
// its tiles and windows straight from the images by the grid's start
// coordinates, so the (N, w, w) window stack (176 MB at 2048^2, s = 33,
// r = 10) is never written; the mean-centring of the tile (densetrack.py,
// `t_nl - mean`) moves into the kernel.
//
// Design (L = 2r + 1, w = s + 2r; cuda_densetrack.layout sizes the block):
// one wave of resident blocks, each walking its nodes b, b + gridDim.x, ...
// and each node's F frames, the tile copied, reduced and centred once.
//
// - The numerator is register-tiled. A thread owns the kStrip = 7 offsets
//   (u, 7g .. 7g+6); for each tile row a of its part it slides a ring of
//   kRing = 12 window values in registers along window row u + a: each
//   step loads one window value and does 7 FMAs with one tile value, and
//   the tile values come as warp-uniform 16-byte broadcasts, one per 4
//   steps (the first design did 1 FMA and 2 more sums per 2 shared loads).
//   The tile rows are split into ksplit = 2 parts of 2 warps each, whose
//   sums meet in shared memory. For the default tile side (kFixedTile =
//   33, Config F) a row is unrolled whole when compiled, so the ring's
//   indices are constants and no step is wasted; other sides step through
//   rows zero-padded to a multiple of kRing. The window's pitch is the
//   host's choice, the one with no bank conflict for the threads' row
//   starts (75 floats at Config F).
// - s1 and s2 leave the correlation loop: they are separable box sums. A
//   thread per window row sums its first s values directly and slides
//   along the row for the other L - 1 (+ the value entering, - the one
//   leaving); a thread per output column does the same down the row sums.
//   These run on the last part's threads, which have the fewest tile rows.
//   Each sum is then a direct sum of s terms plus at most L - 1 slides of
//   two, not an integral image, whose differences over a whole frame
//   cancel in float32; chip_smoke.py holds s1 and s2 against float64 sums
//   on the card.
// - Copies are asynchronous (cp.async, 4 bytes each, all in flight). The
//   next node's tile goes into a second buffer during the node's last
//   frame, its mean reduced at the barrier that ends the frame's work; the
//   next window is copied in as soon as the numerator and the row sums are
//   done with the current one, while the column sums and the numerator's
//   parts are finished.
//
// What bounds it on Hopper: float32 FMA issue together with shared-memory
// bandwidth in the numerator loop, which is FMAs but for one window load a
// step and a tile broadcast every 4 (a window pitch with bank conflicts on
// those loads is far slower). At Config F (15,625 nodes, 441 offsets, 33^2
// terms) the numerator is 7.50e9 FMAs, 0.224 ms a frame at 67 TFLOP/s;
// device memory is 116 MB a frame (0.035 ms). The window copies that are
// not hidden, the barriers and the box sums take the rest (PERF.md has the
// times). Taller register tiles (2 or 3 rows of offsets a thread:
// fewer shared loads per FMA), a dedicated box-sum warp and double-buffered
// windows were each slower in exploratory builds: more registers or shared
// memory a block, so fewer warps an SM.
//
// Tensor cores are left out. As products the correlation is one
// (L x s)·(s x s) product per window row, ~2.5x the FLOPs; to stay within
// the kernel's 1e-5 tolerance (a single TF32 pass keeps ~3 digits) it
// would run as 3xTF32, which comes out about even with FP32 on the CUDA
// cores.
//
// Covered: float32 images; ksplit * 32 * ceil(L * ceil(L / 7) / 32) <= 256
// threads and the shared memory (two tiles, the window, two row-sum planes,
// the numerator's parts) within the 227 KB a block may opt in to
// (cuda_densetrack.supported). Others take the plain version on CUDA and
// are counted by the wrapper.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kStrip = 7;       // offsets a thread accumulates along a row
constexpr int kRing = 12;       // window values a sliding strip keeps in registers
constexpr int kFixedTile = 33;  // the tile side whose rows are unrolled whole
constexpr int kMaxThreads = 256;

static_assert(kRing % 4 == 0 && kRing >= kStrip + 3, "a ring holds a strip and one float4 step");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[j] += sum_{b < S} wrow[b + j] * trow[b] with S known when compiled:
// the whole row unrolled, no padded steps. trow 16-byte aligned and
// readable to a multiple of 4, wrow readable to S + kStrip - 2.
template <int S>
__device__ __forceinline__ void strip_dot_fixed(const float* __restrict__ wrow,
                                                const float* __restrict__ trow,
                                                float (&acc)[kStrip]) {
  float ring[kRing];
#pragma unroll
  for (int j = 0; j < kStrip - 1; ++j) ring[j] = wrow[j];
  float4 t4;
#pragma unroll
  for (int b = 0; b < S; ++b) {
    if (b % 4 == 0) t4 = *reinterpret_cast<const float4*>(trow + b);
    const float tv = b % 4 == 0 ? t4.x : b % 4 == 1 ? t4.y : b % 4 == 2 ? t4.z : t4.w;
    ring[(b + kStrip - 1) % kRing] = wrow[b + kStrip - 1];
#pragma unroll
    for (int j = 0; j < kStrip; ++j) acc[j] = fmaf(ring[(b + j) % kRing], tv, acc[j]);
  }
}

// acc[j] += sum_{b < sp} wrow[b + j] * trow[b] for any tile side: the row
// in steps of kRing over the zero-padded sp. trow 16-byte aligned, sp a
// multiple of kRing, wrow readable to sp + kStrip - 2.
__device__ __forceinline__ void strip_dot(const float* __restrict__ wrow,
                                          const float* __restrict__ trow, int sp,
                                          float (&acc)[kStrip]) {
  float ring[kRing];
#pragma unroll
  for (int j = 0; j < kStrip - 1; ++j) ring[j] = wrow[j];
  for (int b0 = 0; b0 < sp; b0 += kRing) {
#pragma unroll
    for (int q = 0; q < kRing / 4; ++q) {
      const float4 t4 = *reinterpret_cast<const float4*>(trow + b0 + 4 * q);
      const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * q + i;
        ring[(k + kStrip - 1) % kRing] = wrow[b0 + k + kStrip - 1];
#pragma unroll
        for (int j = 0; j < kStrip; ++j) acc[j] = fmaf(ring[(k + j) % kRing], tv[i], acc[j]);
      }
    }
  }
}

// Box sums of x[0 .. n + count - 2] (stride pitch) over every run of n:
// out[m * opitch] = sum_{b < n} x[(m + b) * pitch], m < count. The first is
// summed directly, each next one slides: + x[m + n - 1] - x[m - 1]. With
// kSquares, out2 gets the same of x^2.
template <bool kSquares>
__device__ __forceinline__ void box_run(const float* __restrict__ x, int pitch, int n, int count,
                                        float* __restrict__ out, float* __restrict__ out2,
                                        int opitch) {
  float a1 = 0.f, a2 = 0.f;
  for (int b = 0; b < n; ++b) {
    const float v = x[b * pitch];
    a1 += v;
    if (kSquares) a2 = fmaf(v, v, a2);
  }
  out[0] = a1;
  if (kSquares) out2[0] = a2;
  for (int m = 1; m < count; ++m) {
    const float lo = x[(m - 1) * pitch];
    const float hi = x[(m + n - 1) * pitch];
    a1 += hi - lo;
    out[m * opitch] = a1;
    if (kSquares) {
      a2 = fmaf(hi - lo, hi + lo, a2);
      out2[m * opitch] = a2;
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows x cols floats at src (row stride W) into dst (row pitch pitch)
// with asynchronous 4-byte copies, all in flight at once: warp i copies
// rows i, i + nwarps, ...
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int rows,
                                      int cols, int pitch, int W) {
  const int lane = threadIdx.x & 31;
  for (int y = threadIdx.x >> 5; y < rows; y += blockDim.x >> 5) {
    const float* row = src + static_cast<size_t>(y) * W;
    for (int c = lane; c < cols; c += 32) cp_async4(dst + y * pitch + c, row + c);
  }
}

// Grid: one wave of resident blocks, block b taking the nodes b, b +
// gridDim.x, ... and each node's F frames in turn. blockDim.x = ksplit *
// tpp: thread t works on numerator task t % tpp (offsets (u, 7g + j), u =
// task % L, g = task / L; tpp a multiple of 32) over the tile rows of part
// t / tpp of ksplit. Dynamic shared memory, in floats: two tiles s x sp
// (this node's, and the next one's copied in during this node's last
// frame), the window w x wp, row sums 2 x w x L, numerator parts
// (ksplit - 1) x L x L.
__global__ void __launch_bounds__(kMaxThreads, 3)
ncc_sums_kernel(const float* __restrict__ ref, const float* __restrict__ frames,
                const int* __restrict__ y0s, const int* __restrict__ x0s, int F, int H, int W,
                int gx, int N, int s, int r, int sp, int wp, int tpp, int ksplit,
                float* __restrict__ num, float* __restrict__ s1, float* __restrict__ s2) {
  extern __shared__ float4 smem4[];
  __shared__ float red[32];
  const int w = s + 2 * r;
  const int L = 2 * r + 1;
  const int nstrip = (L + kStrip - 1) / kStrip;
  float* tiles = reinterpret_cast<float*>(smem4);
  float* win = tiles + 2 * s * sp;
  float* rs1 = win + w * wp;
  float* rs2 = rs1 + w * L;
  float* parts = rs2 + w * L;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t plane = static_cast<size_t>(H) * W;

  // zero for good: the tiles' and the window's pad columns (no copy writes
  // them)
  for (int y = warp; y < 2 * s; y += nwarps)
    for (int c = s + lane; c < sp; c += 32) tiles[y * sp + c] = 0.f;
  for (int y = warp; y < w; y += nwarps)
    for (int c = w + lane; c < wp; c += 32) win[y * wp + c] = 0.f;

  // the numerator task and part of this thread
  const int k = tid / tpp;
  const int task = tid - k * tpp;
  const bool has_task = task < L * nstrip;
  const int u = task % L;
  const int v0 = kStrip * (task / L);
  const int rows = (s + ksplit - 1) / ksplit;
  const int a0 = k * rows;
  const int a1 = min(s, a0 + rows);
  // the box sums run on the last part's threads, which have the fewest
  // tile rows (and, after the second barrier, no parts to add up)
  const int box0 = (ksplit - 1) * tpp;

  auto origin = [&](int node) {  // top-left corner of the node's tile
    const int iy = node / gx;
    return static_cast<size_t>(y0s[iy]) * W + x0s[node - iy * gx];
  };
  // Each thread copies, sums and centres the same elements of a tile:
  // rows warp, warp + nwarps, ..., columns lane, lane + 32, ...
  auto own_sum = [&](const float* t) {
    float part = 0.f;
    for (int a = warp; a < s; a += nwarps)
      for (int b = lane; b < s; b += 32) part += t[a * sp + b];
    return warp_sum(part);
  };
  auto centre = [&](float* t) {
    float sum = 0.f;
    for (int i = 0; i < nwarps; ++i) sum += red[i];
    const float mean = sum / static_cast<float>(s * s);
    for (int a = warp; a < s; a += nwarps)
      for (int b = lane; b < s; b += 32) t[a * sp + b] -= mean;
  };
  const size_t win_off = static_cast<size_t>(r) * W + r;

  int n = blockIdx.x;
  size_t o = origin(n);
  stage(tiles, ref + o, s, s, sp, W);
  stage(win, frames + o - win_off, w, w, wp, W);
  cp_async_commit();
  cp_async_wait_all();
  const float first = own_sum(tiles);
  if (lane == 0) red[warp] = first;
  __syncthreads();
  centre(tiles);

  int tb = 0;
  for (; n < N; n += gridDim.x) {
    const int n_next = n + gridDim.x;
    const bool next_node = n_next < N;
    const size_t o_next = next_node ? origin(n_next) : 0;
    float* tile = tiles + tb * s * sp;
    float* tile_next = tiles + (tb ^ 1) * s * sp;
    for (int f = 0; f < F; ++f) {
      const bool last = f + 1 == F;
      cp_async_wait_all();
      __syncthreads();  // this (node, frame)'s window and centred tile are in place
      if (last && next_node) {  // the next node's tile, copied in meanwhile
        stage(tile_next, ref + o_next, s, s, sp, W);
        cp_async_commit();
      }

      // row sums: rs[y][v] = sum_{b < s} win[y][v + b], v < L
      for (int y = tid - box0; y >= 0 && y < w; y += blockDim.x - box0)
        box_run<true>(win + y * wp, 1, s, L, rs1 + y * L, rs2 + y * L, 1);

      float acc[kStrip];
#pragma unroll
      for (int j = 0; j < kStrip; ++j) acc[j] = 0.f;
      if (has_task) {
        const float* wrow = win + u * wp + v0;
        if (s == kFixedTile) {
          for (int a = a0; a < a1; ++a) strip_dot_fixed<kFixedTile>(wrow + a * wp, tile + a * sp, acc);
        } else {
          for (int a = a0; a < a1; ++a) strip_dot(wrow + a * wp, tile + a * sp, sp, acc);
        }
        if (k > 0) {
          float* out = parts + (k - 1) * L * L + u * L + v0;
#pragma unroll
          for (int j = 0; j < kStrip; ++j)
            if (v0 + j < L) out[j] = acc[j];
        }
      }
      if (last && next_node) {
        cp_async_wait_all();
        const float part = own_sum(tile_next);
        if (lane == 0) red[warp] = part;
      }
      __syncthreads();  // the window is done with; row sums, parts and red are in place

      // copy in the next (node, frame)'s window; centre the next tile
      if (!last) {
        stage(win, frames + (f + 1) * plane + o - win_off, w, w, wp, W);
      } else if (next_node) {
        stage(win, frames + o_next - win_off, w, w, wp, W);
        centre(tile_next);
      }
      cp_async_commit();

      const size_t base = (static_cast<size_t>(f) * N + n) * L * L;
      if (has_task && k == 0) {
        float* out = num + base + u * L + v0;
#pragma unroll
        for (int j = 0; j < kStrip; ++j) {
          if (v0 + j < L) {
            float v = acc[j];
            for (int p = 0; p < ksplit - 1; ++p) v += parts[p * L * L + u * L + v0 + j];
            out[j] = v;
          }
        }
      }
      // column sums of the row sums: s1[u][v] = sum_{a < s} rs1[u + a][v]
      for (int q = tid - box0; q >= 0 && q < 2 * L; q += blockDim.x - box0) {
        const int v = q % L;
        box_run<false>((q < L ? rs1 : rs2) + v, L, s, L, (q < L ? s1 : s2) + base + v,
                       nullptr, L);
      }
    }
    tb ^= 1;
    o = o_next;
  }
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
      cudaFuncSetAttribute(ncc_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cache) {
    int seen = g_smem_allowed[device].load(std::memory_order_relaxed);
    while (seen < smem && !g_smem_allowed[device].compare_exchange_weak(seen, smem)) {
    }
  }
  return err;
}

}  // namespace

extern "C" {

const char* densetrack_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ref (H, W), frames (F, H, W) float32; y0s (gy), x0s (gx) int32 with every
// window inside the frame; num, s1, s2 (F * gy * gx, 2r+1, 2r+1) float32;
// sp, wp, tpp, ksplit, threads and smem (bytes) from cuda_densetrack.layout.
int densetrack_sums(int device, const void* ref, const void* frames, const void* y0s,
                    const void* x0s, int F, int H, int W, int gy, int gx, int s, int r, int sp,
                    int wp, int tpp, int ksplit, int threads, int smem, void* num, void* s1,
                    void* s2, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave of resident blocks, each walking the nodes
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ncc_sums_kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int N = gy * gx;
  const int grid = per_sm * sms < N ? per_sm * sms : N;
  ncc_sums_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ref), static_cast<const float*>(frames),
      static_cast<const int*>(y0s), static_cast<const int*>(x0s), F, H, W, gx, N, s, r, sp, wp,
      tpp, ksplit, static_cast<float*>(num), static_cast<float*>(s1), static_cast<float*>(s2));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
