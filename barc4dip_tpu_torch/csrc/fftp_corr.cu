// SPDX-License-Identifier: CECILL-2.1
//
// K1: real circular correlation planes from rfft2 spectra, with an optional
// fused NCC epilogue and per-row peak reduction.
//
// Replaces the TPU kernel family in barc4dip_tpu/ops/pallas_fftp.py
// (_stage1_kernel, _stage2_kernel, _stage2_ncc_kernel, built by _build and
// _build_ncc). The contract is kept, the TPU's permuted-order four-step DFT
// is not: the forward spectra are natural-order rfft2 half spectra
// (torch.fft.rfft2), and the inverse transform is this file's own work, on
// the register-resident Stockham core of stockham_fft.cuh.
//
//   out[o] = irfft2(F[o / K] * conj(G[g(o)]), s=(H, W))      (numpy irfft)
//   g(o)   = o % K when the bank is shared by every image, else o
//
// Pass 1, corr_cols_inverse<LOGH>: one block per (plane o, C = min(16384/H,
//   64) adjacent columns k < W/2), H/16 threads per column (1024 threads at
//   H >= 256). Forms F*conj(G) while loading, runs the inverse FFT of length
//   H down each column, writes the complex mid plane (NB, H, W/2). Columns 0
//   and W/2 only need the real part of their column inverse (numpy drops
//   the imaginary parts of the DC and Nyquist bins after it), so they share
//   slot 0: Z[m] = Hm(X_0)[m] + i*Hm(X_W/2)[m], Hm(X)[m] = (X[m] +
//   conj(X[-m]))/2, whose inverse is Re(Y_0) + i*Re(Y_W/2). No block is
//   given to a ragged last column, and the mid plane's rows are 32-byte
//   aligned.
// Pass 2, corr_rows_c2r<LOGW, false>: one block of 256 threads per (plane
//   o, P = 4096/W row pairs), W/16 threads per pair. Rebuilds the two
//   Hermitian rows of length W from columns k and W-k while loading, packs
//   them as Za + i*Zb into one complex inverse FFT (both outputs are real),
//   scales by 1/(H*W).
// Pass 2', corr_rows_c2r<LOGW, true>: pass 2, then the NCC epilogue of
//   _stage2_ncc_kernel: divide by sqrt(var[f] * energy[g]) (0 where that is
//   <= eps, decided on var * energy against a threshold the host derives
//   from eps, so the kernel needs no IEEE square root), -inf where row >= vh
//   or column >= vw, and for each row the (max, first column of the max)
//   with NaN ranked highest. The caller takes the first row holding the
//   plane's maximum: exactly the row-major first-occurrence argmax. Peak
//   columns are int32 (the TPU kernel stores flat indices in f32, exact only
//   below 2^24 pixels).
// In both passes the grid is (K, groups, NF), template index fastest: the K
// blocks that read one image's spectrum rows (pass 1) or variance rows
// (pass 2') run together and share them through L2.
//
// Covered: float32 (complex64 spectra), H and W powers of two in [128, 4096].
//
// What bounds it on Hopper. At 2048^2 a plane is 16.8 MB of float32 output
// and 16.8 MB of complex mid plane (2048 x 1024 x 8 B), and each spectrum
// is 16.8 MB: 67-84 MB of device memory traffic a plane, 20-25 us at
// 3.35 TB/s. The FFT's flops (about 2.5*N*log2(N), 0.23 GFLOP a plane) are
// a few microseconds of FP32. The radix-2 design this replaces ran 11
// barrier-separated stages through shared memory with a global twiddle load
// per butterfly, and its two passes took about 50 us each a plane on the
// H100. Here each thread keeps 16 values in registers and runs radix-16
// butterflies there, so a length-2048 transform makes 2 exchanges through
// padded (bank-conflict-free) shared memory; the twiddles sit in shared
// memory, copied once per block; loads and stores are in natural order,
// coalesced, with no bit reversal. Every kernel fits 64 registers without
// spilling, so a pass-1 block of 1024 threads (32 warps) fills an SM. Pass 1
// is then bound by its strided reads (32-64 B of each spectrum row a block,
// rows 8 B out of 32-byte alignment) and pass 2 by its row traffic; the NCC
// epilogue and the peak reduction ride pass 2 so the map is never re-read
// for its argmax. At B = 1 the mid plane stays in L2 and pass 2 is no
// faster a plane than at B = 4, where it does not: keeping pass 1 and 2
// over groups of planes that fit in L2 would save nothing measurable.
//
// Tensor cores are not used: the FFT's flops are far below its memory
// floor, a DFT written as a matrix product multiplies them by about
// N / log2(N), and it would have to run in 3xTF32 or FP64 to meet the 2e-5
// tolerance (a single TF32 or bf16 pass is the ~4e-3 error class that
// barc4dip_tpu/ops/mxufft.py records for the TPU's bf16 DFT).

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "stockham_fft.cuh"

namespace {

using stockham::ilog2c;
using stockham::kPer;

constexpr int kColThreads = 1024;
constexpr int kRowThreads = 256;
constexpr int kMinLog = 7, kMaxLog = 12;

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// columns per pass-1 block: kColThreads threads, at most 64 columns (W/2 >= 64)
__host__ __device__ constexpr int cols_per_block(int logh) {
  return kColThreads / ((1 << logh) / kPer) < 64 ? kColThreads / ((1 << logh) / kPer) : 64;
}

template <int LOGH>
__global__ void __launch_bounds__(kColThreads)
corr_cols_inverse(const float2* __restrict__ F, const float2* __restrict__ G,
                  float2* __restrict__ mid, const float2* __restrict__ tw,
                  int W, int K, int g_shared) {
  constexpr int H = 1 << LOGH;
  constexpr int T = H / kPer;
  constexpr int C = cols_per_block(LOGH);
  extern __shared__ float2 sm[];
  float2* stw = sm + C * stockham::padded(H);
  stockham::load_twiddles<LOGH>(stw, tw);

  const int c = threadIdx.x % C;
  const int t = threadIdx.x / C;
  const int f = blockIdx.z;
  const int o = f * K + blockIdx.x;
  const int g = g_shared ? blockIdx.x : o;
  const int Wh = W / 2 + 1;
  const int Wq = W / 2;
  const int k = blockIdx.y * C + c;
  const float2* Fp = F + f * static_cast<size_t>(H) * Wh;
  const float2* Gp = G + g * static_cast<size_t>(H) * Wh;

  float2 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = (t + i * T) * Wh + k;  // a plane has < 2^31 entries
    v[i] = cmul_conj(Fp[e], Gp[e]);
  }
  if (blockIdx.y == 0) {  // slot 0: the Hermitian parts of columns 0 and W/2
    // X_0 and X_W/2 go through the exchange buffers of slots 0 and 1, unused
    // until stage 0 stores: holding both in registers spills at 64
    // registers, the budget of a 1024-thread block
    float2* x0 = sm;
    float2* xn = sm + 1;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) x0[stockham::pad(t + i * T) * C] = v[i];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = (t + i * T) * Wh + Wq;
        xn[stockham::pad(t + i * T) * C] = cmul_conj(Fp[e], Gp[e]);
      }
    }
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int m = stockham::pad(t + i * T) * C;
        const int r = stockham::pad((H - t - i * T) & (H - 1)) * C;
        const float2 a = x0[m], b = x0[r], cn = xn[m], d = xn[r];
        const float2 p = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
        const float2 q = make_float2(0.5f * (cn.x + d.x), 0.5f * (cn.y - d.y));
        v[i] = make_float2(p.x - q.y, p.y + q.x);
      }
    }
    __syncthreads();
  }
  stockham::run<LOGH, 0, C>(v, sm + c, stw, t);

  float2* Mp = mid + static_cast<size_t>(o) * H * Wq;
#pragma unroll
  for (int i = 0; i < kPer; ++i) Mp[(t + i * T) * Wq + k] = v[i];
}

// (v, i) beats (bv, bi): NaN ranks highest, ties go to the lower index,
// index -1 marks "nothing yet".
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && bn ? i < bi : vn;
  return v > bv || (v == bv && i < bi);
}

// the best (v, i) over each run of WIDTH lanes, in its first lane
template <int WIDTH>
__device__ __forceinline__ void seg_best(float& v, int& i) {
#pragma unroll
  for (int off = WIDTH / 2; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off, WIDTH);
    const int oi = __shfl_down_sync(0xffffffffu, i, off, WIDTH);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int LOGW, bool NCC>
__global__ void __launch_bounds__(kRowThreads)
corr_rows_c2r(const float2* __restrict__ mid, float* __restrict__ out,
              const float2* __restrict__ tw, int H, float scale,
              const float* __restrict__ var, const float* __restrict__ energy,
              int K, int e_shared, float thr, int vh, int vw,
              float* __restrict__ rowmax, int* __restrict__ rowarg) {
  constexpr int W = 1 << LOGW;
  constexpr int T = W / kPer;
  constexpr int P = kRowThreads / T;
  constexpr int Wq = W / 2;
  extern __shared__ float2 sm[];
  float2* stw = sm + P * stockham::padded(W);
  stockham::load_twiddles<LOGW>(stw, tw);

  const int t = threadIdx.x % T;
  const int p = threadIdx.x / T;
  const int o = blockIdx.z * K + blockIdx.x;
  const int ra = 2 * (blockIdx.y * P + p);
  const float2* ma = mid + (static_cast<size_t>(o) * H + ra) * Wq;
  const float2* mb = ma + Wq;

  // z[n] = Xa[n] + i*Xb[n], Xa[n] = conj(Xa[W-n]) for n > W/2; the real DC
  // and Nyquist bins sit in slot 0 as (DC, Nyquist)
  float2 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    float2 xa, xb;
    if (i < kPer / 2) {
      const int n = t + i * T;
      xa = ma[n];
      xb = mb[n];
      if (i == 0 && t == 0) {
        xa.y = 0.f;
        xb.y = 0.f;
      }
    } else {
      const bool nyq = i == kPer / 2 && t == 0;
      const int n = nyq ? 0 : (kPer - i) * T - t;
      xa = ma[n];
      xb = mb[n];
      if (nyq) {
        xa = make_float2(xa.y, 0.f);
        xb = make_float2(xb.y, 0.f);
      } else {
        xa.y = -xa.y;
        xb.y = -xb.y;
      }
    }
    v[i] = make_float2(xa.x - xb.y, xa.y + xb.x);
  }
  stockham::run<LOGW, 0, 1>(v, sm + p * stockham::padded(W), stw, t);

  // thread t holds outputs n = t + i*T of rows ra (x) and ra + 1 (y)
  float* oa = out + (static_cast<size_t>(o) * H + ra) * W;
  float* ob = oa + W;
  if constexpr (!NCC) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      oa[t + i * T] = v[i].x * scale;
      ob[t + i * T] = v[i].y * scale;
    }
  } else {
    const int f = blockIdx.z;
    const float en = energy[e_shared ? blockIdx.x : o];
    const float* va = var + (static_cast<size_t>(f) * H + ra) * W;
    const float* vb = va + W;
    float bva = 0.f, bvb = 0.f;
    int bia = t, bib = t;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = t + i * T;
      // sqrt(x) > eps exactly when x > thr; rsqrtf's ~2 ulp are far inside
      // the FFT's round-off (an IEEE sqrt and divide here doubled the pass)
      const float xa = va[n] * en;
      const float xb = vb[n] * en;
      float a = xa > thr ? v[i].x * scale * rsqrtf(xa) : 0.f;
      float b = xb > thr ? v[i].y * scale * rsqrtf(xb) : 0.f;
      if (n >= vw || ra >= vh) a = -INFINITY;
      if (n >= vw || ra + 1 >= vh) b = -INFINITY;
      oa[n] = a;
      ob[n] = b;
      // n grows with i, so a tie keeps the earlier column: better() reduced
      if (i == 0 || a > bva || (isnan(a) && !isnan(bva))) {
        bva = a;
        bia = n;
      }
      if (i == 0 || b > bvb || (isnan(b) && !isnan(bvb))) {
        bvb = b;
        bib = n;
      }
    }
    constexpr int kSeg = T < 32 ? T : 32;
    seg_best<kSeg>(bva, bia);
    seg_best<kSeg>(bvb, bib);
    const size_t r = static_cast<size_t>(o) * H + ra;
    if constexpr (T <= 32) {
      if (t == 0) {
        rowmax[r] = bva;
        rowarg[r] = bia;
        rowmax[r + 1] = bvb;
        rowarg[r + 1] = bib;
      }
    } else {  // T/32 warps per row pair: through shared memory
      constexpr int kWarps = kRowThreads / 32;
      constexpr int kPerPair = T / 32;
      __shared__ float sva[kWarps], svb[kWarps];
      __shared__ int sia[kWarps], sib[kWarps];
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) {
        sva[warp] = bva;
        sia[warp] = bia;
        svb[warp] = bvb;
        sib[warp] = bib;
      }
      __syncthreads();
      if (t < 32) {  // the first warp of each row pair
        const int w = p * kPerPair + t;
        bva = t < kPerPair ? sva[w] : 0.f;
        bia = t < kPerPair ? sia[w] : -1;
        bvb = t < kPerPair ? svb[w] : 0.f;
        bib = t < kPerPair ? sib[w] : -1;
        seg_best<32>(bva, bia);
        seg_best<32>(bvb, bib);
        if (t == 0) {
          rowmax[r] = bva;
          rowarg[r] = bia;
          rowmax[r + 1] = bvb;
          rowarg[r + 1] = bib;
        }
      }
    }
  }
}

bool covered(int n) { return n >= (1 << kMinLog) && n <= (1 << kMaxLog) && (n & (n - 1)) == 0; }

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

// cudaFuncSetAttribute once per (device, kernel): each instantiation's
// dynamic shared memory is a constant of its template arguments
constexpr int kMaxDevices = 64;
constexpr int kKinds = 3;  // cols, rows, rows_ncc
std::atomic<bool> g_smem_set[kMaxDevices][kKinds][kMaxLog + 1];

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, int kind, int logn, int smem) {
  const bool cache = device >= 0 && device < kMaxDevices;
  if (cache && g_smem_set[device][kind][logn].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cache) g_smem_set[device][kind][logn].store(true, std::memory_order_release);
  return err;
}

template <int LOGH>
int launch_cols(int device, const float2* F, const float2* G, float2* mid,
                const float2* tw, int W, int NB, int K, int g_shared,
                cudaStream_t stream) {
  constexpr int H = 1 << LOGH;
  constexpr int C = cols_per_block(LOGH);
  constexpr int smem =
      (C * stockham::padded(H) + stockham::tw_count(LOGH)) * static_cast<int>(sizeof(float2));
  cudaError_t err = allow_smem(corr_cols_inverse<LOGH>, device, 0, LOGH, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(K, W / 2 / C, NB / K);
  corr_cols_inverse<LOGH><<<grid, C * (H / kPer), smem, stream>>>(F, G, mid, tw, W, K, g_shared);
  return static_cast<int>(cudaGetLastError());
}

template <int LOGW, bool NCC>
int launch_rows(int device, const float2* mid, float* out, const float2* tw,
                int H, int NB, float scale, const float* var,
                const float* energy, int K, int e_shared, float thr, int vh,
                int vw, float* rowmax, int* rowarg, cudaStream_t stream) {
  constexpr int W = 1 << LOGW;
  constexpr int P = kRowThreads / (W / kPer);
  constexpr int smem =
      (P * stockham::padded(W) + stockham::tw_count(LOGW)) * static_cast<int>(sizeof(float2));
  cudaError_t err = allow_smem(corr_rows_c2r<LOGW, NCC>, device, NCC ? 2 : 1, LOGW, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(K, H / 2 / P, NB / K);
  corr_rows_c2r<LOGW, NCC><<<grid, kRowThreads, smem, stream>>>(
      mid, out, tw, H, scale, var, energy, K, e_shared, thr, vh, vw, rowmax, rowarg);
  return static_cast<int>(cudaGetLastError());
}

template <bool NCC>
int rows_dispatch(int device, const void* mid, void* out, const void* tw,
                  int ntw, int H, int W, int NB, float scale, const void* var,
                  const void* energy, int K, int e_shared, float thr, int vh,
                  int vw, void* rowmax, int* rowarg, void* stream) {
  if (!covered(H) || !covered(W) || ntw != stockham::tw_count(ilog2c(W)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* m = static_cast<const float2*>(mid);
  auto* o = static_cast<float*>(out);
  const auto* w = static_cast<const float2*>(tw);
  const auto* vr = static_cast<const float*>(var);
  const auto* en = static_cast<const float*>(energy);
  auto* rm = static_cast<float*>(rowmax);
  auto s = static_cast<cudaStream_t>(stream);
  switch (ilog2c(W)) {
#define K1_ROWS(L)                                                                   \
  case L:                                                                            \
    return launch_rows<L, NCC>(device, m, o, w, H, NB, scale, vr, en, K, e_shared, \
                               thr, vh, vw, rm, rowarg, s);
    K1_ROWS(7)
    K1_ROWS(8)
    K1_ROWS(9)
    K1_ROWS(10)
    K1_ROWS(11)
    K1_ROWS(12)
#undef K1_ROWS
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* fftp_corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// F (NF, H, W/2+1) complex64, G (K, H, W/2+1) when g_shared else
// (NB, H, W/2+1), mid (NB, H, W/2) complex64, tw the stage twiddle table of
// length H (ntw complex64 entries). NB = NF * K.
int fftp_corr_cols(int device, const void* F, const void* G, void* mid,
                   const void* tw, int ntw, int H, int W, int NB, int K,
                   int g_shared, void* stream) {
  if (!covered(H) || !covered(W) || ntw != stockham::tw_count(ilog2c(H)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* f = static_cast<const float2*>(F);
  const auto* g = static_cast<const float2*>(G);
  auto* m = static_cast<float2*>(mid);
  const auto* w = static_cast<const float2*>(tw);
  auto s = static_cast<cudaStream_t>(stream);
  switch (ilog2c(H)) {
#define K1_COLS(L) \
  case L:          \
    return launch_cols<L>(device, f, g, m, w, W, NB, K, g_shared, s);
    K1_COLS(7)
    K1_COLS(8)
    K1_COLS(9)
    K1_COLS(10)
    K1_COLS(11)
    K1_COLS(12)
#undef K1_COLS
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// mid (NB, H, W/2) complex64 -> out (NB, H, W) float32; tw the stage
// twiddle table of length W (ntw complex64 entries).
int fftp_corr_rows(int device, const void* mid, void* out, const void* tw,
                   int ntw, int H, int W, int NB, float scale, void* stream) {
  return rows_dispatch<false>(device, mid, out, tw, ntw, H, W, NB, scale,
                              nullptr, nullptr, 1, 1, 0.f, H, W, nullptr,
                              nullptr, stream);
}

// As fftp_corr_rows plus the NCC epilogue: var (NF, H, W) float32, energy
// (K) when e_shared else (NB) float32, thr the float32 threshold with
// sqrt(x) > eps <=> x > thr, rowmax (NB, H) float32, rowarg (NB, H) int32.
int fftp_corr_rows_ncc(int device, const void* mid, void* out,
                       const void* tw, int ntw, int H, int W, int NB,
                       float scale, const void* var, const void* energy,
                       int K, int e_shared, float thr, int vh, int vw,
                       void* rowmax, void* rowarg, void* stream) {
  return rows_dispatch<true>(device, mid, out, tw, ntw, H, W, NB, scale, var,
                             energy, K, e_shared, thr, vh, vw, rowmax,
                             static_cast<int*>(rowarg), stream);
}

}  // extern "C"
