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
// Each side is n = 2^a * m with m odd. The kernels are instantiated per a
// (7..13) and per ODD = (m > 1), and take m at run time: a power-of-two
// side runs code with its length, T and block shape constant (the code K1
// had before it took odd sides), an odd one (a <= 11, m <= 63) the
// runtime-length code with one direct odd stage (stockham_fft.cuh). A
// transform of length n is held by T = n/16 threads.
//
// Pass 1, corr_cols_inverse<a, ODD>: one block per (plane o, C adjacent columns
//   k < W/2), C = min(1024/T, 64) with T = H/16, so C*T <= 1024 threads
//   (C >= 2 at every H <= 8192). Forms F*conj(G) while loading, runs the
//   inverse FFT of length H down each column, writes the complex mid plane
//   (NB, H, W/2). Where C does not divide W/2 (H = 1536: T = 96, C = 10)
//   the last block's columns past W/2 load zeros and store nothing. Columns
//   0 and W/2 only need the real part of their column inverse (numpy drops
//   the imaginary parts of the DC and Nyquist bins after it), so they share
//   slot 0: Z[m] = Hm(X_0)[m] + i*Hm(X_W/2)[m], Hm(X)[m] = (X[m] +
//   conj(X[-m]))/2, whose inverse is Re(Y_0) + i*Re(Y_W/2).
// Pass 2, corr_rows_c2r<a, ODD, false>: one block per (plane o, P row pairs),
//   P = max(1, 256/T) with T = W/16, P*T threads (at most 512). Where P
//   does not divide H/2 the last block's pairs past H load zeros and store
//   nothing. Rebuilds the two Hermitian rows of length W from columns k and
//   W-k while loading (this needs only 16 | W), packs them as Za + i*Zb into
//   one complex inverse FFT (both outputs are real), scales by 1/(H*W).
// Pass 2', corr_rows_c2r<a, ODD, true>: pass 2, then the NCC epilogue of
//   _stage2_ncc_kernel: divide by sqrt(var[f] * energy[g]) (0 where that is
//   <= eps, decided on var * energy against a threshold the host derives
//   from eps, so the kernel needs no IEEE square root), -inf where row >= vh
//   or column >= vw, and for each row the (max, first column of the max)
//   with NaN ranked highest. The row's T threads reduce by warp shuffles
//   when T is a power of two up to 32 or a multiple of 32, else (T = 8m or
//   16m, W = 384, 640, ..., 8064) through shared memory, one thread a row
//   pair. The caller takes the first row holding the plane's maximum:
//   exactly the row-major first-occurrence argmax. Peak columns are int32
//   (the TPU kernel stores flat indices in f32, exact only below 2^24
//   pixels).
// In both passes the grid is (K, groups, NF), template index fastest: the K
// blocks that read one image's spectrum rows (pass 1) or variance rows
// (pass 2') run together and share them through L2.
//
// Covered: float32 (complex64 spectra), H and W = 128*k, k = 1..64: the
// shapes barc4dip_tpu/ops/pallas_fftp.supported takes. Shared memory: at
// most C*T = 1024 threads' padded exchange slots (139,264 B) plus a twiddle
// table of at most 8,176 entries (65,408 B) in pass 1, 204,672 B in all,
// under the 232,448 B a block may opt into.
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
// coalesced, with no bit reversal. The power-of-two instantiations fit 64
// registers without spilling (chip_smoke.py prints every instantiation's
// registers and spills), so a pass-1 block of 1024 threads (32 warps) fills
// an SM. Pass 1
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

using stockham::kPer;

constexpr int kColThreads = 1024;
constexpr int kRowThreads = 256;     // pass 2 block, while T = W/16 <= 256
constexpr int kRowMaxThreads = 512;  // T at W = 8192 (and up to 504 at W = 8064)
constexpr int kMinLog = 7, kMaxLog = 13;
constexpr int kMaxSide = 8192;

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// columns per pass-1 block, T threads each: at most 1024 threads and 64
// columns (W/2 >= 64)
__host__ __device__ constexpr int cols_per_block(int T) {
  return kColThreads / T < 64 ? kColThreads / T : 64;
}

// row pairs per pass-2 block, T threads each
__host__ __device__ constexpr int pairs_per_block(int T) {
  return T >= kRowThreads ? 1 : kRowThreads / T;
}

// pass 2's block bound: 256 threads for a power-of-two W up to 4096, as
// before the odd sides, else the 512 that W = 8192 or an odd side may need
__host__ __device__ constexpr int rows_bound(int loga, bool odd) {
  return odd || loga == kMaxLog ? kRowMaxThreads : kRowThreads;
}

// ODD = (m > 1), H = m << LOGA: a power-of-two H has H, T and C constant
template <int LOGA, bool ODD>
__global__ void __launch_bounds__(kColThreads)
corr_cols_inverse(const float2* __restrict__ F, const float2* __restrict__ G,
                  float2* __restrict__ mid, const float2* __restrict__ tw, int ntw,
                  int m, int W, int K, int g_shared) {
  const int H = ODD ? m << LOGA : 1 << LOGA;
  const int T = H / kPer;
  const int C = cols_per_block(T);
  extern __shared__ float2 sm[];
  float2* stw = sm + C * stockham::padded(H);
  stockham::load_twiddles(stw, tw, ntw);

  const int c = threadIdx.x % C;
  const int t = threadIdx.x / C;
  const int f = blockIdx.z;
  const int o = f * K + blockIdx.x;
  const int g = g_shared ? blockIdx.x : o;
  const int Wh = W / 2 + 1;
  const int Wq = W / 2;
  const int k = blockIdx.y * C + c;
  // the last block's columns may run past W/2, only when H has an odd
  // factor (a power-of-two H gives a power of two C <= 64, which divides
  // W/2 = 64k): such a column transforms column 0 and stores nothing, so
  // no load is conditional
  const bool live = !ODD || k < Wq;
  const int kl = live ? k : 0;
  const float2* Fp = F + f * static_cast<size_t>(H) * Wh;
  const float2* Gp = G + g * static_cast<size_t>(H) * Wh;

  float2 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = (t + i * T) * Wh + kl;  // a plane has < 2^31 entries
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
        const int n = t + i * T;
        const int mm = stockham::pad(n) * C;
        const int r = stockham::pad(n == 0 ? 0 : H - n) * C;
        const float2 a = x0[mm], b = x0[r], cn = xn[mm], d = xn[r];
        const float2 p = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
        const float2 q = make_float2(0.5f * (cn.x + d.x), 0.5f * (cn.y - d.y));
        v[i] = make_float2(p.x - q.y, p.y + q.x);
      }
    }
    __syncthreads();
  }
  stockham::run<LOGA, ODD, 0>(v, sm + c, stw, t, m, C);

  if (live) {
    float2* Mp = mid + static_cast<size_t>(o) * H * Wq;
#pragma unroll
    for (int i = 0; i < kPer; ++i) Mp[(t + i * T) * Wq + k] = v[i];
  }
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

// the best (v, i) over each run of `width` lanes (a power of two <= 32), in
// its first lane
__device__ __forceinline__ void seg_best(float& v, int& i, int width) {
  for (int off = width / 2; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off, width);
    const int oi = __shfl_down_sync(0xffffffffu, i, off, width);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int LOGA, bool ODD, bool NCC>
__global__ void __launch_bounds__(rows_bound(LOGA, ODD))
corr_rows_c2r(const float2* __restrict__ mid, float* __restrict__ out,
              const float2* __restrict__ tw, int ntw, int m, int H, float scale,
              const float* __restrict__ var, const float* __restrict__ energy,
              int K, int e_shared, float thr, int vh, int vw,
              float* __restrict__ rowmax, int* __restrict__ rowarg) {
  const int W = ODD ? m << LOGA : 1 << LOGA;
  const int T = W / kPer;
  const int P = pairs_per_block(T);
  const int Wq = W / 2;
  extern __shared__ float2 sm[];
  float2* stw = sm + P * stockham::padded(W);
  stockham::load_twiddles(stw, tw, ntw);

  const int t = threadIdx.x % T;
  const int p = threadIdx.x / T;
  const int o = blockIdx.z * K + blockIdx.x;
  const int ra = 2 * (blockIdx.y * P + p);
  // the last block's pairs may run past H, only when W has an odd factor (a
  // power-of-two W gives a power of two P <= 32, which divides H/2 = 64k):
  // such a pair transforms rows 0 and 1 and stores nothing, so no load is
  // conditional
  const bool live = !ODD || ra < H;
  const float2* ma = mid + (static_cast<size_t>(o) * H + (live ? ra : 0)) * Wq;
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
  stockham::run<LOGA, ODD, 0>(v, sm + p * stockham::padded(W), stw, t, m, 1);

  // thread t holds outputs n = t + i*T of rows ra (x) and ra + 1 (y)
  float* oa = out + (static_cast<size_t>(o) * H + (live ? ra : 0)) * W;
  float* ob = oa + W;
  if constexpr (!NCC) {
    if (live) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        oa[t + i * T] = v[i].x * scale;
        ob[t + i * T] = v[i].y * scale;
      }
    }
  } else {
    const int f = blockIdx.z;
    const float en = energy[e_shared ? blockIdx.x : o];
    const float* va = var + (static_cast<size_t>(f) * H + (live ? ra : 0)) * W;
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
      if (live) {
        oa[n] = a;
        ob[n] = b;
      }
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
    const size_t r = static_cast<size_t>(o) * H + ra;
    if (T <= 32 && (T & (T - 1)) == 0) {  // a row pair inside one warp
      seg_best(bva, bia, T);
      seg_best(bvb, bib, T);
      if (t == 0 && live) {
        rowmax[r] = bva;
        rowarg[r] = bia;
        rowmax[r + 1] = bvb;
        rowarg[r + 1] = bib;
      }
    } else if (T % 32 == 0) {  // T/32 warps per row pair: through shared memory
      constexpr int kWarps = kRowMaxThreads / 32;
      const int per_pair = T / 32;
      __shared__ float sva[kWarps], svb[kWarps];
      __shared__ int sia[kWarps], sib[kWarps];
      seg_best(bva, bia, 32);
      seg_best(bvb, bib, 32);
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) {
        sva[warp] = bva;
        sia[warp] = bia;
        svb[warp] = bvb;
        sib[warp] = bib;
      }
      __syncthreads();
      if (t < 32) {  // the first warp of each row pair
        const int w = p * per_pair + t;
        bva = t < per_pair ? sva[w] : 0.f;
        bia = t < per_pair ? sia[w] : -1;
        bvb = t < per_pair ? svb[w] : 0.f;
        bib = t < per_pair ? sib[w] : -1;
        seg_best(bva, bia, 32);
        seg_best(bvb, bib, 32);
        if (t == 0 && live) {
          rowmax[r] = bva;
          rowarg[r] = bia;
          rowmax[r + 1] = bvb;
          rowarg[r + 1] = bib;
        }
      }
    } else {  // a row pair straddles warps: the pair's first thread scans
      // the candidates, staged in the exchange buffer (free once every
      // thread is past the barrier)
      __syncthreads();
      const int nt = blockDim.x;
      float* sva = reinterpret_cast<float*>(sm);
      float* svb = sva + nt;
      int* sia = reinterpret_cast<int*>(svb + nt);
      int* sib = sia + nt;
      sva[threadIdx.x] = bva;
      sia[threadIdx.x] = bia;
      svb[threadIdx.x] = bvb;
      sib[threadIdx.x] = bib;
      __syncthreads();
      if (t == 0 && live) {
        const int base = p * T;
        for (int u = 1; u < T; ++u) {
          if (better(sva[base + u], sia[base + u], bva, bia)) {
            bva = sva[base + u];
            bia = sia[base + u];
          }
          if (better(svb[base + u], sib[base + u], bvb, bib)) {
            bvb = svb[base + u];
            bib = sib[base + u];
          }
        }
        rowmax[r] = bva;
        rowarg[r] = bia;
        rowmax[r + 1] = bvb;
        rowarg[r + 1] = bib;
      }
    }
  }
}

// n = 2^loga * m with m odd, for n = 128*k, k = 1..64
bool split(int n, int* loga, int* m) {
  if (n < (1 << kMinLog) || n > kMaxSide || n % (1 << kMinLog) != 0) return false;
  *loga = __builtin_ctz(static_cast<unsigned>(n));
  *m = n >> *loga;
  return true;
}

// dynamic shared memory of a launch at side n = m << loga
constexpr int cols_smem(int loga, int m) {
  return ((cols_per_block((m << loga) / kPer) * stockham::padded(m << loga)) +
          stockham::tw_count(loga, m)) * static_cast<int>(sizeof(float2));
}

constexpr int rows_smem(int loga, int m) {
  return ((pairs_per_block((m << loga) / kPer) * stockham::padded(m << loga)) +
          stockham::tw_count(loga, m)) * static_cast<int>(sizeof(float2));
}

// the most an instantiation asks for: m = 1, or every odd m > 1 it takes
constexpr int max_smem(bool cols, int loga, bool odd) {
  int best = 0;
  for (int m = odd ? 3 : 1; (m << loga) <= kMaxSide; m += 2) {
    const int s = cols ? cols_smem(loga, m) : rows_smem(loga, m);
    best = s > best ? s : best;
    if (!odd) break;
  }
  return best;
}

constexpr int kOptInSmem = 232448;  // what a block may opt into on sm_90

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

// cudaFuncSetAttribute once per (device, kernel), to the most dynamic shared
// memory the instantiation may launch with
constexpr int kMaxDevices = 64;
constexpr int kKinds = 3;  // cols, rows, rows_ncc
std::atomic<bool> g_smem_set[kMaxDevices][kKinds][kMaxLog + 1][2];

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, int kind, int loga, bool odd, int smem) {
  const bool cache = device >= 0 && device < kMaxDevices;
  if (cache && g_smem_set[device][kind][loga][odd].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cache) g_smem_set[device][kind][loga][odd].store(true, std::memory_order_release);
  return err;
}

template <int LOGA, bool ODD>
int launch_cols(int device, const float2* F, const float2* G, float2* mid,
                const float2* tw, int ntw, int m, int W, int NB, int K, int g_shared,
                cudaStream_t stream) {
  constexpr int kMax = max_smem(true, LOGA, ODD);
  static_assert(kMax <= kOptInSmem, "pass 1 shared memory");
  cudaError_t err = allow_smem(corr_cols_inverse<LOGA, ODD>, device, 0, LOGA, ODD, kMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int T = (m << LOGA) / kPer;
  const int C = cols_per_block(T);
  const dim3 grid(K, (W / 2 + C - 1) / C, NB / K);
  corr_cols_inverse<LOGA, ODD><<<grid, C * T, cols_smem(LOGA, m), stream>>>(
      F, G, mid, tw, ntw, m, W, K, g_shared);
  return static_cast<int>(cudaGetLastError());
}

template <int LOGA, bool ODD, bool NCC>
int launch_rows(int device, const float2* mid, float* out, const float2* tw, int ntw,
                int m, int H, int NB, float scale, const float* var,
                const float* energy, int K, int e_shared, float thr, int vh,
                int vw, float* rowmax, int* rowarg, cudaStream_t stream) {
  constexpr int kMax = max_smem(false, LOGA, ODD);
  static_assert(kMax <= kOptInSmem - 256, "pass 2 shared memory");
  cudaError_t err = allow_smem(corr_rows_c2r<LOGA, ODD, NCC>, device, NCC ? 2 : 1, LOGA, ODD, kMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int T = (m << LOGA) / kPer;
  const int P = pairs_per_block(T);
  const dim3 grid(K, (H / 2 + P - 1) / P, NB / K);
  corr_rows_c2r<LOGA, ODD, NCC><<<grid, P * T, rows_smem(LOGA, m), stream>>>(
      mid, out, tw, ntw, m, H, scale, var, energy, K, e_shared, thr, vh, vw, rowmax, rowarg);
  return static_cast<int>(cudaGetLastError());
}

template <bool NCC>
int rows_dispatch(int device, const void* mid, void* out, const void* tw,
                  int ntw, int H, int W, int NB, float scale, const void* var,
                  const void* energy, int K, int e_shared, float thr, int vh,
                  int vw, void* rowmax, int* rowarg, void* stream) {
  int la, ma, loga, m;
  if (!split(H, &la, &ma) || !split(W, &loga, &m) || ntw != stockham::tw_count(loga, m))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* mp = static_cast<const float2*>(mid);
  auto* o = static_cast<float*>(out);
  const auto* w = static_cast<const float2*>(tw);
  const auto* vr = static_cast<const float*>(var);
  const auto* en = static_cast<const float*>(energy);
  auto* rm = static_cast<float*>(rowmax);
  auto s = static_cast<cudaStream_t>(stream);
#define K1_ROWS(L, ODD)                                                                  \
  return launch_rows<L, ODD, NCC>(device, mp, o, w, ntw, m, H, NB, scale, vr, en, K,     \
                                  e_shared, thr, vh, vw, rm, rowarg, s);
  switch (loga) {
    case 7: if (m > 1) { K1_ROWS(7, true) } K1_ROWS(7, false)
    case 8: if (m > 1) { K1_ROWS(8, true) } K1_ROWS(8, false)
    case 9: if (m > 1) { K1_ROWS(9, true) } K1_ROWS(9, false)
    case 10: if (m > 1) { K1_ROWS(10, true) } K1_ROWS(10, false)
    case 11: if (m > 1) { K1_ROWS(11, true) } K1_ROWS(11, false)
    case 12: K1_ROWS(12, false)
    case 13: K1_ROWS(13, false)
  }
#undef K1_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* fftp_corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// F (NF, H, W/2+1) complex64, G (K, H, W/2+1) when g_shared else
// (NB, H, W/2+1), mid (NB, H, W/2) complex64, tw the twiddle table of
// length H (ntw complex64 entries). NB = NF * K.
int fftp_corr_cols(int device, const void* F, const void* G, void* mid,
                   const void* tw, int ntw, int H, int W, int NB, int K,
                   int g_shared, void* stream) {
  int loga, m, lw, mw;
  if (!split(H, &loga, &m) || !split(W, &lw, &mw) || ntw != stockham::tw_count(loga, m))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* f = static_cast<const float2*>(F);
  const auto* g = static_cast<const float2*>(G);
  auto* mp = static_cast<float2*>(mid);
  const auto* w = static_cast<const float2*>(tw);
  auto s = static_cast<cudaStream_t>(stream);
#define K1_COLS(L, ODD) return launch_cols<L, ODD>(device, f, g, mp, w, ntw, m, W, NB, K, g_shared, s);
  switch (loga) {
    case 7: if (m > 1) { K1_COLS(7, true) } K1_COLS(7, false)
    case 8: if (m > 1) { K1_COLS(8, true) } K1_COLS(8, false)
    case 9: if (m > 1) { K1_COLS(9, true) } K1_COLS(9, false)
    case 10: if (m > 1) { K1_COLS(10, true) } K1_COLS(10, false)
    case 11: if (m > 1) { K1_COLS(11, true) } K1_COLS(11, false)
    case 12: K1_COLS(12, false)
    case 13: K1_COLS(13, false)
  }
#undef K1_COLS
  return static_cast<int>(cudaErrorInvalidValue);
}

// mid (NB, H, W/2) complex64 -> out (NB, H, W) float32; tw the twiddle
// table of length W (ntw complex64 entries).
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
