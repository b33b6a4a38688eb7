// SPDX-License-Identifier: CECILL-2.1
//
// K1: real circular correlation planes from rfft2 spectra, with an optional
// fused NCC epilogue and per-row peak reduction.
//
// Replaces the TPU kernel family in barc4dip_tpu/ops/pallas_fftp.py
// (_stage1_kernel, _stage2_kernel, _stage2_ncc_kernel, built by _build and
// _build_ncc). The contract is kept, the TPU's permuted-order four-step DFT
// is not: the forward spectra are natural-order rfft2 half spectra
// (torch.fft.rfft2), and the inverse transform is this file's own work.
//
//   out[o] = irfft2(F[o / K] * conj(G[g(o)]), s=(H, W))      (numpy irfft)
//   g(o)   = o % K when the bank is shared by every image, else o
//
// Pass 1, corr_cols_inverse: one block per (plane o, 4 adjacent columns
//   k < W/2+1). Forms F*conj(G) while loading (bit-reversed into shared
//   memory), runs an in-place radix-2 inverse FFT of length H down each
//   column, writes the complex mid plane (NB, H, W/2+1).
// Pass 2, corr_rows_c2r: one block per (plane o, row pair). Rebuilds the
//   two Hermitian rows of length W (imaginary parts of the DC and Nyquist
//   bins dropped, as numpy's irfft does), packs them as Za + i*Zb into one
//   complex inverse FFT (both outputs are real), scales by 1/(H*W).
// Pass 2', corr_rows_c2r_ncc: pass 2, then the NCC epilogue of
//   _stage2_ncc_kernel: divide by sqrt(var[f] * energy[g]) (0 where that is
//   <= eps), -inf where row >= vh or column >= vw, and for each row the
//   (max, first column of the max) with NaN ranked highest. The caller takes
//   the first row holding the plane's maximum: exactly the row-major
//   first-occurrence argmax. Peak columns are int32 (the TPU kernel stores
//   flat indices in f32, exact only below 2^24 pixels).
//
// Covered: float32 (complex64 spectra), H and W powers of two in [128, 4096].
//
// What bounds it on Hopper: the planes. At 2048^2 one plane is 16 MB of
// float32 output and 8.4 MB of complex mid plane, so the passes stream
// device memory (3.35 TB/s) while the butterflies are a few flops per byte.
// The design keeps traffic at one read of the spectra, one write and one
// read of the mid plane and one write of the output; the NCC epilogue and
// the peak reduction ride pass 2 so the map is never re-read for its
// argmax. Pass 1 loads 4 columns per block so each row read is a full
// 32-byte sector. Twiddles are built on the host in float64 and rounded
// once to float32. Making it fast (mixed radix, register-resident
// sub-FFTs, fewer shared-memory bank conflicts) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // pass-1 columns per block

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ int bitrev(int i, int logn) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - logn));
}

// In-place radix-2 decimation-in-time FFT of NCOLS interleaved columns
// (element r of column c at x[r * NCOLS + c]) whose inputs were stored in
// bit-reversed order. tw[m] = exp(+2*pi*i*m/n), m < n/2 (inverse sign).
template <int NCOLS>
__device__ void fft_inplace(float2* x, int n, int logn,
                            const float2* __restrict__ tw) {
  const int nb = (n >> 1) * NCOLS;
  for (int s = 1; s <= logn; ++s) {
    const int half = 1 << (s - 1);
    const int tstride = n >> s;
    for (int q = threadIdx.x; q < nb; q += blockDim.x) {
      const int c = q % NCOLS;
      const int b = q / NCOLS;
      const int j = b & (half - 1);
      const int i0 = ((b >> (s - 1)) << s) + j;
      const int i1 = i0 + half;
      const float2 w = __ldg(tw + j * tstride);
      const float2 u = x[i0 * NCOLS + c];
      const float2 v = cmul(w, x[i1 * NCOLS + c]);
      x[i0 * NCOLS + c] = make_float2(u.x + v.x, u.y + v.y);
      x[i1 * NCOLS + c] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
corr_cols_inverse(const float2* __restrict__ F, const float2* __restrict__ G,
                  float2* __restrict__ mid, const float2* __restrict__ tw,
                  int H, int logH, int Wh, int K, int g_shared) {
  extern __shared__ float2 sm[];
  const int o = blockIdx.y;
  const int f = o / K;
  const int g = g_shared ? o % K : o;
  const int k0 = blockIdx.x * kCols;
  const size_t plane = static_cast<size_t>(H) * Wh;
  const float2* Fp = F + f * plane;
  const float2* Gp = G + g * plane;
  const int n = H * kCols;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / kCols;
    const int c = e % kCols;
    const int k = k0 + c;
    float2 v = make_float2(0.f, 0.f);
    if (k < Wh) {
      const size_t i = static_cast<size_t>(r) * Wh + k;
      v = cmul_conj(Fp[i], Gp[i]);
    }
    sm[bitrev(r, logH) * kCols + c] = v;
  }
  __syncthreads();
  fft_inplace<kCols>(sm, H, logH, tw);
  float2* Mp = mid + o * plane;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / kCols;
    const int c = e % kCols;
    const int k = k0 + c;
    if (k < Wh) Mp[static_cast<size_t>(r) * Wh + k] = sm[r * kCols + c];
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

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <bool NCC>
__global__ void __launch_bounds__(kThreads)
corr_rows_c2r(const float2* __restrict__ mid, float* __restrict__ out,
              const float2* __restrict__ tw, int H, int W, int logW, float scale,
              const float* __restrict__ var, const float* __restrict__ energy,
              int K, int e_shared, float eps, int vh, int vw,
              float* __restrict__ rowmax, int* __restrict__ rowarg) {
  extern __shared__ float2 sm[];
  const int o = blockIdx.y;
  const int ra = 2 * blockIdx.x;
  const int Wh = W / 2 + 1;
  const int half = W >> 1;
  const float2* ma = mid + (static_cast<size_t>(o) * H + ra) * Wh;
  const float2* mb = ma + Wh;
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    float2 xa, xb;
    if (k <= half) {
      xa = ma[k];
      xb = mb[k];
      if (k == 0 || k == half) {
        xa.y = 0.f;
        xb.y = 0.f;
      }
    } else {
      xa = ma[W - k];
      xb = mb[W - k];
      xa.y = -xa.y;
      xb.y = -xb.y;
    }
    sm[bitrev(k, logW)] = make_float2(xa.x - xb.y, xa.y + xb.x);
  }
  __syncthreads();
  fft_inplace<1>(sm, W, logW, tw);

  float* oa = out + (static_cast<size_t>(o) * H + ra) * W;
  float* ob = oa + W;
  if (!NCC) {
    for (int n = threadIdx.x; n < W; n += blockDim.x) {
      const float2 z = sm[n];
      oa[n] = z.x * scale;
      ob[n] = z.y * scale;
    }
    return;
  }

  const int f = o / K;
  const float en = energy[e_shared ? o % K : o];
  const float* va = var + (static_cast<size_t>(f) * H + ra) * W;
  const float* vb = va + W;
  float bva = 0.f, bvb = 0.f;
  int bia = -1, bib = -1;
  for (int n = threadIdx.x; n < W; n += blockDim.x) {
    const float2 z = sm[n];
    const float da = sqrtf(va[n] * en);
    const float db = sqrtf(vb[n] * en);
    float a = da > eps ? (z.x * scale) / da : 0.f;
    float b = db > eps ? (z.y * scale) / db : 0.f;
    if (n >= vw || ra >= vh) a = -INFINITY;
    if (n >= vw || ra + 1 >= vh) b = -INFINITY;
    oa[n] = a;
    ob[n] = b;
    if (better(a, n, bva, bia)) {
      bva = a;
      bia = n;
    }
    if (better(b, n, bvb, bib)) {
      bvb = b;
      bib = n;
    }
  }
  __shared__ float sva[kThreads / 32], svb[kThreads / 32];
  __shared__ int sia[kThreads / 32], sib[kThreads / 32];
  warp_best(bva, bia);
  warp_best(bvb, bib);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sva[warp] = bva;
    sia[warp] = bia;
    svb[warp] = bvb;
    sib[warp] = bib;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    bva = lane < nw ? sva[lane] : 0.f;
    bia = lane < nw ? sia[lane] : -1;
    bvb = lane < nw ? svb[lane] : 0.f;
    bib = lane < nw ? sib[lane] : -1;
    warp_best(bva, bia);
    warp_best(bvb, bib);
    if (lane == 0) {
      const size_t r = static_cast<size_t>(o) * H + ra;
      rowmax[r] = bva;
      rowarg[r] = bia;
      rowmax[r + 1] = bvb;
      rowarg[r + 1] = bib;
    }
  }
}

int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

extern "C" {

const char* fftp_corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// F (NF, H, Wh) complex64, G (K, H, Wh) when g_shared else (NB, H, Wh),
// mid (NB, H, Wh) complex64, tw (H/2) complex64. NB = NF * K.
int fftp_corr_cols(int device, const void* F, const void* G, void* mid,
                   const void* tw, int H, int Wh, int NB, int K, int g_shared,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = H * kCols * static_cast<int>(sizeof(float2));
  err = cudaFuncSetAttribute(
      corr_cols_inverse, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Wh + kCols - 1) / kCols, NB);
  corr_cols_inverse<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(F), static_cast<const float2*>(G),
      static_cast<float2*>(mid), static_cast<const float2*>(tw), H, ilog2(H),
      Wh, K, g_shared);
  return static_cast<int>(cudaGetLastError());
}

// mid (NB, H, Wh) complex64 -> out (NB, H, W) float32; tw (W/2) complex64.
int fftp_corr_rows(int device, const void* mid, void* out, const void* tw,
                   int H, int W, int NB, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = W * static_cast<int>(sizeof(float2));
  err = cudaFuncSetAttribute(
      corr_rows_c2r<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H / 2, NB);
  corr_rows_c2r<false><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(mid), static_cast<float*>(out),
      static_cast<const float2*>(tw), H, W, ilog2(W), scale, nullptr, nullptr,
      1, 1, 0.f, H, W, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// As fftp_corr_rows plus the NCC epilogue: var (NF, H, W) float32, energy
// (K) when e_shared else (NB) float32, rowmax (NB, H) float32, rowarg
// (NB, H) int32.
int fftp_corr_rows_ncc(int device, const void* mid, void* out,
                       const void* tw, int H, int W, int NB, float scale,
                       const void* var, const void* energy, int K,
                       int e_shared, float eps, int vh, int vw, void* rowmax,
                       void* rowarg, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = W * static_cast<int>(sizeof(float2));
  err = cudaFuncSetAttribute(
      corr_rows_c2r<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H / 2, NB);
  corr_rows_c2r<true><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(mid), static_cast<float*>(out),
      static_cast<const float2*>(tw), H, W, ilog2(W), scale,
      static_cast<const float*>(var), static_cast<const float*>(energy), K,
      e_shared, eps, vh, vw, static_cast<float*>(rowmax),
      static_cast<int*>(rowarg));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
