// SPDX-License-Identifier: CECILL-2.1
//
// A register-resident Stockham FFT core for one block of threads: the
// unnormalised inverse DFT y[n] = sum_m x[m] exp(+2*pi*i*m*n/N) of length
// N = 2^LOGA * m, natural order in and out, for LOGA in [7, 13] (a template
// argument) and m odd (a runtime argument). K1 takes every N = 128*k,
// k <= 64, so m <= 63, and m = 1 above 4096.
//
// Each transform is held by T = N/16 threads, 16 complex values each: thread
// t holds v[i] = x[t + i*T]. The plan factors 2^LOGA first: radix 16 for
// every stage but the last power-of-two stage, whose radix is
// 2^(LOGA mod 4) when that is not 1 (2048 = 16*16*8, 4096 = 16*16*16, 8192 =
// 16*16*16*2, 128 = 16*8). At stage s (Ns = 16^s, radix R, M = 16/R
// butterflies per thread) butterfly m of thread t is j = t + m*T; it takes
// v[m + q*M] (q < R, that is x[j + q*N/R]), multiplies by the stage twiddles
// exp(+2*pi*i*q*(j mod Ns)/(Ns*R)), runs the R-point DFT in registers
// (radix-2 steps on register names, constant internal twiddles), and writes
// output q to y[(j / Ns)*Ns*R + (j mod Ns) + q*Ns]. Between stages the values
// go through shared memory, padded by one slot in 16 so that neither the
// stride-16 writes of stage 0 nor the unit-stride reads conflict on banks.
// These stages depend on N only through T, so one instantiation per LOGA
// serves every m.
//
// When m > 1 a last stage of radix m follows (Ns = 2^LOGA = N/m). Its
// butterfly j < Ns takes x[j + q*Ns], q < m, and its output p is
// y[j + p*Ns] = sum_q x[j + q*Ns] exp(+2*pi*i*q*(j + p*Ns)/N): the stage
// twiddle and the m-point DFT fold into one factor exp(+2*pi*i*r/N),
// r = q*n mod N for output n. So each thread forms its own 16 outputs as
// direct m-term sums out of shared memory (m complex multiply-adds a point)
// and the odd stage needs no second exchange. One code path serves every odd
// m in 3..63; no per-radix butterflies, since the sums cost far less than
// the memory traffic around them (csrc/fftp_corr.cu).
//
// The last stage's outputs stay in registers, v[i] = y[t + i*T], so a caller
// reads its input and writes its output in natural order with no bit
// reversal. ceil(LOGA/4) stages, plus one when m > 1, with one exchange
// through shared memory between each pair of stages.
//
// The twiddles come from a table built on the host in float64 and rounded
// once to float32 (barc4dip_tpu_torch/ops/cuda_fftp.stage_twiddles); the
// caller copies it into shared memory once per block. For power-of-two stage
// s >= 1 entry (q - 1)*Ns + k of its part holds exp(+2*pi*i*q*k/(Ns*R)),
// q = 1..R-1, k < Ns, the parts in stage order; consecutive threads read
// consecutive k. When m > 1, N entries exp(+2*pi*i*r/N), r < N, follow.

#pragma once

#include <cuda_runtime.h>

namespace stockham {

constexpr int kPer = 16;  // complex values per thread

__host__ __device__ constexpr int stages(int loga) { return (loga + 3) / 4; }

__host__ __device__ constexpr int radix(int loga, int s) {
  return 4 * (s + 1) <= loga ? 16 : 1 << (loga - 4 * s);
}

// first entry of power-of-two stage s's twiddles in the table (s >= 1)
__host__ __device__ constexpr int tw_offset(int loga, int s) {
  int off = 0;
  for (int u = 1; u < s; ++u) off += (radix(loga, u) - 1) << (4 * u);
  return off;
}

// table length for N = 2^loga * m: the power-of-two stages, then N entries
// for the odd stage when m > 1
__host__ __device__ constexpr int tw_count(int loga, int m) {
  return tw_offset(loga, stages(loga)) + (m > 1 ? m << loga : 0);
}

// padded shared-memory slots of one transform of length n
__host__ __device__ constexpr int padded(int n) { return n + n / 16; }

__device__ __forceinline__ int pad(int a) { return a + (a >> 4); }

__host__ __device__ constexpr int bitrev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

__host__ __device__ constexpr int ilog2c(int n) { return n <= 1 ? 0 : 1 + ilog2c(n / 2); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// v * exp(+2*pi*i*k/16), k in [0, 8) known once the loops are unrolled
__device__ __forceinline__ float2 rot16(float2 v, int k) {
  constexpr float c1 = 0.923879532511286756f;  // cos(pi/8)
  constexpr float s1 = 0.382683432365089772f;  // sin(pi/8)
  constexpr float r2 = 0.707106781186547524f;  // sqrt(1/2)
  switch (k) {
    case 0: return v;
    case 1: return make_float2(v.x * c1 - v.y * s1, v.x * s1 + v.y * c1);
    case 2: return make_float2((v.x - v.y) * r2, (v.x + v.y) * r2);
    case 3: return make_float2(v.x * s1 - v.y * c1, v.x * c1 + v.y * s1);
    case 4: return make_float2(-v.y, v.x);
    case 5: return make_float2(-v.x * s1 - v.y * c1, v.x * c1 - v.y * s1);
    case 6: return make_float2(-(v.x + v.y) * r2, (v.x - v.y) * r2);
    default: return make_float2(-v.x * c1 - v.y * s1, v.x * s1 - v.y * c1);
  }
}

// One radix-2 level (butterflies HALF apart) of the R-point DFT below, then
// the next. Every loop bound is a template constant, so the loops unroll
// fully and every register index is known: a bound that depends on an
// outer loop's counter left a runtime loop that selected registers by
// predicated moves, at several times the cost.
template <int R, int STRIDE, int HALF>
__device__ __forceinline__ void dit_levels(float2* a) {
#pragma unroll
  for (int i = 0; i < R; i += 2 * HALF) {
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const float2 u = a[(i + k) * STRIDE];
      const float2 w = rot16(a[(i + k + HALF) * STRIDE], k * (8 / HALF));
      a[(i + k) * STRIDE] = make_float2(u.x + w.x, u.y + w.y);
      a[(i + k + HALF) * STRIDE] = make_float2(u.x - w.x, u.y - w.y);
    }
  }
  if constexpr (2 * HALF < R) dit_levels<R, STRIDE, 2 * HALF>(a);
}

// R-point inverse DFT, in place, of a[q * STRIDE], q < R (R = 2, 4, 8, 16):
// radix-2 steps over register names; the bit reversal is a renaming.
template <int R, int STRIDE>
__device__ __forceinline__ void dft(float2* a) {
  constexpr int kBits = ilog2c(R);
  float2 b[R];
#pragma unroll
  for (int i = 0; i < R; ++i) b[i] = a[bitrev(i, kBits) * STRIDE];
#pragma unroll
  for (int i = 0; i < R; ++i) a[i * STRIDE] = b[i];
  dit_levels<R, STRIDE, 1>(a);
}

// The odd stage's outputs I.. of thread t, v[I] = y[n], n = t + I*T: m
// terms each out of the exchange buffer x, with wo[r] = exp(+2*pi*i*r/N).
// Written as a recursion on I so that every register index is a template
// constant whatever the compiler does with the runtime loop over q.
template <int LOGA, int I>
__device__ __forceinline__ void odd_outputs(float2 (&v)[kPer], const float2* x, const float2* wo,
                                            int t, int T, int m, int cs) {
  constexpr int NA = 1 << LOGA;
  const int N = m << LOGA;
  const int n = t + I * T;
  const int j = n & (NA - 1);
  float2 acc = x[pad(j) * cs];
  int r = 0;
  for (int q = 1; q < m; ++q) {
    r += n;
    if (r >= N) r -= N;
    const float2 p = cmul(x[pad(j + q * NA) * cs], wo[r]);
    acc.x += p.x;
    acc.y += p.y;
  }
  v[I] = acc;
  if constexpr (I + 1 < kPer) odd_outputs<LOGA, I + 1>(v, x, wo, t, T, m, cs);
}

// Stages S.. of the length-(m << LOGA) transform whose inputs thread t
// holds in v (v[i] = x[t + i*T] of stage S's input, T = (m << LOGA) / 16).
// ODD = (m > 1): a power-of-two length (ODD false, m = 1) keeps T a
// compile-time constant and has no odd stage, so its code is that of a
// plain 2^LOGA transform. Slot a of the transform's exchange buffer is
// x[pad(a) * cs]: cs = 1 for a buffer of its own, cs = C for C transforms
// interleaved slot by slot. tw is the twiddle table in shared memory. Every
// thread of the block calls this together, with the same m (it holds
// barriers).
template <int LOGA, bool ODD, int S>
__device__ __forceinline__ void run(float2 (&v)[kPer], float2* x, const float2* tw, int t,
                                    int m, int cs) {
  constexpr int NA = 1 << LOGA;
  constexpr int NS = 1 << (4 * S);
  constexpr int R = radix(LOGA, S);
  constexpr int M = kPer / R;
  const int T = ODD ? (m << LOGA) / kPer : NA / kPer;
  if constexpr (S > 0) {
    constexpr int off = tw_offset(LOGA, S);
#pragma unroll
    for (int u = 0; u < M; ++u) {
      const int k = (t + u * T) & (NS - 1);
#pragma unroll
      for (int q = 1; q < R; ++q) v[u + q * M] = cmul(v[u + q * M], tw[off + (q - 1) * NS + k]);
    }
  }
#pragma unroll
  for (int u = 0; u < M; ++u) dft<R, M>(v + u);
  if constexpr (NS * R < NA || ODD) {  // an exchange, then the next stage
    if constexpr (S > 0) __syncthreads();  // the previous exchange is read
#pragma unroll
    for (int u = 0; u < M; ++u) {
      const int j = t + u * T;
      const int base = (j / NS) * NS * R + (j & (NS - 1));
#pragma unroll
      for (int q = 0; q < R; ++q) x[pad(base + q * NS) * cs] = v[u + q * M];
    }
    __syncthreads();
    if constexpr (NS * R < NA) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = x[pad(t + i * T) * cs];
      run<LOGA, ODD, S + 1>(v, x, tw, t, m, cs);
    } else {  // the odd stage, radix m (Ns = NA)
      odd_outputs<LOGA, 0>(v, x, tw + tw_offset(LOGA, stages(LOGA)), t, T, m, cs);
    }
  }
}

// Copy the twiddle table (ntw entries) into shared memory (the first
// exchange's barrier orders it before its first use).
__device__ __forceinline__ void load_twiddles(float2* dst, const float2* __restrict__ src, int ntw) {
  for (int e = threadIdx.x; e < ntw; e += blockDim.x) dst[e] = src[e];
}

}  // namespace stockham
