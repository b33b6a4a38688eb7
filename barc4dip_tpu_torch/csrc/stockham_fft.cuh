// SPDX-License-Identifier: CECILL-2.1
//
// A register-resident Stockham FFT core for one block of threads: the
// unnormalised inverse DFT y[n] = sum_m x[m] exp(+2*pi*i*m*n/N) of length
// N = 2^LOGN (128..4096), natural order in and out.
//
// Each transform is held by T = N/16 threads, 16 complex values each: thread
// t holds v[i] = x[t + i*T]. The plan is radix 16 for every stage but the
// last, whose radix is 2^(LOGN mod 4) when that is not 1 (2048 = 16*16*8,
// 4096 = 16*16*16, 128 = 16*8). At stage s (Ns = 16^s, radix R, M = 16/R
// butterflies per thread) butterfly m of thread t is j = t + m*T; it takes
// v[m + q*M] (q < R, that is x[j + q*N/R]), multiplies by the stage twiddles
// exp(+2*pi*i*q*(j mod Ns)/(Ns*R)), runs the R-point DFT in registers
// (radix-2 steps on register names, constant internal twiddles), and writes
// output q to y[(j / Ns)*Ns*R + (j mod Ns) + q*Ns]. Between stages the values
// go through shared memory, padded by one slot in 16 so that neither the
// stride-16 writes of stage 0 nor the unit-stride reads conflict on banks;
// the last stage's outputs stay in registers, v[i] = y[t + i*T], so a caller
// reads its input and writes its output in natural order with no bit
// reversal. ceil(LOGN/4) stages, so 3 at 2048, with 2 exchanges through
// shared memory.
//
// The stage twiddles come from a table built on the host in float64 and
// rounded once to float32 (barc4dip_tpu_torch/ops/cuda_fftp.stage_twiddles);
// the caller copies it into shared memory once per block. For stage s >= 1
// entry (q - 1)*Ns + k of its part holds exp(+2*pi*i*q*k/(Ns*R)), q = 1..R-1,
// k < Ns, the parts in stage order; consecutive threads read consecutive k.

#pragma once

#include <cuda_runtime.h>

namespace stockham {

constexpr int kPer = 16;  // complex values per thread

__host__ __device__ constexpr int stages(int logn) { return (logn + 3) / 4; }

__host__ __device__ constexpr int radix(int logn, int s) {
  return 4 * (s + 1) <= logn ? 16 : 1 << (logn - 4 * s);
}

// first entry of stage s's twiddles in the table (s >= 1)
__host__ __device__ constexpr int tw_offset(int logn, int s) {
  int off = 0;
  for (int u = 1; u < s; ++u) off += (radix(logn, u) - 1) << (4 * u);
  return off;
}

__host__ __device__ constexpr int tw_count(int logn) {
  return tw_offset(logn, stages(logn));
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

// Stages S.. of the transform whose inputs thread t holds in v (v[i] =
// x[t + i*T] of stage S's input). Slot a of the transform's exchange buffer
// is x[pad(a) * CS]: CS = 1 for a buffer of its own, CS = C for C transforms
// interleaved slot by slot. tw is the stage twiddle table in shared memory.
// Every thread of the block calls this together (it holds barriers).
template <int LOGN, int S, int CS>
__device__ __forceinline__ void run(float2 (&v)[kPer], float2* x, const float2* tw, int t) {
  constexpr int N = 1 << LOGN;
  constexpr int T = N / kPer;
  constexpr int NS = 1 << (4 * S);
  constexpr int R = radix(LOGN, S);
  constexpr int M = kPer / R;
  if constexpr (S > 0) {
    constexpr int off = tw_offset(LOGN, S);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int k = (t + m * T) & (NS - 1);
#pragma unroll
      for (int q = 1; q < R; ++q) v[m + q * M] = cmul(v[m + q * M], tw[off + (q - 1) * NS + k]);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) dft<R, M>(v + m);
  if constexpr (NS * R < N) {
    if constexpr (S > 0) __syncthreads();  // the previous exchange is read
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = t + m * T;
      const int base = (j / NS) * NS * R + (j & (NS - 1));
#pragma unroll
      for (int q = 0; q < R; ++q) x[pad(base + q * NS) * CS] = v[m + q * M];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = x[pad(t + i * T) * CS];
    run<LOGN, S + 1, CS>(v, x, tw, t);
  }
}

// Copy the stage twiddle table into shared memory (the first exchange's
// barrier orders it before its first use).
template <int LOGN>
__device__ __forceinline__ void load_twiddles(float2* dst, const float2* __restrict__ src) {
  for (int e = threadIdx.x; e < tw_count(LOGN); e += blockDim.x) dst[e] = src[e];
}

}  // namespace stockham
