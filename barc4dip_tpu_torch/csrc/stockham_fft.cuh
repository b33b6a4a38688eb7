// SPDX-License-Identifier: CECILL-2.1
//
// A register-resident Stockham FFT core for one block of threads: the
// unnormalised inverse DFT y[n] = sum_m x[m] exp(+2*pi*i*m*n/N) of length
// N = 2^LOGA * m, natural order in and out, for LOGA in [4, 13] and m odd,
// both template arguments (M = m), except on the direct route below, where
// m is a runtime argument (M = 0). K1 takes every side 128*k, k <= 64, so m,
// the odd part of k, is at most 63. Pass 1 up to 2048 rows and pass 2 run a
// whole side here (LOGA >= 7); pass 1 above 2048 rows runs 8 transforms of
// length 16*k, one a block of a thread-block cluster (LOGA 4..9,
// csrc/fftp_corr.cu).
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
//
// The odd factor m > 1 takes one of two routes, fixed by m (no fallback):
//
// - The register route, every 7-smooth m (3, 5, 7, 9, 15, 21, 25, 27, 35,
//   45, 49, 63: the odd parts of every side a detector has). m is factored
//   into radices 7, then 5, then 3 (63 = 7*3*3), one Stockham stage each,
//   run between the last two power-of-two stages (3072 = 16*16*3*4, 8064 =
//   16*7*3*3*8; with one power-of-two stage, LOGA = 4, they run first). A
//   butterfly reads its R inputs from the exchange buffer, applies the stage
//   twiddles, runs the R-point DFT in registers (constant cos/sin of 2*pi/R,
//   the symmetric form: (R-1)/2 sums and differences) and writes its R
//   outputs back to the slots it read. 16 values a thread is not a multiple
//   of R, so a stage's N/R butterflies go to the T threads in turn (j = t +
//   u*T, u < ceil(16/R), the last turn for the first threads only); writing
//   in place leaves each slot to one thread in a stage, so a stage needs one
//   barrier, after it, and holds R values at a time. The price of writing
//   in place is the order: a value's slot is a digit permutation of its
//   logical index (rev_digits reverses the odd digits, radix by radix), and
//   the last power-of-two stage reads its inputs through that permutation,
//   then leaves its outputs in registers in natural order: the odd stages
//   add no exchange, only one in-place pass each. An odd stage's twiddles
//   come from a part of the table of its own, as a power-of-two stage's do
//   (NP * (m - 1) entries for all of them, NP = 16^(stages - 1) the values
//   combined before them); the last stage's (Ns = N/PL, not a power of
//   two: a part would hold ~N) are exp(+2*pi*i*q*j/N), each w^(2^b) the
//   product of two short tables, hi[e >> 4] * lo[e mod 16] (N/16 and 16
//   entries; lo's 16 take a bank pair each, so no read of it conflicts),
//   the other powers products of those in registers. At N = 8064 the odd
//   twiddles take 1,512 entries where the direct route's table held 8,064.
// - The direct route, m with a prime factor of 11 or more (11, 13, 17, ...,
//   33, 39, 51, 55, 57: sides 1408, 1664, 2176, ... that no sensor has). One
//   last stage of radix m with Ns = 2^LOGA: output p of butterfly j < Ns is
//   y[j + p*Ns] = sum_q x[j + q*Ns] exp(+2*pi*i*q*(j + p*Ns)/N), so each
//   thread forms its own 16 outputs as direct m-term sums out of shared
//   memory (2m - 1 loads an output), with the table of the N factors
//   exp(+2*pi*i*r/N).
//
// Why the register route: the direct sums, one code path for every m with m
// and T known only at run time, measured half the power-of-two rate at 3 and
// 5 (1.0 against 2.0 TB/s in pass 1 on an H100) and 0.29 TB/s at m = 63,
// where an output costs 125 loads: K1 at 8064^2 read 4.28 ms against
// cuFFT's 1.28. Its kernels took 74-109 registers and spilled, and every
// block copied the N-entry table (PERF.md has both designs' numbers).
//
// The last stage's outputs stay in registers, v[i] = y[t + i*T], so a caller
// reads its input and writes its output in natural order with no bit
// reversal.
//
// The twiddles come from a table built on the host in float64 and rounded
// once to float32 (barc4dip_tpu_torch/ops/cuda_fftp.stage_twiddles); the
// caller copies it into shared memory once per block. For power-of-two stage
// s >= 1 entry (q - 1)*Ns + k of its part holds exp(+2*pi*i*q*k/(Ns*R)),
// q = 1..R-1, k < Ns, the parts in stage order; consecutive threads read
// consecutive k. When m > 1 there follow, on the direct route, the N
// entries exp(+2*pi*i*r/N), r < N; on the register route the last
// power-of-two stage has no part, each odd stage has one (laid out alike)
// after the others, and hi (N/16 entries exp(+2*pi*i*h*16/N)) then lo (16
// entries exp(+2*pi*i*l/N)) follow.

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

// the largest register radix dividing m (7, then 5, then 3), else 1
__host__ __device__ constexpr int odd_radix_of(int m) {
  return m % 7 == 0 ? 7 : m % 5 == 0 ? 5 : m % 3 == 0 ? 3 : 1;
}

// register radices of odd m (m 7-smooth: they multiply to m)
__host__ __device__ constexpr int odd_count(int m) {
  int n = 0;
  for (; odd_radix_of(m) > 1; ++n) m /= odd_radix_of(m);
  return n;
}

// m has no prime factor above 7: the register route for m > 1 (m = 1 too)
__host__ __device__ constexpr bool register_route(int m) {
  while (odd_radix_of(m) > 1) m /= odd_radix_of(m);
  return m == 1;
}

// radix of odd stage i, and the product of the radices before it
__host__ __device__ constexpr int odd_radix(int m, int i) {
  for (int s = 0; s < i; ++s) m /= odd_radix_of(m);
  return odd_radix_of(m);
}

__host__ __device__ constexpr int odd_prefix(int m, int i) {
  int p = 1;
  for (int s = 0; s < i; ++s) {
    p *= odd_radix_of(m);
    m /= odd_radix_of(m);
  }
  return p;
}

// log2 of the lo table's length on the register route: 16 entries, each in
// a bank pair of its own, so no read of it conflicts whatever its stride
constexpr int kLoBits = 4;

// the register route's last power-of-two stage (radix PL), and NP = 16^SL,
// the values combined before it and before the odd stages
__host__ __device__ constexpr int last_stage(int loga) { return stages(loga) - 1; }
__host__ __device__ constexpr int np_of(int loga) { return 1 << (4 * last_stage(loga)); }

// table length of an instantiation (M as run() takes it) at N = 2^loga * m:
// the power-of-two stages, then N entries (direct route, M = 0); on the
// register route (M > 1) the power-of-two stages but the last, the odd
// stages' parts (NP * (M - 1) entries in all), then hi and lo
__host__ __device__ constexpr int route_tw_count(int loga, int M, int m) {
  return M == 1   ? tw_offset(loga, stages(loga))
         : M == 0 ? tw_offset(loga, stages(loga)) + (m << loga)
                  : tw_offset(loga, last_stage(loga)) + np_of(loga) * (M - 1) + (M << loga >> kLoBits) +
                        (1 << kLoBits);
}

// M of the static route for odd factor m: 1, m (register route) or 0 (direct)
__host__ __device__ constexpr int route_of(int m) { return register_route(m) ? m : 0; }

// table length for N = 2^loga * m on its route
__host__ __device__ constexpr int tw_count(int loga, int m) { return route_tw_count(loga, route_of(m), m); }

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

// cos and sin of 2*pi*j/R, R = 3, 5, 7, j mod R (float32, from float64)
__host__ __device__ constexpr float cos_r(int r, int j) {
  const int k = j % r <= r / 2 ? j % r : r - j % r;
  return k == 0   ? 1.0f
         : r == 3 ? -0.5f
         : r == 5 ? (k == 1 ? 0.309016994374947424f : -0.809016994374947424f)
                  : (k == 1 ? 0.623489801858733531f : k == 2 ? -0.222520933956314404f : -0.900968867902419126f);
}

__host__ __device__ constexpr float sin_r(int r, int j) {
  const int k = j % r <= r / 2 ? j % r : r - j % r;
  const float s = k == 0   ? 0.0f
                  : r == 3 ? 0.866025403784438647f
                  : r == 5 ? (k == 1 ? 0.951056516295153572f : 0.587785252292473129f)
                           : (k == 1 ? 0.781831482468029809f : k == 2 ? 0.974927912181823607f : 0.433883739117558120f);
  return j % r <= r / 2 ? s : -s;
}

// R-point inverse DFT in registers, in place, R = 3, 5, 7: with s_k =
// a[k] + a[R-k], d_k = a[k] - a[R-k] (k = 1..R/2), output p and R - p are
// a[0] + sum_k cos(2*pi*k*p/R) s_k +- i * sum_k sin(2*pi*k*p/R) d_k.
template <int R>
__device__ __forceinline__ void dft_odd(float2 (&a)[R]) {
  constexpr int h = R / 2;
  float2 s[h], d[h];
  float2 y0 = a[0];
#pragma unroll
  for (int k = 1; k <= h; ++k) {
    s[k - 1] = make_float2(a[k].x + a[R - k].x, a[k].y + a[R - k].y);
    d[k - 1] = make_float2(a[k].x - a[R - k].x, a[k].y - a[R - k].y);
    y0.x += s[k - 1].x;
    y0.y += s[k - 1].y;
  }
#pragma unroll
  for (int p = 1; p <= h; ++p) {
    float2 re = a[0], im = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 1; k <= h; ++k) {
      const float c = cos_r(R, k * p), sn = sin_r(R, k * p);
      re.x += c * s[k - 1].x;
      re.y += c * s[k - 1].y;
      im.x += sn * d[k - 1].x;
      im.y += sn * d[k - 1].y;
    }
    a[p] = make_float2(re.x - im.y, re.y + im.x);
    a[R - p] = make_float2(re.x + im.y, re.y - im.x);
  }
  a[0] = y0;
}

// The block offset of odd digits L..S-1 of kd, each digit reversed into its
// place: digit l (radix odd_radix(M, l), least significant first) counts
// M / odd_prefix(M, l + 1) blocks of the last power-of-two radix. kd < the
// product of those radices, so the last digit needs no remainder.
template <int M, int L, int S>
__device__ __forceinline__ int rev_digits(int kd) {
  if constexpr (L >= S) {
    return 0;
  } else if constexpr (L + 1 == S) {
    return kd * (M / odd_prefix(M, L + 1));
  } else {
    constexpr int r = odd_radix(M, L);
    return (kd % r) * (M / odd_prefix(M, L + 1)) + rev_digits<M, L + 1, S>(kd / r);
  }
}

// w^q, q < 16, from p[b] = w^(2^b): one product a set bit after the first
template <int Q>
__device__ __forceinline__ float2 wpow(const float2* p) {
  float2 w = make_float2(1.f, 0.f);
  bool first = true;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if ((Q >> b) & 1) {
      w = first ? p[b] : cmul(w, p[b]);
      first = false;
    }
  }
  return w;
}

// a[q * STRIDE] *= w^q for q = Q..R-1
template <int R, int STRIDE, int Q>
__device__ __forceinline__ void twiddle_from(float2* a, const float2* p) {
  if constexpr (Q < R) {
    a[Q * STRIDE] = cmul(a[Q * STRIDE], wpow<Q>(p));
    twiddle_from<R, STRIDE, Q + 1>(a, p);
  }
}

// a[q * STRIDE] *= w^q, q = 1..R-1 (R <= 16), w = exp(+2*pi*i*r/N) and
// (R - 1) * r < N: each w^(2^b) is the table's hi[e >> LB] * lo[e mod 2^LB],
// e = r * 2^b (squaring them instead read up to 4.5x the float32 error of
// the power-of-two tables at radix 16), w^q the product of those of q's bits
template <int R, int STRIDE, int LB>
__device__ __forceinline__ void twiddle(float2* a, const float2* hi, const float2* lo, int r) {
  float2 p[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if ((1 << b) < R) p[b] = cmul(hi[(r << b) >> LB], lo[(r << b) & ((1 << LB) - 1)]);
  twiddle_from<R, STRIDE, 1>(a, p);
}

// The register route runs its odd stages between the last two power-of-two
// stages: NP = 16^SL values combined before them (SL the last power-of-two
// stage, radix PL), N/NP = PL * M blocks. Odd stage I (radix R, Ns = NP *
// the radices before it) works in place in the exchange buffer x (slot a at
// x[pad(a) * cs]): the value of logical index b*Ns + k (block b, frequency
// k) sits in slot (b + PL * rev_digits(k / NP)) * NP + (k mod NP); butterfly
// j (b' = j / Ns, k = j mod Ns) takes blocks b' + q*SPAN, q < R, and writes
// its output q, logical (b', k + q*Ns), to the slot its input q came from.
template <int LOGA, int M, int I>
__device__ __forceinline__ void odd_stage(float2* x, const float2* tw, int t, int cs) {
  constexpr int N = M << LOGA;
  constexpr int T = N / kPer;
  constexpr int NP = np_of(LOGA);
  constexpr int PL = radix(LOGA, last_stage(LOGA));
  constexpr int R = odd_radix(M, I);
  constexpr int NS = NP * odd_prefix(M, I);
  constexpr int SPAN = PL * M / odd_prefix(M, I + 1);  // blocks after this stage
  constexpr int NB = N / R;                            // butterflies
#pragma unroll
  for (int u = 0; u < (NB + T - 1) / T; ++u) {
    const int j = t + u * T;
    if ((u + 1) * T > NB && j >= NB) break;  // the last turn, first threads only
    const int k = j % NS;
    const int base = (j / NS + PL * rev_digits<M, 0, I>(k / NP)) * NP + (k & (NP - 1));
    float2 a[R];
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = x[pad(base + q * SPAN * NP) * cs];
    // stage twiddle of input q, exp(+2*pi*i*q*k/(Ns*R)): entry (q - 1)*Ns + k
    // of the stage's part (its first entry at NP * (odd_prefix - 1))
    if constexpr (NS > 1) {
      constexpr int off = tw_offset(LOGA, last_stage(LOGA)) + NP * (odd_prefix(M, I) - 1);
#pragma unroll
      for (int q = 1; q < R; ++q) a[q] = cmul(a[q], tw[off + (q - 1) * NS + k]);
    }
    dft_odd<R>(a);
#pragma unroll
    for (int q = 0; q < R; ++q) x[pad(base + q * SPAN * NP) * cs] = a[q];
  }
}

// The register route from odd stage I on: the odd stages, each followed by
// a barrier, then the last power-of-two stage (radix PL, Ns = N/PL): input
// n = t + i*T read into v[i] from its slot, butterfly j = t + u*T
// (v[u + q*16/PL]) twiddled by exp(+2*pi*i*q*j/N), its outputs y[j + q*Ns]
// = y[t + (u + q*16/PL)*T] left in v in natural order.
template <int LOGA, int M, int I>
__device__ __forceinline__ void odd_stages(float2 (&v)[kPer], float2* x, const float2* tw, int t, int cs) {
  constexpr int T = (M << LOGA) / kPer;
  constexpr int S = odd_count(M);
  constexpr int NP = np_of(LOGA);
  constexpr int PL = radix(LOGA, last_stage(LOGA));
  constexpr int MU = kPer / PL;
  odd_stage<LOGA, M, I>(x, tw, t, cs);
  __syncthreads();
  if constexpr (I + 1 < S) {
    odd_stages<LOGA, M, I + 1>(v, x, tw, t, cs);
  } else {
    // hi and lo follow the odd stages' parts
    const float2* hi = tw + tw_offset(LOGA, last_stage(LOGA)) + NP * (M - 1);
    const float2* lo = hi + ((M << LOGA) >> kLoBits);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = t + i * T;
      const int nd = n / NP;
      v[i] = x[pad((nd / M + PL * rev_digits<M, 0, S>(nd % M)) * NP + (n & (NP - 1))) * cs];
    }
#pragma unroll
    for (int u = 0; u < MU; ++u) {
      twiddle<PL, MU, kLoBits>(v + u, hi, lo, t + u * T);
      dft<PL, MU>(v + u);
    }
  }
}

// The direct route's outputs I.. of thread t, v[I] = y[n], n = t + I*T: m
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
// M = m: a power-of-two length (M = 1) has no odd stage, so its code is that
// of a plain 2^LOGA transform; M = 3..63 runs the register route, its odd
// stages between the last two power-of-two stages, every length constant;
// M = 0 the direct route, its odd stage last, m and T at run time. Slot a of
// the transform's exchange buffer is x[pad(a) * cs]: cs = 1 for a buffer of
// its own, cs = C for C transforms interleaved slot by slot. tw is the
// twiddle table in shared memory. Every thread of the block calls this
// together, with the same m (it holds barriers).
template <int LOGA, int M, int S>
__device__ __forceinline__ void run(float2 (&v)[kPer], float2* x, const float2* tw, int t,
                                    int m, int cs) {
  constexpr int NA = 1 << LOGA;
  constexpr int NS = 1 << (4 * S);
  constexpr int R = radix(LOGA, S);
  constexpr int MU = kPer / R;
  constexpr int SL = last_stage(LOGA);
  const int T = ((M == 0 ? m : M) << LOGA) / kPer;
  if constexpr (M > 1 && S == SL) {  // one power-of-two stage (LOGA 4): the odd stages first
#pragma unroll
    for (int i = 0; i < kPer; ++i) x[pad(t + i * T) * cs] = v[i];
    __syncthreads();
    odd_stages<LOGA, M, 0>(v, x, tw, t, cs);
  } else {
    if constexpr (S > 0) {
      constexpr int off = tw_offset(LOGA, S);
#pragma unroll
      for (int u = 0; u < MU; ++u) {
        const int k = (t + u * T) & (NS - 1);
#pragma unroll
        for (int q = 1; q < R; ++q) v[u + q * MU] = cmul(v[u + q * MU], tw[off + (q - 1) * NS + k]);
      }
    }
#pragma unroll
    for (int u = 0; u < MU; ++u) dft<R, MU>(v + u);
    if constexpr (NS * R < NA || M == 0) {  // an exchange, then the next stage
      if constexpr (S > 0) __syncthreads();  // the previous exchange is read
#pragma unroll
      for (int u = 0; u < MU; ++u) {
        const int j = t + u * T;
        const int base = (j / NS) * NS * R + (j & (NS - 1));
#pragma unroll
        for (int q = 0; q < R; ++q) x[pad(base + q * NS) * cs] = v[u + q * MU];
      }
      __syncthreads();
      if constexpr (M > 1 && S + 1 == SL) {  // the odd stages, then the last stage
        odd_stages<LOGA, M, 0>(v, x, tw, t, cs);
      } else if constexpr (NS * R < NA) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) v[i] = x[pad(t + i * T) * cs];
        run<LOGA, M, S + 1>(v, x, tw, t, m, cs);
      } else {  // the direct route (Ns = NA): its table follows every stage's
        odd_outputs<LOGA, 0>(v, x, tw + tw_offset(LOGA, stages(LOGA)), t, T, m, cs);
      }
    }
  }
}

// Copy the twiddle table (ntw entries) into shared memory (the first
// exchange's barrier orders it before its first use).
__device__ __forceinline__ void load_twiddles(float2* dst, const float2* __restrict__ src, int ntw) {
  for (int e = threadIdx.x; e < ntw; e += blockDim.x) dst[e] = src[e];
}

}  // namespace stockham
