// SPDX-License-Identifier: CECILL-2.1
//
// K4's block body: the ascending eigenvalues of one symmetric M x M float32
// matrix, computed by one thread block (see symeig_tridiag.cu for the
// design and what bounds it). Kept apart from the launch so that the same
// source also compiles for the CPU against a stub cuda_runtime.h, one OS
// thread a CUDA thread (tests/test_torch_symeig.py); it uses threadIdx.x,
// blockDim.x (a multiple of 32), __syncthreads, __syncthreads_or and
// __shfl_xor_sync, and the _rn intrinsics where the rounding must not
// depend on the compiler's contraction.
//
// The arithmetic is ops/cuda_symeig.symeig_tridiag_plain's, step for step:
//
// 1. A = G's lower triangle mirrored (torch.linalg.eigvalsh reads only the
//    lower triangle). A non-finite entry gives an all-NaN spectrum.
// 2. Householder tridiagonalisation in LAPACK sytd2 order (UPLO = 'L'). At
//    step i the reflector H = I - tau v v^T, v = (1, x[1:] / (alpha - beta)),
//    maps x = A[i+1:, i] onto beta e_1, beta = -sign(alpha) |x|; tau = 0
//    where x[1:] is zero (a zero column, or the last step). Then
//    w = tau A v - (tau/2)(tau (A v) . v) v and A <- A - v w^T - w v^T on
//    the trailing block. d_i = A[i, i], e_i = beta. The norms, tau, beta,
//    the scale of v and the dot product are float64; the O(M^3) work (the
//    update and A v) is float32. The update of an entry is
//    a - (fl(v_r w_c) + fl(w_r v_c)), whose two products swap places at
//    (c, r): the stored matrix stays exactly symmetric, and rows can be
//    read in place of columns.
//    Lazy form: step i applies step i-1's update to row i first, forms the
//    reflector from it, then applies step i-1's update to the trailing
//    block [i+1, M)^2 and takes y = A v in the same pass, so each step
//    reads and writes the trailing block once. Three barriers a step.
// 3. Sturm bisection in float64 (LAPACK stebz/laebz semantics): the count
//    of pivots q_j = (d_j - e_{j-1}^2 * (1 / q_{j-1})) - x that are <= 0,
//    a pivot smaller than pivmin = DBL_MIN * max(1, max e^2) in magnitude
//    replaced by -pivmin (a correctly rounded reciprocal, then a product:
//    a shorter chain on the card than a division, and as monotonic in x);
//    the Gershgorin interval widened by 2.1 (M eps64 |T| + 2 pivmin); one
//    thread per eigenvalue index, all indices in parallel, each with the
//    same number of halvings: until the width is at most
//    max(2^-23 |T|, 2 pivmin), at most 64. The midpoints of one dyadic grid
//    keep the spectrum ascending. No input can make the loops run longer.
#pragma once

#include <cfloat>
#include <cmath>

namespace symeig {

constexpr int kWarp = 32;
constexpr int kMaxCols = 8;    // trailing columns a lane keeps in registers: M <= 256
constexpr int kRedFloats = 256;  // four reductions of up to 32 warps, float64

// Shared memory of one block, in floats: the reductions, then v for two
// steps, w and y (M each), then A (M * M). After the reduction the
// vectors' room holds d and e^2 as float64.
__host__ __device__ inline int smem_floats(int M) { return kRedFloats + 4 * M + M * M; }

// NaN and +-inf fail both (no isfinite: its overloads differ by compiler)
__device__ __forceinline__ bool finite(double x) { return fabs(x) <= DBL_MAX; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // butterfly: every lane ends with the same sum (a + b == b + a)
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_min(double v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the sum of a block's n warp partials, in four independent chains
__device__ __forceinline__ double partials_sum(const double* p, int n) {
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
  for (int k = 0; k < n; k += 4) {
    s0 += p[k];
    if (k + 1 < n) s1 += p[k + 1];
    if (k + 2 < n) s2 += p[k + 2];
    if (k + 3 < n) s3 += p[k + 3];
  }
  return (s0 + s1) + (s2 + s3);
}

// step i-1's w at one index: tau y + alpha2 v in float64, rounded once
__device__ __forceinline__ float w_of(double tau, double alpha2, float y, float v) {
  return static_cast<float>(__dadd_rn(__dmul_rn(tau, y), __dmul_rn(alpha2, v)));
}

// a - (v_r w_c + w_r v_c), symmetric in (r, c) bit for bit
__device__ __forceinline__ float rank2(float a, float vr, float wc, float wr, float vc) {
  return __fsub_rn(a, __fadd_rn(__fmul_rn(vr, wc), __fmul_rn(wr, vc)));
}

// G: one M x M matrix (row-major; its lower triangle is read); out: its M
// ascending eigenvalues; smem: smem_floats(M) floats, 8-byte aligned.
__device__ inline void solve(const float* __restrict__ G, float* __restrict__ out, int M,
                             float* smem) {
  const int tid = static_cast<int>(threadIdx.x), nt = static_cast<int>(blockDim.x);
  const int lane = tid % kWarp, warp = tid / kWarp, nw = nt / kWarp;
  double* red0 = reinterpret_cast<double*>(smem);
  double* red1 = red0 + kWarp;
  double* red2 = red1 + kWarp;
  double* red3 = red2 + kWarp;
  float* vb0 = smem + kRedFloats;
  float* vb1 = vb0 + M;
  float* wv = vb1 + M;
  float* yv = wv + M;
  float* A = yv + M;

  // 1. the lower triangle, mirrored
  int bad = 0;
  for (int k = tid; k < M * M; k += nt) {
    const int r = k / M, c = k - r * M;
    if (r >= c) {
      const float g = G[k];
      bad |= !finite(g);
      A[k] = g;
      A[c * M + r] = g;
    }
  }
  for (int k = tid; k < 4 * M; k += nt) vb0[k] = 0.f;
  if (__syncthreads_or(bad)) {
    for (int j = tid; j < M; j += nt) out[j] = NAN;
    return;
  }

  // 2. tridiagonalisation; d_i stays at A[i, i], e_i goes to A[i, i + 1]
  double tau_prev = 0.0, alpha2 = 0.0;  // step i-1's (none before step 0)
  float* vp = vb1;                      // step i-1's v (zeros before step 0)
  float* v = vb0;
  for (int i = 0; i + 1 < M; ++i) {
    // row i gets step i-1's update; w of step i-1 over [i, M)
    const float wi = w_of(tau_prev, alpha2, yv[i], vp[i]);
    const float vpi = vp[i];
    double sq = 0.0;
    for (int c = i + tid; c < M; c += nt) {
      const float wc = w_of(tau_prev, alpha2, yv[c], vp[c]);
      wv[c] = wc;
      const float a = rank2(A[i * M + c], vpi, wc, wi, vp[c]);
      A[i * M + c] = a;
      if (c >= i + 2) sq += static_cast<double>(a) * a;
    }
    sq = warp_sum(sq);
    if (lane == 0) red1[warp] = sq;
    __syncthreads();

    // the reflector of x = A[i, i+1:], the same numbers in every thread
    const double xn2 = partials_sum(red1, nw);
    const double alpha = A[i * M + i + 1];
    double tau = 0.0, beta = alpha, scale = 0.0;
    if (xn2 > 0.0) {
      beta = -copysign(sqrt(alpha * alpha + xn2), alpha);
      tau = (beta - alpha) / beta;
      scale = 1.0 / (alpha - beta);
    }
    for (int c = i + 1 + tid; c < M; c += nt)
      v[c] = c == i + 1 ? 1.f : static_cast<float>(A[i * M + c] * scale);
    __syncthreads();

    // the trailing block: step i-1's update, then y = A v; a warp a row,
    // a lane's columns i+1+lane+32m held in registers
    float cvp[kMaxCols], cw[kMaxCols], cv[kMaxCols];
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) {
      const int c = i + 1 + lane + kWarp * m;
      cvp[m] = c < M ? vp[c] : 0.f;
      cw[m] = c < M ? wv[c] : 0.f;
      cv[m] = c < M ? v[c] : 0.f;
    }
    double dot = 0.0;  // y . v over this warp's rows, on lane 0
    for (int r = i + 1 + warp; r < M; r += nw) {
      const float vr = vp[r], wr = wv[r];
      float* row = A + r * M;
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        if (i + 1 + kWarp * m >= M) break;  // the warp's columns end: skip, not mask
        const int c = i + 1 + lane + kWarp * m;
        if (c < M) {
          const float a = rank2(row[c], vr, cw[m], wr, cvp[m]);
          row[c] = a;
          acc = fmaf(a, cv[m], acc);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        yv[r] = acc;
        dot += static_cast<double>(acc) * v[r];
      }
    }
    if (lane == 0) red0[warp] = dot;
    if (tid == 0) A[i * M + i + 1] = static_cast<float>(beta);
    __syncthreads();

    const double yv_dot = partials_sum(red0, nw);
    alpha2 = -0.5 * tau * (tau * yv_dot);
    tau_prev = tau;
    float* t = vp;
    vp = v;
    v = t;
  }

  // 3. bisection; d and e^2 move into the vectors' room as float64
  double* dd = reinterpret_cast<double*>(vb0);
  double* ee = dd + M;  // ee[j] = e_j^2, ee[M-1] = 0
  double lo = INFINITY, hi = -INFINITY, emax = 0.0;
  bad = 0;
  for (int j = tid; j < M; j += nt) {
    const double dj = A[j * M + j];
    const double ej = j + 1 < M ? fabs(static_cast<double>(A[j * M + j + 1])) : 0.0;
    const double ejm = j > 0 ? fabs(static_cast<double>(A[(j - 1) * M + j])) : 0.0;
    bad |= !(finite(dj) && finite(ej));
    dd[j] = dj;
    ee[j] = ej * ej;
    lo = fmin(lo, dj - (ejm + ej));
    hi = fmax(hi, dj + (ejm + ej));
    emax = fmax(emax, ej * ej);
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  emax = warp_max(emax);
  if (lane == 0) {
    red1[warp] = lo;
    red2[warp] = hi;
    red3[warp] = emax;
  }
  if (__syncthreads_or(bad)) {
    for (int j = tid; j < M; j += nt) out[j] = NAN;
    return;
  }
  double gl = red1[0], gu = red2[0], e2max = red3[0];
  for (int k = 1; k < nw; ++k) {
    gl = fmin(gl, red1[k]);
    gu = fmax(gu, red2[k]);
    e2max = fmax(e2max, red3[k]);
  }
  const double tnorm = fmax(fabs(gl), fabs(gu));
  const double pivmin = DBL_MIN * fmax(1.0, e2max);
  const double widen = 2.1 * tnorm * DBL_EPSILON * M + 2.1 * 2.0 * pivmin;
  gl -= widen;
  gu += widen;
  const double tol = fmax(tnorm * (FLT_EPSILON), 2.0 * pivmin);
  int halvings = 0;
  for (double width = gu - gl; width > tol && halvings < 64; width *= 0.5) ++halvings;

  for (int j = tid; j < M; j += nt) {
    double a = gl, b = gu;
    for (int h = 0; h < halvings; ++h) {
      const double x = 0.5 * (a + b);
      double q = dd[0] - x;
      if (fabs(q) < pivmin) q = -pivmin;
      int below = q <= 0.0;
      for (int k = 1; k < M; ++k) {
        q = (dd[k] - ee[k - 1] * __drcp_rn(q)) - x;
        if (fabs(q) < pivmin) q = -pivmin;
        below += q <= 0.0;
      }
      if (below > j) b = x;
      else a = x;
    }
    out[j] = static_cast<float>(0.5 * (a + b));
  }
}

}  // namespace symeig
