// The step's assembly, written once for the two kernels of csrc/assembly.cu and for the host
// (tests/test_torch_assembly.py builds this header with the host's C++ compiler): one
// particle's flat coordinates -> its seven PSMCParams leaves, its log prior and its AFS term
// (A1, `assemble`), and the gradient of their dot with cotangents (A2, `gradient`), as
// ops/assembly.py's plain version computes them (params.MCMCParams.to_dm -> PSMCParams.from_dm
// with transition.transition_matrix and SizeHistory.ect / pi; model.log_prior; model.log_afs
// with SizeHistory.etjj / etbl).
//
// A group of G lanes (G = LANES, a warp) carries a particle.  Lane l owns the
// contiguous intervals j in [l q, l q + q), q = ceil(M / G), and computes their grid points,
// rates, expected times, emissions and the 2x2 live blocks of their two sub-intervals
// t_j -> e_j -> t_{j+1} (transition._expQ2) with no dependence on another lane.  What chains
// the intervals runs across the lanes:
//   - the live occupancy (r0, r1) entering every sub-interval (`occupancy`): each lane
//     composes its own blocks in order, an exclusive Kogge-Stone scan of those products gives
//     the product before each lane (phlash_tpu/transition.py's associative_scan of mm2), and
//     the lane carries its row 0 through its own blocks; each absorption increment is then
//     r0 p02 + r1 p12 from the occupancy entering its sub-interval;
//   - the hazard prefix and the exclusive log-survival sum: scans; pi's interior sum: a
//     butterfly reduction; p_float_out[0], the log-survival at interval 1 and A[0, 1]:
//     broadcast through the workspace;
//   - the AFS term: (pair count, interval) spread over the lanes, then the sums over
//     intervals, the W product, the normalization and the xlogy sum spread over the lanes;
//   - the prior: reductions over the coordinates.
// A2 runs A1's forward, then one reverse pass: the leaves' cotangents lane-local, the
// adjoints of the prefix sums as suffix scans, the occupancy's adjoint as a suffix scan of
// affine maps (`occupancy_adjoint`: the transposed blocks), and each lane's local adjoint of
// its intervals by one evaluation on dual numbers with a tangent of width 3 (sub_interval in
// (dg, c, rho), the expected time in (t_j, t_{j+1}, c), the escape terms in (d_et, c, c dt)).
// So every branch (texp_mean's Taylor switch, expm1inv, _expQ2's tiny / series / w <= 0
// cases, the degenerate sub-intervals, the clamps) is taken on the values as torch's autograd
// takes it, and each primitive's derivative is the one torch uses (clamp passes the gradient
// at equality, abs has sign(0) = 0, expm1' = result + 1, sqrt' = 1 / (2 result), xlogy's
// y-derivative x / y).  The gradient is written once a particle, with no atomics.
//
// A particle's state lives in a workspace (`Work`): shared memory on the card, sized at launch
// from M, n - 1 and R (work_elems), a buffer on the host.  Per-interval values sit at
// f[field * M + j]; a lane reads another lane's values only after sync_lanes().
//
// Rounding: the float32 gradient in t1 and tM is ill-conditioned in the forward values (the
// grid points above all), and phase 3c holds it to twice the plain float32 version's error.
// So every operation rounds as the plain version's separate ATen kernels round it: this file
// is built without contracted multiply-adds (ops/build.SOURCE_FLAGS), the grid as `grid_point`
// says, and only the scans and reductions across lanes associate otherwise.
//
// The lane layer below is the only code that differs between the card and the host.  On the
// card each thread runs its own lane and the cross-lane steps are __shfl_*_sync over the group.
// On the host `each` runs the lanes in turn over arrays of G values and the cross-lane steps
// read those arrays in the same Kogge-Stone and butterfly order, so the host runs the kernel's
// own association of every scan and reduction.
#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace phlash_assembly {

#ifndef __CUDACC__
using std::isfinite;
using std::isnan;
#endif

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// ---------------------------------------------------------------------------
// scalar primitives: libdevice, no fast-math, so NaN and +-inf propagate
// ---------------------------------------------------------------------------

__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xexpm1(float x) { return expm1f(x); }
__device__ __forceinline__ double xexpm1(double x) { return expm1(x); }
__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return log(x); }
__device__ __forceinline__ float xlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double xlog1p(double x) { return log1p(x); }
__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double xsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
__device__ __forceinline__ double xabs(double x) { return fabs(x); }

template <class T>
__device__ __forceinline__ T val(T x) { return x; }

// clamp(x, lo, hi) as torch.clamp: NaN stays NaN
template <class T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <class T>
__device__ __forceinline__ T clamp_minv(T x, T lo) { return x < lo ? lo : x; }

template <class T>
__device__ __forceinline__ T sigmoid(T x) { return T(1) / (T(1) + xexp(-x)); }

// xlogy(x, y) for a constant x: NaN where y is NaN, 0 where x == 0
template <class T>
__device__ __forceinline__ T xlogy(T x, T y) {
  if (isnan(y)) return y;
  return x == T(0) ? T(0) : x * xlog(y);
}

// where torch.clamp passes the gradient: lo <= x <= hi (not at NaN)
template <class T>
__device__ __forceinline__ T passes(T x, T lo, T hi) {
  return (x >= lo && x <= hi) ? T(1) : T(0);
}

// ---------------------------------------------------------------------------
// dual numbers: a value and its tangents along W input coordinates
// ---------------------------------------------------------------------------

template <class T, int W>
struct Dual {
  T v;
  T d[W];
  __device__ __forceinline__ Dual(T v_ = T(0)) : v(v_) {
    for (int i = 0; i < W; ++i) d[i] = T(0);
  }
};

template <class N> struct Scalar { using type = N; };
template <class T, int W> struct Scalar<Dual<T, W>> { using type = T; };

template <class T, int W>
__device__ __forceinline__ T val(const Dual<T, W>& x) { return x.v; }

// the input coordinate i of an evaluation: tangent 1 along i
template <class T, int W>
__device__ __forceinline__ Dual<T, W> seed(T v, int i) {
  Dual<T, W> r(v);
  r.d[i] = T(1);
  return r;
}

// value v, tangent s * a's
template <class T, int W>
__device__ __forceinline__ Dual<T, W> chain(T v, const Dual<T, W>& a, T s) {
  Dual<T, W> r(v);
  for (int i = 0; i < W; ++i) r.d[i] = s * a.d[i];
  return r;
}

template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator-(const Dual<T, W>& a) {
  Dual<T, W> r(-a.v);
  for (int i = 0; i < W; ++i) r.d[i] = -a.d[i];
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator+(const Dual<T, W>& a, const Dual<T, W>& b) {
  Dual<T, W> r(a.v + b.v);
  for (int i = 0; i < W; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator+(const Dual<T, W>& a, T b) {
  Dual<T, W> r(a);
  r.v = a.v + b;
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator+(T a, const Dual<T, W>& b) {
  Dual<T, W> r(b);
  r.v = a + b.v;
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator-(const Dual<T, W>& a, const Dual<T, W>& b) {
  Dual<T, W> r(a.v - b.v);
  for (int i = 0; i < W; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator-(const Dual<T, W>& a, T b) {
  Dual<T, W> r(a);
  r.v = a.v - b;
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator-(T a, const Dual<T, W>& b) {
  Dual<T, W> r(a - b.v);
  for (int i = 0; i < W; ++i) r.d[i] = -b.d[i];
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator*(const Dual<T, W>& a, const Dual<T, W>& b) {
  Dual<T, W> r(a.v * b.v);
  for (int i = 0; i < W; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator*(const Dual<T, W>& a, T b) {
  return chain(a.v * b, a, b);
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator*(T a, const Dual<T, W>& b) {
  return chain(a * b.v, b, a);
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator/(const Dual<T, W>& a, const Dual<T, W>& b) {
  const T q = a.v / b.v;
  Dual<T, W> r(q);
  for (int i = 0; i < W; ++i) r.d[i] = (a.d[i] - q * b.d[i]) / b.v;
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator/(const Dual<T, W>& a, T b) {
  Dual<T, W> r(a.v / b);
  for (int i = 0; i < W; ++i) r.d[i] = a.d[i] / b;
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> operator/(T a, const Dual<T, W>& b) {
  const T q = a / b.v;
  Dual<T, W> r(q);
  for (int i = 0; i < W; ++i) r.d[i] = -q * b.d[i] / b.v;
  return r;
}

template <class T, int W>
__device__ __forceinline__ Dual<T, W> xexp(const Dual<T, W>& x) {
  const T e = xexp(x.v);
  return chain(e, x, e);
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> xexpm1(const Dual<T, W>& x) {
  const T e = xexpm1(x.v);
  return chain(e, x, e + T(1));
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> xlog(const Dual<T, W>& x) {
  Dual<T, W> r(xlog(x.v));
  for (int i = 0; i < W; ++i) r.d[i] = x.d[i] / x.v;
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> xlog1p(const Dual<T, W>& x) {
  Dual<T, W> r(xlog1p(x.v));
  for (int i = 0; i < W; ++i) r.d[i] = x.d[i] / (x.v + T(1));
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> xsqrt(const Dual<T, W>& x) {
  const T s = xsqrt(x.v);
  Dual<T, W> r(s);
  for (int i = 0; i < W; ++i) r.d[i] = x.d[i] / (T(2) * s);
  return r;
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> xabs(const Dual<T, W>& x) {
  const T s = x.v > T(0) ? T(1) : (x.v < T(0) ? T(-1) : T(0));  // torch's sign: 0 at 0
  return chain(xabs(x.v), x, s);
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> clampv(const Dual<T, W>& x, T lo, T hi) {
  return chain(clampv(x.v, lo, hi), x, passes(x.v, lo, hi));
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> clamp_minv(const Dual<T, W>& x, T lo) {
  return chain(clamp_minv(x.v, lo), x, x.v >= lo ? T(1) : T(0));
}
template <class T, int W>
__device__ __forceinline__ Dual<T, W> sigmoid(const Dual<T, W>& x) {
  const T y = sigmoid(x.v);
  return chain(y, x, (T(1) - y) * y);
}

// ---------------------------------------------------------------------------
// an interval's own arithmetic, generic in the number type N (T or Dual<T, W>)
// ---------------------------------------------------------------------------

template <class N, class T = typename Scalar<N>::type>
__device__ __forceinline__ N clip20(N a) { return clampv(a, T(1e-20), T(1.0 - 1e-20)); }
template <class N, class T = typename Scalar<N>::type>
__device__ __forceinline__ N clip8(N a) { return clampv(a, T(1e-8), T(1.0 - 1e-8)); }

// log(1 + e^x) = max(x, 0) + log1p(e^-|x|), no large-x threshold (utils/numerics.py)
template <class N>
__device__ __forceinline__ N softplus(N x) {
  using T = typename Scalar<N>::type;
  return clamp_minv(x, T(0)) + xlog1p(xexp(-xabs(x)));
}

// 1/x - 1/expm1(x), with the Taylor form for |x| < 0.1 and expm1inv's
// rewrite for x > 10 (utils/numerics.texp_mean)
template <class N>
__device__ __forceinline__ N texp_mean(N x) {
  using T = typename Scalar<N>::type;
  if (xabs(val(x)) < T(0.1)) return (T(0.5) - x / T(12)) + (x * x * x) / T(720);
  const N inv = val(x) > T(10) ? -xexp(-x) / xexpm1(-x) : T(1) / xexpm1(x);
  return T(1) / x - inv;
}

// one sub-interval's 2x2 live block and absorption (transition._expQ2 at
// n = 2), with the degenerate-length override of transition_matrix
template <class N>
struct Block {
  N p00, p01, p10, p11, p02, p12;
};

template <class N>
__device__ __forceinline__ Block<N> identity_block() {
  using T = typename Scalar<N>::type;
  return {N(T(1)), N(T(0)), N(T(0)), N(T(1)), N(T(0)), N(T(0))};
}

template <class N>
__device__ __forceinline__ Block<N> sub_interval(N dg, N c, N rho) {
  using T = typename Scalar<N>::type;
  // torch.isclose(dg, 0): dg == 0, or |dg| finite and <= atol (1e-8)
  const T dv = val(dg);
  if (dv == T(0) || (isfinite(dv) && xabs(dv) <= T(1e-8))) return identity_block<N>();
  const N r = (dg * T(2)) * rho;
  const N cc = dg * c;
  const N cn = cc * T(2);
  const N u = xsqrt((cn * cn - ((cc * T(2)) * T(0)) * r) + r * r) / T(2);
  const N v = (r + cn) / T(2);
  const N w = (r - cn) / T(2);
  const N ab = (cc * r) * T(1);
  const N upv = u + v;
  const N a = -ab / (val(upv) == T(0) ? N(T(1)) : upv);
  const N b = -upv;
  const N ea = xexpm1(a), eb = xexpm1(b);
  const bool tiny = val(u) < T(1e-6);
  const N u_ok = tiny ? N(T(1)) : u;
  const N two_u = u_ok * T(2);
  Block<N> q;
  N shu;
  if (tiny) {
    const N emv = xexp(-v);
    shu = emv * (T(1) + (u_ok * u_ok) / T(6));
    q.p00 = emv * (T(1) - w);
    q.p11 = emv * (T(1) + w);
  } else {
    shu = (ea - eb) / two_u;
    const N big_raw = u + xabs(w);
    const N big = val(big_raw) == T(0) ? N(T(1)) : big_raw;
    const N small = (cc * r) / big;
    const bool neg = val(w) <= T(0);
    const N s_plus = neg ? small : big;
    const N s_minus = neg ? big : small;
    const N exp_a = xexp(a), exp_b = xexp(b);
    q.p00 = (exp_a * s_minus + exp_b * s_plus) / two_u;
    q.p11 = (exp_a * s_plus + exp_b * s_minus) / two_u;
  }
  q.p01 = r * shu;
  q.p10 = cc * shu;
  if (xabs(val(a)) < T(0.05) && xabs(val(b)) < T(0.05)) {
    // the exact series where both exponents are small
    N series = N(T(0)), h = N(T(1)), bp = N(T(1));
    T fact = T(2);
    for (int k = 2; k < 8; ++k) {
      series = series + h / fact;
      bp = bp * b;
      h = a * h + bp;
      fact = fact * T(k + 1);
    }
    q.p02 = ab * series;
  } else {
    q.p02 = (b * ea - a * eb) / two_u;
  }
  const N kappa = cc + w;
  if (tiny) {
    q.p12 = -(xexpm1(-v) + kappa * xexp(-v));
  } else {
    q.p12 = -((u_ok + kappa) * ea + (u_ok - kappa) * eb) / two_u;
  }
  return q;
}

// an interval's c dt, its sub-interval lengths t_j -> e_j and e_j -> t_{j+1}, and e_j
// (transition_matrix's d_te / d_et, SizeHistory.ect before its clamp)
template <class N>
struct Pre {
  N cdt, d_te, d_et, ect;
};

template <class N>
__device__ __forceinline__ Pre<N> pre_finite(N t0, N t1, N c) {
  using T = typename Scalar<N>::type;
  const N dt = t1 - t0;
  const N cdt = c * dt;
  const N g = texp_mean(cdt);
  return {cdt, clamp_minv(dt * g, T(0)), clamp_minv(dt * (T(1) - g), T(0)), t0 + dt * g};
}

// the open last interval: t_{M-1} -> e_{M-1} is 1 / c long
template <class N>
__device__ __forceinline__ Pre<N> pre_last(N t0, N c) {
  using T = typename Scalar<N>::type;
  return {N(T(0)), T(1) / c, N(T(0)), t0 + T(1) / c};
}

// what the occupancy meets after e_j: re-coalescence before t_{j+1} (p_back), escape past it
// (esc), survival across the interval and coalescence in it (both clipped to [1e-8, 1 - 1e-8])
template <class N>
struct Post {
  N p_back, esc, ps, pc;
};

template <class N>
__device__ __forceinline__ Post<N> post_finite(N d_et, N c, N cdt) {
  const N dc = d_et * c;
  return {-xexpm1(-dc), xexp(-dc), clip8(xexp(-cdt)), clip8(-xexpm1(-cdt))};
}

template <class N>
__device__ __forceinline__ Post<N> post_last() {
  using T = typename Scalar<N>::type;
  return {N(T(1)), N(T(0)), clip8(N(T(0))), clip8(N(T(1)))};
}

// the emissions in theta * E[coalescence time in the interval]
template <class N, class T>
__device__ __forceinline__ void emissions(N ect, T theta, N& e0, N& e1) {
  const N lam = clamp_minv(ect, T(1e-20)) * theta;
  e0 = clip20(xexp(-lam));
  e1 = clip20(-xexpm1(-lam));
}

// t_{i+1} = exp(lo + span k_i), k_i = i / (M - 2): geomspace(t1, tM, M - 1) rounded as the plain
// version rounds it on the same device (to_dm: log, subtract, multiply, add and exp, each
// rounded; this file is built without contracted multiply-adds).  ATen divides a CUDA tensor
// by a number as a product with its reciprocal, and a CPU tensor by true division.  The
// gradient in t1 and tM is ill-conditioned in these points: rounding them otherwise moved the
// float32 gradient by up to 1e-5 of its max, ten times what the inputs' own rounding does.
template <class T>
__device__ __forceinline__ T grid_point(T lo, T span, int i, int M) {
#ifdef __CUDACC__
  const T k = T(i) * (T(1) / T(M - 2));
#else
  const T k = T(i) / T(M - 2);
#endif
  return xexp(lo + span * k);
}

// ---------------------------------------------------------------------------
// 2x2 maps: a block's live part, and the reverse pass's affine maps
// ---------------------------------------------------------------------------

template <class T, int K>
struct Vec {
  T a[K];
};
template <class T> using Mat = Vec<T, 4>;  // row-major 2x2
template <class T> using Aff = Vec<T, 6>;  // x -> A x + b: A row-major, then b

template <class T>
__device__ __forceinline__ Mat<T> eye2() { return {{T(1), T(0), T(0), T(1)}}; }

// x @ y (phlash_tpu/transition.py's mm2): the occupancy's combine, earlier block on the left
template <class T>
__device__ __forceinline__ Mat<T> mm2(const Mat<T>& x, const Mat<T>& y) {
  return {{x.a[0] * y.a[0] + x.a[1] * y.a[2], x.a[0] * y.a[1] + x.a[1] * y.a[3],
           x.a[2] * y.a[0] + x.a[3] * y.a[2], x.a[2] * y.a[1] + x.a[3] * y.a[3]}};
}

// f after s, both adjoint maps rho -> A rho + b: the combine of the occupancy's adjoint, f
// the earlier segment's (rho at its start from rho at its end = the start of s's)
template <class T>
__device__ __forceinline__ Aff<T> compose(const Aff<T>& f, const Aff<T>& s) {
  return {{f.a[0] * s.a[0] + f.a[1] * s.a[2], f.a[0] * s.a[1] + f.a[1] * s.a[3],
           f.a[2] * s.a[0] + f.a[3] * s.a[2], f.a[2] * s.a[1] + f.a[3] * s.a[3],
           (f.a[0] * s.a[4] + f.a[1] * s.a[5]) + f.a[4],
           (f.a[2] * s.a[4] + f.a[3] * s.a[5]) + f.a[5]}};
}

template <class T>
struct Add {
  __device__ __forceinline__ T operator()(T x, T y) const { return x + y; }
};
template <class T>
struct Mm2 {
  __device__ __forceinline__ Mat<T> operator()(const Mat<T>& x, const Mat<T>& y) const {
    return mm2(x, y);
  }
};
template <class T>
struct Compose {
  __device__ __forceinline__ Aff<T> operator()(const Aff<T>& f, const Aff<T>& s) const {
    return compose(f, s);
  }
};

// ---------------------------------------------------------------------------
// the lane layer: a group of G lanes carries one particle
// ---------------------------------------------------------------------------

// lanes a particle: a warp.  Half a warp (two particles a warp) measured no faster at M = 16
// on an H100 and 18-30% slower at n - 1 = 9 and 15, where the AFS term spreads over the
// lanes (PERF.md)
constexpr int LANES = 32;

enum Shfl { UP, DOWN, XOR };  // __shfl_{up,down,xor}_sync over G lanes

#ifdef __CUDACC__
// a value each lane holds its own of: one V in the thread's registers
template <class V>
struct Lanes {
  V x;
  __device__ __forceinline__ V& operator[](int) { return x; }
  __device__ __forceinline__ const V& operator[](int) const { return x; }
};

// run f for this thread's lane
template <int G, class F>
__device__ __forceinline__ void each(F&& f) { f(static_cast<int>(threadIdx.x) & (G - 1)); }

// the workspace written so far is visible to every lane
__device__ __forceinline__ void sync_lanes() { __syncwarp(); }

template <Shfl S, int G, class T>
__device__ __forceinline__ T shfl1(T v, int a) {
  if constexpr (S == UP) return __shfl_up_sync(0xffffffffu, v, a, G);
  else if constexpr (S == DOWN) return __shfl_down_sync(0xffffffffu, v, a, G);
  else return __shfl_xor_sync(0xffffffffu, v, a, G);
}
template <Shfl S, int G, class T, int K>
__device__ __forceinline__ Vec<T, K> shfl1(const Vec<T, K>& v, int a) {
  Vec<T, K> o;
  for (int i = 0; i < K; ++i) o.a[i] = shfl1<S, G>(v.a[i], a);
  return o;
}

template <Shfl S, int G, class V>
__device__ __forceinline__ Lanes<V> shfl(const Lanes<V>& v, int a) {
  return {shfl1<S, G>(v.x, a)};
}
#else
// a value each lane holds its own of: one V a lane
template <class V>
struct Lanes {
  V x[32];
  V& operator[](int l) { return x[l]; }
  const V& operator[](int l) const { return x[l]; }
};

// run f for lanes 0 .. G - 1 in turn
template <int G, class F>
inline void each(F&& f) {
  for (int l = 0; l < G; ++l) f(l);
}

inline void sync_lanes() {}

// the lane whose value lane l receives
template <Shfl S, int G>
inline int source(int l, int a) {
  if (S == UP) return l >= a ? l - a : l;
  if (S == DOWN) return l + a < G ? l + a : l;
  return l ^ a;
}

template <Shfl S, int G, class V>
inline Lanes<V> shfl(const Lanes<V>& v, int a) {
  Lanes<V> o;
  for (int l = 0; l < G; ++l) o[l] = v[source<S, G>(l, a)];
  return o;
}
#endif

// inclusive Kogge-Stone scan in prefix order: s[l] <- s[0] op ... op s[l]
template <int G, class V, class Op>
__device__ __forceinline__ void scan_prefix(Lanes<V>& s, Op op) {
  for (int d = 1; d < G; d *= 2) {
    const Lanes<V> o = shfl<UP, G>(s, d);
    each<G>([&](int l) {
      if (l >= d) s[l] = op(o[l], s[l]);
    });
  }
}

// inclusive Kogge-Stone scan in suffix order: s[l] <- s[l] op ... op s[G - 1]
template <int G, class V, class Op>
__device__ __forceinline__ void scan_suffix(Lanes<V>& s, Op op) {
  for (int d = 1; d < G; d *= 2) {
    const Lanes<V> o = shfl<DOWN, G>(s, d);
    each<G>([&](int l) {
      if (l + d < G) s[l] = op(s[l], o[l]);
    });
  }
}

// s[0] op ... op s[l - 1]; `id` at lane 0
template <int G, class V, class Op>
__device__ __forceinline__ Lanes<V> before(Lanes<V> s, Op op, const V& id) {
  scan_prefix<G>(s, op);
  Lanes<V> o = shfl<UP, G>(s, 1);
  each<G>([&](int l) {
    if (l == 0) o[l] = id;
  });
  return o;
}

// s[l + 1] op ... op s[G - 1]; `id` at lane G - 1
template <int G, class V, class Op>
__device__ __forceinline__ Lanes<V> after(Lanes<V> s, Op op, const V& id) {
  scan_suffix<G>(s, op);
  Lanes<V> o = shfl<DOWN, G>(s, 1);
  each<G>([&](int l) {
    if (l == G - 1) o[l] = id;
  });
  return o;
}

// the sum over the lanes by a butterfly, bitwise the same on every lane
template <int G, class T>
__device__ __forceinline__ T lane_sum(Lanes<T> s) {
  for (int m = 1; m < G; m *= 2) {
    const Lanes<T> o = shfl<XOR, G>(s, m);
    each<G>([&](int l) { s[l] = s[l] + o[l]; });
  }
  return s[0];
}

// ---------------------------------------------------------------------------
// inputs and the workspace
// ---------------------------------------------------------------------------

// the inputs of one launch; every float array in the assembly's dtype T
template <class T>
struct Inputs {
  const T* x;               // (P, D) flat coordinates: t_tr (2), c_tr (K), rho_over_theta_tr
  const long long* expand;  // (M,) the pattern's group of each interval
  const T* afs;             // (n - 1,) observed spectrum, or null (no AFS term)
  const T* tr;              // (R, n - 1) AFS transform, or null (the identity, R = n - 1)
  const T* w;               // (n - 1, n - 1) Polanski-Kimmel W, or null (no AFS term)
  int P, D, M, nm1, R;
  T theta, alpha, beta;
};

constexpr int N_LEAVES = 7;  // b, d, u, v, emis0, emis1, pi

// per-interval fields of the workspace: A1's (the forward), then A2's adjoints
enum Field : int {
  F_C,    // c_j
  F_T0,   // t_j
  F_T1,   // t_{j+1} (0 for the last interval)
  F_CDT,  // c_j dt_j (0 for the last)
  F_DTE,  // t_j -> e_j
  F_DET,  // e_j -> t_{j+1}
  F_ECT,  // e_j before its clamp
  F_QA,   // the block of t_j -> e_j: p00 p01 p10 p11 p02 p12
  F_QB = F_QA + 6,   // the block of e_j -> t_{j+1} (the identity for the last)
  F_PB = F_QB + 6,   // p_back
  F_ESC,  // escape past t_{j+1}
  F_PS,   // p_surv, clipped
  F_PC,   // p_coal, clipped
  F_R0,   // occupancy entering t_j
  F_R1,
  F_AE0,  // occupancy at e_j
  F_AE1,
  F_PFO,  // p_float_out, clipped
  F_HX,   // hazard before interval j
  F_CLS,  // log-survival before interval j
  F_A0,   // A[0, j], clipped
  N_FWD_FIELDS,
  F_DC = N_FWD_FIELDS,  // d c_j
  F_DCDT,  // d (c dt)_j
  F_DHX,   // d hazard before j
  F_DHI,   // d hazard through j
  F_DPFO,  // d p_float_out through u and A[0, .]
  F_DPC,   // d p_coal (clipped)
  F_DPS,   // d p_surv (clipped)
  F_DCLS,  // d log-survival before j
  F_DA0,   // d A[0, j] through v
  F_DPB,   // d p_back
  F_DESC,  // d esc
  F_DR0,   // the loss's direct derivative in the occupancy entering t_j
  F_DR1,
  F_DE0,   // ... and at e_j
  F_DE1,
  F_GQA,   // d block of t_j -> e_j, p00 .. p12
  F_GQB = F_GQA + 6,  // d block of e_j -> t_{j+1}
  F_DT0 = F_GQB + 6,  // d t_j through interval j
  F_DT1,   // d t_{j+1} through interval j
  N_FIELDS
};

// elements of T a particle's workspace takes: the fields, the leaves (7, M), the AFS term's
// buffers (a chunk of at most G pair counts' terms, etjj and esfs, each row's y and
// transformed count) and, for A2, their adjoints
__host__ __device__ __forceinline__ size_t work_elems(int G, int M, int nm1, int R, bool grad) {
  const size_t rows = static_cast<size_t>(imin(nm1, G));
  size_t n = static_cast<size_t>(grad ? N_FIELDS : N_FWD_FIELDS) * M + N_LEAVES * M + rows * M +
             2 * static_cast<size_t>(nm1) + 2 * static_cast<size_t>(R);
  if (grad) n += static_cast<size_t>(R) + 2 * static_cast<size_t>(nm1);
  return n;
}

template <class T>
struct Work {
  T* f;      // fields: f[field * M + j]
  T* leaf;   // (7, M)
  T* term;   // (min(n - 1, G), M) one chunk of etjj's terms
  T* etjj;   // (n - 1)
  T* esfs;   // (n - 1) etbl, then etbl / its sum
  T* y;      // (R) the transformed esfs
  T* tafs;   // (R) the transformed counts
  T* dy;     // (R) A2: d y
  T* desfs;  // (n - 1) A2: d etbl
  T* detjj;  // (n - 1) A2: d etjj
  int M;
  __device__ __forceinline__ T& at(int field, int j) const {
    return f[static_cast<size_t>(field) * M + j];
  }
};

template <class T>
__device__ __forceinline__ Work<T> carve(T* base, int G, int M, int nm1, int R, bool grad) {
  Work<T> w;
  w.M = M;
  w.f = base;
  w.leaf = w.f + static_cast<size_t>(grad ? N_FIELDS : N_FWD_FIELDS) * M;
  w.term = w.leaf + N_LEAVES * M;
  w.etjj = w.term + static_cast<size_t>(imin(nm1, G)) * M;
  w.esfs = w.etjj + nm1;
  w.y = w.esfs + nm1;
  w.tafs = w.y + R;
  w.dy = w.tafs + R;
  w.desfs = w.dy + R;
  w.detjj = w.desfs + nm1;
  return w;
}

template <class T>
__device__ __forceinline__ void put_block(const Work<T>& w, int f, int j, const Block<T>& b) {
  w.at(f, j) = b.p00;
  w.at(f + 1, j) = b.p01;
  w.at(f + 2, j) = b.p10;
  w.at(f + 3, j) = b.p11;
  w.at(f + 4, j) = b.p02;
  w.at(f + 5, j) = b.p12;
}

template <class T>
__device__ __forceinline__ Mat<T> live_block(const Work<T>& w, int f, int j) {
  return {{w.at(f, j), w.at(f + 1, j), w.at(f + 2, j), w.at(f + 3, j)}};
}

// acc[i] += the block's derivative along input i, dotted with its adjoint at field f
template <class T, int W>
__device__ __forceinline__ void contract(const Block<Dual<T, W>>& b, const Work<T>& w, int f,
                                         int j, T* acc) {
  const T g[6] = {w.at(f, j),     w.at(f + 1, j), w.at(f + 2, j),
                  w.at(f + 3, j), w.at(f + 4, j), w.at(f + 5, j)};
  for (int i = 0; i < W; ++i)
    acc[i] = acc[i] + (((((g[0] * b.p00.d[i] + g[1] * b.p01.d[i]) + g[2] * b.p10.d[i]) +
                         g[3] * b.p11.d[i]) + g[4] * b.p02.d[i]) + g[5] * b.p12.d[i]);
}

// ---------------------------------------------------------------------------
// the occupancy across the lanes, and its adjoint
// ---------------------------------------------------------------------------

// The live occupancy entering every sub-interval, from the blocks at F_QA / F_QB (lane l's
// intervals are [l q, l q + q)): each lane composes its own blocks in order, an exclusive scan
// gives the product of all blocks before its first (whose row 0 is the occupancy there: the
// chain starts in state 0), and the lane carries that row through its own blocks.  Writes
// F_R0 / F_R1 (entering t_j) and F_AE0 / F_AE1 (at e_j).
template <int G, class T>
__device__ void occupancy(const Work<T>& w) {
  const int M = w.M, q = (M + G - 1) / G;
  Lanes<Mat<T>> prod;
  each<G>([&](int l) {
    Mat<T> m = eye2<T>();
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      m = mm2(m, live_block(w, F_QA, j));
      if (j < M - 1) m = mm2(m, live_block(w, F_QB, j));
    }
    prod[l] = m;
  });
  const Lanes<Mat<T>> start = before<G>(prod, Mm2<T>(), eye2<T>());
  each<G>([&](int l) {
    T r0 = start[l].a[0], r1 = start[l].a[1];
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      w.at(F_R0, j) = r0;
      w.at(F_R1, j) = r1;
      const Mat<T> a = live_block(w, F_QA, j);
      const T e0 = r0 * a.a[0] + r1 * a.a[2], e1 = r0 * a.a[1] + r1 * a.a[3];
      w.at(F_AE0, j) = e0;
      w.at(F_AE1, j) = e1;
      if (j < M - 1) {
        const Mat<T> b = live_block(w, F_QB, j);
        r0 = e0 * b.a[0] + e1 * b.a[2];
        r1 = e0 * b.a[1] + e1 * b.a[3];
      }
    }
  });
}

// The occupancy's adjoint.  From the loss's direct derivatives in the occupancy entering t_j
// (F_DR0 / F_DR1) and at e_j (F_DE0 / F_DE1), the total ones satisfy rho_k = delta_k +
// P_k rho_{k+1} backwards over the sub-intervals k; the derivative in block k's live entries
// is then r_k rho_{k+1}^T, written to F_GQA / F_GQB entries 0..3.  Each lane's intervals make
// the affine map rho(its start) = A rho(its end) + b (A its block product, b its adjoint when
// rho(end) = 0); an exclusive suffix scan of those maps gives every lane its rho(end), and the
// lane carries it back through its own blocks.
template <int G, class T>
__device__ void occupancy_adjoint(const Work<T>& w) {
  const int M = w.M, q = (M + G - 1) / G;
  Lanes<Aff<T>> seg;
  each<G>([&](int l) {
    Mat<T> m = eye2<T>();
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      m = mm2(m, live_block(w, F_QA, j));
      if (j < M - 1) m = mm2(m, live_block(w, F_QB, j));
    }
    T b0 = T(0), b1 = T(0);
    for (int j = imin(M, l * q + q) - 1; j >= l * q; --j) {
      T e0 = w.at(F_DE0, j), e1 = w.at(F_DE1, j);
      if (j < M - 1) {
        const Mat<T> b = live_block(w, F_QB, j);
        e0 = e0 + (b.a[0] * b0 + b.a[1] * b1);
        e1 = e1 + (b.a[2] * b0 + b.a[3] * b1);
      }
      const Mat<T> a = live_block(w, F_QA, j);
      b0 = w.at(F_DR0, j) + (a.a[0] * e0 + a.a[1] * e1);
      b1 = w.at(F_DR1, j) + (a.a[2] * e0 + a.a[3] * e1);
    }
    seg[l] = {{m.a[0], m.a[1], m.a[2], m.a[3], b0, b1}};
  });
  const Lanes<Aff<T>> rest =
      after<G>(seg, Compose<T>(), Aff<T>{{T(1), T(0), T(0), T(1), T(0), T(0)}});
  each<G>([&](int l) {
    T b0 = rest[l].a[4], b1 = rest[l].a[5];  // rho entering the next lane's first interval
    for (int j = imin(M, l * q + q) - 1; j >= l * q; --j) {
      T e0 = w.at(F_DE0, j), e1 = w.at(F_DE1, j);
      if (j < M - 1) {
        const T a0 = w.at(F_AE0, j), a1 = w.at(F_AE1, j);
        w.at(F_GQB, j) = a0 * b0;
        w.at(F_GQB + 1, j) = a0 * b1;
        w.at(F_GQB + 2, j) = a1 * b0;
        w.at(F_GQB + 3, j) = a1 * b1;
        const Mat<T> b = live_block(w, F_QB, j);
        e0 = e0 + (b.a[0] * b0 + b.a[1] * b1);
        e1 = e1 + (b.a[2] * b0 + b.a[3] * b1);
      }
      const T r0 = w.at(F_R0, j), r1 = w.at(F_R1, j);
      w.at(F_GQA, j) = r0 * e0;
      w.at(F_GQA + 1, j) = r0 * e1;
      w.at(F_GQA + 2, j) = r1 * e0;
      w.at(F_GQA + 3, j) = r1 * e1;
      const Mat<T> a = live_block(w, F_QA, j);
      b0 = w.at(F_DR0, j) + (a.a[0] * e0 + a.a[1] * e1);
      b1 = w.at(F_DR1, j) + (a.a[2] * e0 + a.a[3] * e1);
    }
  });
}

// ---------------------------------------------------------------------------
// A1: the forward
// ---------------------------------------------------------------------------

// the particle's scalars the reverse pass reads again
template <class T>
struct Terms {
  T l_prior, l_afs, interior, total;
};

// Particle p's forward into the workspace: the leaves at w.leaf, every field of
// N_FWD_FIELDS, the AFS buffers; returns the prior, the AFS term and two sums.
template <int G, class T>
__device__ Terms<T> forward(const Inputs<T>& in, int p, const Work<T>& w) {
  const int D = in.D, M = in.M, K = D - 3, q = (M + G - 1) / G;
  const T* xp = in.x + static_cast<size_t>(p) * D;
  auto leaf = [&](int f, int j) -> T& { return w.leaf[f * M + j]; };

  // to_dm: t = [0, geomspace(t1, tM, M - 1)], c = softplus(c_tr)[expand]; the same on every lane
  const T t1 = xexp(xp[0]);
  const T tM = t1 + xexp(xp[1]);
  const T lo = xlog(t1);
  const T span = xlog(tM) - lo;
  const T rot = T(0.1) + T(9.9) * sigmoid(xp[D - 1]);
  const T rho = rot * in.theta;

  // 1. each lane's intervals, on their own: rate, grid points, expected time, emissions, the
  //    two blocks and what the occupancy meets after e_j; the lane's sums of c dt and
  //    log p_surv for the scans
  Lanes<T> hsum, lsum;
  each<G>([&](int l) {
    T hs = T(0), ls = T(0);
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      const bool finite = j < M - 1;
      const T c = softplus(xp[2 + static_cast<int>(in.expand[j])]);
      const T t0 = j == 0 ? T(0) : grid_point(lo, span, j - 1, M);
      const T tn = finite ? grid_point(lo, span, j, M) : T(0);
      const Pre<T> pr = finite ? pre_finite(t0, tn, c) : pre_last(t0, c);
      emissions(pr.ect, in.theta, leaf(4, j), leaf(5, j));
      put_block(w, F_QA, j, sub_interval(pr.d_te, c, rho));
      put_block(w, F_QB, j, finite ? sub_interval(pr.d_et, c, rho) : identity_block<T>());
      const Post<T> po = finite ? post_finite(pr.d_et, c, pr.cdt) : post_last<T>();
      w.at(F_C, j) = c;
      w.at(F_T0, j) = t0;
      w.at(F_T1, j) = tn;
      w.at(F_CDT, j) = pr.cdt;
      w.at(F_DTE, j) = pr.d_te;
      w.at(F_DET, j) = pr.d_et;
      w.at(F_ECT, j) = pr.ect;
      w.at(F_PB, j) = po.p_back;
      w.at(F_ESC, j) = po.esc;
      w.at(F_PS, j) = po.ps;
      w.at(F_PC, j) = po.pc;
      hs = hs + pr.cdt;
      ls = ls + xlog(po.ps);
    }
    hsum[l] = hs;
    lsum[l] = ls;
  });

  // 2. the occupancy, the hazard and the log-survival before each lane's intervals
  occupancy<G>(w);
  const Lanes<T> hbase = before<G>(hsum, Add<T>(), T(0));
  const Lanes<T> lbase = before<G>(lsum, Add<T>(), T(0));

  // 3. each lane's intervals again: the absorptions, the diagonals, p_float_out, the prefix
  //    sums and pi (P(coalescence in interval j) from the survival at the breakpoints)
  Lanes<T> isum;
  each<G>([&](int l) {
    T h = hbase[l], cl = lbase[l], is = T(0);
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      const bool finite = j < M - 1;
      const T r0 = w.at(F_R0, j), r1 = w.at(F_R1, j);
      const T e0 = w.at(F_AE0, j), e1 = w.at(F_AE1, j);
      const T inc_a = r0 * w.at(F_QA + 4, j) + r1 * w.at(F_QA + 5, j);
      if (finite) {
        const T inc_b = e0 * w.at(F_QB + 4, j) + e1 * w.at(F_QB + 5, j);
        leaf(0, j) = clip20(inc_a + inc_b);
      } else {
        leaf(0, j) = T(0);
      }
      leaf(1, j) = clip20((e0 + e1 * w.at(F_PB, j)) + inc_a);
      w.at(F_PFO, j) = clip8(e1 * w.at(F_ESC, j));
      const T hx = h;
      w.at(F_HX, j) = hx;
      if (finite) h = hx + w.at(F_CDT, j);
      w.at(F_CLS, j) = cl;
      cl = cl + xlog(w.at(F_PS, j));
      if (j >= 1) {
        const T sp = xexp(-hx);
        const T it = finite ? -(xexp(-h) - sp) : -(T(0) - sp);
        leaf(6, j) = clip20(it);
        is = is + it;
      }
    }
    isum[l] = is;
  });
  const T interior = lane_sum<G>(isum);
  sync_lanes();

  // 4. row 0 of the transition (A[0, j], j >= 1), then v = A[0, .] / A[0, 1] and
  //    u_j = A[j, j + 1] / v_{j + 1}
  const T pfo0 = w.at(F_PFO, 0), cls1 = w.at(F_CLS, 1);
  each<G>([&](int l) {
    for (int j = l * q; j < imin(M, l * q + q); ++j)
      if (j >= 1) w.at(F_A0, j) = clip20((pfo0 * xexp(w.at(F_CLS, j) - cls1)) * w.at(F_PC, j));
  });
  sync_lanes();
  const T a01 = w.at(F_A0, 1);
  each<G>([&](int l) {
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      if (j == 0) {
        leaf(3, 0) = T(0);
        leaf(6, 0) = clip20(T(1) - interior);
      } else {
        const T v = w.at(F_A0, j) / a01;
        leaf(3, j) = v;
        leaf(2, j - 1) = clip20(w.at(F_PFO, j - 1) * w.at(F_PC, j)) / v;
      }
      if (j == M - 1) leaf(2, j) = T(0);
    }
  });

  // 5. the AFS term: xlogy(T afs, T etbl / sum(etbl)), etbl = etjj W^T
  T l_afs = T(0), total = T(0);
  const int nm1 = in.nm1, R = in.R;
  if (nm1 > 0) {
    for (int c0 = 0; c0 < nm1; c0 += G) {  // G pair counts at a time
      const int rows = imin(G, nm1 - c0);
      each<G>([&](int l) {
        for (int i = l; i < rows * M; i += G) {
          const int jj = c0 + i / M, k = i % M;
          const T m = T((jj + 2) * (jj + 1) / 2);  // pairs among jj + 2 lineages
          const T hm = xexp(-(w.at(F_HX, k) * m));
          w.term[i] = k < M - 1 ? (hm * -xexpm1(-(w.at(F_CDT, k) * m))) / (w.at(F_C, k) * m)
                                : hm / (w.at(F_C, k) * m);
        }
      });
      sync_lanes();
      each<G>([&](int l) {
        if (l < rows) {
          T s = T(0);
          for (int k = 0; k < M - 1; ++k) s = s + w.term[l * M + k];
          w.etjj[c0 + l] = s + w.term[l * M + M - 1];
        }
      });
      sync_lanes();
    }
    Lanes<T> part;
    each<G>([&](int l) {
      T s = T(0);
      for (int b = l; b < nm1; b += G) {
        T e = T(0);
        for (int jj = 0; jj < nm1; ++jj)
          e = e + w.etjj[jj] * in.w[static_cast<size_t>(b) * nm1 + jj];
        w.esfs[b] = e;
        s = s + e;
      }
      part[l] = s;
    });
    total = lane_sum<G>(part);
    each<G>([&](int l) {
      for (int b = l; b < nm1; b += G) w.esfs[b] = w.esfs[b] / total;
    });
    sync_lanes();
    each<G>([&](int l) {
      T s = T(0);
      for (int r = l; r < R; r += G) {
        T t_afs = T(0), y = T(0);
        if (in.tr == nullptr) {
          t_afs = in.afs[r];
          y = w.esfs[r];
        } else {
          const T* row = in.tr + static_cast<size_t>(r) * nm1;
          for (int b = 0; b < nm1; ++b) {
            t_afs = t_afs + row[b] * in.afs[b];
            y = y + w.esfs[b] * row[b];
          }
        }
        w.y[r] = y;
        w.tafs[r] = t_afs;
        s = s + xlogy(t_afs, y);
      }
      part[l] = s;
    });
    l_afs = lane_sum<G>(part);
  }

  // 6. log_prior: a normal on log(rho / theta), the smoothness of log c, the ridge
  const T lx = xlog(rot);
  Lanes<T> smooth_p, ridge_p;
  each<G>([&](int l) {
    T sm = T(0), rg = T(0);
    for (int k = l + 1; k < K; k += G) {
      const T df = xlog(softplus(xp[2 + k])) - xlog(softplus(xp[1 + k]));
      sm = sm + df * df;
    }
    for (int d = l; d < D; d += G) rg = rg + xp[d] * xp[d];
    smooth_p[l] = sm;
    ridge_p[l] = rg;
  });
  const T smooth = lane_sum<G>(smooth_p), ridge = lane_sum<G>(ridge_p);
  T lp = -(T(1.8378770664093453) + lx * lx) / T(2);  // log(2 pi)
  lp = lp - in.alpha * smooth;
  return {lp - in.beta * ridge, l_afs, interior, total};
}

// A1 for particle p: its leaves (7, M), log prior and AFS term
template <int G, class T>
__device__ void assemble(const Inputs<T>& in, int p, const Work<T>& w, T* leaves, T* l_prior,
                         T* l_afs) {
  const Terms<T> s = forward<G>(in, p, w);
  sync_lanes();
  const int n = N_LEAVES * in.M;
  each<G>([&](int l) {
    T* out = leaves + static_cast<size_t>(p) * n;
    for (int i = l; i < n; i += G) out[i] = w.leaf[i];
    if (l == 0) {
      l_prior[p] = s.l_prior;
      l_afs[p] = s.l_afs;
    }
  });
}

// ---------------------------------------------------------------------------
// A2: the forward, then one reverse pass
// ---------------------------------------------------------------------------

// A2 for particle p: grad[p, :] = d/dx of <g_leaves[p], leaves> + g_prior[p] l_prior +
// g_afs[p] l_afs
template <int G, class T>
__device__ void gradient(const Inputs<T>& in, int p, const Work<T>& w, const T* g_leaves,
                         const T* g_prior, const T* g_afs, T* grad) {
  using D3 = Dual<T, 3>;
  using D1 = Dual<T, 1>;
  const int D = in.D, M = in.M, K = D - 3, q = (M + G - 1) / G, nm1 = in.nm1, R = in.R;
  const T* xp = in.x + static_cast<size_t>(p) * D;
  const T* g = g_leaves + static_cast<size_t>(p) * N_LEAVES * M;
  const T gp = g_prior[p], ga = g_afs[p];
  const Terms<T> s = forward<G>(in, p, w);
  sync_lanes();
  const T t1 = xexp(xp[0]);
  const T e1 = xexp(xp[1]);
  const T tM = t1 + e1;
  const T ysig = sigmoid(xp[D - 1]);
  const T rot = T(0.1) + T(9.9) * ysig;
  const T rho = rot * in.theta;
  const T pfo0 = w.at(F_PFO, 0), cls1 = w.at(F_CLS, 1), a01 = w.at(F_A0, 1);

  // 1. the AFS term: back through xlogy, the normalization, W and the sums over intervals,
  //    to each interval's hazard, c dt and c (a lane its own intervals, over the pair counts)
  if (nm1 > 0) {
    each<G>([&](int l) {
      for (int r = l; r < R; r += G) w.dy[r] = (ga * w.tafs[r]) / w.y[r];
    });
    sync_lanes();
    Lanes<T> part;
    each<G>([&](int l) {
      T acc = T(0);
      for (int b = l; b < nm1; b += G) {
        T de = T(0);
        if (in.tr == nullptr) {
          de = w.dy[b];
        } else {
          for (int r = 0; r < R; ++r) de = de + w.dy[r] * in.tr[static_cast<size_t>(r) * nm1 + b];
        }
        w.desfs[b] = de / s.total;
        acc = acc + -(de * (w.esfs[b] / s.total));
      }
      part[l] = acc;
    });
    const T dtotal = lane_sum<G>(part);
    each<G>([&](int l) {
      for (int b = l; b < nm1; b += G) w.desfs[b] = w.desfs[b] + dtotal;
    });
    sync_lanes();
    each<G>([&](int l) {
      for (int jj = l; jj < nm1; jj += G) {
        T e = T(0);
        for (int b = 0; b < nm1; ++b) e = e + w.desfs[b] * in.w[static_cast<size_t>(b) * nm1 + jj];
        w.detjj[jj] = e;
      }
    });
    sync_lanes();
  }
  each<G>([&](int l) {
    for (int k = l * q; k < imin(M, l * q + q); ++k) {
      T dh = T(0), dcdt = T(0), dc = T(0);
      const T hx = w.at(F_HX, k), cdt = w.at(F_CDT, k), c = w.at(F_C, k);
      for (int jj = 0; jj < nm1; ++jj) {
        const T m = T((jj + 2) * (jj + 1) / 2), dterm = w.detjj[jj];
        const T hm = xexp(-(hx * m)), cm = c * m;
        T dhm;
        if (k < M - 1) {
          const T em = xexpm1(-(cdt * m));
          const T term = (hm * -em) / cm;
          const T dnum = dterm / cm;
          dc = dc + (-(dterm * (term / cm))) * m;
          dhm = dnum * -em;
          dcdt = dcdt + ((dnum * hm) * (em + T(1))) * m;
        } else {
          const T term = hm / cm;
          dc = dc + (-(dterm * (term / cm))) * m;
          dhm = dterm / cm;
        }
        dh = dh + (-(dhm * hm)) * m;
      }
      w.at(F_DHX, k) = dh;
      w.at(F_DCDT, k) = dcdt;
      w.at(F_DC, k) = dc;
    }
  });

  // 2. pi: back to the hazard before and through each interval, then its prefix sum's
  //    adjoint (a suffix scan) into c dt
  const T dint = -(g[6 * M] * passes(T(1) - s.interior, T(1e-20), T(1.0 - 1e-20)));
  Lanes<T> hpart;
  each<G>([&](int l) {
    T acc = T(0);
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      T dhx = w.at(F_DHX, j), dhi = T(0);
      if (j >= 1) {
        const bool finite = j < M - 1;
        const T hx = w.at(F_HX, j), sp = xexp(-hx);
        const T sj = finite ? xexp(-(hx + w.at(F_CDT, j))) : T(0);
        const T it = finite ? -(sj - sp) : -(T(0) - sp);
        const T dit = g[6 * M + j] * passes(it, T(1e-20), T(1.0 - 1e-20)) + dint;
        if (finite) dhi = sj * dit;
        dhx = dhx - sp * dit;
      }
      w.at(F_DHX, j) = dhx;
      w.at(F_DHI, j) = dhi;
      acc = acc + (dhx + dhi);
    }
    hpart[l] = acc;
  });
  const Lanes<T> hlater = after<G>(hpart, Add<T>(), T(0));
  each<G>([&](int l) {
    T run = hlater[l];
    for (int j = imin(M, l * q + q) - 1; j >= l * q; --j) {
      w.at(F_DCDT, j) = w.at(F_DCDT, j) + (w.at(F_DHI, j) + run);
      run = run + (w.at(F_DHX, j) + w.at(F_DHI, j));
    }
  });

  // 3. v and u, then row 0 of the transition, then the log-survival sum's adjoint (a suffix
  //    scan) into p_surv
  Lanes<T> part;
  each<G>([&](int l) {
    T acc = T(0);
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      if (j == M - 1) w.at(F_DPFO, j) = T(0);  // u_{M-1} = 0
      if (j == 0) {
        w.at(F_DPC, 0) = T(0);  // p_coal[0] reaches neither u nor A[0, .]
        continue;
      }
      const T v = w.at(F_A0, j) / a01;
      const T pw = w.at(F_PFO, j - 1) * w.at(F_PC, j);
      const T g2 = g[2 * M + j - 1];
      const T dv = g[3 * M + j] + -(g2 * ((clip20(pw) / v) / v));
      const T dpw = (g2 / v) * passes(pw, T(1e-20), T(1.0 - 1e-20));
      w.at(F_DPFO, j - 1) = dpw * w.at(F_PC, j);
      w.at(F_DPC, j) = dpw * w.at(F_PFO, j - 1);
      w.at(F_DA0, j) = dv / a01;
      acc = acc + -(dv * (v / a01));
    }
    part[l] = acc;
  });
  const T da01 = lane_sum<G>(part);
  Lanes<T> p0part;
  each<G>([&](int l) {
    T a_p = T(0), a_c = T(0);
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      if (j == 0) {
        w.at(F_DCLS, 0) = T(0);
        continue;
      }
      const T da0 = j == 1 ? w.at(F_DA0, j) + da01 : w.at(F_DA0, j);
      const T E = xexp(w.at(F_CLS, j) - cls1), t = pfo0 * E, pc = w.at(F_PC, j);
      const T dpre = da0 * passes(t * pc, T(1e-20), T(1.0 - 1e-20));
      const T dt = dpre * pc;
      w.at(F_DPC, j) = w.at(F_DPC, j) + dpre * t;
      a_p = a_p + dt * E;
      const T dz = (dt * pfo0) * E;
      w.at(F_DCLS, j) = dz;
      a_c = a_c - dz;
    }
    p0part[l] = a_p;
    part[l] = a_c;
  });
  const T dpfo0 = lane_sum<G>(p0part), dcls1 = lane_sum<G>(part);
  each<G>([&](int l) {
    T acc = T(0);
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      if (j == 1) w.at(F_DCLS, 1) = w.at(F_DCLS, 1) + dcls1;
      acc = acc + w.at(F_DCLS, j);
    }
    part[l] = acc;
  });
  const Lanes<T> clater = after<G>(part, Add<T>(), T(0));
  each<G>([&](int l) {
    T run = clater[l];
    for (int j = imin(M, l * q + q) - 1; j >= l * q; --j) {
      w.at(F_DPS, j) = run / w.at(F_PS, j);
      run = run + w.at(F_DCLS, j);
    }
  });
  sync_lanes();

  // 4. the diagonals, the sub-diagonal and p_float_out: the loss's direct derivatives in the
  //    occupancy, the absorptions' in p02 / p12; then the occupancy's adjoint
  each<G>([&](int l) {
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      const T r0 = w.at(F_R0, j), r1 = w.at(F_R1, j);
      const T e0 = w.at(F_AE0, j), e1 = w.at(F_AE1, j);
      const T esc = w.at(F_ESC, j), pb = w.at(F_PB, j);
      const T qa02 = w.at(F_QA + 4, j), qa12 = w.at(F_QA + 5, j);
      const T dpfo = j == 0 ? w.at(F_DPFO, 0) + dpfo0 : w.at(F_DPFO, j);
      const T dq = dpfo * passes(e1 * esc, T(1e-8), T(1.0 - 1e-8));
      T de1 = dq * esc;
      const T inc_a = r0 * qa02 + r1 * qa12;
      const T dpre = g[M + j] * passes((e0 + e1 * pb) + inc_a, T(1e-20), T(1.0 - 1e-20));
      T de0 = dpre, dinc = dpre;
      de1 = de1 + dpre * pb;
      w.at(F_DESC, j) = dq * e1;
      w.at(F_DPB, j) = dpre * e1;
      if (j < M - 1) {
        const T qb02 = w.at(F_QB + 4, j), qb12 = w.at(F_QB + 5, j);
        const T ds = g[j] * passes(inc_a + (e0 * qb02 + e1 * qb12), T(1e-20), T(1.0 - 1e-20));
        dinc = dinc + ds;
        de0 = de0 + ds * qb02;
        de1 = de1 + ds * qb12;
        w.at(F_GQB + 4, j) = ds * e0;
        w.at(F_GQB + 5, j) = ds * e1;
      }
      w.at(F_DR0, j) = dinc * qa02;
      w.at(F_DR1, j) = dinc * qa12;
      w.at(F_DE0, j) = de0;
      w.at(F_DE1, j) = de1;
      w.at(F_GQA + 4, j) = dinc * r0;
      w.at(F_GQA + 5, j) = dinc * r1;
    }
  });
  occupancy_adjoint<G>(w);

  // 5. each interval's local adjoint, one dual evaluation a function: the blocks in
  //    (dg, c, rho), the escape terms in (d_et, c, c dt), the emissions in e_j, the expected
  //    time in (t_j, t_{j+1}, c)
  Lanes<T> drho_p;
  each<G>([&](int l) {
    T arho = T(0);
    for (int j = l * q; j < imin(M, l * q + q); ++j) {
      const bool finite = j < M - 1;
      const T c = w.at(F_C, j);
      T da[3] = {T(0), T(0), T(0)};  // d_te, c, rho
      contract(sub_interval(seed<T, 3>(w.at(F_DTE, j), 0), seed<T, 3>(c, 1), seed<T, 3>(rho, 2)),
               w, F_GQA, j, da);
      T dc = w.at(F_DC, j) + da[1], dcdt = w.at(F_DCDT, j);
      T ddet = T(0);
      arho = arho + da[2];
      if (finite) {
        T db[3] = {T(0), T(0), T(0)};  // d_et, c, rho
        contract(sub_interval(seed<T, 3>(w.at(F_DET, j), 0), seed<T, 3>(c, 1), seed<T, 3>(rho, 2)),
                 w, F_GQB, j, db);
        arho = arho + db[2];
        const Post<D3> po = post_finite(seed<T, 3>(w.at(F_DET, j), 0), seed<T, 3>(c, 1),
                                        seed<T, 3>(w.at(F_CDT, j), 2));
        const T gpo[4] = {w.at(F_DPB, j), w.at(F_DESC, j), w.at(F_DPS, j), w.at(F_DPC, j)};
        T dpo[3];
        for (int i = 0; i < 3; ++i)
          dpo[i] = ((gpo[0] * po.p_back.d[i] + gpo[1] * po.esc.d[i]) + gpo[2] * po.ps.d[i]) +
                   gpo[3] * po.pc.d[i];
        ddet = db[0] + dpo[0];
        dc = (dc + db[1]) + dpo[1];
        dcdt = dcdt + dpo[2];
      }
      D1 em0, em1;
      emissions(seed<T, 1>(w.at(F_ECT, j), 0), in.theta, em0, em1);
      const T dect = g[4 * M + j] * em0.d[0] + g[5 * M + j] * em1.d[0];
      const T t0 = w.at(F_T0, j), tn = w.at(F_T1, j);
      const D3 s0 = seed<T, 3>(t0, 0), s1 = seed<T, 3>(tn, 1), sc = seed<T, 3>(c, 2);
      const Pre<D3> pr = finite ? pre_finite(s0, s1, sc) : pre_last(s0, sc);
      T dpre[3];
      for (int i = 0; i < 3; ++i)
        dpre[i] = ((dcdt * pr.cdt.d[i] + da[0] * pr.d_te.d[i]) + ddet * pr.d_et.d[i]) +
                  dect * pr.ect.d[i];
      w.at(F_DC, j) = dc + dpre[2];
      w.at(F_DT0, j) = dpre[0];
      w.at(F_DT1, j) = dpre[1];
    }
    drho_p[l] = arho;
  });
  const T drho = lane_sum<G>(drho_p);
  sync_lanes();

  // 6. the grid points t_{i+1} = exp(lo + span i / (M - 2)), i < M - 1: each one's derivative
  //    from its two intervals first (their shares through t_{i+1} - t_i nearly cancel), then
  //    its share of (lo, span)
  Lanes<T> dlo_p, dspan_p;
  each<G>([&](int l) {
    T alo = T(0), asp = T(0);
    for (int i = l * q; i < imin(M - 1, l * q + q); ++i) {
      const T z = (w.at(F_DT1, i) + w.at(F_DT0, i + 1)) * w.at(F_T1, i);
      alo = alo + z;
      asp = asp + z * (T(i) / T(M - 2));
    }
    dlo_p[l] = alo;
    dspan_p[l] = asp;
  });
  const T dlo = lane_sum<G>(dlo_p), dspan = lane_sum<G>(dspan_p);

  // 7. the coordinates: the grid's ends, each rate group (its intervals' rates in order, and
  //    the prior's smoothness), rho / theta; each with the prior's ridge
  const T dtM = dspan / tM;
  const T dt1 = (dlo - dspan) / t1 + dtM;
  const T lx = xlog(rot);
  const T drot = drho * in.theta + -(gp * lx) / rot;
  const T dridge = -(gp * in.beta), dsmooth = -(gp * in.alpha);
  each<G>([&](int l) {
    for (int d = l; d < D; d += G) {
      T v;
      if (d == 0) {
        v = dt1 * t1;
      } else if (d == 1) {
        v = dtM * e1;
      } else if (d == D - 1) {
        v = (drot * T(9.9)) * ((T(1) - ysig) * ysig);
      } else {
        const int k = d - 2;
        T dcg = T(0);
        for (int j = 0; j < M; ++j)
          if (in.expand[j] == k) dcg = dcg + w.at(F_DC, j);
        const T ck = softplus(xp[d]), lck = xlog(ck);
        T dl = T(0);
        if (k >= 1) {
          const T df = lck - xlog(softplus(xp[d - 1]));
          dl = dl + dsmooth * (T(2) * df);
        }
        if (k + 1 < K) {
          const T df = xlog(softplus(xp[d + 1])) - lck;
          dl = dl - dsmooth * (T(2) * df);
        }
        v = (dcg + dl / ck) * softplus(seed<T, 1>(xp[d], 0)).d[0];
      }
      const T rg = dridge * xp[d];
      grad[static_cast<size_t>(p) * D + d] = v + (rg + rg);
    }
  });
}

}  // namespace phlash_assembly
