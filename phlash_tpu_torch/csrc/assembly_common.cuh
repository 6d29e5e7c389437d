// The step's assembly, written once for the two kernels of csrc/assembly.cu:
// one particle's flat coordinates -> its seven PSMCParams leaves, its log
// prior and its AFS term, as ops/assembly.py's plain version computes them
// (params.MCMCParams.to_dm -> PSMCParams.from_dm with transition.
// transition_matrix and SizeHistory.ect / pi; model.log_prior; model.log_afs
// with SizeHistory.etjj / etbl).
//
// `assemble<N>` is a template over the number type N: float or double for
// the forward kernel (A1), Dual<float> or Dual<double> for the gradient
// kernel (A2), whose thread seeds one coordinate's tangent and carries it
// through the same operations.  So every branch (texp_mean's Taylor switch,
// expm1inv, _expQ2's tiny / series / w <= 0 cases, the degenerate
// sub-intervals, the clamps) is taken on the values, as torch's autograd
// takes it, and each primitive's tangent is the derivative torch's autograd
// uses for it (clamp passes the tangent at equality, abs has sign(0) = 0,
// expm1' = result + 1, sqrt' = 1 / (2 result), xlogy's y-derivative x / y).
//
// Streaming: the 2M - 1 sub-interval product, the exclusive log-survival
// sum, the hazard prefix sums and the M x M transition matrix (of which
// from_dm reads only the three diagonals and row 0) are never built; a
// thread walks the intervals once, carrying the occupancy (r0, r1), the
// prefix sums and the previous interval's p_float_out.  The AFS term needs
// every interval's rate and c * dt again for each of its n - 1 pair counts,
// and the n - 1 branch lengths before it can normalize: those live in a
// scratch buffer in device memory (the wrapper's), slot k of thread i at
// scratch[k * threads + i], so no per-thread array has a compile-time size
// and any M or n the plain version takes is taken here.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else  // a host C++ compiler: tests/test_torch_assembly.py runs this code on the CPU
#define __device__
#define __forceinline__ inline
#endif

namespace phlash_assembly {

#ifndef __CUDACC__
using std::isfinite;
using std::isnan;
#endif

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

// ---------------------------------------------------------------------------
// dual numbers: (value, tangent along one coordinate)
// ---------------------------------------------------------------------------

template <class T>
struct Dual {
  T v, d;
  __device__ __forceinline__ Dual(T v_ = T(0), T d_ = T(0)) : v(v_), d(d_) {}
};

template <class N> struct Scalar { using type = N; };
template <class T> struct Scalar<Dual<T>> { using type = T; };

template <class T>
__device__ __forceinline__ T val(Dual<T> x) { return x.v; }

template <class T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <class T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <class T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.d}; }
template <class T>
__device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.d}; }
template <class T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <class T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }
template <class T>
__device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }
template <class T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <class T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }
template <class T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }
template <class T>
__device__ __forceinline__ Dual<T> operator/(T a, Dual<T> b) {
  const T q = a / b.v;
  return {q, -q * b.d / b.v};
}

template <class T>
__device__ __forceinline__ Dual<T> xexp(Dual<T> x) {
  const T e = xexp(x.v);
  return {e, e * x.d};
}
template <class T>
__device__ __forceinline__ Dual<T> xexpm1(Dual<T> x) {
  const T e = xexpm1(x.v);
  return {e, (e + T(1)) * x.d};
}
template <class T>
__device__ __forceinline__ Dual<T> xlog(Dual<T> x) { return {xlog(x.v), x.d / x.v}; }
template <class T>
__device__ __forceinline__ Dual<T> xlog1p(Dual<T> x) {
  return {xlog1p(x.v), x.d / (x.v + T(1))};
}
template <class T>
__device__ __forceinline__ Dual<T> xsqrt(Dual<T> x) {
  const T r = xsqrt(x.v);
  return {r, x.d / (T(2) * r)};
}
template <class T>
__device__ __forceinline__ Dual<T> xabs(Dual<T> x) {
  const T s = x.v > T(0) ? T(1) : (x.v < T(0) ? T(-1) : T(0));  // torch's sign: 0 at 0
  return {xabs(x.v), s * x.d};
}
template <class T>
__device__ __forceinline__ Dual<T> clampv(Dual<T> x, T lo, T hi) {
  return {clampv(x.v, lo, hi), (x.v >= lo && x.v <= hi) ? x.d : T(0)};
}
template <class T>
__device__ __forceinline__ Dual<T> clamp_minv(Dual<T> x, T lo) {
  return {clamp_minv(x.v, lo), x.v >= lo ? x.d : T(0)};
}
template <class T>
__device__ __forceinline__ Dual<T> sigmoid(Dual<T> x) {
  const T y = sigmoid(x.v);
  return {y, x.d * ((T(1) - y) * y)};
}
template <class T>
__device__ __forceinline__ Dual<T> xlogy(T x, Dual<T> y) {
  return {xlogy(x, y.v), x * y.d / y.v};
}

// ---------------------------------------------------------------------------
// the assembly's pieces, generic in N
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ Block<N> sub_interval(N dg, N c, N rho) {
  using T = typename Scalar<N>::type;
  // torch.isclose(dg, 0): dg == 0, or |dg| finite and <= atol (1e-8)
  const T dv = val(dg);
  if (dv == T(0) || (isfinite(dv) && xabs(dv) <= T(1e-8)))
    return {N(T(1)), N(T(0)), N(T(0)), N(T(1)), N(T(0)), N(T(0))};
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

// Assemble particle p.  `seed` is the coordinate whose tangent is 1 (Dual N;
// ignored otherwise); `scr` the thread's scratch (slot k at scr[k * ss]).
// `out` takes out.leaf(f, j, value), out.prior(value), out.afs(value).
template <class N, class T, class Out>
__device__ void assemble(const Inputs<T>& in, int p, int seed, N* scr, size_t ss, Out& out) {
  const int D = in.D, M = in.M, K = D - 3;
  const T* xp = in.x + static_cast<size_t>(p) * D;
  auto coord = [&](int d) {
    N c = N(xp[d]);
    if constexpr (!std::is_same<N, T>::value) c.d = d == seed ? T(1) : T(0);
    return c;
  };
  auto clip = [](N a) { return clampv(a, T(1e-20), T(1.0 - 1e-20)); };
  auto clip8 = [](N a) { return clampv(a, T(1e-8), T(1.0 - 1e-8)); };

  // to_dm: t = [0, geomspace(t1, tM, M - 1)], c = softplus(c_tr)[expand]
  const N t1 = xexp(coord(0));
  const N tM = t1 + xexp(coord(1));
  const N lo = xlog(t1);
  const N span = xlog(tM) - lo;
  auto grid = [&](int i) { return xexp(lo + span * (T(i) / T(M - 2))); };  // t_{i+1}
  auto rate = [&](int j) { return softplus(coord(2 + static_cast<int>(in.expand[j]))); };
  const N rot = T(0.1) + T(9.9) * sigmoid(coord(D - 1));
  const N rho = rot * in.theta;

  // log_prior
  {
    const N lx = xlog(rot);
    N lp = -(T(1.8378770664093453) + lx * lx) / T(2);  // log(2 pi)
    N smooth = N(T(0));
    N prev = xlog(softplus(coord(2)));
    for (int k = 1; k < K; ++k) {
      const N cur = xlog(softplus(coord(2 + k)));
      const N df = cur - prev;
      smooth = smooth + df * df;
      prev = cur;
    }
    lp = lp - in.alpha * smooth;
    N ridge = N(T(0));
    for (int d = 0; d < D; ++d) {
      const N xd = coord(d);
      ridge = ridge + xd * xd;
    }
    out.prior(lp - in.beta * ridge);
  }

  // one walk over the intervals j = 0 .. M-1
  N r0 = N(T(1)), r1 = N(T(0));    // live occupancy entering sub-interval 2j
  N t_j = N(T(0)), c_j = rate(0);
  N haz = N(T(0));                 // sum of c dt over the intervals before j + 1
  N surv_prev = N(T(0)), interior = N(T(0));
  N cls = N(T(0)), cls1 = N(T(0)); // exclusive log-survival sums cls[j], cls[1]
  N pfo0 = N(T(0)), pfo_prev = N(T(0)), a01 = N(T(1));
  for (int j = 0; j < M; ++j) {
    const bool finite = j < M - 1;
    N t_next, dt, cdt, d_te, d_et, ect;
    if (finite) {
      t_next = grid(j);
      dt = t_next - t_j;
      cdt = c_j * dt;
      const N g = texp_mean(cdt);
      d_te = clamp_minv(dt * g, T(0));
      d_et = clamp_minv(dt * (T(1) - g), T(0));
      ect = t_j + dt * g;
      scr[(M + j) * ss] = cdt;
    } else {
      d_te = T(1) / c_j;
      ect = t_j + T(1) / c_j;
    }
    scr[j * ss] = c_j;

    // emissions in theta * E[coalescence time in the interval]
    const N lam = clamp_minv(ect, T(1e-20)) * in.theta;
    out.leaf(4, j, clip(xexp(-lam)));
    out.leaf(5, j, clip(-xexpm1(-lam)));

    // the sub-intervals t_j -> e_j (and e_j -> t_{j+1})
    const Block<N> qa = sub_interval(d_te, c_j, rho);
    const N inc_a = r0 * qa.p02 + r1 * qa.p12;
    N n0 = r0 * qa.p00 + r1 * qa.p10;
    N n1 = r0 * qa.p01 + r1 * qa.p11;
    const N at_e0 = n0, at_e1 = n1;
    N inc_b, p_back, esc, p_surv, p_coal;
    if (finite) {
      const Block<N> qb = sub_interval(d_et, c_j, rho);
      inc_b = at_e0 * qb.p02 + at_e1 * qb.p12;
      n0 = at_e0 * qb.p00 + at_e1 * qb.p10;
      n1 = at_e0 * qb.p01 + at_e1 * qb.p11;
      const N dc = d_et * c_j;
      p_back = -xexpm1(-dc);
      esc = xexp(-dc);
      p_surv = xexp(-cdt);
      p_coal = -xexpm1(-cdt);
    } else {
      inc_b = at_e0 + at_e1;  // the absorbing tail
      p_back = N(T(1));
      esc = N(T(0));
      p_surv = N(T(0));
      p_coal = N(T(1));
    }
    r0 = n0;
    r1 = n1;
    const N pfo = clip8(at_e1 * esc);
    p_surv = clip8(p_surv);
    p_coal = clip8(p_coal);

    // the transition's diagonals and row 0, clipped, then read off
    out.leaf(0, j, finite ? clip(inc_a + inc_b) : N(T(0)));
    out.leaf(1, j, clip((at_e0 + at_e1 * p_back) + inc_a));
    if (j == 0) {
      pfo0 = pfo;
      out.leaf(3, 0, N(T(0)));
    } else {
      const N a0j = clip((pfo0 * xexp(cls - cls1)) * p_coal);
      if (j == 1) a01 = a0j;
      const N vj = a0j / a01;
      out.leaf(3, j, vj);
      out.leaf(2, j - 1, clip(pfo_prev * p_coal) / vj);
    }
    pfo_prev = pfo;
    cls = cls + xlog(p_surv);
    if (j == 0) cls1 = cls;

    // pi: P(coalescence in interval j) from the survival at the breakpoints
    if (finite) {
      haz = haz + cdt;
      const N surv = xexp(-haz);
      if (j > 0) {
        const N it = -(surv - surv_prev);
        interior = interior + it;
        out.leaf(6, j, clip(it));
      }
      surv_prev = surv;
    } else {
      const N it = -(N(T(0)) - surv_prev);
      interior = interior + it;
      out.leaf(6, j, clip(it));
    }
    if (finite) {
      t_j = t_next;
      c_j = rate(j + 1);
    }
  }
  out.leaf(2, M - 1, N(T(0)));
  out.leaf(6, 0, clip(T(1) - interior));

  // the AFS term: xlogy(T afs, T etbl / sum(etbl)), etbl = etjj W^T
  if (in.nm1 == 0) {
    out.afs(N(T(0)));
    return;
  }
  const int nm1 = in.nm1;
  N* etbl = scr + static_cast<size_t>(2 * M) * ss;
  for (int b = 0; b < nm1; ++b) etbl[b * ss] = N(T(0));
  for (int jj = 0; jj < nm1; ++jj) {
    const T m = T((jj + 2) * (jj + 1) / 2);  // pairs among jj + 2 lineages
    N h = N(T(0)), fsum = N(T(0));
    for (int k = 0; k < M - 1; ++k) {
      const N ck = scr[k * ss], cdtk = scr[(M + k) * ss];
      fsum = fsum + (xexp(-(h * m)) * -xexpm1(-(cdtk * m))) / (ck * m);
      h = h + cdtk;
    }
    const N etjj = fsum + xexp(-(h * m)) / (scr[(M - 1) * ss] * m);
    for (int b = 0; b < nm1; ++b) etbl[b * ss] = etbl[b * ss] + etjj * in.w[b * nm1 + jj];
  }
  N total = N(T(0));
  for (int b = 0; b < nm1; ++b) total = total + etbl[b * ss];
  for (int b = 0; b < nm1; ++b) etbl[b * ss] = etbl[b * ss] / total;  // esfs
  N l_afs = N(T(0));
  for (int r = 0; r < in.R; ++r) {
    T t_afs = T(0);
    N y = N(T(0));
    if (in.tr == nullptr) {
      t_afs = in.afs[r];
      y = etbl[r * ss];
    } else {
      const T* row = in.tr + static_cast<size_t>(r) * nm1;
      for (int b = 0; b < nm1; ++b) {
        t_afs = t_afs + row[b] * in.afs[b];
        y = y + etbl[b * ss] * row[b];
      }
    }
    l_afs = l_afs + xlogy(t_afs, y);
  }
  out.afs(l_afs);
}

}  // namespace phlash_assembly
