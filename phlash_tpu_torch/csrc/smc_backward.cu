// Structured SMC' adjoint kernel (replaces the TPU kernel B3:
// phlash_tpu/ops/pallas_smc.py backward_structured, body _make_bwd_kernel).
//
// Each thread runs one (particle, chunk) HMM backwards over its periods.
// For each period (reversed) it rebuilds the period's NORM_EVERY sites from
// the stored boundary state, caching the input state x of every site, then:
//   at the boundary   ybar = (abar - <abar, a/c> + g) / c
//   per site, reversed:
//     vbar = f * ybar;  de0/de1 += v * ybar (routed by the observation)
//     db += S(x) vbar;  dd += x vbar;  dvv += P(u x) vbar;  du += x S(vv vbar)
//     xbar = P(b vbar) + d vbar + u S(vv vbar)     (padding passes through)
// and dpi = the final abar.  Gradients are written per instance (B, S, M);
// the wrapper sums the chunk axis for the per-particle parameters.
//
// Bound: as the forward, a latency-bound chain per thread at only B*S
// threads; the site cache (NORM_EVERY * M floats) and the six gradient
// accumulators live in local memory, which L1 serves.  See ops/smc.py.
#include "smc_common.cuh"

using namespace phlash;

template <int M>
__global__ void __launch_bounds__(THREADS)
smc_backward_kernel(const float* __restrict__ b, const float* __restrict__ d,
                    const float* __restrict__ u, const float* __restrict__ vv,
                    const float* __restrict__ e0, const float* __restrict__ e1,
                    const int8_t* __restrict__ obs, const float* __restrict__ pstates,
                    const float* __restrict__ gbar, const float* __restrict__ abar0,
                    int B, int S, int L, float* __restrict__ db, float* __restrict__ dd,
                    float* __restrict__ du, float* __restrict__ dvv,
                    float* __restrict__ de0, float* __restrict__ de1,
                    float* __restrict__ dpi) {
  const int n = B * S;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = i / S;
  const int s = i - p * S;

  float rb[M], rd[M], ru[M], rv[M], r0[M], r1[M], ab[M];
  load_row<M>(b, p, rb);
  load_row<M>(d, p, rd);
  load_row<M>(u, p, ru);
  load_row<M>(vv, p, rv);
  load_row<M>(e0, p, r0);
  load_row<M>(e1, p, r1);
  load_row<M>(abar0, i, ab);
  const float g = gbar[i];

  float gb[M], gd[M], gu[M], gv[M], g0[M], g1[M];
#pragma unroll
  for (int m = 0; m < M; ++m) gb[m] = gd[m] = gu[m] = gv[m] = g0[m] = g1[m] = 0.f;

  const int8_t* row = obs + static_cast<size_t>(s) * L;
  const int n_per = (L + NORM_EVERY - 1) / NORM_EVERY;
  float xs[NORM_EVERY][M];
  for (int q = n_per - 1; q >= 0; --q) {
    // rebuild the period from its boundary state
    float a[M];
    const float* src = pstates + static_cast<size_t>(q) * M * n + i;
#pragma unroll
    for (int m = 0; m < M; ++m) a[m] = src[static_cast<size_t>(m) * n];
#pragma unroll
    for (int j = 0; j < NORM_EVERY; ++j) {
#pragma unroll
      for (int m = 0; m < M; ++m) xs[j][m] = a[m];
      const int ob = site_obs(row, q * NORM_EVERY + j, L);
      if (ob == -2) continue;
      float v[M];
      transition<M>(a, rb, rd, ru, rv, v);
#pragma unroll
      for (int m = 0; m < M; ++m) a[m] = v[m] * emis_factor(ob, r0[m], r1[m]);
    }
    float c = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) c += a[m];
    c = fmaxf(c, TINY_NORM);
    float dot = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) dot += ab[m] * (a[m] / c);
    float y[M];
#pragma unroll
    for (int m = 0; m < M; ++m) y[m] = (ab[m] - dot + g) / c;

    // the period's sites in reverse
#pragma unroll
    for (int j = NORM_EVERY - 1; j >= 0; --j) {
      const int ob = site_obs(row, q * NORM_EVERY + j, L);
      if (ob == -2) continue;
      const float* x = xs[j];
      float sv[M], pv[M], tmp[M], vbar[M];
      suffix_strict<M>(x, sv);
#pragma unroll
      for (int m = 0; m < M; ++m) tmp[m] = ru[m] * x[m];
      prefix_strict<M>(tmp, pv);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float v = rb[m] * sv[m] + rd[m] * x[m] + rv[m] * pv[m];
        const float dfull = v * y[m];
        if (ob == 0) g0[m] += dfull;
        if (ob == 1) g1[m] += dfull;
        vbar[m] = emis_factor(ob, r0[m], r1[m]) * y[m];
        gb[m] += sv[m] * vbar[m];
        gd[m] += x[m] * vbar[m];
        gv[m] += pv[m] * vbar[m];
      }
      float t1[M], pb[M];
#pragma unroll
      for (int m = 0; m < M; ++m) tmp[m] = rv[m] * vbar[m];
      suffix_strict<M>(tmp, t1);
#pragma unroll
      for (int m = 0; m < M; ++m) tmp[m] = rb[m] * vbar[m];
      prefix_strict<M>(tmp, pb);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        gu[m] += x[m] * t1[m];
        y[m] = pb[m] + rd[m] * vbar[m] + ru[m] * t1[m];
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) ab[m] = y[m];
  }
  store_row<M>(db, i, gb);
  store_row<M>(dd, i, gd);
  store_row<M>(du, i, gu);
  store_row<M>(dvv, i, gv);
  store_row<M>(de0, i, g0);
  store_row<M>(de1, i, g1);
  store_row<M>(dpi, i, ab);
}

template <int M>
static void launch(const float* b, const float* d, const float* u, const float* vv,
                   const float* e0, const float* e1, const int8_t* obs, const float* pstates,
                   const float* gbar, const float* abar0, int B, int S, int L, float* db,
                   float* dd, float* du, float* dvv, float* de0, float* de1, float* dpi,
                   cudaStream_t stream) {
  const int n = B * S;
  const int blocks = (n + THREADS - 1) / THREADS;
  smc_backward_kernel<M><<<blocks, THREADS, 0, stream>>>(
      b, d, u, vv, e0, e1, obs, pstates, gbar, abar0, B, S, L, db, dd, du, dvv, de0, de1, dpi);
}

extern "C" int phlash_smc_backward(const float* b, const float* d, const float* u,
                                   const float* vv, const float* e0, const float* e1,
                                   const int8_t* obs, const float* pstates, const float* gbar,
                                   const float* abar0, int B, int S, int L, int M, float* db,
                                   float* dd, float* du, float* dvv, float* de0, float* de1,
                                   float* dpi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PHLASH_BWD(MM)                                                                      \
  launch<MM>(b, d, u, vv, e0, e1, obs, pstates, gbar, abar0, B, S, L, db, dd, du, dvv, de0, \
             de1, dpi, st)
  switch (M) {
    case 8: PHLASH_BWD(8); break;
    case 16: PHLASH_BWD(16); break;
    case 32: PHLASH_BWD(32); break;
    case 64: PHLASH_BWD(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PHLASH_BWD
  return static_cast<int>(cudaGetLastError());
}
