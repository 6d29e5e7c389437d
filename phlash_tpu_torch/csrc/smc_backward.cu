// Structured SMC' adjoint kernel (replaces the TPU kernel B3:
// phlash_tpu/ops/pallas_smc.py backward_structured, body _make_bwd_kernel).
//
// A group of G = M / SPL lanes runs one (particle, chunk) HMM backwards over
// its periods, SPL states a lane.  For each period (reversed) it rebuilds the
// period's NORM_EVERY sites from the stored boundary state, caching each
// site's input state x, S(x) and P(u x) in registers, then:
//   at the boundary   ybar = (abar - <abar, a/c> + g) / c
//   per site, reversed:
//     vbar = f * ybar;  de0/de1 += v * ybar (routed by the observation)
//     db += S(x) vbar;  dd += x vbar;  dvv += P(u x) vbar;  du += x S(vv vbar)
//     xbar = P(b vbar) + d vbar + u S(vv vbar)     (padding passes through)
// and dpi = the final abar.  Gradients are written per instance (B, S, M);
// the wrapper sums the chunk axis for the per-particle parameters.
//
// Bound on the H100: as the forward, the dependence chain of B*S HMMs: per
// site one scan pair in the rebuild and one in the reverse sweep (the cached
// S(x), P(u x) spare the two others), two butterflies a period.  The design
// keeps everything a lane needs in registers (the 8-site cache, the six
// gradient accumulators: no local memory), issues the load of the previous
// period's boundary state before the current period's work so its latency
// leaves the chain, and stages the observation row in shared memory as the
// forward does.  See ops/smc.py for the design note.
#include "smc_common.cuh"

using namespace phlash;

template <int M, int SPL>
__global__ void __launch_bounds__(Group<M, SPL>::THREADS)
smc_backward_kernel(const float* __restrict__ b, const float* __restrict__ d,
                    const float* __restrict__ u, const float* __restrict__ vv,
                    const float* __restrict__ e0, const float* __restrict__ e1,
                    const int8_t* __restrict__ obs, const float* __restrict__ pstates,
                    const float* __restrict__ gbar, const float* __restrict__ abar0,
                    int B, int S, int L, float* __restrict__ db, float* __restrict__ dd,
                    float* __restrict__ du, float* __restrict__ dvv,
                    float* __restrict__ de0, float* __restrict__ de1,
                    float* __restrict__ dpi) {
  constexpr int G = Group<M, SPL>::G;
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<G>(B, S);
  const int m0 = me.lane * SPL;

  float rb[SPL], rd[SPL], ru[SPL], rv[SPL], r0[SPL], r1[SPL], ab[SPL];
  const size_t prow = static_cast<size_t>(me.p) * M + m0;
  load_params<SPL>(b + prow, rb);
  load_params<SPL>(d + prow, rd);
  load_params<SPL>(u + prow, ru);
  load_params<SPL>(vv + prow, rv);
  load_params<SPL>(e0 + prow, r0);
  load_params<SPL>(e1 + prow, r1);
  load_params<SPL>(abar0 + me.i * M + m0, ab);
  const float g = gbar[me.i];

  float gb[SPL], gd[SPL], gu[SPL], gv[SPL], g0[SPL], g1[SPL];
#pragma unroll
  for (int r = 0; r < SPL; ++r) gb[r] = gd[r] = gu[r] = gv[r] = g0[r] = g1[r] = 0.f;

  // period q's boundary state is pstates[q, s, p, m0:m0+SPL]
  const float* pst = pstates + (static_cast<size_t>(me.s) * B + me.p) * M + m0;
  const size_t per_stride = static_cast<size_t>(S) * B * M;
  const int n_per = (L + NORM_EVERY - 1) / NORM_EVERY;
  float next[SPL];  // the boundary state of the period after this one, in flight
  load_states<SPL>(pst + static_cast<size_t>(n_per - 1) * per_stride, next);

  const int8_t* row = obs + static_cast<size_t>(me.s) * L;
  for (int t0 = (L - 1) / OBS_TILE * OBS_TILE; t0 >= 0; t0 -= OBS_TILE) {
    const int n = min(OBS_TILE, L - t0);
    __syncthreads();  // the previous tile's readers are done
    const int mis = stage_obs(row + t0, n, sh);
    __syncthreads();
    for (int j0 = (n - 1) / NORM_EVERY * NORM_EVERY; j0 >= 0; j0 -= NORM_EVERY) {
      const int q = (t0 + j0) / NORM_EVERY;
      float a[SPL];
#pragma unroll
      for (int r = 0; r < SPL; ++r) a[r] = next[r];
      load_states<SPL>(pst + static_cast<size_t>(max(q - 1, 0)) * per_stride, next);

      int obv[NORM_EVERY];
#pragma unroll
      for (int j = 0; j < NORM_EVERY; ++j) obv[j] = j0 + j < n ? sh[mis + j0 + j] : -2;

      // rebuild the period from its boundary state
      float xs[NORM_EVERY][SPL], svs[NORM_EVERY][SPL], pvs[NORM_EVERY][SPL];
#pragma unroll
      for (int j = 0; j < NORM_EVERY; ++j) {
#pragma unroll
        for (int r = 0; r < SPL; ++r) xs[j][r] = a[r];
        advance<G, SPL>(a, obv[j], me.lane, rb, rd, ru, rv, r0, r1, svs[j], pvs[j]);
      }
      const float c = fmaxf(group_sum<G, SPL>(a), TINY_NORM);
      float y[SPL];
#pragma unroll
      for (int r = 0; r < SPL; ++r) y[r] = ab[r] * (a[r] / c);
      const float dot = group_sum<G, SPL>(y);
#pragma unroll
      for (int r = 0; r < SPL; ++r) y[r] = (ab[r] - dot + g) / c;

      // the period's sites in reverse
#pragma unroll
      for (int j = NORM_EVERY - 1; j >= 0; --j) {
        const int ob = obv[j];
        const bool live = ob != -2;
        float vbar[SPL], wv[SPL], wb[SPL], t1[SPL], pb[SPL];
#pragma unroll
        for (int r = 0; r < SPL; ++r) {
          const float yb = live ? y[r] : 0.f;
          const float v = rb[r] * svs[j][r] + rd[r] * xs[j][r] + rv[r] * pvs[j][r];
          const float dfull = v * yb;
          g0[r] += ob == 0 ? dfull : 0.f;
          g1[r] += ob == 1 ? dfull : 0.f;
          vbar[r] = emis_factor(ob, r0[r], r1[r]) * yb;
          gb[r] += svs[j][r] * vbar[r];
          gd[r] += xs[j][r] * vbar[r];
          gv[r] += pvs[j][r] * vbar[r];
          wv[r] = rv[r] * vbar[r];
          wb[r] = rb[r] * vbar[r];
        }
        scan_pair<G, SPL>(wv, wb, me.lane, t1, pb);  // S(vv vbar), P(b vbar)
#pragma unroll
        for (int r = 0; r < SPL; ++r) {
          gu[r] += xs[j][r] * t1[r];
          const float xbar = pb[r] + rd[r] * vbar[r] + ru[r] * t1[r];
          y[r] = live ? xbar : y[r];
        }
      }
#pragma unroll
      for (int r = 0; r < SPL; ++r) ab[r] = y[r];
    }
  }
  if (me.active) {
    const size_t o = me.i * M + m0;
    store_states<SPL>(db + o, gb);
    store_states<SPL>(dd + o, gd);
    store_states<SPL>(du + o, gu);
    store_states<SPL>(dvv + o, gv);
    store_states<SPL>(de0 + o, g0);
    store_states<SPL>(de1 + o, g1);
    store_states<SPL>(dpi + o, ab);
  }
}

extern "C" int phlash_smc_backward(const float* b, const float* d, const float* u,
                                   const float* vv, const float* e0, const float* e1,
                                   const int8_t* obs, const float* pstates, const float* gbar,
                                   const float* abar0, int B, int S, int L, int M,
                                   float* db, float* dd, float* du, float* dvv, float* de0,
                                   float* de1, float* dpi, void* stream) {
  if (B <= 0 || S <= 0 || S > 65535 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + INSTANCES_PER_BLOCK - 1) / INSTANCES_PER_BLOCK, S);
#define PHLASH_BWD(MM, SS)                                                              \
  if (M == MM) {                                                                        \
    smc_backward_kernel<MM, SS><<<grid, Group<MM, SS>::THREADS, 0, st>>>(               \
        b, d, u, vv, e0, e1, obs, pstates, gbar, abar0, B, S, L, db, dd, du, dvv, de0,  \
        de1, dpi);                                                                      \
    return static_cast<int>(cudaGetLastError());                                        \
  }
  PHLASH_SMC_INSTANCES(PHLASH_BWD)
#undef PHLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
