// Dense-transition adjoint kernel (replaces the TPU kernel B5:
// phlash_tpu/ops/pallas_hmm_vjp.py backward_packed, body _bwd_kernel).
//
// A group of G = 16 / SPL lanes runs one (particle, chunk) HMM backwards over
// its periods of PACKED_PERIOD sites, SPL states a lane (PACKED_BWD_SPL = 1:
// 16 lanes, 2 instances a warp).  A lane keeps its columns of A (for
// v = alpha A), its rows of A (for abar <- w A^T) and its rows of dA in
// registers.  For each period, last first:
//   rebuild   from the period's checkpoint with the forward's arithmetic
//             (packed_site), caching in registers each site's alpha before
//             it and v for the lane's states, and the site's rc = 1 / c
//   reverse   per site:
//             ubar = (abar - <abar, alpha> + g) rc;  w = live ? ubar f : 0
//             abar <- live ? w A^T : abar;  dA[m, :] += alpha_prev[m] w
//             de0/de1 += v ubar (routed by the observation, live only)
// and dpi = the final abar.  Gradients are written per instance; the
// wrapper sums the chunk axis for the per-particle A and emissions.
//
// Bound on the H100: as the forward, the per-site dependence chain of B*S
// HMMs, about twice the forward's work a site, and the shuffle pipe that
// the 1260 warps share (38 shuffles a site a warp).  The design:
// - no history in device memory: the period's cache lives in registers (a
//   scratch of alpha and v for every site of a 256-site segment would be
//   82 MB at the fit shape, more than the 50 MB L2), and the previous
//   period's checkpoint is loaded before the current period's work;
// - the w values that form w A^T by shuffles also form the lane's rows of
//   dA, so the rank-one update costs no shuffle;
// - <abar, alpha> off the chain: abar = w' A^T and v' = alpha A for the
//   live site after this one, so <abar, alpha> = sum_j w'_j v'_j, whose
//   butterfly runs beside the shuffles of w' A^T instead of before them;
// - one reciprocal a site, cached; nothing branches on the observation;
// - one state a lane: 2 or 4 states a lane need more than 255 registers
//   with this cache and spill (PERF.md has the measurements).
#include "packed_common.cuh"

using namespace phlash;

template <int SPL>
__global__ void __launch_bounds__(Group<PM, SPL>::THREADS)
packed_backward_kernel(const float* __restrict__ A, const float* __restrict__ e0,
                       const float* __restrict__ e1, const int8_t* __restrict__ obs,
                       const float* __restrict__ ckpt, const float* __restrict__ gbar, int B,
                       int S, int L, float* __restrict__ dA, float* __restrict__ de0,
                       float* __restrict__ de1, float* __restrict__ dpi) {
  constexpr int G = PM / SPL;
  constexpr int P = PACKED_PERIOD;
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<G>(B, S);
  const int m0 = me.lane * SPL;

  float cols[PM][SPL], rows[PM][SPL], drows[PM][SPL], f0[SPL], f1[SPL];
  const float* Ap = A + static_cast<size_t>(me.p) * PM * PM;
  load_columns<SPL>(Ap, me.lane, cols);
  load_rows<SPL>(Ap, me.lane, rows);
  load_params<SPL>(e0 + me.p * PM + m0, f0);
  load_params<SPL>(e1 + me.p * PM + m0, f1);
  const float g = gbar[me.i];
  float ab[SPL], g0[SPL], g1[SPL];
  // <abar, alpha> of the site being swept: sum_j w_j v_j of the live site
  // after it (abar = w A^T and v = alpha A), 0 before any
  float dot = 0.f;
#pragma unroll
  for (int r = 0; r < SPL; ++r) {
    ab[r] = g0[r] = g1[r] = 0.f;
#pragma unroll
    for (int k = 0; k < PM; ++k) drows[k][r] = 0.f;
  }

  // period q's checkpoint is ckpt[q, i, m0:m0+SPL]
  const float* ck = ckpt + me.i * PM + m0;
  const size_t per_stride = static_cast<size_t>(B) * S * PM;
  const int n_per = (L + P - 1) / P;
  float next[SPL];  // the checkpoint of the period being reached, in flight
  load_states<SPL>(ck + static_cast<size_t>(n_per - 1) * per_stride, next);

  const int8_t* row = obs + static_cast<size_t>(me.s) * L;
  for (int t0 = (L - 1) / OBS_TILE * OBS_TILE; t0 >= 0; t0 -= OBS_TILE) {
    const int n = min(OBS_TILE, L - t0);
    __syncthreads();  // the previous tile's readers are done
    const int mis = stage_obs(row + t0, n, sh);
    __syncthreads();
    for (int j0 = (n - 1) / P * P; j0 >= 0; j0 -= P) {
      const int q = (t0 + j0) / P;
      float x[SPL], rho = 1.f;  // alpha = x * rho
#pragma unroll
      for (int r = 0; r < SPL; ++r) x[r] = next[r];
      load_states<SPL>(ck + static_cast<size_t>(max(q - 1, 0)) * per_stride, next);

      // the period's codes, 2 bits a site (ob + 2)
      unsigned codes = 0;
#pragma unroll
      for (int j = 0; j < P; ++j)
        codes |= static_cast<unsigned>((j0 + j < n ? sh[mis + j0 + j] : -2) + 2) << (2 * j);

      // rebuild the period from its checkpoint
      float xs[P][SPL], vs[P][SPL], rcs[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
#pragma unroll
        for (int r = 0; r < SPL; ++r) xs[j][r] = x[r] * rho;
        packed_site<SPL>(x, rho, static_cast<int>((codes >> (2 * j)) & 3u) - 2, cols, f0, f1,
                         vs[j], rcs[j]);
      }

      // the period's sites in reverse
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        const int ob = static_cast<int>((codes >> (2 * j)) & 3u) - 2;
        const bool live = ob != -2;
        float ubar[SPL], w[SPL], wv[SPL], abn[SPL];
#pragma unroll
        for (int r = 0; r < SPL; ++r) {
          ubar[r] = (ab[r] - dot + g) * rcs[j];
          w[r] = select(live, ubar[r] * emission(ob, f0[r], f1[r]), 0.f);
          wv[r] = w[r] * vs[j][r];
        }
        times<SPL>(w, rows, abn, [&](int k, float wk) {
#pragma unroll
          for (int r = 0; r < SPL; ++r) drows[k][r] = fmaf(xs[j][r], wk, drows[k][r]);
        });
        // the next site's <abar, alpha>, beside this site's w A^T
        dot = select(live, group_sum<G, SPL>(wv), dot);
#pragma unroll
        for (int r = 0; r < SPL; ++r) {
          ab[r] = select(live, abn[r], ab[r]);
          const float dfull = vs[j][r] * ubar[r];
          g0[r] += select(ob == 0, dfull, 0.f);
          g1[r] += select(ob == 1, dfull, 0.f);
        }
      }
    }
  }

  if (!me.active) return;
  float* dAi = dA + me.i * PM * PM;
#pragma unroll
  for (int k = 0; k < PM; ++k)
#pragma unroll
    for (int r = 0; r < SPL; ++r) dAi[(m0 + r) * PM + term_state<SPL>(me.lane, k)] = drows[k][r];
  const size_t o = me.i * PM + m0;
  store_states<SPL>(de0 + o, g0);
  store_states<SPL>(de1 + o, g1);
  store_states<SPL>(dpi + o, ab);
}

extern "C" int phlash_packed_backward(const float* A, const float* e0, const float* e1,
                                      const int8_t* obs, const float* ckpt, const float* gbar,
                                      int B, int S, int L, float* dA, float* de0, float* de1,
                                      float* dpi, void* stream) {
  if (B <= 0 || S <= 0 || S > 65535 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int SPL = PACKED_BWD_SPL;
  const dim3 grid((B + INSTANCES_PER_BLOCK - 1) / INSTANCES_PER_BLOCK, S);
  packed_backward_kernel<SPL><<<grid, Group<PM, SPL>::THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      A, e0, e1, obs, ckpt, gbar, B, S, L, dA, de0, de1, dpi);
  return static_cast<int>(cudaGetLastError());
}
