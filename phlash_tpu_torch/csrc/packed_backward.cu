// Dense-transition adjoint kernel (replaces the TPU kernel B5:
// phlash_tpu/ops/pallas_hmm_vjp.py backward_packed, body _bwd_kernel).
//
// Each 16-lane half-warp runs one (particle, chunk) HMM backwards over its
// segments.  Lane j holds column j of A (for v = alpha A), row j of A (for
// abar <- w A^T) and accumulates column j of dA, de0[j], de1[j].  For each
// segment, last first:
//   rebuild   from the segment's checkpoint, storing alpha before each site
//             and v into the scratch `hist` (2, seg_len, B*S, 16)
//   reverse   per site, with c = sum(v * f) and alpha = v * f / c:
//             ubar = (abar - <abar, alpha> + g) / c;  w = live ? ubar * f : 0
//             dA[:, j] += alpha_prev * w_j;  abar <- live ? w A^T : abar
//             de0/de1 += v * ubar (routed by the observation, live only)
// and dpi = the final abar.  Gradients are written per instance; the
// wrapper sums the chunk axis for the per-particle A and emissions.
//
// Bound: as the forward, a dependence chain per half-warp, about three
// times the forward's operations per site (the rebuild, the transposed
// product and the rank-one dA update, 40 shuffles a site in the reverse
// sweep), plus the scratch: 2 * 16 floats per site per instance written
// and read once, coalesced across a warp.  See ops/packed.py.
#include "packed_common.cuh"

using namespace phlash;

__global__ void __launch_bounds__(PACKED_THREADS)
packed_backward_kernel(const float* __restrict__ A, const float* __restrict__ e0,
                       const float* __restrict__ e1, const int8_t* __restrict__ obs,
                       const float* __restrict__ ckpt, const float* __restrict__ gbar, int B,
                       int S, int L, int seg_len, float* __restrict__ hist,
                       float* __restrict__ dA, float* __restrict__ de0,
                       float* __restrict__ de1, float* __restrict__ dpi) {
  const Instance me = this_instance(B, S);
  const int n = B * S;
  const int j = me.lane;

  float col[PM], rowA[PM], dcol[PM];
  const float* Ap = A + static_cast<size_t>(me.p) * PM * PM;
#pragma unroll
  for (int k = 0; k < PM; ++k) {
    col[k] = Ap[k * PM + j];
    rowA[k] = Ap[j * PM + k];
    dcol[k] = 0.f;
  }
  const float f0 = e0[me.p * PM + j];
  const float f1 = e1[me.p * PM + j];
  const float g = gbar[me.i];
  float ab = 0.f, g0 = 0.f, g1 = 0.f;

  const int8_t* row = obs + static_cast<size_t>(me.s) * L;
  float* a_hist = hist;
  float* v_hist = hist + static_cast<size_t>(seg_len) * n * PM;
  const int n_seg = (L + seg_len - 1) / seg_len;
  for (int q = n_seg - 1; q >= 0; --q) {
    const int t0 = q * seg_len;
    const int len = min(seg_len, L - t0);

    // rebuild the segment from its checkpoint
    float a = ckpt[(static_cast<size_t>(q) * n + me.i) * PM + j];
    for (int k = 0; k < len; ++k) {
      const int ob = row[t0 + k];
      const float v = half_warp_dot(a, col);
      const size_t h = (static_cast<size_t>(k) * n + me.i) * PM + j;
      if (me.active) {
        a_hist[h] = a;
        v_hist[h] = v;
      }
      const float u = v * emis_factor(ob, f0, f1);
      const float c = half_warp_sum(u);
      if (ob != -2) a = u / c;
    }

    // sweep it in reverse; a clamped copy reads nothing (its own lanes only
    // see each other's values, and nothing of it is stored)
    for (int k = len - 1; k >= 0; --k) {
      const int ob = row[t0 + k];
      const size_t h = (static_cast<size_t>(k) * n + me.i) * PM + j;
      const float a_prev = me.active ? a_hist[h] : 0.f;
      const float v = me.active ? v_hist[h] : 0.f;
      const float f = emis_factor(ob, f0, f1);
      const float u = v * f;
      const float c = half_warp_sum(u);
      const float dot = half_warp_sum(ab * (u / c));
      const float ubar = (ab - dot + g) / c;
      const bool live = ob != -2;
      const float w = live ? ubar * f : 0.f;
      const float ab_new = half_warp_dot(w, rowA);
#pragma unroll
      for (int i = 0; i < PM; ++i) dcol[i] = fmaf(__shfl_sync(FULL_MASK, a_prev, i, PM), w, dcol[i]);
      if (live) {
        ab = ab_new;
        const float dfull = v * ubar;
        if (ob == 0) g0 += dfull;
        if (ob == 1) g1 += dfull;
      }
    }
  }

  if (!me.active) return;
  float* dAi = dA + static_cast<size_t>(me.i) * PM * PM;
#pragma unroll
  for (int i = 0; i < PM; ++i) dAi[i * PM + j] = dcol[i];
  const size_t o = static_cast<size_t>(me.i) * PM + j;
  de0[o] = g0;
  de1[o] = g1;
  dpi[o] = ab;
}

extern "C" int phlash_packed_backward(const float* A, const float* e0, const float* e1,
                                      const int8_t* obs, const float* ckpt, const float* gbar,
                                      int B, int S, int L, int seg_len, float* hist, float* dA,
                                      float* de0, float* de1, float* dpi, void* stream) {
  if (B * S <= 0 || L <= 0 || seg_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  packed_backward_kernel<<<packed_blocks(B * S), PACKED_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      A, e0, e1, obs, ckpt, gbar, B, S, L, seg_len, hist, dA, de0, de1, dpi);
  return static_cast<int>(cudaGetLastError());
}
