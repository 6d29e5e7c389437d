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
//
// phlash_packed_backward_split runs the same in K segments, as the forward's
// split does: speculative sweeps (every segment from abar = 0 and a zero
// look-ahead, which is the last segment's true start), fix sweeps from each
// upper neighbour's speculative state up to the first checkpoint where the
// carried (abar, <abar, alpha>) equals the stored one bitwise, and a splice
// down the segments.  Every period is still rebuilt from its checkpoint, so
// the alpha side needs no speculation.  Both paths run one period body
// (packed_reverse_period, packed_common.cuh), so a chain that meets does the
// unsplit kernel's arithmetic from there on.  The gradients are summed by
// interval, segment and row, in a fixed order.
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
      float x[SPL];  // the period's checkpoint (the previous one loads beside the work)
#pragma unroll
      for (int r = 0; r < SPL; ++r) x[r] = next[r];
      load_states<SPL>(ck + static_cast<size_t>(max(q - 1, 0)) * per_stride, next);

      // the period's codes, 2 bits a site (ob + 2)
      unsigned codes = 0;
#pragma unroll
      for (int j = 0; j < P; ++j)
        codes |= static_cast<unsigned>((j0 + j < n ? sh[mis + j0 + j] : -2) + 2) << (2 * j);

      packed_reverse_period<SPL>(x, codes, ab, dot, g, cols, rows, f0, f1, drows, g0, g1);
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

// ---------------------------------------------------------------------------
// The split path: K segments a row (ops/packed.segment_plan), three launches.
// ---------------------------------------------------------------------------

constexpr int NGRAD = PM + 2;  // a lane's gradient rows: dA's PM terms, de0, de1

struct PackedBwdSplit {
  int K, P;                    // segments a row, periods a segment (P % CHECK_EVERY == 0)
  float* top_ab;               // (K, B*S, PM) the abar each segment's stored sweep started from
  float* top_dot;              // (K, B*S) and its look-ahead <abar, alpha>
  float* ab_ck;                // (n_chk, B*S, PM) abar at each checkpoint (the start of period i C)
  float* dot_ck;               // (n_chk, B*S)
  float* spec_ab;              // (K, B*S, PM) the speculative sweep's state at its segment's start
  float* spec_dot;             // (K, B*S)
  float* int_grad;             // (n_chk, NGRAD, B*S, PM) each interval's gradient sums
  float* seg_grad;             // (K, NGRAD, B*S, PM) each segment's sums over its intervals
  unsigned long long* counts;  // SplitCount
};

// A lane's NGRAD gradient rows, as the unsplit kernel keeps them.
struct Grads {
  float dr[PM][PACKED_BWD_SPL], g0[PACKED_BWD_SPL], g1[PACKED_BWD_SPL];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < PACKED_BWD_SPL; ++r) {
      g0[r] = g1[r] = 0.f;
#pragma unroll
      for (int k = 0; k < PM; ++k) dr[k][r] = 0.f;
    }
  }
  // store to / add from dst[j * stride], j < NGRAD: dA's terms, then de0, de1
  __device__ __forceinline__ void store(float* __restrict__ dst, size_t stride) const {
#pragma unroll
    for (int k = 0; k < PM; ++k) store_states<PACKED_BWD_SPL>(dst + k * stride, dr[k]);
    store_states<PACKED_BWD_SPL>(dst + PM * stride, g0);
    store_states<PACKED_BWD_SPL>(dst + (PM + 1) * stride, g1);
  }
  __device__ __forceinline__ void add(const float* __restrict__ src, size_t stride) {
    float x[NGRAD][PACKED_BWD_SPL];
#pragma unroll
    for (int j = 0; j < NGRAD; ++j) load_states<PACKED_BWD_SPL>(src + j * stride, x[j]);
#pragma unroll
    for (int r = 0; r < PACKED_BWD_SPL; ++r) {
#pragma unroll
      for (int k = 0; k < PM; ++k) dr[k][r] += x[k][r];
      g0[r] += x[PM][r];
      g1[r] += x[PM + 1][r];
    }
  }
};

// A lane's columns and rows of A and its emission entries.
struct BwdRows {
  float cols[PM][PACKED_BWD_SPL], rows[PM][PACKED_BWD_SPL], f0[PACKED_BWD_SPL],
      f1[PACKED_BWD_SPL];
  __device__ __forceinline__ void load(const float* __restrict__ A, const float* __restrict__ e0,
                                       const float* __restrict__ e1, const GroupLane& me) {
    constexpr int SPL = PACKED_BWD_SPL;
    const float* Ap = A + static_cast<size_t>(me.p) * PM * PM;
    load_columns<SPL>(Ap, me.lane, cols);
    load_rows<SPL>(Ap, me.lane, rows);
    load_params<SPL>(e0 + me.p * PM + me.lane * SPL, f0);
    load_params<SPL>(e1 + me.p * PM + me.lane * SPL, f1);
  }
};

// Segment k of one instance's adjoint, swept from its last period down from
// (ab, dot) (registers, updated in place).  SPEC sweeps the whole segment and
// stores the state at its checkpoints, its interval sums and the state it
// started from; FIX first compares (ab, dot) with that start, then with the
// stored state at each checkpoint, and is done at the first match bitwise
// (from there down the stored sweep is this chain's), storing its own before.
// A group that is done computes on for the shuffles and stores nothing.
// Returns the sites the group ran before it was done.
template <bool FIX>
__device__ __forceinline__ unsigned packed_backward_segment(
    float (&ab)[PACKED_BWD_SPL], float& dot, bool& done, bool& met, int k, const GroupLane& me,
    const BwdRows& w, float g, const int8_t* __restrict__ row, const float* __restrict__ ckpt,
    int B, int S, int L, const PackedBwdSplit& ws, int8_t* sh) {
  constexpr int SPL = PACKED_BWD_SPL;
  constexpr int G = PM / SPL;
  constexpr int P = PACKED_PERIOD;
  const int m0 = me.lane * SPL;
  const int n_per = (L + P - 1) / P;
  const Segment seg(k, ws.P, n_per);
  const int t_beg = seg.q0 * P, t_end = min(seg.q1 * P, L);
  const size_t per = static_cast<size_t>(B) * S;  // instances
  const size_t per_stride = per * PM;
  float* top = ws.top_ab + (static_cast<size_t>(k) * per + me.i) * PM + m0;
  float* tdot = ws.top_dot + static_cast<size_t>(k) * per + me.i;
  if constexpr (FIX) {
    const bool same = state_equal<G, SPL>(ab, dot, top, *tdot);
    met = met || (same && !done);
    done = done || same;
    if (!__syncthreads_or(!done)) return 0;
  }
  if (!done) {
    store_states<SPL>(top, ab);
    if (me.lane == 0) *tdot = dot;
  }

  Grads acc;
  acc.zero();
  const float* ck = ckpt + me.i * PM + m0;
  float next[SPL];  // the checkpoint of the period being reached, in flight
  load_states<SPL>(ck + static_cast<size_t>(seg.q1 - 1) * per_stride, next);
  unsigned ran = 0;
  bool wrote = false, stop = false;
  for (int t0 = t_beg + (t_end - t_beg - 1) / OBS_TILE * OBS_TILE; t0 >= t_beg && !stop;
       t0 -= OBS_TILE) {
    const int n = min(OBS_TILE, t_end - t0);
    __syncthreads();  // the previous tile's readers are done
    const int mis = stage_obs(row + t0, n, sh);
    __syncthreads();
    for (int j0 = (n - 1) / P * P; j0 >= 0; j0 -= P) {
      const int q = (t0 + j0) / P;
      float x[SPL];
#pragma unroll
      for (int r = 0; r < SPL; ++r) x[r] = next[r];
      load_states<SPL>(ck + static_cast<size_t>(max(q - 1, seg.q0)) * per_stride, next);
      unsigned codes = 0;  // the period's codes, 2 bits a site (ob + 2)
#pragma unroll
      for (int j = 0; j < P; ++j)
        codes |= static_cast<unsigned>((j0 + j < n ? sh[mis + j0 + j] : -2) + 2) << (2 * j);
      packed_reverse_period<SPL>(x, codes, ab, dot, g, w.cols, w.rows, w.f0, w.f1, acc.dr,
                                 acc.g0, acc.g1);
      if (!done) ran += min(P, n - j0);
      if (q % CHECK_EVERY == 0) {  // the state at checkpoint q: interval q / C is complete
        const size_t i = q / CHECK_EVERY;
        if (!done) {
          acc.store(ws.int_grad + (i * NGRAD * per + me.i) * PM + m0, per_stride);
          wrote = true;
        }
        acc.zero();
        float* abc = ws.ab_ck + (i * per + me.i) * PM + m0;
        float* dc = ws.dot_ck + i * per + me.i;
        if constexpr (FIX) {
          const bool same = state_equal<G, SPL>(ab, dot, abc, *dc);
          met = met || (same && !done);
          done = done || same;
          if (!__syncthreads_or(!done)) {
            stop = true;
            break;
          }
        }
        if (!done) {
          store_states<SPL>(abc, ab);
          if (me.lane == 0) *dc = dot;
        }
      }
    }
  }
  if (wrote) {  // the segment's sums over its intervals, top to bottom
    acc.zero();
    for (int i = (seg.q1 - 1) / CHECK_EVERY; i >= seg.q0 / CHECK_EVERY; --i)
      acc.add(ws.int_grad + (static_cast<size_t>(i) * NGRAD * per + me.i) * PM + m0, per_stride);
    acc.store(ws.seg_grad + (static_cast<size_t>(k) * NGRAD * per + me.i) * PM + m0, per_stride);
  }
  return ran;
}

// The split kernels hold 3 blocks of 4 warps an SM (170 registers at most), the
// residency ops/packed.TARGET_WARPS_PER_SM["adjoint"] plans for.
#define PACKED_BWD_SPLIT_BOUNDS __launch_bounds__(Group<PM, PACKED_BWD_SPL>::THREADS, 3)

// Speculative pass: segment k = blockIdx.z from abar = 0 and a zero
// look-ahead (the last segment's true start, a guess for the others).
__global__ void PACKED_BWD_SPLIT_BOUNDS
packed_backward_kernel_speculate(const float* __restrict__ A, const float* __restrict__ e0,
                                 const float* __restrict__ e1, const int8_t* __restrict__ obs,
                                 const float* __restrict__ ckpt, const float* __restrict__ gbar,
                                 int B, int S, int L, PackedBwdSplit ws) {
  constexpr int SPL = PACKED_BWD_SPL;
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<PM / SPL>(B, S);
  const int m0 = me.lane * SPL;
  BwdRows w;
  w.load(A, e0, e1, me);
  const int k = blockIdx.z;
  float ab[SPL], dot = 0.f;
#pragma unroll
  for (int r = 0; r < SPL; ++r) ab[r] = 0.f;
  bool done = !me.active, met = false;
  const unsigned ran = packed_backward_segment<false>(
      ab, dot, done, met, k, me, w, gbar[me.i], obs + static_cast<size_t>(me.s) * L, ckpt, B, S,
      L, ws, sh);
  const size_t o = static_cast<size_t>(k) * B * S + me.i;
  if (me.active) {
    store_states<SPL>(ws.spec_ab + o * PM + m0, ab);
    if (me.lane == 0) ws.spec_dot[o] = dot;
  }
  const bool first = me.active && me.lane == 0;
  add_count(ws.counts, SEGMENTS, first ? 1u : 0u);
  add_count(ws.counts, SPLIT_SITES, first ? ran : 0u);
}

// Fix pass: segment k = blockIdx.z (< K - 1) from segment k + 1's speculative
// state at its start.
__global__ void PACKED_BWD_SPLIT_BOUNDS
packed_backward_kernel_fix(const float* __restrict__ A, const float* __restrict__ e0,
                           const float* __restrict__ e1, const int8_t* __restrict__ obs,
                           const float* __restrict__ ckpt, const float* __restrict__ gbar, int B,
                           int S, int L, PackedBwdSplit ws) {
  constexpr int SPL = PACKED_BWD_SPL;
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<PM / SPL>(B, S);
  const int m0 = me.lane * SPL;
  BwdRows w;
  w.load(A, e0, e1, me);
  const int k = blockIdx.z;
  const size_t o = static_cast<size_t>(k + 1) * B * S + me.i;
  float ab[SPL];
  load_states<SPL>(ws.spec_ab + o * PM + m0, ab);
  float dot = ws.spec_dot[o];
  bool done = !me.active, met = false;
  const unsigned ran = packed_backward_segment<true>(
      ab, dot, done, met, k, me, w, gbar[me.i], obs + static_cast<size_t>(me.s) * L, ckpt, B, S,
      L, ws, sh);
  const bool first = me.active && me.lane == 0;
  add_count(ws.counts, RESOLVED, first && met ? 1u : 0u);
  add_count(ws.counts, FIX_SITES, first ? ran : 0u);
}

// Splice: a group an instance walks segments K-2 .. 0 from the last segment's
// state at its start, re-running (as the fix pass) any segment whose stored
// sweep did not start from its upper neighbour's true state; then dA, de0 and
// de1 (the segments' sums, in order) and dpi (abar at site 0).
__global__ void PACKED_BWD_SPLIT_BOUNDS
packed_backward_kernel_splice(const float* __restrict__ A, const float* __restrict__ e0,
                              const float* __restrict__ e1, const int8_t* __restrict__ obs,
                              const float* __restrict__ ckpt, const float* __restrict__ gbar,
                              int B, int S, int L, PackedBwdSplit ws, float* __restrict__ dA,
                              float* __restrict__ de0, float* __restrict__ de1,
                              float* __restrict__ dpi) {
  constexpr int SPL = PACKED_BWD_SPL;
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<PM / SPL>(B, S);
  const int m0 = me.lane * SPL;
  BwdRows w;
  w.load(A, e0, e1, me);
  const size_t per = static_cast<size_t>(B) * S;
  const float g = gbar[me.i];
  float ab[SPL];
  size_t c = static_cast<size_t>((ws.K - 1) * ws.P / CHECK_EVERY) * per + me.i;
  load_states<SPL>(ws.ab_ck + c * PM + m0, ab);
  float dot = ws.dot_ck[c];
  unsigned ran = 0;
  for (int k = ws.K - 2; k >= 0; --k) {
    bool done = !me.active, met = false;
    ran += packed_backward_segment<true>(ab, dot, done, met, k, me, w, g,
                                         obs + static_cast<size_t>(me.s) * L, ckpt, B, S, L, ws,
                                         sh);
    // a group that swept to the segment's start holds the state there (lane 0
    // has just stored dot, which the other lanes must not read back); one
    // that met takes the stored sweep's, which an earlier launch wrote
    if (done) {
      c = static_cast<size_t>(k * ws.P / CHECK_EVERY) * per + me.i;
      load_states<SPL>(ws.ab_ck + c * PM + m0, ab);
      dot = ws.dot_ck[c];
    }
  }
  if (me.active) {
    Grads sum;
    sum.zero();
    for (int k = 0; k < ws.K; ++k)
      sum.add(ws.seg_grad + (static_cast<size_t>(k) * NGRAD * per + me.i) * PM + m0, per * PM);
    float* dAi = dA + me.i * PM * PM;
#pragma unroll
    for (int k = 0; k < PM; ++k)
#pragma unroll
      for (int r = 0; r < SPL; ++r) dAi[(m0 + r) * PM + term_state<SPL>(me.lane, k)] = sum.dr[k][r];
    const size_t o = me.i * PM + m0;
    store_states<SPL>(de0 + o, sum.g0);
    store_states<SPL>(de1 + o, sum.g1);
    store_states<SPL>(dpi + o, ab);
  }
  add_count(ws.counts, FIX_SITES, me.active && me.lane == 0 ? ran : 0u);
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

// The split adjoint: K >= 2 segments of P periods, as the split forward.
extern "C" int phlash_packed_backward_split(const float* A, const float* e0, const float* e1,
                                            const int8_t* obs, const float* ckpt,
                                            const float* gbar, int B, int S, int L, int K, int P,
                                            float* dA, float* de0, float* de1, float* dpi,
                                            float* top_ab, float* top_dot, float* ab_ck,
                                            float* dot_ck, float* spec_ab, float* spec_dot,
                                            float* int_grad, float* seg_grad,
                                            unsigned long long* counts, void* stream) {
  const int n_per = L > 0 ? (L + PACKED_PERIOD - 1) / PACKED_PERIOD : 0;
  if (B <= 0 || S <= 0 || S > 65535 || L <= 0 || K < 2 || K > 65535 || P <= 0 ||
      P % CHECK_EVERY != 0 || static_cast<long long>(K - 1) * P >= n_per ||
      static_cast<long long>(K) * P < n_per)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gx = (B + INSTANCES_PER_BLOCK - 1) / INSTANCES_PER_BLOCK;
  constexpr int T = Group<PM, PACKED_BWD_SPL>::THREADS;
  const PackedBwdSplit ws{K, P, top_ab, top_dot, ab_ck, dot_ck, spec_ab, spec_dot,
                          int_grad, seg_grad, counts};
  packed_backward_kernel_speculate<<<dim3(gx, S, K), T, 0, st>>>(A, e0, e1, obs, ckpt, gbar, B,
                                                                 S, L, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_backward_kernel_fix<<<dim3(gx, S, K - 1), T, 0, st>>>(A, e0, e1, obs, ckpt, gbar, B, S,
                                                               L, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_backward_kernel_splice<<<dim3(gx, S), T, 0, st>>>(A, e0, e1, obs, ckpt, gbar, B, S, L,
                                                           ws, dA, de0, de1, dpi);
  return static_cast<int>(cudaGetLastError());
}
