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
//
// phlash_smc_backward_split runs the same in K segments, as the forward's
// split does: speculative sweeps (the last segment from abar0, exact; the
// others from zero), fix sweeps from each upper neighbour's speculative abar
// up to the first checkpoint where abar equals the stored one bitwise, and a
// splice down the segments.  The gradients are summed by interval, segment
// and row, in a fixed order.  The split kernels keep the 8-site cache in
// shared memory (smc_common.cuh's PeriodCache: 12 KB a one-warp block at
// M = 16), so that at most 128 registers a thread hold
// ADJOINT_WARPS_PER_SM warps an SM; everything else stays in registers.  A
// launch whose warps the register-cache instances hold (SHARED false) runs
// those instead: one warp's chain is faster with the cache in registers.
//
// With `live` set (smc_common.cuh: each row's live end) both paths sweep
// each row down from its live end: the unsplit kernel from period
// n_live - 1, the split from its last live segment (the exact start) down.
#include "smc_common.cuh"

using namespace phlash;

template <int M, int SPL>
__global__ void __launch_bounds__(Group<M, SPL>::THREADS)
smc_backward_kernel(const float* __restrict__ b, const float* __restrict__ d,
                    const float* __restrict__ u, const float* __restrict__ vv,
                    const float* __restrict__ e0, const float* __restrict__ e1,
                    const int8_t* __restrict__ obs, const float* __restrict__ pstates,
                    const float* __restrict__ gbar, const float* __restrict__ abar0,
                    const int* __restrict__ live, int B, int S, int L,
                    float* __restrict__ db, float* __restrict__ dd,
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
  const int n_per = row_periods(live, me.s, L);  // the row's live periods
  const int L_live = min(n_per * NORM_EVERY, L);
  float next[SPL];  // the boundary state of the period after this one, in flight
  load_states<SPL>(pst + static_cast<size_t>(max(n_per - 1, 0)) * per_stride, next);

  const int8_t* row = obs + static_cast<size_t>(me.s) * L;
  for (int t0 = L_live > 0 ? (L_live - 1) / OBS_TILE * OBS_TILE : -OBS_TILE; t0 >= 0;
       t0 -= OBS_TILE) {
    const int n = min(OBS_TILE, L_live - t0);
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

// ---------------------------------------------------------------------------
// The split path: K segments a row (ops/smc.segment_plan), three launches.
// ---------------------------------------------------------------------------

// The split adjoint's block shape at (M, SPL): its threads, the blocks an SM
// its shared-cache kernels are bound to (the register-cache ones to 1: as
// many registers as a thread may take), and their dynamic shared memory.
template <int M, int SPL>
struct AdjointSplit {
  static constexpr int THREADS = Group<M, SPL>::THREADS;
  static constexpr int MIN_BLOCKS = ADJOINT_WARPS_PER_SM * 32 / THREADS;
  static constexpr size_t CACHE_BYTES = PeriodCache<SPL>::bytes(THREADS);
  static_assert(THREADS % 32 == 0 && MIN_BLOCKS >= 1, "whole warps, at least one block an SM");
};

extern __shared__ __align__(16) unsigned char adjoint_cache[];

// A split kernel's period cache: the block's shared memory (SHARED) or registers.
template <int SPL, bool SHARED>
struct SplitCache : RegisterCache<SPL> {};
template <int SPL>
struct SplitCache<SPL, true> : PeriodCache<SPL> {
  __device__ __forceinline__ SplitCache() : PeriodCache<SPL>(adjoint_cache) {}
};

struct BwdSplit {
  int K, P;                    // segments a row, periods a segment (P % CHECK_EVERY == 0)
  const int* live;             // (S,) each row's live periods, or nullptr (whole rows)
  float* top;                  // (K, S, B, M) the abar each segment's stored sweep started from
  float* ab_ck;                // (n_chk, S, B, M) abar at each checkpoint (the start of period i C)
  float* spec_end;             // (K, S, B, M) the speculative sweep's abar at its segment's start
  float* int_grad;             // (n_chk, 6, S, B, M) each interval's six gradient sums
  float* seg_grad;             // (K, 6, S, B, M) each segment's sums over its intervals
  unsigned long long* counts;  // SplitCount
};

// Segment k of one instance's adjoint, swept from its last period down from
// abar ab (registers, updated in place).  SPEC sweeps the whole segment and
// stores abar at its checkpoints, its interval sums and the abar it started
// from; FIX first compares ab with that start, then ab at each checkpoint
// with the stored one, and is done at the first match bitwise (from there
// down the stored sweep is this chain's), storing its own before.  A group
// that is done computes on for the shuffles and stores nothing.  Returns the
// sites the group ran before it was done.
template <int M, int SPL, bool FIX, bool SHARED>
__device__ __forceinline__ unsigned backward_segment(float* ab, bool& done, bool& met, int k,
                                                     const GroupLane& me, const Rows<SPL>& w,
                                                     float g, const int8_t* __restrict__ row,
                                                     const float* __restrict__ pstates, int B,
                                                     int S, int L, const BwdSplit& ws,
                                                     int8_t* sh) {
  constexpr int G = Group<M, SPL>::G;
  const int m0 = me.lane * SPL;
  const Segment seg(k, ws.P, row_periods(ws.live, me.s, L));
  const int t_beg = seg.q0 * NORM_EVERY, t_end = min(seg.q1 * NORM_EVERY, L);
  const size_t inst = static_cast<size_t>(me.s) * B + me.p;  // chunk-major instance
  const size_t per = static_cast<size_t>(S) * B;             // instances a period
  float* top = ws.top + (static_cast<size_t>(k) * per + inst) * M + m0;
  if constexpr (FIX) {
    const bool same = group_equal<G, SPL>(ab, top);
    met = met || (same && !done);
    done = done || same;
    if (!__syncthreads_or(!done)) return 0;
  }
  if (!done) store_states<SPL>(top, ab);

  float gb[SPL], gd[SPL], gu[SPL], gv[SPL], g0[SPL], g1[SPL];
#pragma unroll
  for (int r = 0; r < SPL; ++r) gb[r] = gd[r] = gu[r] = gv[r] = g0[r] = g1[r] = 0.f;
  const float* pst = pstates + inst * M + m0;
  const size_t per_stride = per * M;
  float next[SPL];  // the start state of the period below this one, in flight
  load_states<SPL>(pst + static_cast<size_t>(seg.q1 - 1) * per_stride, next);
  SplitCache<SPL, SHARED> cache;
  unsigned ran = 0;
  bool wrote = false, stop = false;
  for (int t0 = t_beg + (t_end - t_beg - 1) / OBS_TILE * OBS_TILE; t0 >= t_beg && !stop;
       t0 -= OBS_TILE) {
    const int n = min(OBS_TILE, t_end - t0);
    __syncthreads();  // the previous tile's readers are done
    const int mis = stage_obs(row + t0, n, sh);
    __syncthreads();
    for (int j0 = (n - 1) / NORM_EVERY * NORM_EVERY; j0 >= 0; j0 -= NORM_EVERY) {
      const int q = (t0 + j0) / NORM_EVERY;
      float a[SPL];
#pragma unroll
      for (int r = 0; r < SPL; ++r) a[r] = next[r];
      load_states<SPL>(pst + static_cast<size_t>(max(q - 1, seg.q0)) * per_stride, next);
      const PeriodCodes codes(sh, mis, j0, n);
      reverse_period<G, SPL>(a, codes, ab, g, me.lane, cache, w.b, w.d, w.u, w.v, w.e0, w.e1,
                             gb, gd, gu, gv, g0, g1);
      if (!done) ran += min(NORM_EVERY, n - j0);
      if (q % CHECK_EVERY == 0) {  // abar at checkpoint q: interval q / C is complete
        const size_t i = q / CHECK_EVERY;
        if (!done) {
          float* o = ws.int_grad + (i * 6 * per + inst) * M + m0;
          store_states<SPL>(o, gb);
          store_states<SPL>(o + per_stride, gd);
          store_states<SPL>(o + 2 * per_stride, gu);
          store_states<SPL>(o + 3 * per_stride, gv);
          store_states<SPL>(o + 4 * per_stride, g0);
          store_states<SPL>(o + 5 * per_stride, g1);
          wrote = true;
        }
#pragma unroll
        for (int r = 0; r < SPL; ++r) gb[r] = gd[r] = gu[r] = gv[r] = g0[r] = g1[r] = 0.f;
        float* ck = ws.ab_ck + (i * per + inst) * M + m0;
        if constexpr (FIX) {
          const bool same = group_equal<G, SPL>(ab, ck);
          met = met || (same && !done);
          done = done || same;
          if (!__syncthreads_or(!done)) {
            stop = true;
            break;
          }
        }
        if (!done) store_states<SPL>(ck, ab);
      }
    }
  }
  if (wrote) {  // the segment's sums over its intervals, top to bottom
#pragma unroll
    for (int r = 0; r < SPL; ++r) gb[r] = gd[r] = gu[r] = gv[r] = g0[r] = g1[r] = 0.f;
    for (int i = (seg.q1 - 1) / CHECK_EVERY; i >= seg.q0 / CHECK_EVERY; --i) {
      const float* o = ws.int_grad + (static_cast<size_t>(i) * 6 * per + inst) * M + m0;
      float x[SPL];
      load_states<SPL>(o, x);
#pragma unroll
      for (int r = 0; r < SPL; ++r) gb[r] += x[r];
      load_states<SPL>(o + per_stride, x);
#pragma unroll
      for (int r = 0; r < SPL; ++r) gd[r] += x[r];
      load_states<SPL>(o + 2 * per_stride, x);
#pragma unroll
      for (int r = 0; r < SPL; ++r) gu[r] += x[r];
      load_states<SPL>(o + 3 * per_stride, x);
#pragma unroll
      for (int r = 0; r < SPL; ++r) gv[r] += x[r];
      load_states<SPL>(o + 4 * per_stride, x);
#pragma unroll
      for (int r = 0; r < SPL; ++r) g0[r] += x[r];
      load_states<SPL>(o + 5 * per_stride, x);
#pragma unroll
      for (int r = 0; r < SPL; ++r) g1[r] += x[r];
    }
    float* o = ws.seg_grad + (static_cast<size_t>(k) * 6 * per + inst) * M + m0;
    store_states<SPL>(o, gb);
    store_states<SPL>(o + per_stride, gd);
    store_states<SPL>(o + 2 * per_stride, gu);
    store_states<SPL>(o + 3 * per_stride, gv);
    store_states<SPL>(o + 4 * per_stride, g0);
    store_states<SPL>(o + 5 * per_stride, g1);
  }
  return ran;
}

// Speculative pass: segment k = blockIdx.z from abar0 (the row's last live
// segment, exact) or from zero (a guess); a segment past the row's live end
// is empty.
template <int M, int SPL, bool SHARED>
__global__ void __launch_bounds__(AdjointSplit<M, SPL>::THREADS,
                                  SHARED ? AdjointSplit<M, SPL>::MIN_BLOCKS : 1)
smc_backward_kernel_speculate(const float* __restrict__ b, const float* __restrict__ d,
                              const float* __restrict__ u, const float* __restrict__ vv,
                              const float* __restrict__ e0, const float* __restrict__ e1,
                              const int8_t* __restrict__ obs, const float* __restrict__ pstates,
                              const float* __restrict__ gbar, const float* __restrict__ abar0,
                              int B, int S, int L, BwdSplit ws) {
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<Group<M, SPL>::G>(B, S);
  const int k = blockIdx.z, k_last = last_segment(row_periods(ws.live, me.s, L), ws.P);
  if (k > k_last) return;  // the whole block's row
  const int m0 = me.lane * SPL;
  Rows<SPL> w;
  w.load(b, d, u, vv, e0, e1, static_cast<size_t>(me.p) * M + m0);
  float ab[SPL];
  if (k == k_last) {
    load_params<SPL>(abar0 + me.i * M + m0, ab);
  } else {
#pragma unroll
    for (int r = 0; r < SPL; ++r) ab[r] = 0.f;
  }
  bool done = !me.active, met = false;
  const unsigned ran = backward_segment<M, SPL, false, SHARED>(
      ab, done, met, k, me, w, gbar[me.i], obs + static_cast<size_t>(me.s) * L, pstates, B, S,
      L, ws, sh);
  if (me.active)
    store_states<SPL>(
        ws.spec_end + (static_cast<size_t>(k) * S * B + static_cast<size_t>(me.s) * B + me.p) * M + m0,
        ab);
  const bool first = me.active && me.lane == 0;
  add_count(ws.counts, SEGMENTS, first ? 1u : 0u);
  add_count(ws.counts, SPLIT_SITES, first ? ran : 0u);
}

// Fix pass: segment k = blockIdx.z (below the row's last live segment) from
// segment k + 1's speculative abar at its start.
template <int M, int SPL, bool SHARED>
__global__ void __launch_bounds__(AdjointSplit<M, SPL>::THREADS,
                                  SHARED ? AdjointSplit<M, SPL>::MIN_BLOCKS : 1)
smc_backward_kernel_fix(const float* __restrict__ b, const float* __restrict__ d,
                        const float* __restrict__ u, const float* __restrict__ vv,
                        const float* __restrict__ e0, const float* __restrict__ e1,
                        const int8_t* __restrict__ obs, const float* __restrict__ pstates,
                        const float* __restrict__ gbar, int B, int S, int L, BwdSplit ws) {
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<Group<M, SPL>::G>(B, S);
  const int k = blockIdx.z;
  if (k >= last_segment(row_periods(ws.live, me.s, L), ws.P)) return;
  const int m0 = me.lane * SPL;
  Rows<SPL> w;
  w.load(b, d, u, vv, e0, e1, static_cast<size_t>(me.p) * M + m0);
  const size_t per = static_cast<size_t>(S) * B, inst = static_cast<size_t>(me.s) * B + me.p;
  float ab[SPL];
  load_states<SPL>(ws.spec_end + ((k + 1) * per + inst) * M + m0, ab);
  bool done = !me.active, met = false;
  const unsigned ran = backward_segment<M, SPL, true, SHARED>(
      ab, done, met, k, me, w, gbar[me.i], obs + static_cast<size_t>(me.s) * L, pstates, B, S,
      L, ws, sh);
  const bool first = me.active && me.lane == 0;
  add_count(ws.counts, RESOLVED, first && met ? 1u : 0u);
  add_count(ws.counts, FIX_SITES, first ? ran : 0u);
}

// Splice: a group an instance walks segments k_last - 1 .. 0 from its last
// live segment's abar at that segment's start (k_last = K - 1 on whole
// rows), re-running (as the fix pass) any segment whose stored sweep did not
// start from its upper neighbour's true abar; then the six gradients (the
// segments' sums, in order) and dpi (abar at site 0; zeros and abar0 on a
// row with no live period).
template <int M, int SPL, bool SHARED>
__global__ void __launch_bounds__(AdjointSplit<M, SPL>::THREADS,
                                  SHARED ? AdjointSplit<M, SPL>::MIN_BLOCKS : 1)
smc_backward_kernel_splice(const float* __restrict__ b, const float* __restrict__ d,
                           const float* __restrict__ u, const float* __restrict__ vv,
                           const float* __restrict__ e0, const float* __restrict__ e1,
                           const int8_t* __restrict__ obs, const float* __restrict__ pstates,
                           const float* __restrict__ gbar, const float* __restrict__ abar0,
                           int B, int S, int L, BwdSplit ws, float* __restrict__ db,
                           float* __restrict__ dd, float* __restrict__ du,
                           float* __restrict__ dvv, float* __restrict__ de0,
                           float* __restrict__ de1, float* __restrict__ dpi) {
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<Group<M, SPL>::G>(B, S);
  const int m0 = me.lane * SPL;
  Rows<SPL> w;
  w.load(b, d, u, vv, e0, e1, static_cast<size_t>(me.p) * M + m0);
  const size_t per = static_cast<size_t>(S) * B, inst = static_cast<size_t>(me.s) * B + me.p;
  const float g = gbar[me.i];
  const int k_last = last_segment(row_periods(ws.live, me.s, L), ws.P);
  float ab[SPL];
  if (k_last < 0)
    load_params<SPL>(abar0 + me.i * M + m0, ab);
  else
    load_states<SPL>(ws.ab_ck + (static_cast<size_t>(k_last * ws.P / CHECK_EVERY) * per + inst) * M + m0, ab);
  unsigned ran = 0;
  for (int k = k_last - 1; k >= 0; --k) {
    bool done = !me.active, met = false;
    ran += backward_segment<M, SPL, true, SHARED>(ab, done, met, k, me, w, g,
                                          obs + static_cast<size_t>(me.s) * L, pstates, B, S, L,
                                          ws, sh);
    load_states<SPL>(ws.ab_ck + (static_cast<size_t>(k * ws.P / CHECK_EVERY) * per + inst) * M + m0, ab);
  }
  if (me.active) {
    float* outs[6] = {db, dd, du, dvv, de0, de1};
    const size_t per_stride = per * M;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float s[SPL];
#pragma unroll
      for (int r = 0; r < SPL; ++r) s[r] = 0.f;
      for (int k = 0; k <= k_last; ++k) {
        float x[SPL];
        load_states<SPL>(ws.seg_grad + (static_cast<size_t>(k) * 6 * per + inst) * M + m0 + j * per_stride, x);
#pragma unroll
        for (int r = 0; r < SPL; ++r) s[r] += x[r];
      }
      store_states<SPL>(outs[j] + me.i * M + m0, s);
    }
    store_states<SPL>(dpi + me.i * M + m0, ab);
  }
  add_count(ws.counts, FIX_SITES, me.active && me.lane == 0 ? ran : 0u);
}

extern "C" int phlash_smc_backward(const float* b, const float* d, const float* u,
                                   const float* vv, const float* e0, const float* e1,
                                   const int8_t* obs, const float* pstates, const float* gbar,
                                   const float* abar0, const int* live, int B, int S, int L,
                                   int M, float* db, float* dd, float* du, float* dvv,
                                   float* de0, float* de1, float* dpi, void* stream) {
  if (B <= 0 || S <= 0 || S > 65535 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + INSTANCES_PER_BLOCK - 1) / INSTANCES_PER_BLOCK, S);
#define PHLASH_BWD(MM, SS)                                                              \
  if (M == MM) {                                                                        \
    smc_backward_kernel<MM, SS><<<grid, Group<MM, SS>::THREADS, 0, st>>>(               \
        b, d, u, vv, e0, e1, obs, pstates, gbar, abar0, live, B, S, L, db, dd, du, dvv, \
        de0, de1, dpi);                                                                 \
    return static_cast<int>(cudaGetLastError());                                        \
  }
  PHLASH_SMC_INSTANCES(PHLASH_BWD)
#undef PHLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// Let the split adjoint's shared-cache kernels at (M, SPL) take their period
// cache and prefer the largest shared-memory carveout (ADJOINT_WARPS_PER_SM
// blocks' caches need it), once a device: at the first split launch or
// occupancy query on it (the first split launch is eager, so a CUDA graph's
// capture makes no such call).
template <int M, int SPL>
int prepare_adjoint_split() {
  static bool ready[64] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (ready[dev]) return 0;
  using A = AdjointSplit<M, SPL>;
  const void* kernels[3] = {
      reinterpret_cast<const void*>(smc_backward_kernel_speculate<M, SPL, true>),
      reinterpret_cast<const void*>(smc_backward_kernel_fix<M, SPL, true>),
      reinterpret_cast<const void*>(smc_backward_kernel_splice<M, SPL, true>)};
  for (const void* k : kernels) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(A::CACHE_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ready[dev] = true;
  return 0;
}

// The three split launches with the period cache in shared memory (SHARED) or
// in registers.
template <int M, int SPL, bool SHARED>
int backward_split(const float* b, const float* d, const float* u, const float* vv,
                   const float* e0, const float* e1, const int8_t* obs, const float* pstates,
                   const float* gbar, const float* abar0, int B, int S, int L, int K,
                   const BwdSplit& ws, float* db, float* dd, float* du, float* dvv, float* de0,
                   float* de1, float* dpi, cudaStream_t st) {
  constexpr int T = AdjointSplit<M, SPL>::THREADS;
  constexpr size_t C = SHARED ? AdjointSplit<M, SPL>::CACHE_BYTES : 0;
  if constexpr (SHARED) {
    const int ready = prepare_adjoint_split<M, SPL>();
    if (ready != 0) return ready;
  }
  const int gx = (B + INSTANCES_PER_BLOCK - 1) / INSTANCES_PER_BLOCK;
  smc_backward_kernel_speculate<M, SPL, SHARED><<<dim3(gx, S, K), T, C, st>>>(
      b, d, u, vv, e0, e1, obs, pstates, gbar, abar0, B, S, L, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  smc_backward_kernel_fix<M, SPL, SHARED><<<dim3(gx, S, K - 1), T, C, st>>>(
      b, d, u, vv, e0, e1, obs, pstates, gbar, B, S, L, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  smc_backward_kernel_splice<M, SPL, SHARED><<<dim3(gx, S), T, C, st>>>(
      b, d, u, vv, e0, e1, obs, pstates, gbar, abar0, B, S, L, ws, db, dd, du, dvv, de0, de1,
      dpi);
  return static_cast<int>(cudaGetLastError());
}

// The split adjoint: K >= 2 segments of P periods, as the split forward; the
// period cache in shared memory where `shared` is set, else in registers.
extern "C" int phlash_smc_backward_split(const float* b, const float* d, const float* u,
                                         const float* vv, const float* e0, const float* e1,
                                         const int8_t* obs, const float* pstates,
                                         const float* gbar, const float* abar0, const int* live,
                                         int B, int S, int L, int M, int K, int P, int shared,
                                         float* db, float* dd, float* du, float* dvv,
                                         float* de0, float* de1, float* dpi, float* top,
                                         float* ab_ck, float* spec_end, float* int_grad,
                                         float* seg_grad, unsigned long long* counts,
                                         void* stream) {
  const int n_per = L > 0 ? (L + NORM_EVERY - 1) / NORM_EVERY : 0;
  if (B <= 0 || S <= 0 || S > 65535 || L <= 0 || K < 2 || K > 65535 || P <= 0 ||
      P % CHECK_EVERY != 0 || static_cast<long long>(K - 1) * P >= n_per ||
      static_cast<long long>(K) * P < n_per)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdSplit ws{K, P, live, top, ab_ck, spec_end, int_grad, seg_grad, counts};
#define PHLASH_BWD_SPLIT(MM, SS)                                                            \
  if (M == MM)                                                                              \
    return shared ? backward_split<MM, SS, true>(b, d, u, vv, e0, e1, obs, pstates, gbar,   \
                                                 abar0, B, S, L, K, ws, db, dd, du, dvv,    \
                                                 de0, de1, dpi, st)                         \
                  : backward_split<MM, SS, false>(b, d, u, vv, e0, e1, obs, pstates, gbar,  \
                                                  abar0, B, S, L, K, ws, db, dd, du, dvv,   \
                                                  de0, de1, dpi, st);
  PHLASH_SMC_INSTANCES(PHLASH_BWD_SPLIT)
#undef PHLASH_BWD_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks an SM of the split adjoint's speculative kernel at M on the
// current device, its cache in shared memory (`shared`) or in registers, as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor counts them (ops/smc.
// resident_warps); minus the CUDA error where the query fails,
// -cudaErrorInvalidValue where no kernel is built for M.
extern "C" int phlash_smc_adjoint_split_blocks_per_sm(int M, int shared) {
  int n = 0;
  cudaError_t err = cudaSuccess;
#define PHLASH_BWD_OCC(MM, SS)                                                                \
  if (M == MM) {                                                                              \
    if (shared) {                                                                             \
      const int ready = prepare_adjoint_split<MM, SS>();                                      \
      if (ready != 0) return -ready;                                                          \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                    \
          &n, smc_backward_kernel_speculate<MM, SS, true>, AdjointSplit<MM, SS>::THREADS,     \
          AdjointSplit<MM, SS>::CACHE_BYTES);                                                 \
    } else {                                                                                  \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                    \
          &n, smc_backward_kernel_speculate<MM, SS, false>, AdjointSplit<MM, SS>::THREADS, 0); \
    }                                                                                         \
    return err == cudaSuccess ? n : -static_cast<int>(err);                                   \
  }
  PHLASH_SMC_INSTANCES(PHLASH_BWD_OCC)
#undef PHLASH_BWD_OCC
  return -static_cast<int>(cudaErrorInvalidValue);
}
