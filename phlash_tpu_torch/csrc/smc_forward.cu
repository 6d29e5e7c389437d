// Structured SMC' forward kernel (replaces the TPU kernels B1/B2:
// phlash_tpu/ops/pallas_smc.py forward_structured, body _make_fwd_kernel).
//
// A group of G = M / SPL lanes runs one (particle, chunk) HMM over its chunk's
// sites, SPL states a lane:
//   v = b * S(a) + d * a + vv * P(u * a)      (S/P strict suffix/prefix sums)
//   a = v * f(obs)                            (padding freezes a)
// and every NORM_EVERY sites c = max(sum a, TINY_NORM), a /= c, ll += log c.
// With pstates != nullptr (B2) it also stores the state at every period
// start: the adjoint's residual.
//
// Bound on the H100: neither bytes nor FLOPs but the per-site dependence
// chain (two scans, the emission, a select) of only B*S independent HMMs.
// The design shortens the chain and spreads it over the card: S and P are
// Kogge-Stone shuffle scans over the group (log2 G steps, the two scans'
// shuffles interleaved, after a local scan of the lane's SPL states) instead
// of M-long serial add chains, and 8 instances a block put B*S*G lanes to
// work (at the fit shape, M = 16 and SPL = 4: 2500 instances of 4 lanes,
// 315 one-warp blocks on all 132 SMs).  The block's observation row is staged
// into shared memory by 16-byte loads, so every lane reads its site's code as
// a broadcast.  No tensor cores: see ops/smc.py for the design note.
//
// Where the instances alone leave the card nearly empty (one genome: 500
// instances on rows of ~94,000 sites), phlash_smc_forward_split cuts each row
// into K segments on period boundaries and runs three kernels: speculate
// (every segment from pi, the first exact), fix (each later segment from its
// neighbour's speculative end, up to the first checkpoint where its state
// equals the stored one bitwise) and splice (the segments in order, re-running
// any whose stored trajectory did not start from its neighbour's true end).
// Every period's state is the unsplit kernel's, bit for bit.
//
// With `live` set (smc_common.cuh: each row's live end, which
// phlash_smc_live_periods finds) both paths run each row up to its live end
// only, and alpha is the state there.
#include "smc_common.cuh"

using namespace phlash;

template <int M, int SPL>
__global__ void __launch_bounds__(Group<M, SPL>::THREADS)
smc_forward_kernel(const float* __restrict__ b, const float* __restrict__ d,
                   const float* __restrict__ u, const float* __restrict__ vv,
                   const float* __restrict__ e0, const float* __restrict__ e1,
                   const float* __restrict__ pi, const int8_t* __restrict__ obs,
                   const int* __restrict__ live, int B, int S, int L,
                   float* __restrict__ ll, float* __restrict__ alpha,
                   float* __restrict__ pstates) {
  constexpr int G = Group<M, SPL>::G;
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<G>(B, S);
  const int m0 = me.lane * SPL;

  float rb[SPL], rd[SPL], ru[SPL], rv[SPL], r0[SPL], r1[SPL], a[SPL];
  const size_t prow = static_cast<size_t>(me.p) * M + m0;
  load_params<SPL>(b + prow, rb);
  load_params<SPL>(d + prow, rd);
  load_params<SPL>(u + prow, ru);
  load_params<SPL>(vv + prow, rv);
  load_params<SPL>(e0 + prow, r0);
  load_params<SPL>(e1 + prow, r1);
  load_params<SPL>(pi + me.i * M + m0, a);

  // period q's state goes to pstates[q, s, p, m0:m0+SPL]
  float* pst = pstates == nullptr
                   ? nullptr
                   : pstates + (static_cast<size_t>(me.s) * B + me.p) * M + m0;
  const size_t per_stride = static_cast<size_t>(S) * B * M;

  const int8_t* row = obs + static_cast<size_t>(me.s) * L;
  const int L_live = min(row_periods(live, me.s, L) * NORM_EVERY, L);  // the row's live end
  float acc = 0.f;
  for (int t0 = 0; t0 < L_live; t0 += OBS_TILE) {
    const int n = min(OBS_TILE, L_live - t0);
    __syncthreads();  // the previous tile's readers are done
    const int mis = stage_obs(row + t0, n, sh);
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += NORM_EVERY) {
      if (pst != nullptr && me.active)
        store_states<SPL>(pst + static_cast<size_t>((t0 + j0) / NORM_EVERY) * per_stride, a);
#pragma unroll
      for (int j = 0; j < NORM_EVERY; ++j) {
        const int ob = j0 + j < n ? sh[mis + j0 + j] : -2;
        float sv[SPL], pv[SPL];
        advance<G, SPL>(a, ob, me.lane, rb, rd, ru, rv, r0, r1, sv, pv);
      }
      const float c = fmaxf(group_sum<G, SPL>(a), TINY_NORM);
#pragma unroll
      for (int r = 0; r < SPL; ++r) a[r] = a[r] / c;
      acc += logf(c);
    }
  }
  if (me.active) {
    if (me.lane == 0) ll[me.i] = acc;
    store_states<SPL>(alpha + me.i * M + m0, a);
  }
}

// ---------------------------------------------------------------------------
// The split path: K segments a row (ops/smc.segment_plan), three launches.
// ---------------------------------------------------------------------------

struct FwdSplit {
  int K, P;                    // segments a row, periods a segment (P % CHECK_EVERY == 0)
  const int* live;             // (S,) each row's live periods, or nullptr (whole rows)
  float* pstates;              // (n_per, S, B, M) the period states (B2), or nullptr (B1)
  float* ckpt;                 // (n_chk, S, B, M) the states at the checkpoints (B1), or nullptr
  float* int_ll;               // (n_chk, S, B) each interval's sum of log c
  float* seg_ll;               // (K, S, B) each segment's sum of its intervals, in order
  float* spec_end;             // (K, S, B, M) the speculative pass's end states
  float* end;                  // (K, S, B, M) the end state of each segment's stored trajectory
  unsigned long long* counts;  // SplitCount
};

// Segment k of one instance's row from the state a (registers, advanced in
// place).  SPEC runs the whole segment and stores its trajectory; FIX
// compares a with the stored trajectory at each checkpoint and is done at the
// first one where they are equal bitwise (from there on the stored states are
// this chain's), storing its own states, interval sums and (if it never met)
// end state before that.  A group that is done (met, or a clamped copy)
// computes on for the shuffles and stores nothing.  Returns the sites the
// group ran before it was done.
template <int M, int SPL, bool FIX>
__device__ __forceinline__ unsigned forward_segment(float* a, bool& done, bool& met, int k,
                                                    const GroupLane& me, const Rows<SPL>& w,
                                                    const int8_t* __restrict__ row, int B, int S,
                                                    int L, const FwdSplit& ws, int8_t* sh) {
  constexpr int G = Group<M, SPL>::G;
  const int m0 = me.lane * SPL;
  const Segment seg(k, ws.P, row_periods(ws.live, me.s, L));
  const int t_end = min(seg.q1 * NORM_EVERY, L);
  const size_t inst = static_cast<size_t>(me.s) * B + me.p;  // chunk-major instance
  const size_t per = static_cast<size_t>(S) * B;             // instances a period
  unsigned ran = 0;
  bool wrote = false, stop = false;
  float acc = 0.f;
  for (int t0 = seg.q0 * NORM_EVERY; t0 < t_end && !stop; t0 += OBS_TILE) {
    const int n = min(OBS_TILE, t_end - t0);
    __syncthreads();  // the previous tile's readers are done
    const int mis = stage_obs(row + t0, n, sh);
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += NORM_EVERY) {
      const int q = (t0 + j0) / NORM_EVERY;
      if (q % CHECK_EVERY == 0) {
        const size_t i = q / CHECK_EVERY;
        if (q > seg.q0 && !done) {
          if (me.lane == 0) ws.int_ll[(i - 1) * per + inst] = acc;
          wrote = true;
        }
        acc = 0.f;
        float* st = ws.pstates != nullptr ? ws.pstates + (q * per + inst) * M + m0
                                          : ws.ckpt + (i * per + inst) * M + m0;
        if constexpr (FIX) {
          const bool same = group_equal<G, SPL>(a, st);
          met = met || (same && !done);
          done = done || same;
          if (!__syncthreads_or(!done)) {
            stop = true;
            break;
          }
        }
        if (!done && ws.ckpt != nullptr) store_states<SPL>(st, a);
      }
      if (!done && ws.pstates != nullptr)
        store_states<SPL>(ws.pstates + (q * per + inst) * M + m0, a);
      acc += logf(forward_period<G, SPL>(a, sh, mis, j0, n, me.lane, w.b, w.d, w.u, w.v, w.e0,
                                         w.e1));
      if (!done) ran += min(NORM_EVERY, n - j0);
    }
  }
  if (!stop && !done) {  // ran the whole segment: its last interval and its end
    if (me.lane == 0) ws.int_ll[static_cast<size_t>((seg.q1 - 1) / CHECK_EVERY) * per + inst] = acc;
    store_states<SPL>(ws.end + (static_cast<size_t>(k) * per + inst) * M + m0, a);
    wrote = true;
  }
  if (wrote && me.lane == 0) {  // the segment's sum of its intervals, in order
    float s = 0.f;
    for (int i = seg.q0 / CHECK_EVERY; i <= (seg.q1 - 1) / CHECK_EVERY; ++i)
      s += ws.int_ll[static_cast<size_t>(i) * per + inst];
    ws.seg_ll[static_cast<size_t>(k) * per + inst] = s;
  }
  return ran;
}

// Speculative pass: segment k = blockIdx.z from pi (exact for k = 0, a guess
// after), storing its whole trajectory; a segment past the row's live end
// is empty.
template <int M, int SPL>
__global__ void __launch_bounds__(Group<M, SPL>::THREADS)
smc_forward_kernel_speculate(const float* __restrict__ b, const float* __restrict__ d,
                             const float* __restrict__ u, const float* __restrict__ vv,
                             const float* __restrict__ e0, const float* __restrict__ e1,
                             const float* __restrict__ pi, const int8_t* __restrict__ obs,
                             int B, int S, int L, FwdSplit ws) {
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<Group<M, SPL>::G>(B, S);
  const int k = blockIdx.z;
  if (k * ws.P >= row_periods(ws.live, me.s, L)) return;  // the whole block's row
  const int m0 = me.lane * SPL;
  Rows<SPL> w;
  w.load(b, d, u, vv, e0, e1, static_cast<size_t>(me.p) * M + m0);
  float a[SPL];
  load_params<SPL>(pi + me.i * M + m0, a);
  bool done = !me.active, met = false;
  const unsigned ran = forward_segment<M, SPL, false>(a, done, met, k, me, w,
                                                      obs + static_cast<size_t>(me.s) * L, B, S,
                                                      L, ws, sh);
  if (me.active)
    store_states<SPL>(
        ws.spec_end + (static_cast<size_t>(k) * S * B + static_cast<size_t>(me.s) * B + me.p) * M + m0,
        a);
  const bool first = me.active && me.lane == 0;
  add_count(ws.counts, SEGMENTS, first ? 1u : 0u);
  add_count(ws.counts, SPLIT_SITES, first ? ran : 0u);
}

// Fix pass: segment k = blockIdx.z + 1 from segment k - 1's speculative end,
// up to the row's last live segment.
template <int M, int SPL>
__global__ void __launch_bounds__(Group<M, SPL>::THREADS)
smc_forward_kernel_fix(const float* __restrict__ b, const float* __restrict__ d,
                       const float* __restrict__ u, const float* __restrict__ vv,
                       const float* __restrict__ e0, const float* __restrict__ e1,
                       const int8_t* __restrict__ obs, int B, int S, int L, FwdSplit ws) {
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<Group<M, SPL>::G>(B, S);
  const int k = blockIdx.z + 1;
  if (k > last_segment(row_periods(ws.live, me.s, L), ws.P)) return;
  const int m0 = me.lane * SPL;
  Rows<SPL> w;
  w.load(b, d, u, vv, e0, e1, static_cast<size_t>(me.p) * M + m0);
  const size_t per = static_cast<size_t>(S) * B, inst = static_cast<size_t>(me.s) * B + me.p;
  float a[SPL];
  load_states<SPL>(ws.spec_end + ((k - 1) * per + inst) * M + m0, a);
  bool done = !me.active, met = false;
  const unsigned ran = forward_segment<M, SPL, true>(a, done, met, k, me, w,
                                                     obs + static_cast<size_t>(me.s) * L, B, S,
                                                     L, ws, sh);
  const bool first = me.active && me.lane == 0;
  add_count(ws.counts, RESOLVED, first && met ? 1u : 0u);
  add_count(ws.counts, FIX_SITES, first ? ran : 0u);
}

// Splice: a group an instance walks segments 1 .. k_last (the row's last
// live segment, K - 1 on whole rows) in order from segment 0's end,
// re-running (as the fix pass) any segment whose stored trajectory did not
// start from its predecessor's true end; then ll (the segments' sums in
// order) and alpha (the last live segment's end; pi and ll 0 on a row with
// no live period).
template <int M, int SPL>
__global__ void __launch_bounds__(Group<M, SPL>::THREADS)
smc_forward_kernel_splice(const float* __restrict__ b, const float* __restrict__ d,
                          const float* __restrict__ u, const float* __restrict__ vv,
                          const float* __restrict__ e0, const float* __restrict__ e1,
                          const float* __restrict__ pi, const int8_t* __restrict__ obs, int B,
                          int S, int L, FwdSplit ws, float* __restrict__ ll,
                          float* __restrict__ alpha) {
  __shared__ __align__(16) int8_t sh[OBS_TILE + 16];
  const GroupLane me = group_lane<Group<M, SPL>::G>(B, S);
  const int m0 = me.lane * SPL;
  Rows<SPL> w;
  w.load(b, d, u, vv, e0, e1, static_cast<size_t>(me.p) * M + m0);
  const size_t per = static_cast<size_t>(S) * B, inst = static_cast<size_t>(me.s) * B + me.p;
  const int k_last = last_segment(row_periods(ws.live, me.s, L), ws.P);
  float a[SPL];
  if (k_last < 0)
    load_params<SPL>(pi + me.i * M + m0, a);
  else
    load_states<SPL>(ws.end + inst * M + m0, a);
  unsigned ran = 0;
  for (int k = 1; k <= k_last; ++k) {
    bool done = !me.active, met = false;
    ran += forward_segment<M, SPL, true>(a, done, met, k, me, w,
                                         obs + static_cast<size_t>(me.s) * L, B, S, L, ws, sh);
    load_states<SPL>(ws.end + (k * per + inst) * M + m0, a);
  }
  if (me.active) {
    if (me.lane == 0) {
      float s = 0.f;
      for (int k = 0; k <= k_last; ++k) s += ws.seg_ll[k * per + inst];
      ll[me.i] = s;
    }
    store_states<SPL>(alpha + me.i * M + m0, a);
  }
  add_count(ws.counts, FIX_SITES, me.active && me.lane == 0 ? ran : 0u);
}

// Each row's live end (smc_common.cuh), a block a row: every thread finds
// the last observed site among its 16-site pieces of the row, the block takes
// the largest; then the row's live periods and its trimmed and whole
// instance-sites for a launch of B instances a row.
constexpr int LIVE_THREADS = 256;

__global__ void __launch_bounds__(LIVE_THREADS)
smc_live_kernel(const int8_t* __restrict__ obs, int L, int B, int* __restrict__ live,
                unsigned long long* __restrict__ counts) {
  __shared__ int best;
  if (threadIdx.x == 0) best = -1;
  __syncthreads();
  const int8_t* row = obs + static_cast<size_t>(blockIdx.x) * L;
  int last = -1;
  for (int t = threadIdx.x * 16; t < L; t += LIVE_THREADS * 16) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int ob = t + j < L ? row[t + j] : -2;
      last = ob == 0 || ob == 1 ? t + j : last;
    }
  }
  last = __reduce_max_sync(FULL_MASK, last);
  if ((threadIdx.x & 31) == 0) atomicMax(&best, last);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n_live = best < 0 ? 0 : best / NORM_EVERY + 1;
    live[blockIdx.x] = n_live;
    const long long past = L - min(n_live * NORM_EVERY, L);
    atomicAdd(counts + TRIMMED_SITES, static_cast<unsigned long long>(past * B));
    atomicAdd(counts + ROW_SITES, static_cast<unsigned long long>(static_cast<long long>(L) * B));
  }
}

extern "C" int phlash_smc_live_periods(const int8_t* obs, int S, int L, int B, int* live,
                                       unsigned long long* counts, void* stream) {
  if (S <= 0 || L <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  smc_live_kernel<<<S, LIVE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(obs, L, B, live,
                                                                              counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int phlash_smc_forward(const float* b, const float* d, const float* u,
                                  const float* vv, const float* e0, const float* e1,
                                  const float* pi, const int8_t* obs, const int* live, int B,
                                  int S, int L, int M, float* ll, float* alpha, float* pstates,
                                  void* stream) {
  if (B <= 0 || S <= 0 || S > 65535 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + INSTANCES_PER_BLOCK - 1) / INSTANCES_PER_BLOCK, S);
#define PHLASH_FWD(MM, SS)                                                              \
  if (M == MM) {                                                                        \
    smc_forward_kernel<MM, SS><<<grid, Group<MM, SS>::THREADS, 0, st>>>(                \
        b, d, u, vv, e0, e1, pi, obs, live, B, S, L, ll, alpha, pstates);               \
    return static_cast<int>(cudaGetLastError());                                        \
  }
  PHLASH_SMC_INSTANCES(PHLASH_FWD)
#undef PHLASH_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split forward: K >= 2 segments of P periods (the last may be shorter,
// none empty on whole rows); exactly one of pstates (B2) and ckpt (B1) is set.
extern "C" int phlash_smc_forward_split(const float* b, const float* d, const float* u,
                                        const float* vv, const float* e0, const float* e1,
                                        const float* pi, const int8_t* obs, const int* live,
                                        int B, int S, int L, int M, int K, int P, float* ll,
                                        float* alpha, float* pstates, float* ckpt,
                                        float* int_ll, float* seg_ll, float* spec_end,
                                        float* end, unsigned long long* counts, void* stream) {
  const int n_per = L > 0 ? (L + NORM_EVERY - 1) / NORM_EVERY : 0;
  if (B <= 0 || S <= 0 || S > 65535 || L <= 0 || K < 2 || K > 65535 || P <= 0 ||
      P % CHECK_EVERY != 0 || static_cast<long long>(K - 1) * P >= n_per ||
      static_cast<long long>(K) * P < n_per || (pstates == nullptr) == (ckpt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gx = (B + INSTANCES_PER_BLOCK - 1) / INSTANCES_PER_BLOCK;
  const FwdSplit ws{K, P, live, pstates, ckpt, int_ll, seg_ll, spec_end, end, counts};
#define PHLASH_FWD_SPLIT(MM, SS)                                                           \
  if (M == MM) {                                                                           \
    constexpr int T = Group<MM, SS>::THREADS;                                              \
    smc_forward_kernel_speculate<MM, SS><<<dim3(gx, S, K), T, 0, st>>>(                    \
        b, d, u, vv, e0, e1, pi, obs, B, S, L, ws);                                        \
    cudaError_t err = cudaGetLastError();                                                  \
    if (err != cudaSuccess) return static_cast<int>(err);                                  \
    smc_forward_kernel_fix<MM, SS><<<dim3(gx, S, K - 1), T, 0, st>>>(                      \
        b, d, u, vv, e0, e1, obs, B, S, L, ws);                                            \
    err = cudaGetLastError();                                                              \
    if (err != cudaSuccess) return static_cast<int>(err);                                  \
    smc_forward_kernel_splice<MM, SS><<<dim3(gx, S), T, 0, st>>>(                          \
        b, d, u, vv, e0, e1, pi, obs, B, S, L, ws, ll, alpha);                             \
    return static_cast<int>(cudaGetLastError());                                           \
  }
  PHLASH_SMC_INSTANCES(PHLASH_FWD_SPLIT)
#undef PHLASH_FWD_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int phlash_smc_check_every() { return CHECK_EVERY; }

// the kernels' mapping at M: states per lane (0 if no kernel is built for M)
// and instances per block
extern "C" int phlash_smc_states_per_lane(int M) {
#define PHLASH_SPL(MM, SS) \
  if (M == MM) return SS;
  PHLASH_SMC_INSTANCES(PHLASH_SPL)
#undef PHLASH_SPL
  return 0;
}

extern "C" int phlash_smc_instances_per_block() { return INSTANCES_PER_BLOCK; }

extern "C" const char* phlash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
