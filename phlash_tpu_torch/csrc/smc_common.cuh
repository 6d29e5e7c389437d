// Shared pieces of the structured SMC' forward and adjoint kernels.
//
// Layout (chosen for Hopper, not carried over from the TPU's lane tiles):
//   instance (p, s)                  one HMM per (particle p, chunk s), run by
//                                    a group of G = M / SPL lanes; lane l holds
//                                    states l*SPL .. l*SPL + SPL - 1
//   grid (ceil(B / 8), S)            8 instances of one chunk per block, so a
//                                    block (and every warp in it) shares one
//                                    observation row
//   params     (B, M) float32        one row per particle, read once
//   pi, alpha, gradients (B, S, M)   one row per instance
//   obs        (S, L) int8           raw rows {-2 pad, -1 missing, 0, 1},
//                                    staged into shared memory OBS_TILE sites
//                                    at a time; sites past L count as padding
//   pstates    (n_per, S, B, M)      chunk-major, so a warp's period store and
//                                    load is one run of consecutive floats
// A group past the last particle works on a clamped copy of it (its lanes must
// still take part in the shuffles) and stores nothing.
//
// The split path (ops/smc.segment_plan picks K > 1 segments a row where the
// unsplit grid leaves the card nearly empty): grid (ceil(B / 8), S, K), the
// z axis a segment of P periods (P a multiple of CHECK_EVERY, so every
// segment rescales at the unsplit kernel's sites).  Beside the outputs, a
// per-call workspace, chunk-major as pstates, over checkpoints (every
// CHECK_EVERY periods) and segments:
//   forward   states at the checkpoints (B1; B2 compares with pstates),
//             each interval's sum of log c (n_chk, S, B), each segment's sum
//             of its intervals and end state (K, S, B[, M]), and the
//             speculative pass's end states
//   adjoint   abar at the checkpoints, the abar each segment's sweep started
//             from, each interval's six gradient sums (n_chk, 6, S, B, M) and
//             each segment's sums over its intervals
// Three launches a direction: the speculative pass (every segment from a
// guess), the fix pass (segment k from its neighbour's speculative end, up
// to the first checkpoint where it equals the stored trajectory bitwise)
// and the splice (a group an instance walks the segments in order and
// re-runs any whose start was wrong).  What each stores stays one chain's
// trajectory over the segment, so a later re-run may stop at any match.
// The adjoint's three kernels keep each period's rebuild in shared memory
// (PeriodCache, dynamic, sized at launch) and are bound to
// ADJOINT_WARPS_PER_SM warps an SM, or, where a launch puts fewer warps on
// the card than register-cache kernels hold, in registers (RegisterCache).
//
// Each row's live end (`live`, (S,) int32, or nullptr for whole rows): the
// periods up to and including the one that holds the row's last observed
// site (code 0 or 1), n_live = last / NORM_EVERY + 1, 0 where the row has
// none; phlash_smc_live_periods finds them on the card.  Past that site
// every emission factor is 1 and the structured transition is row-stochastic,
// so the tail's rescalings sum to log 1 = 0: it adds nothing to ll, and its
// gradient with respect to the model's parameters is zero, as is its abar
// once the last live period's rescale takes the direction of ones out.  A
// likelihood that discards the final state (the step's and the held-out
// ELPD's) therefore runs each row to its live end only: the forward sums
// log c over n_live periods and stores their states, the adjoint starts at
// period n_live - 1 from abar0, and the split treats a segment wholly past
// n_live as empty (the last live segment k_last = (n_live - 1) / P takes the
// adjoint's exact start).  The live end is rounded up to a whole period, so
// every state and c before it keeps the whole-row kernel's bits.  The
// warm-up filter reads the final state, which a missing run at the end of
// its prefix does move: it always runs whole rows.  Grids and plans stay
// those of whole rows (L on the host); a block's row, and so its end, is
// uniform over the block.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace phlash {

constexpr int NORM_EVERY = 8;          // sites between rescalings (as on the TPU)
constexpr float TINY_NORM = 1e-30f;    // normalizer clamp (as on the TPU)
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int INSTANCES_PER_BLOCK = 8;
constexpr int OBS_TILE = 1024;         // sites per staged tile, a multiple of NORM_EVERY
static_assert(OBS_TILE % NORM_EVERY == 0, "a period must not straddle two tiles");
// periods between the split path's checkpoints: a fix chain compares with the
// stored trajectory there, and the per-interval sums are kept at that grain
constexpr int CHECK_EVERY = 16;

// the split path's device counters (ops/smc.DEVICE_COUNTS names them)
enum SplitCount { SEGMENTS = 0, RESOLVED = 1, FIX_SITES = 2, SPLIT_SITES = 3 };
// the live ends' device counters (ops/smc.TRIM_COUNTS names them): the
// instance-sites past the live ends and all instance-sites of the rows
enum TrimCount { TRIMMED_SITES = 0, ROW_SITES = 1 };

// The periods row s runs: its live end, or every period of L sites.
__device__ __forceinline__ int row_periods(const int* __restrict__ live, int s, int L) {
  return live == nullptr ? (L + NORM_EVERY - 1) / NORM_EVERY : live[s];
}

// emission factor: hom -> e0, het -> e1, missing -> 1 (padding never gets here)
__device__ __forceinline__ float emis_factor(int ob, float e0, float e1) {
  return ob == 0 ? e0 : (ob == 1 ? e1 : 1.f);
}

// The (M, SPL) template instances built, one SPL per M: the kernels' whole
// mapping, which the library reports by phlash_smc_states_per_lane.  At
// M = 16 SPL = 4 ran both kernels faster than SPL = 1 (PERF.md); M = 64
// needs SPL >= 2 (G <= 32).
#define PHLASH_SMC_INSTANCES(X) X(8, 2) X(16, 4) X(32, 2) X(64, 4)

template <int M, int SPL>
struct Group {
  static constexpr int G = M / SPL;                          // lanes per instance
  static constexpr int THREADS = INSTANCES_PER_BLOCK * G;    // threads per block
  static_assert(M % SPL == 0 && G >= 4 && G <= 32 && (G & (G - 1)) == 0,
                "a group is 4 to 32 lanes, a power of two");
};

struct GroupLane {
  int p, s;     // particle (clamped to the last one) and chunk
  size_t i;     // instance row p * S + s of the (B, S, ...) tensors
  int lane;     // lane within the group
  bool active;  // false on a clamped copy: compute, store nothing
};

template <int G>
__device__ __forceinline__ GroupLane group_lane(int B, int S) {
  GroupLane r;
  const int raw = blockIdx.x * INSTANCES_PER_BLOCK + static_cast<int>(threadIdx.x) / G;
  r.active = raw < B;
  r.p = r.active ? raw : B - 1;
  r.s = blockIdx.y;
  r.i = static_cast<size_t>(r.p) * S + r.s;
  r.lane = threadIdx.x % G;
  return r;
}

// SPL consecutive floats; 16- or 8-byte accesses where SPL allows (the caller
// passes addresses aligned to SPL floats)
template <int SPL>
__device__ __forceinline__ void load_states(const float* __restrict__ src, float* dst) {
  if constexpr (SPL % 4 == 0) {
#pragma unroll
    for (int k = 0; k < SPL / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(src)[k];
      dst[4 * k] = v.x, dst[4 * k + 1] = v.y, dst[4 * k + 2] = v.z, dst[4 * k + 3] = v.w;
    }
  } else if constexpr (SPL % 2 == 0) {
#pragma unroll
    for (int k = 0; k < SPL / 2; ++k) {
      const float2 v = reinterpret_cast<const float2*>(src)[k];
      dst[2 * k] = v.x, dst[2 * k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int r = 0; r < SPL; ++r) dst[r] = src[r];
  }
}

template <int SPL>
__device__ __forceinline__ void store_states(float* __restrict__ dst, const float* src) {
  if constexpr (SPL % 4 == 0) {
#pragma unroll
    for (int k = 0; k < SPL / 4; ++k)
      reinterpret_cast<float4*>(dst)[k] =
          make_float4(src[4 * k], src[4 * k + 1], src[4 * k + 2], src[4 * k + 3]);
  } else if constexpr (SPL % 2 == 0) {
#pragma unroll
    for (int k = 0; k < SPL / 2; ++k)
      reinterpret_cast<float2*>(dst)[k] = make_float2(src[2 * k], src[2 * k + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < SPL; ++r) dst[r] = src[r];
  }
}

// Per-particle rows (b, d, u, vv, e0, e1) are read with scalar loads: the
// caller's tensors may start anywhere.
template <int SPL>
__device__ __forceinline__ void load_params(const float* __restrict__ src, float* dst) {
#pragma unroll
  for (int r = 0; r < SPL; ++r) dst[r] = src[r];
}

// sum of SPL values as a pairwise tree (a short dependence chain)
template <int N>
__device__ __forceinline__ float tree_sum(const float* x) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    return tree_sum<N / 2>(x) + tree_sum<N - N / 2>(x + N / 2);
  }
}

// Exclusive suffix of x and exclusive prefix of w over the M states of a
// group, both at once: for state m = lane * SPL + r
//   sx[r] = sum_{m' > m} x[m'],   pw[r] = sum_{m' < m} w[m'].
// Each lane scans its own SPL states; the lanes' totals are scanned across
// the group: first the totals of lanes l+1, l+2, l+3 (l-1, l-2, l-3 for the
// prefix) by three independent shuffles, then Kogge-Stone doubling from span
// 4, one shuffle a step.  That is as many shuffles as a plain Kogge-Stone
// scan and one round fewer: G = 4 takes one round, 8 two, 16 three.  The two
// scans' shuffles are interleaved.  The suffix is a reverse scan, never
// total - prefix: the states span ~1e-34 to 1 and a difference would lose
// the small ones.
template <int G, int SPL>
__device__ __forceinline__ void scan_pair(const float* x, const float* w, int lane, float* sx,
                                          float* pw) {
  // the lane's own states, off the shuffles' chain: sx[r] (pw[r]) first holds
  // the sum over this lane's states after (before) r
  if constexpr (SPL > 1) {
    sx[SPL - 2] = x[SPL - 1];
    pw[1] = w[0];
#pragma unroll
    for (int r = SPL - 3; r >= 0; --r) sx[r] = sx[r + 1] + x[r + 1];
#pragma unroll
    for (int r = 2; r < SPL; ++r) pw[r] = pw[r - 1] + w[r - 1];
  }
  // lane totals; then ix (iw) sums lanes [l, l + k) ((l - k, l]), ox (ow)
  // lanes (l, l + k) ((l - k, l)) as the span k grows
  // (every lane shuffles; the lanes past the group's edge then select 0)
  float ix = tree_sum<SPL>(x), iw = tree_sum<SPL>(w);
  const float x1 = __shfl_down_sync(FULL_MASK, ix, 1, G);
  const float w1 = __shfl_up_sync(FULL_MASK, iw, 1, G);
  const float x2 = __shfl_down_sync(FULL_MASK, ix, 2, G);
  const float w2 = __shfl_up_sync(FULL_MASK, iw, 2, G);
  const float x3 = __shfl_down_sync(FULL_MASK, ix, 3, G);
  const float w3 = __shfl_up_sync(FULL_MASK, iw, 3, G);
  float ox = (lane + 1 < G ? x1 : 0.f) + ((lane + 2 < G ? x2 : 0.f) + (lane + 3 < G ? x3 : 0.f));
  float ow = (lane >= 1 ? w1 : 0.f) + ((lane >= 2 ? w2 : 0.f) + (lane >= 3 ? w3 : 0.f));
  ix += ox, iw += ow;
#pragma unroll
  for (int k = 4; k < G; k <<= 1) {
    const float xk = __shfl_down_sync(FULL_MASK, ix, k, G);
    const float wk = __shfl_up_sync(FULL_MASK, iw, k, G);
    const float mx = lane + k < G ? xk : 0.f;
    const float mw = lane >= k ? wk : 0.f;
    ox += mx, ow += mw;
    ix += mx, iw += mw;
  }
  sx[SPL - 1] = ox;
  pw[0] = ow;
#pragma unroll
  for (int r = 0; r < SPL - 1; ++r) sx[r] += ox;
#pragma unroll
  for (int r = 1; r < SPL; ++r) pw[r] += ow;
}

// sum over the group's M states by an xor butterfly: every lane of the group
// ends with the same bits
template <int G, int SPL>
__device__ __forceinline__ float group_sum(const float* x) {
  float s = tree_sum<SPL>(x);
#pragma unroll
  for (int k = G / 2; k >= 1; k >>= 1) s += __shfl_xor_sync(FULL_MASK, s, k, G);
  return s;
}

// One site of the forward for this lane's states:
//   a <- (b S(a) + d a + vv P(u a)) f(ob), or a unchanged on padding.
// Every lane runs the scans whatever ob is (the shuffles need the whole warp).
// sv / pv receive S(a) and P(u a) of the input state.
template <int G, int SPL>
__device__ __forceinline__ void advance(float* a, int ob, int lane, const float* rb,
                                        const float* rd, const float* ru, const float* rv,
                                        const float* r0, const float* r1, float* sv,
                                        float* pv) {
  float ua[SPL];
#pragma unroll
  for (int r = 0; r < SPL; ++r) ua[r] = ru[r] * a[r];
  scan_pair<G, SPL>(a, ua, lane, sv, pv);
#pragma unroll
  for (int r = 0; r < SPL; ++r) {
    const float v = rb[r] * sv[r] + rd[r] * a[r] + rv[r] * pv[r];
    a[r] = ob == -2 ? a[r] : v * emis_factor(ob, r0[r], r1[r]);
  }
}

// Stage sites [0, n) of `src` into shared `sh` (OBS_TILE + 16 bytes, 16-byte
// aligned) with the whole block; returns the index in `sh` of site 0.  The
// bytes keep their offset within a 16-byte word, so the whole words of the
// row go by 16-byte loads (a warp reads 512 consecutive bytes) and only the
// ragged head and tail go byte by byte.  The caller synchronizes.
__device__ __forceinline__ int stage_obs(const int8_t* __restrict__ src, int n, int8_t* sh) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int8_t* base = src - mis;
  const int w0 = (mis + 15) >> 4, w1 = (mis + n) >> 4;  // whole words [w0, w1)
  for (int w = w0 + threadIdx.x; w < w1; w += blockDim.x)
    reinterpret_cast<int4*>(sh)[w] = __ldg(reinterpret_cast<const int4*>(base) + w);
  const int head_end = min(w0 * 16, mis + n);
  for (int k = mis + threadIdx.x; k < head_end; k += blockDim.x) sh[k] = base[k];
  for (int k = max(w0, w1) * 16 + threadIdx.x; k < mis + n; k += blockDim.x) sh[k] = base[k];
  return mis;
}

// One period of the forward, the unsplit kernel's loop body: the NORM_EVERY
// sites from j0 of a tile staged at sh[mis] (those at or past n are
// padding), then the rescale; returns c.
template <int G, int SPL>
__device__ __forceinline__ float forward_period(float* a, const int8_t* sh, int mis, int j0,
                                                int n, int lane, const float* rb,
                                                const float* rd, const float* ru,
                                                const float* rv, const float* r0,
                                                const float* r1) {
#pragma unroll
  for (int j = 0; j < NORM_EVERY; ++j) {
    const int ob = j0 + j < n ? sh[mis + j0 + j] : -2;
    float sv[SPL], pv[SPL];
    advance<G, SPL>(a, ob, lane, rb, rd, ru, rv, r0, r1, sv, pv);
  }
  const float c = fmaxf(group_sum<G, SPL>(a), TINY_NORM);
#pragma unroll
  for (int r = 0; r < SPL; ++r) a[r] = a[r] / c;
  return c;
}

// The split adjoint's residency: the warps an SM its three kernels are built
// to hold (__launch_bounds__: at M = 16, 16 one-warp blocks of at most 128
// registers a thread), ops/smc.TARGET_WARPS_PER_SM["adjoint"].  They fit
// because the period cache below lives in shared memory, not in registers.
constexpr int ADJOINT_WARPS_PER_SM = 16;

// The arrays of the split adjoint's period cache, a site's x, S(x), P(u x).
enum CacheArray { CACHE_X = 0, CACHE_SX = 1, CACHE_PV = 2, CACHE_ARRAYS = 3 };

// The split adjoint's period cache: the rebuild's x, S(x) and P(u x) at each
// of a period's NORM_EVERY sites (3 x 8 x SPL floats a lane: 96 at M = 16,
// which in registers would hold the kernels to 8 warps an SM), in the
// block's dynamic shared memory, a slice a warp laid out [site][array][lane]
// as SPL-float vectors: a warp's access is 32 consecutive vectors (512 bytes
// at SPL = 4), without bank conflicts.  A lane reads back only what it wrote,
// so no barrier is needed.  The accesses are PTX of their own (asm volatile):
// the compiler keeps them where they are written, so it can neither forward
// a stored value to its load (which would hold it in a register again) nor
// move a load above its store.
template <int SPL>
struct PeriodCache {
  static_assert(SPL == 2 || SPL == 4, "a lane's states are one 8- or 16-byte access");
  static constexpr int VEC = SPL * 4;                                     // bytes a lane's vector
  static constexpr int WARP_BYTES = NORM_EVERY * CACHE_ARRAYS * 32 * VEC;  // a warp's slice
  // the cache of a block of `threads` threads (a multiple of 32)
  static constexpr size_t bytes(int threads) {
    return static_cast<size_t>(threads / 32) * WARP_BYTES;
  }
  unsigned lane;  // shared-window address of this lane's vector at (site 0, X)
  __device__ __forceinline__ explicit PeriodCache(void* smem)
      : lane(static_cast<unsigned>(__cvta_generic_to_shared(smem)) +
             threadIdx.x / 32 * WARP_BYTES + threadIdx.x % 32 * VEC) {}
  __device__ __forceinline__ unsigned at(int j, int k) const {
    return lane + (j * CACHE_ARRAYS + k) * 32 * VEC;
  }
  __device__ __forceinline__ void put(int j, int k, const float* x) const {
    if constexpr (SPL == 4) {
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(at(j, k)), "f"(x[0]),
                   "f"(x[1]), "f"(x[2]), "f"(x[3]));
    } else {
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(at(j, k)), "f"(x[0]), "f"(x[1]));
    }
  }
  __device__ __forceinline__ void get(int j, int k, float* x) const {
    if constexpr (SPL == 4) {
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                   : "r"(at(j, k)));
    } else {
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(x[0]), "=f"(x[1]) : "r"(at(j, k)));
    }
  }
};

// The same cache in registers (its arrays indexed by unrolled counters only):
// no shared memory and no loads, but 3 x 8 x SPL registers a lane, which hold
// the kernels to 8 warps an SM at M = 16; the faster of the two where a launch
// puts no more warps than that on the card (ops/smc.backward_launch).
template <int SPL>
struct RegisterCache {
  float v[NORM_EVERY][CACHE_ARRAYS][SPL];
  __device__ __forceinline__ void put(int j, int k, const float* x) {
#pragma unroll
    for (int r = 0; r < SPL; ++r) v[j][k][r] = x[r];
  }
  __device__ __forceinline__ void get(int j, int k, float* x) const {
#pragma unroll
    for (int r = 0; r < SPL; ++r) x[r] = v[j][k][r];
  }
};

// A period's NORM_EVERY observation codes, four to a word (a byte each), so
// that the split adjoint holds them in two registers, not eight.
struct PeriodCodes {
  unsigned w[2];
  // codes of sites j0 .. j0 + 7 of a tile staged at sh[mis] (past n: padding)
  __device__ __forceinline__ PeriodCodes(const int8_t* sh, int mis, int j0, int n) {
    w[0] = w[1] = 0u;
#pragma unroll
    for (int j = 0; j < NORM_EVERY; ++j) {
      const int ob = j0 + j < n ? sh[mis + j0 + j] : -2;
      w[j >> 2] |= (static_cast<unsigned>(ob) & 0xffu) << (8 * (j & 3));
    }
  }
  __device__ __forceinline__ int operator[](int j) const {
    return static_cast<int>(static_cast<int8_t>((w[j >> 2] >> (8 * (j & 3))) & 0xffu));
  }
};

// One period of the split adjoint: rebuild the period's sites from its start
// state a (overwritten) into `cache` (a PeriodCache or a RegisterCache), then
// sweep them in reverse from abar
// (ab, in and out) with the ll cotangent g, adding to the six gradient
// accumulators.  No step of the abar chain (y -> vbar -> scan_pair -> xbar)
// reads the cache, only the accumulators and v do: a site's cache is loaded
// after its scan, so that it holds no register through the shuffles.  A
// site's code is the block's (one row a block), so the emission terms' adds
// are predicated on it, not selected: a select's + 0.f on another code leaves
// an accumulator that starts at +0 as it was.
template <int G, int SPL, class Cache>
__device__ __forceinline__ void reverse_period(float* a, const PeriodCodes& codes, float* ab,
                                               float g, int lane, Cache& cache,
                                               const float* rb, const float* rd,
                                               const float* ru, const float* rv,
                                               const float* r0, const float* r1, float* gb,
                                               float* gd, float* gu, float* gv, float* g0,
                                               float* g1) {
#pragma unroll
  for (int j = 0; j < NORM_EVERY; ++j) {
    float sv[SPL], pv[SPL];
    cache.put(j, CACHE_X, a);
    advance<G, SPL>(a, codes[j], lane, rb, rd, ru, rv, r0, r1, sv, pv);
    cache.put(j, CACHE_SX, sv);
    cache.put(j, CACHE_PV, pv);
  }
  const float c = fmaxf(group_sum<G, SPL>(a), TINY_NORM);
  float y[SPL];
#pragma unroll
  for (int r = 0; r < SPL; ++r) y[r] = ab[r] * (a[r] / c);
  const float dot = group_sum<G, SPL>(y);
#pragma unroll
  for (int r = 0; r < SPL; ++r) y[r] = (ab[r] - dot + g) / c;

#pragma unroll
  for (int j = NORM_EVERY - 1; j >= 0; --j) {
    const int ob = codes[j];
    const bool live = ob != -2;
    float vbar[SPL], wv[SPL], wb[SPL], t1[SPL], pb[SPL];
#pragma unroll
    for (int r = 0; r < SPL; ++r) {
      vbar[r] = emis_factor(ob, r0[r], r1[r]) * (live ? y[r] : 0.f);
      wv[r] = rv[r] * vbar[r];
      wb[r] = rb[r] * vbar[r];
    }
    scan_pair<G, SPL>(wv, wb, lane, t1, pb);  // S(vv vbar), P(b vbar)
    float xs[SPL], svs[SPL], pvs[SPL];  // site j's x, S(x), P(u x)
    cache.get(j, CACHE_X, xs);
    cache.get(j, CACHE_SX, svs);
    cache.get(j, CACHE_PV, pvs);
#pragma unroll
    for (int r = 0; r < SPL; ++r) {
      // the emission term's product rounded on its own (__fmul_rn: not fused
      // into the add), as the select's operand was
      const float v = rb[r] * svs[r] + rd[r] * xs[r] + rv[r] * pvs[r];
      if (ob == 0) g0[r] += __fmul_rn(v, y[r]);
      if (ob == 1) g1[r] += __fmul_rn(v, y[r]);
      gb[r] += svs[r] * vbar[r];
      gd[r] += xs[r] * vbar[r];
      gv[r] += pvs[r] * vbar[r];
      gu[r] += xs[r] * t1[r];
      const float xbar = pb[r] + rd[r] * vbar[r] + ru[r] * t1[r];
      y[r] = live ? xbar : y[r];
    }
  }
#pragma unroll
  for (int r = 0; r < SPL; ++r) ab[r] = y[r];
}

// ---------------------------------------------------------------------------
// the split path's pieces
// ---------------------------------------------------------------------------

// A lane's six per-particle rows (b, d, u, vv, e0, e1).
template <int SPL>
struct Rows {
  float b[SPL], d[SPL], u[SPL], v[SPL], e0[SPL], e1[SPL];
  __device__ __forceinline__ void load(const float* __restrict__ pb, const float* __restrict__ pd,
                                       const float* __restrict__ pu, const float* __restrict__ pv,
                                       const float* __restrict__ p0, const float* __restrict__ p1,
                                       size_t o) {
    load_params<SPL>(pb + o, b);
    load_params<SPL>(pd + o, d);
    load_params<SPL>(pu + o, u);
    load_params<SPL>(pv + o, v);
    load_params<SPL>(p0 + o, e0);
    load_params<SPL>(p1 + o, e1);
  }
};

// Whether the group's M states equal a stored copy bit for bit (every lane of
// the group gets the same answer).
template <int G, int SPL>
__device__ __forceinline__ bool group_equal(const float* x, const float* __restrict__ stored) {
  float s[SPL];
  load_states<SPL>(stored, s);
  int same = 1;
#pragma unroll
  for (int r = 0; r < SPL; ++r) same &= __float_as_uint(x[r]) == __float_as_uint(s[r]);
#pragma unroll
  for (int k = G / 2; k >= 1; k >>= 1) same &= __shfl_xor_sync(FULL_MASK, same, k, G);
  return same != 0;
}

// Add v (each lane's share; the whole warp calls) to device counter `which`:
// one atomic a warp, integer only.
__device__ __forceinline__ void add_count(unsigned long long* counts, int which, unsigned v) {
  const unsigned s = __reduce_add_sync(FULL_MASK, v);
  if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(counts + which, static_cast<unsigned long long>(s));
}

// The periods [q0, q1) of segment k (of P periods) in a row that runs n_per
// (its live end): empty where q0 >= n_per.
struct Segment {
  int q0, q1;
  __device__ __forceinline__ Segment(int k, int P, int n_per)
      : q0(k * P), q1(min(k * P + P, n_per)) {}
};

// The row's last live segment (its adjoint's exact start), -1 where the row
// has no live period.
__device__ __forceinline__ int last_segment(int n_live, int P) {
  return n_live > 0 ? (n_live - 1) / P : -1;
}

}  // namespace phlash
