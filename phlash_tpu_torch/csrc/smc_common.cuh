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

}  // namespace phlash
