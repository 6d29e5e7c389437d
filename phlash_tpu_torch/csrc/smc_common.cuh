// Shared pieces of the structured SMC' forward and adjoint kernels.
//
// Layout (chosen for Hopper, not carried over from the TPU's lane tiles):
//   instance i = p * S + s           one thread per (particle p, chunk s) HMM
//   params     (B, M) float32        one row per particle, read once into
//                                    registers / local memory
//   pi, alpha, gradients (B, S, M)   one row per instance
//   obs        (S, L) int8           raw rows {-2 pad, -1 missing, 0, 1};
//                                    sites past L count as padding
//   pstates    (n_per, M, B * S)     state-major, instance fastest, so the
//                                    threads of a warp write/read adjacent
//                                    words at every period boundary
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace phlash {

constexpr int NORM_EVERY = 8;      // sites between rescalings (as on the TPU)
constexpr float TINY_NORM = 1e-30f;  // normalizer clamp (as on the TPU)
constexpr int THREADS = 128;       // threads per block

// y[j] = sum_{k > j} x[k]
template <int M>
__device__ __forceinline__ void suffix_strict(const float* x, float* y) {
  float run = 0.f;
#pragma unroll
  for (int j = M - 1; j >= 0; --j) {
    y[j] = run;
    run += x[j];
  }
}

// y[j] = sum_{k < j} x[k]
template <int M>
__device__ __forceinline__ void prefix_strict(const float* x, float* y) {
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    y[j] = run;
    run += x[j];
  }
}

// v = x @ A in the compressed form b * S(x) + d * x + vv * P(u * x)
template <int M>
__device__ __forceinline__ void transition(const float* x, const float* b, const float* d,
                                           const float* u, const float* vv, float* v) {
  float sv[M];
  suffix_strict<M>(x, sv);
  float pre = 0.f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    v[j] = b[j] * sv[j] + d[j] * x[j] + vv[j] * pre;
    pre += u[j] * x[j];
  }
}

// emission factor: hom -> e0, het -> e1, missing -> 1 (padding never gets here)
__device__ __forceinline__ float emis_factor(int ob, float e0, float e1) {
  return ob == 0 ? e0 : (ob == 1 ? e1 : 1.f);
}

__device__ __forceinline__ int site_obs(const int8_t* row, int t, int L) {
  return t < L ? static_cast<int>(row[t]) : -2;
}

template <int M>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int row, float* dst) {
#pragma unroll
  for (int m = 0; m < M; ++m) dst[m] = src[static_cast<size_t>(row) * M + m];
}

template <int M>
__device__ __forceinline__ void store_row(float* __restrict__ dst, int row, const float* src) {
#pragma unroll
  for (int m = 0; m < M; ++m) dst[static_cast<size_t>(row) * M + m] = src[m];
}

}  // namespace phlash
