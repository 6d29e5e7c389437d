// Structured SMC' forward kernel (replaces the TPU kernels B1/B2:
// phlash_tpu/ops/pallas_smc.py forward_structured, body _make_fwd_kernel).
//
// Each thread runs one (particle, chunk) HMM over its chunk's sites:
//   v = b * S(a) + d * a + vv * P(u * a)      (S/P strict suffix/prefix sums)
//   a = v * f(obs)                            (padding freezes a)
// and every NORM_EVERY sites c = max(sum a, TINY_NORM), a /= c, ll += log c.
// With pstates != nullptr (B2) it also stores the state at every period
// start: the adjoint's residual.
//
// Bound: the per-site dependence chain (two O(M) scans) of only B*S
// independent chains; at the fit shape B*S = 2500 threads = 79 warps, in
// 20 blocks of 128, so 20 of the 132 SMs hold work.  The state vector and
// parameters stay in registers (spilling to local memory for M >= 32).
// See ops/smc.py for the design note.
#include "smc_common.cuh"

using namespace phlash;

template <int M>
__global__ void __launch_bounds__(THREADS)
smc_forward_kernel(const float* __restrict__ b, const float* __restrict__ d,
                   const float* __restrict__ u, const float* __restrict__ vv,
                   const float* __restrict__ e0, const float* __restrict__ e1,
                   const float* __restrict__ pi, const int8_t* __restrict__ obs,
                   int B, int S, int L, float* __restrict__ ll,
                   float* __restrict__ alpha, float* __restrict__ pstates) {
  const int n = B * S;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = i / S;
  const int s = i - p * S;

  float rb[M], rd[M], ru[M], rv[M], r0[M], r1[M], a[M];
  load_row<M>(b, p, rb);
  load_row<M>(d, p, rd);
  load_row<M>(u, p, ru);
  load_row<M>(vv, p, rv);
  load_row<M>(e0, p, r0);
  load_row<M>(e1, p, r1);
  load_row<M>(pi, i, a);

  const int8_t* row = obs + static_cast<size_t>(s) * L;
  const int n_per = (L + NORM_EVERY - 1) / NORM_EVERY;
  float acc = 0.f;
  for (int q = 0; q < n_per; ++q) {
    if (pstates != nullptr) {
      float* dst = pstates + static_cast<size_t>(q) * M * n + i;
#pragma unroll
      for (int m = 0; m < M; ++m) dst[static_cast<size_t>(m) * n] = a[m];
    }
#pragma unroll
    for (int j = 0; j < NORM_EVERY; ++j) {
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
#pragma unroll
    for (int m = 0; m < M; ++m) a[m] = a[m] / c;
    acc += logf(c);
  }
  ll[i] = acc;
  store_row<M>(alpha, i, a);
}

template <int M>
static void launch(const float* b, const float* d, const float* u, const float* vv,
                   const float* e0, const float* e1, const float* pi, const int8_t* obs,
                   int B, int S, int L, float* ll, float* alpha, float* pstates,
                   cudaStream_t stream) {
  const int n = B * S;
  const int blocks = (n + THREADS - 1) / THREADS;
  smc_forward_kernel<M><<<blocks, THREADS, 0, stream>>>(b, d, u, vv, e0, e1, pi, obs, B, S,
                                                        L, ll, alpha, pstates);
}

extern "C" int phlash_smc_forward(const float* b, const float* d, const float* u,
                                  const float* vv, const float* e0, const float* e1,
                                  const float* pi, const int8_t* obs, int B, int S, int L,
                                  int M, float* ll, float* alpha, float* pstates,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 8: launch<8>(b, d, u, vv, e0, e1, pi, obs, B, S, L, ll, alpha, pstates, st); break;
    case 16: launch<16>(b, d, u, vv, e0, e1, pi, obs, B, S, L, ll, alpha, pstates, st); break;
    case 32: launch<32>(b, d, u, vv, e0, e1, pi, obs, B, S, L, ll, alpha, pstates, st); break;
    case 64: launch<64>(b, d, u, vv, e0, e1, pi, obs, B, S, L, ll, alpha, pstates, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* phlash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
