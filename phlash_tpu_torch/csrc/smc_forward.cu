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
#include "smc_common.cuh"

using namespace phlash;

template <int M, int SPL>
__global__ void __launch_bounds__(Group<M, SPL>::THREADS)
smc_forward_kernel(const float* __restrict__ b, const float* __restrict__ d,
                   const float* __restrict__ u, const float* __restrict__ vv,
                   const float* __restrict__ e0, const float* __restrict__ e1,
                   const float* __restrict__ pi, const int8_t* __restrict__ obs,
                   int B, int S, int L, float* __restrict__ ll,
                   float* __restrict__ alpha, float* __restrict__ pstates) {
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
  float acc = 0.f;
  for (int t0 = 0; t0 < L; t0 += OBS_TILE) {
    const int n = min(OBS_TILE, L - t0);
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

extern "C" int phlash_smc_forward(const float* b, const float* d, const float* u,
                                  const float* vv, const float* e0, const float* e1,
                                  const float* pi, const int8_t* obs, int B, int S, int L,
                                  int M, float* ll, float* alpha, float* pstates,
                                  void* stream) {
  if (B <= 0 || S <= 0 || S > 65535 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + INSTANCES_PER_BLOCK - 1) / INSTANCES_PER_BLOCK, S);
#define PHLASH_FWD(MM, SS)                                                              \
  if (M == MM) {                                                                        \
    smc_forward_kernel<MM, SS><<<grid, Group<MM, SS>::THREADS, 0, st>>>(                \
        b, d, u, vv, e0, e1, pi, obs, B, S, L, ll, alpha, pstates);                     \
    return static_cast<int>(cudaGetLastError());                                        \
  }
  PHLASH_SMC_INSTANCES(PHLASH_FWD)
#undef PHLASH_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

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
