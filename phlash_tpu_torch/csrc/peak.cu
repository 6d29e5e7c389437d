// Issue-rate micro-kernels (replace the TPU kernel B6: tools/vpu_peak.py run,
// bodies _make_fma, _make_roll, _make_mix and _make_multiport).
//
// What they compute, as the TPU tool does on one (TB, M, LANES) = (4, 16, 128)
// float32 block: `streams` independent chains, chain k starting at
// a * (1 + 0.01 k), run `inner` steps (inner / UNROLL iterations of UNROLL
// inlined steps, then the remaining inner % UNROLL steps one at a time), and
// the block's output is the chains' sum in stream order.  The TPU tool runs
// INNER = 2048 steps, which every UNROLL divides; a shorter `inner` that no
// UNROLL divides is how the check reaches the roll's wrap and direction
// (after 2048 steps roll's chains are all +inf, and a 16-cycle of states is
// back where it began).  The step, with roll(x)[m] = x[m - 1 mod M] along the M axis:
//   fma        a <- a b + c
//   roll       a <- b a + roll(a)
//   mix        a <- b a + (m >= 1 ? roll(a) : 0) + c a
//   multiport  even streams a <- a b + c on one (M, LANES) row a[k % TB] with
//              b[0], c[0]; odd streams a <- roll(a); the sum is row 0 of the
//              output, the other rows are zeros.
//
// Layout: the SMC' kernels' own (smc_common.cuh).  A column of M = 16 states
// is held by a group of G = M / SPL = 4 lanes, SPL = 4 states (registers) a
// lane, lane l holding states l SPL .. l SPL + SPL - 1.  roll by one state is
// a shift through the lane's registers (renaming, no instruction) and one
// __shfl_sync from lane (l - 1) mod G of the group for the lane's first
// state: cyclic, as the roll is (__shfl_up_sync is not).  mix selects lane
// 0's incoming value to 0 after the shuffle, as scan_pair does at the group's
// edge (a shuffle never sits in a branch).  Per step and stream a lane issues
//   fma 4 FFMA;  roll 4 FFMA + 1 SHFL;  mix 8 FFMA + 1 SHFL + 1 FSEL;
//   multiport 4 FFMA (even) or 1 SHFL (odd)
// (ops/peak.py STEP_COUNTS; the loop's own counter and branch are not
// counted, as vpu_peak does not count them).
//
// A launch runs `copies` copies of the block's work, copy i writing slice i
// of a (copies, TB, M, LANES) output; each slice equals the TPU kernel's one
// block.  The TPU tool's grid, which repeats one block for timing, is this
// `copies`.  A copy is TB * LANES columns (LANES for multiport, whose work is
// one row), 64 warps (16); `threads` a block is the caller's, so that one
// sweep runs both regimes: the card filled, and the SMC' kernels' own
// geometry of one-warp blocks at ~2.4 warps an SM.
//
// Bound on the H100: the pipe each step issues on.  FFMA issues at 4
// warp-instructions a clock an SM (the FP32 pipe), SHFL at 1 (the shuffle
// path, the counterpart of the TPU's one sublane-rotate port), any
// instruction at 4 (one dispatch a clock in each of the SM's 4 partitions).
// With few warps resident a dependent chain issues once per its latency, far
// below these: the sweep measures both.  Nothing is read from or written to
// memory inside the loop; the chains' operands are registers.
#include <cuda_runtime.h>

namespace phlash::peak {

constexpr int TB = 4, M = 16, LANES = 128;  // the TPU tool's block
constexpr int INNER = 2048;                 // steps a chain in the TPU tool
constexpr int SPL = 4;                      // states a lane
constexpr int G = M / SPL;                  // lanes a column
constexpr unsigned FULL_MASK = 0xffffffffu;
enum : int { FMA = 0, ROLL = 1, MIX = 2, MULTIPORT = 3 };

// columns of M states in one copy of the block's work
__host__ __device__ constexpr int columns(int kind) {
  return (kind == MULTIPORT ? 1 : TB) * LANES;
}

}  // namespace phlash::peak

// The (kind, streams, unroll) instances built: tools/vpu_peak.py main's sweep
// (fma, roll, mix at (4, 1), (4, 8), (8, 8), (16, 8); multiport at (8, 8),
// (16, 8), (24, 8), (32, 8)) and mix at (16, 16), (24, 16), the plateau the
// TPU's measurements name.  ops/peak.py CONFIGS must list the same.
#define PHLASH_PEAK_INSTANCES(X)                                                  \
  X(FMA, 4, 1) X(FMA, 4, 8) X(FMA, 8, 8) X(FMA, 16, 8)                            \
  X(ROLL, 4, 1) X(ROLL, 4, 8) X(ROLL, 8, 8) X(ROLL, 16, 8)                        \
  X(MIX, 4, 1) X(MIX, 4, 8) X(MIX, 8, 8) X(MIX, 16, 8) X(MIX, 16, 16) X(MIX, 24, 16) \
  X(MULTIPORT, 8, 8) X(MULTIPORT, 16, 8) X(MULTIPORT, 24, 8) X(MULTIPORT, 32, 8)

using namespace phlash::peak;

// One step of one chain: x holds the lane's SPL states of the chain.
template <int KIND>
__device__ __forceinline__ void step(float* x, const float* rb, const float* rc, int src,
                                     bool edge, bool odd) {
  if constexpr (KIND == FMA) {
#pragma unroll
    for (int r = 0; r < SPL; ++r) x[r] = fmaf(x[r], rb[r], rc[r]);
  } else if constexpr (KIND == ROLL || KIND == MIX) {
    const float s = __shfl_sync(FULL_MASK, x[SPL - 1], src, G);
    const float in = KIND == MIX && edge ? 0.f : s;  // state 0 takes nothing in mix
#pragma unroll
    for (int r = SPL - 1; r >= 0; --r) {
      const float prev = r > 0 ? x[r - 1] : in;
      const float t = fmaf(rb[r], x[r], prev);
      x[r] = KIND == MIX ? fmaf(rc[r], x[r], t) : t;
    }
  } else {  // MULTIPORT: `odd` is a compile-time constant of the unrolled stream loop
    if (odd) {
      const float s = __shfl_sync(FULL_MASK, x[SPL - 1], src, G);
#pragma unroll
      for (int r = SPL - 1; r > 0; --r) x[r] = x[r - 1];
      x[0] = s;
    } else {
#pragma unroll
      for (int r = 0; r < SPL; ++r) x[r] = fmaf(x[r], rb[r], rc[r]);
    }
  }
}

template <int KIND, int STREAMS, int UNROLL>
__global__ void peak_kernel(const float* __restrict__ a, const float* __restrict__ b,
                            const float* __restrict__ c, int inner, float* __restrict__ out) {
  static_assert(INNER % UNROLL == 0, "UNROLL must divide INNER");
  constexpr int COLS = columns(KIND);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int group = t / G, lane = t % G;
  const int copy = group / COLS, col = group % COLS;
  const int tb = col / LANES, n = col % LANES;  // tb is 0 for multiport
  const int src = (lane + G - 1) % G;           // the lane holding state lane * SPL - 1
  const bool edge = lane == 0;                  // holds state 0
  // offset of the lane's state r of row `row` in a (TB, M, LANES) array
  auto at = [&](int row, int r) { return (row * M + lane * SPL + r) * LANES + n; };

  float rb[SPL], rc[SPL], x[STREAMS][SPL];
#pragma unroll
  for (int r = 0; r < SPL; ++r) rb[r] = b[at(tb, r)], rc[r] = c[at(tb, r)];
#pragma unroll
  for (int k = 0; k < STREAMS; ++k) {
    const float f = static_cast<float>(1.0 + 0.01 * k);  // the TPU tool's float32 factor
    const int row = KIND == MULTIPORT ? k % TB : tb;
#pragma unroll
    for (int r = 0; r < SPL; ++r) x[k][r] = a[at(row, r)] * f;
  }

#pragma unroll 1
  for (int i = 0; i < inner / UNROLL; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < STREAMS; ++k) step<KIND>(x[k], rb, rc, src, edge, k % 2 == 1);
    }
  }
  if constexpr (UNROLL > 1) {  // the steps left over; none at INNER
#pragma unroll 1
    for (int i = 0; i < inner % UNROLL; ++i) {
#pragma unroll
      for (int k = 0; k < STREAMS; ++k) step<KIND>(x[k], rb, rc, src, edge, k % 2 == 1);
    }
  }

  // every chain reaches the output: its sum in stream order
  float* o = out + static_cast<size_t>(copy) * TB * M * LANES;
#pragma unroll
  for (int r = 0; r < SPL; ++r) {
    float s = x[0][r];
#pragma unroll
    for (int k = 1; k < STREAMS; ++k) s += x[k][r];
    o[at(tb, r)] = s;
    if constexpr (KIND == MULTIPORT) {
#pragma unroll
      for (int row = 1; row < TB; ++row) o[at(row, r)] = 0.f;
    }
  }
}

// One launch of micro-kernel `kind` (0 fma, 1 roll, 2 mix, 3 multiport) at
// (streams, unroll), `inner` steps a chain, on `copies` copies, `threads` a
// block (a multiple of 32 that divides the copies' threads); a, b, c are
// (TB, M, LANES) float32, out (copies, TB, M, LANES).  Returns a CUDA error
// code (invalid value for an instance that is not built or a geometry that
// does not fit).
extern "C" int phlash_peak(int kind, int streams, int unroll, const float* a, const float* b,
                           const float* c, int inner, int copies, int threads, float* out,
                           void* stream) {
  if (kind < FMA || kind > MULTIPORT || inner < 0 || copies <= 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(copies) * columns(kind) * G;
  if (total % threads != 0 || total / threads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(total / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PHLASH_PEAK(K, S, U)                                               \
  if (kind == K && streams == S && unroll == U) {                          \
    peak_kernel<K, S, U><<<blocks, threads, 0, st>>>(a, b, c, inner, out); \
    return static_cast<int>(cudaGetLastError());                           \
  }
  PHLASH_PEAK_INSTANCES(PHLASH_PEAK)
#undef PHLASH_PEAK
  return static_cast<int>(cudaErrorInvalidValue);
}
