// The step's assembly and its gradient, two kernels (ops/assembly.py):
//   A1 assembly_forward_kernel<T>   flat coordinates (P, D) -> the seven
//      PSMCParams leaves (P, 7, M), the log prior (P,) and the AFS term (P,)
//   A2 assembly_backward_kernel<T>  the gradient (P, D) of
//      <g_leaves, leaves> + <g_prior, l_prior> + <g_afs, l_afs>
// for T = float (the cloud's default) and double (double_precision_params).
//
// Replaces no Pallas kernel: phlash_tpu's jitted SVGD step (mcmc.py:259)
// leaves this work to XLA, which fuses MCMCParams.to_dm, PSMCParams.from_dm
// (transition.transition_matrix, SizeHistory.ect / pi), log_prior and the
// AFS term (SizeHistory.etjj / etbl), and their reverse pass, into a few
// kernels.  The port ran the same mathematics as ~2,150 ATen kernels an
// SVGD iteration (PERF.md section 5).
//
// Bound on the H100: neither bytes (~0.25 MB) nor operations (a few MFLOP
// at 500 particles) but latency: one particle's assembly is a chain of
// ~2M dependent sub-interval blocks, each a dozen libdevice calls, and the
// launch itself costs microseconds.  Design: one thread per particle (A1)
// or per (particle, coordinate) (A2), each walking the intervals once
// (assembly_common.cuh); A2 re-runs A1's device function on dual numbers
// seeded with coordinate d, so it follows every branch exactly as the
// forward does and writes grad[p, d] with no atomics (deterministic).
// 128 threads a block; at the fit's 500 particles A1 fills 4 blocks and
// A2 (D = 18) 71.
#include "assembly_common.cuh"

using namespace phlash_assembly;

namespace {

constexpr int THREADS = 128;

template <class T>
struct Store {
  T* leaves;  // this particle's (7, M) block
  T* l_prior;
  T* l_afs;
  int M;
  __device__ void leaf(int f, int j, T v) { leaves[f * M + j] = v; }
  __device__ void prior(T v) { *l_prior = v; }
  __device__ void afs(T v) { *l_afs = v; }
};

// the directional derivative along the seeded coordinate, dotted with the
// cotangents as the assembly emits each output
template <class T>
struct Contract {
  const T* g;  // this particle's (7, M) cotangent block
  T g_prior, g_afs, acc;
  int M;
  __device__ void leaf(int f, int j, Dual<T> v) { acc += g[f * M + j] * v.d; }
  __device__ void prior(Dual<T> v) { acc += g_prior * v.d; }
  __device__ void afs(Dual<T> v) { acc += g_afs * v.d; }
};

template <class T>
__global__ void __launch_bounds__(THREADS)
assembly_forward_kernel(Inputs<T> in, T* __restrict__ leaves, T* __restrict__ l_prior,
                        T* __restrict__ l_afs, T* __restrict__ scratch) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= in.P) return;
  Store<T> out{leaves + static_cast<size_t>(p) * N_LEAVES * in.M, l_prior + p, l_afs + p, in.M};
  assemble<T, T>(in, p, -1, scratch + p, static_cast<size_t>(in.P), out);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
assembly_backward_kernel(Inputs<T> in, const T* __restrict__ g_leaves,
                         const T* __restrict__ g_prior, const T* __restrict__ g_afs,
                         T* __restrict__ grad, Dual<T>* __restrict__ scratch) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int threads = in.P * in.D;
  if (i >= threads) return;
  const int p = i / in.D, d = i % in.D;
  Contract<T> acc{g_leaves + static_cast<size_t>(p) * N_LEAVES * in.M, g_prior[p], g_afs[p],
                  T(0), in.M};
  assemble<Dual<T>, T>(in, p, d, scratch + i, static_cast<size_t>(threads), acc);
  grad[i] = acc.acc;
}

template <class T>
Inputs<T> inputs(const void* x, const long long* expand, const void* afs, const void* tr,
                 const void* w, int P, int D, int M, int nm1, int R, double theta,
                 double alpha, double beta) {
  return Inputs<T>{static_cast<const T*>(x), expand, static_cast<const T*>(afs),
                   static_cast<const T*>(tr), static_cast<const T*>(w), P, D, M, nm1, R,
                   static_cast<T>(theta), static_cast<T>(alpha), static_cast<T>(beta)};
}

bool valid(int P, int D, int M, int nm1, int R, const void* afs, const void* tr,
           const void* w) {
  if (P <= 0 || D < 4 || M < 3 || nm1 < 0 || R < 0) return false;
  if (nm1 > 0 && (afs == nullptr || w == nullptr || R == 0 || (tr == nullptr && R != nm1)))
    return false;
  return static_cast<long long>(P) * D < (1LL << 31);
}

}  // namespace

// elem: 4 (float) or 8 (double).  Scratch: (2M + n - 1) * P elements.
extern "C" int phlash_assembly_forward(int elem, const void* x, const long long* expand,
                                       const void* afs, const void* tr, const void* w, int P,
                                       int D, int M, int nm1, int R, double theta,
                                       double alpha, double beta, void* leaves, void* l_prior,
                                       void* l_afs, void* scratch, void* stream) {
  if (!valid(P, D, M, nm1, R, afs, tr, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (P + THREADS - 1) / THREADS;
  if (elem == 4) {
    assembly_forward_kernel<float><<<blocks, THREADS, 0, st>>>(
        inputs<float>(x, expand, afs, tr, w, P, D, M, nm1, R, theta, alpha, beta),
        static_cast<float*>(leaves), static_cast<float*>(l_prior), static_cast<float*>(l_afs),
        static_cast<float*>(scratch));
  } else if (elem == 8) {
    assembly_forward_kernel<double><<<blocks, THREADS, 0, st>>>(
        inputs<double>(x, expand, afs, tr, w, P, D, M, nm1, R, theta, alpha, beta),
        static_cast<double*>(leaves), static_cast<double*>(l_prior),
        static_cast<double*>(l_afs), static_cast<double*>(scratch));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Scratch: (2M + n - 1) * P * D dual numbers (2 elements each).
extern "C" int phlash_assembly_backward(int elem, const void* x, const long long* expand,
                                        const void* afs, const void* tr, const void* w, int P,
                                        int D, int M, int nm1, int R, double theta,
                                        double alpha, double beta, const void* g_leaves,
                                        const void* g_prior, const void* g_afs, void* grad,
                                        void* scratch, void* stream) {
  if (!valid(P, D, M, nm1, R, afs, tr, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (P * D + THREADS - 1) / THREADS;
  if (elem == 4) {
    assembly_backward_kernel<float><<<blocks, THREADS, 0, st>>>(
        inputs<float>(x, expand, afs, tr, w, P, D, M, nm1, R, theta, alpha, beta),
        static_cast<const float*>(g_leaves), static_cast<const float*>(g_prior),
        static_cast<const float*>(g_afs), static_cast<float*>(grad),
        static_cast<Dual<float>*>(scratch));
  } else if (elem == 8) {
    assembly_backward_kernel<double><<<blocks, THREADS, 0, st>>>(
        inputs<double>(x, expand, afs, tr, w, P, D, M, nm1, R, theta, alpha, beta),
        static_cast<const double*>(g_leaves), static_cast<const double*>(g_prior),
        static_cast<const double*>(g_afs), static_cast<double*>(grad),
        static_cast<Dual<double>*>(scratch));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// threads a block of both kernels (the launch geometry phase 5 prints)
extern "C" int phlash_assembly_threads_per_block() { return THREADS; }
