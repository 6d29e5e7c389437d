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
// at 500 particles) but latency: a particle's assembly chains 2M - 1
// sub-interval blocks, each a dozen libdevice calls, and its prefix sums.
// Design (assembly_common.cuh): a warp a particle, lanes on the intervals.  The blocks, the emissions and every other per-interval value
// are computed by all lanes at once; only their product (the occupancy),
// the prefix sums and the reductions cross lanes, as Kogge-Stone scans and
// butterflies of depth 5.  A2 runs the forward and one reverse pass
// (suffix scans; each lane's local adjoint on width-3 dual numbers) and
// writes grad[p, :] once, with no atomics: graphed equals eager bitwise.
// A particle's state sits in dynamic shared memory, sized at launch from M,
// n - 1 and R; up to MAX_WARPS warps a block, fewer where a particle's
// workspace is large, and a shape whose one particle exceeds the card's
// opt-in limit is refused (phlash_assembly_geometry; the wrapper raises).
#include "assembly_common.cuh"

using namespace phlash_assembly;

constexpr int MAX_WARPS = 4;  // warps (particles) a block, fewer where a workspace is large

// warp w of the block: particle blockIdx.x * warps + w, its workspace the w-th slice
template <class T>
__device__ __forceinline__ Work<T> warp_work(const Inputs<T>& in, bool grad, int warp) {
  extern __shared__ __align__(16) unsigned char smem[];
  return carve(reinterpret_cast<T*>(smem) + warp * work_elems(LANES, in.M, in.nm1, in.R, grad),
               LANES, in.M, in.nm1, in.R, grad);
}

template <class T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
assembly_forward_kernel(Inputs<T> in, T* __restrict__ leaves, T* __restrict__ l_prior,
                        T* __restrict__ l_afs) {
  const int warp = threadIdx.x / 32, p = blockIdx.x * (blockDim.x / 32) + warp;
  if (p >= in.P) return;  // the whole warp: no collective is left waiting
  assemble<LANES, T>(in, p, warp_work(in, false, warp), leaves, l_prior, l_afs);
}

template <class T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
assembly_backward_kernel(Inputs<T> in, const T* __restrict__ g_leaves,
                         const T* __restrict__ g_prior, const T* __restrict__ g_afs,
                         T* __restrict__ grad) {
  const int warp = threadIdx.x / 32, p = blockIdx.x * (blockDim.x / 32) + warp;
  if (p >= in.P) return;
  gradient<LANES, T>(in, p, warp_work(in, true, warp), g_leaves, g_prior, g_afs, grad);
}

namespace {

struct Geometry {
  int warps;        // warps (particles) a block
  size_t smem;      // shared bytes a block
  size_t particle;  // shared bytes a particle
  int limit;        // the card's opt-in shared bytes a block
};

int smem_limit() {
  static int limits[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (limits[dev] == 0)
    cudaDeviceGetAttribute(&limits[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limits[dev];
}

// the launch's geometry; warps 0 when one particle's workspace exceeds the limit
Geometry geometry(int elem, int M, int nm1, int R, bool grad) {
  Geometry g;
  g.particle = work_elems(LANES, M, nm1, R, grad) * static_cast<size_t>(elem);
  g.limit = smem_limit();
  const size_t fit = g.particle > 0 ? static_cast<size_t>(g.limit) / g.particle : 0;
  g.warps = static_cast<int>(fit < MAX_WARPS ? fit : MAX_WARPS);
  g.smem = g.particle * g.warps;
  return g;
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

// launch `kernel` (an instance in T) in geometry g on `args`
template <class K, class... A>
int launch(K kernel, const Geometry& g, int P, cudaStream_t st, A... args) {
  if (g.warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(P + g.warps - 1) / g.warps, g.warps * 32, g.smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// elem: 4 (float) or 8 (double)
extern "C" int phlash_assembly_forward(int elem, const void* x, const long long* expand,
                                       const void* afs, const void* tr, const void* w, int P,
                                       int D, int M, int nm1, int R, double theta,
                                       double alpha, double beta, void* leaves, void* l_prior,
                                       void* l_afs, void* stream) {
  if (!valid(P, D, M, nm1, R, afs, tr, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(elem, M, nm1, R, false);
  if (elem == 4)
    return launch(assembly_forward_kernel<float>, g, P, st,
                  inputs<float>(x, expand, afs, tr, w, P, D, M, nm1, R, theta, alpha, beta),
                  static_cast<float*>(leaves), static_cast<float*>(l_prior),
                  static_cast<float*>(l_afs));
  if (elem == 8)
    return launch(assembly_forward_kernel<double>, g, P, st,
                  inputs<double>(x, expand, afs, tr, w, P, D, M, nm1, R, theta, alpha, beta),
                  static_cast<double*>(leaves), static_cast<double*>(l_prior),
                  static_cast<double*>(l_afs));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int phlash_assembly_backward(int elem, const void* x, const long long* expand,
                                        const void* afs, const void* tr, const void* w, int P,
                                        int D, int M, int nm1, int R, double theta,
                                        double alpha, double beta, const void* g_leaves,
                                        const void* g_prior, const void* g_afs, void* grad,
                                        void* stream) {
  if (!valid(P, D, M, nm1, R, afs, tr, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(elem, M, nm1, R, true);
  if (elem == 4)
    return launch(assembly_backward_kernel<float>, g, P, st,
                  inputs<float>(x, expand, afs, tr, w, P, D, M, nm1, R, theta, alpha, beta),
                  static_cast<const float*>(g_leaves), static_cast<const float*>(g_prior),
                  static_cast<const float*>(g_afs), static_cast<float*>(grad));
  if (elem == 8)
    return launch(assembly_backward_kernel<double>, g, P, st,
                  inputs<double>(x, expand, afs, tr, w, P, D, M, nm1, R, theta, alpha, beta),
                  static_cast<const double*>(g_leaves), static_cast<const double*>(g_prior),
                  static_cast<const double*>(g_afs), static_cast<double*>(grad));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The geometry of A1 (grad 0) or A2 (grad 1) at these widths on the current device:
// out = {lanes a particle, warps (particles) a block, shared bytes a block, shared bytes a
// particle, the device's opt-in shared bytes a block}.  Returns 0, or 1 when one particle's
// workspace exceeds the opt-in limit (the launch would be refused).
extern "C" int phlash_assembly_geometry(int elem, int M, int nm1, int R, int grad, long long* out) {
  const Geometry g = geometry(elem, M, nm1, R, grad != 0);
  out[0] = LANES;
  out[1] = g.warps;
  out[2] = static_cast<long long>(g.smem);
  out[3] = static_cast<long long>(g.particle);
  out[4] = g.limit;
  return g.warps == 0 ? 1 : 0;
}
