// The SVGD update of one iteration, three kernels (ops/svgd.py):
//   S1 svgd_distances_kernel<T>  particles x (P, D), gradients g (P, D) ->
//      the strict lower triangle of pairwise squared distances, row-major
//      (i > j at i (i - 1) / 2 + j), x and g transposed (D, P) with every
//      non-finite gradient 0, for S3, and the selection's first digit
//   S2 svgd_bandwidth_kernel<T>  that triangle -> h = max(med^2 / log P, 1e-12),
//      med the median of the off-diagonal distances, by exact selection
//   S3 svgd_update_kernel<T>     the RBF direction phi of rows [row0, row0 + B)
//      over every particle, then amsgrad: new particles, mu, nu, nu_max (B, D)
//      and count + 1
// for T = float (the cloud's default) and double (double_precision_params).
//
// Replaces phlash_tpu/svgd.py:32-76 (_kth_smallest_bits, _offdiag_median_select:
// the exact bitwise median that phlash_tpu takes on the accelerator because the
// full sort was the largest non-kernel term of its SVGD step) and
// svgd.py:79-130 (median_bandwidth, svgd_direction), with the optax amsgrad
// step that phlash_tpu's jitted step fuses after it (mcmc.py:259).
//
// Bound on the H100: neither bytes (~1 MB at P = 500, D = 18) nor operations
// (~40 MFLOP) but latency: launches, and the selection's passes over the
// triangle, each of which needs the pass before it.  The plain version runs
// ~50 ATen kernels, one of them a full sort of the P^2 - P distances.
//
// The selection.  Non-negative IEEE floats order as their bit patterns read
// as unsigned integers, so the k-th smallest is found digit by digit from the
// top: a pass histograms the next RADIX bits of the elements that share the
// digits chosen so far, and a scan of the histogram picks the bin that holds
// rank k (3 passes for float, 5 for double).  The median of the P (P - 1) / 2
// triangle values is the median of the off-diagonal multiset, in which each
// appears twice.  A pass over the whole triangle is spread over many blocks;
// the last block to finish (a ticket counter) reads the summed histogram and
// picks the bin, so two launches make two such passes with no grid-wide wait:
//   pass 0: S1's blocks, as they write the triangle;
//   pass 1: S2's blocks, each over a slice of the triangle, also copying the
//     elements that share pass 0's digit (the candidates) into its own region
//     of a workspace;
//   passes 2 on: S2's last block alone, over the candidates (copied into its
//     shared memory when they fit, as they do unless the cloud is nearly
//     degenerate); then, for an even count, the upper middle rank: a
//     duplicate of the lower (the histograms say so) or the least value above
//     it, a min over the smallest candidate set that holds that rank.
// Each launch sums its histogram and takes its tickets in a workspace of its
// own (2^RADIX + 1 counters, the caller's memory), which the C entry point
// zeroes on the launch's stream first: launches on any streams are
// independent, and a launch that failed leaves nothing behind.
// Counts are integers and each min is exact: deterministic whatever the order
// in which blocks and atomics land.  The arithmetic after the selection is the
// plain version's on the card, op for op (sqrt is monotone, so it commutes
// with the selection): h is bitwise the sort's.  Within a block, a warp whose
// lanes all hold one key adds once (a degenerate cloud puts every element in
// one bin).
//
// S3: a block a row, lanes on columns: in tiles of 512 columns, lane l of warp
// w takes columns 32 (COLS w + c) + l, c < COLS, loading CH coordinates of
// each at a time from x^T and g^T (coalesced, many loads in flight).  K[r, j]
// = exp(-sq / h) stays in registers (never in device memory), sq over the
// coordinates in S1's order (one fma each, in double), so the distances that
// set h are those in K.  Each lane sums K g and K (x_j - x_r) over its
// columns in order, a butterfly sums the lanes, lane 0 adds the tile's sums
// to its warp's, and warp 0 adds the warps' in order: every row is summed
// alike in every run with no float atomics (graphed equals eager bitwise).
// Then amsgrad in T.  The repulsion summed as K (x_j - x_r) equals
// K x - rowsum(K) x_r in exact arithmetic and does not cancel: coincident
// particles repel exactly 0.  The distances, K and the sums are in double
// whatever T (the work is ~40 MFLOP at P = 500: the card's float64 rate costs
// nothing here), so a float32 direction carries little more than the
// rounding of its inputs and of h.  Shared memory is 9 D doubles a row, so
// any P runs; a D above the card's opt-in limit is refused
// (phlash_svgd_geometry).
#include <cuda_runtime.h>

namespace {

constexpr int DIST_THREADS = 256;
constexpr int DIST_BLOCKS = 128;    // S1's blocks at most (grid-stride over the pairs)
constexpr int SELECT_THREADS = 1024;
constexpr int SELECT_BLOCKS = 64;   // S2's blocks (a slice of the triangle each)
constexpr int UPDATE_WARPS = 4;     // S3's warps a block (a row)
constexpr int COLS = 4;             // S3: columns a lane takes at a time
constexpr int CH = 4;               // S3: coordinates a lane loads at a time
constexpr int ITEMS = 4;            // S2's last block: loads a lane keeps in flight
constexpr int RADIX = 13;
constexpr int BINS = 1 << RADIX;
constexpr unsigned FULL = 0xffffffffu;

template <class T>
struct Bits;
template <>
struct Bits<float> {
  using U = unsigned int;
  static __device__ __forceinline__ U of(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ float value(U b) { return __uint_as_float(b); }
};
template <>
struct Bits<double> {
  using U = unsigned long long;
  static __device__ __forceinline__ U of(double v) {
    return static_cast<U>(__double_as_longlong(v));
  }
  static __device__ __forceinline__ double value(U b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
};

// The selection's state after a pass: the digits chosen (prefix), k_lo's rank
// among the elements that share them, and how many do.
struct Sel {
  long long prefix, rank, count;
};

// digit bounds of pass p: bits [lo, hi) of an nbits-wide pattern
__device__ __forceinline__ int digit_hi(int nbits, int p) { return nbits - RADIX * p; }
__device__ __forceinline__ int digit_lo(int nbits, int p) {
  const int hi = digit_hi(nbits, p);
  return hi > RADIX ? hi - RADIX : 0;
}

// add 1 to hist[key] (key < 0: nothing) for each lane; a warp whose lanes all
// hold one key adds 32 once.  Every lane of the warp must call it.
__device__ __forceinline__ void count_key(unsigned* hist, int key) {
  const int lane = threadIdx.x & 31;
  const int first = __shfl_sync(FULL, key, 0);
  if (__all_sync(FULL, key == first)) {
    if (lane == 0 && key >= 0) atomicAdd(&hist[key], 32u);
  } else if (key >= 0) {
    atomicAdd(&hist[key], 1u);
  }
}

// exclusive prefix sum of v over the block (a multiple of 32 threads, at most
// 1024); `warp_sums` holds 32 values of shared memory
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned v, unsigned* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  unsigned inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < warps ? warp_sums[lane] : 0u;
    unsigned winc = w;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(FULL, winc, o);
      if (lane >= o) winc += t;
    }
    if (lane < warps) warp_sums[lane] = winc - w;
  }
  __syncthreads();
  const unsigned out = warp_sums[warp] + inc - v;
  __syncthreads();  // warp_sums is read again by the next call
  return out;
}

// The block picks the bin of the shared histogram `hist` that holds rank
// `in.rank` and appends its `width` bits to the prefix: the state after the
// pass.  Each of the NT threads scans BINS / NT bins.  `sums` holds 32 values
// and `out` one Sel of shared memory.
template <int NT>
__device__ Sel choose(const unsigned* hist, const Sel& in, int width, unsigned* sums, Sel* out) {
  constexpr int per = BINS / NT;
  const int first = threadIdx.x * per;
  unsigned c[per], mine = 0;
#pragma unroll
  for (int b = 0; b < per; ++b) mine += c[b] = hist[first + b];
  long long before = block_exclusive_sum(mine, sums);
#pragma unroll
  for (int b = 0; b < per; ++b) {
    if (in.rank >= before && in.rank < before + c[b])
      *out = Sel{(in.prefix << width) | (first + b), in.rank - before, c[b]};
    before += c[b];
  }
  __syncthreads();
  return *out;
}

// The shared histogram `hist` becomes its exclusive prefix sums (each bin's
// offset), also written to out[0, BINS), and out[BINS] the total.
template <int NT>
__device__ void to_offsets(unsigned* hist, unsigned* sums, unsigned* out) {
  constexpr int per = BINS / NT;
  const int first = threadIdx.x * per;
  unsigned c[per], mine = 0;
#pragma unroll
  for (int b = 0; b < per; ++b) mine += c[b] = hist[first + b];
  unsigned at = block_exclusive_sum(mine, sums);
#pragma unroll
  for (int b = 0; b < per; ++b) {
    hist[first + b] = at;
    at += c[b];
  }
  if (threadIdx.x == NT - 1) out[BINS] = at;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < per; ++i) out[threadIdx.x + i * NT] = hist[threadIdx.x + i * NT];
  __syncthreads();  // every offset copied before the caller moves them on
}

// add the block's shared histogram to the launch's, ws[0, BINS)
template <int NT>
__device__ void add_hist(const unsigned* hist, unsigned* ws) {
#pragma unroll
  for (int i = 0; i < BINS / NT; ++i) {
    const int b = threadIdx.x + i * NT;
    if (hist[b] != 0) atomicAdd(&ws[b], hist[b]);
  }
}

// the launch's histogram into the shared `hist` (the last block of a launch,
// when every block has added)
template <int NT>
__device__ void take_hist(unsigned* hist, const unsigned* ws) {
#pragma unroll
  for (int i = 0; i < BINS / NT; ++i) {
    const int b = threadIdx.x + i * NT;
    hist[b] = __ldcg(&ws[b]);
  }
  __syncthreads();
}

// Every block takes a ticket (ws[BINS]) once its writes are done.  True in
// the last block to finish, which then sees every block's writes (the fence
// before each ticket).
__device__ bool last_block(unsigned* ws, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(&ws[BINS], 1u) == gridDim.x - 1;
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

// the block's least u (every thread gets it); `mins` holds 32 values of shared memory
template <class U>
__device__ __forceinline__ U block_min(U u, U* mins) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const U t = __shfl_xor_sync(FULL, u, o);
    u = t < u ? t : u;
  }
  if (lane == 0) mins[warp] = u;
  __syncthreads();
  u = lane < warps ? mins[lane] : ~U(0);
  for (int o = 16; o > 0; o >>= 1) {
    const U t = __shfl_xor_sync(FULL, u, o);
    u = t < u ? t : u;
  }
  return u;
}

}  // namespace

template <class T>
__global__ void __launch_bounds__(DIST_THREADS)
svgd_distances_kernel(const T* __restrict__ x, const T* __restrict__ g, int P, int D,
                      long long m, int staged, T* __restrict__ tri, T* __restrict__ xt,
                      T* __restrict__ gt, long long* __restrict__ sel, unsigned* __restrict__ ws) {
  using U = typename Bits<T>::U;
  constexpr int NBITS = 8 * sizeof(U);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned hist[BINS];
  __shared__ unsigned sums[32];
  __shared__ Sel s_sel;
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n = static_cast<long long>(P) * D;
  for (int b = tid; b < BINS; b += DIST_THREADS) hist[b] = 0;
  // the cloud in shared memory where it fits (rows read across lanes there)
  T* xs = staged ? reinterpret_cast<T*>(smem) : nullptr;
  if (staged)
    for (long long k = tid; k < n; k += DIST_THREADS) xs[k] = x[k];
  __syncthreads();
  const T* __restrict__ rows = staged ? xs : x;
  const long long stride = static_cast<long long>(gridDim.x) * DIST_THREADS;
  for (long long k = static_cast<long long>(blockIdx.x) * DIST_THREADS + tid; k < n;
       k += stride) {
    const long long at = (k % D) * P + k / D;
    const T v = g[k];
    xt[at] = x[k];
    gt[at] = isfinite(v) ? v : T(0);
  }
  // warp-uniform trip count: every lane reaches count_key
  for (long long base = static_cast<long long>(blockIdx.x) * DIST_THREADS + 32 * warp;
       base < m; base += stride) {
    const long long k = base + lane;
    int key = -1;
    if (k < m) {
      // the pair (i, j), i > j, of k = i (i - 1) / 2 + j
      long long i =
          static_cast<long long>(0.5 * (1.0 + sqrt(1.0 + 8.0 * static_cast<double>(k))));
      while (i * (i - 1) / 2 > k) --i;
      while (i * (i + 1) / 2 <= k) ++i;
      const long long j = k - i * (i - 1) / 2;
      double acc = 0.0;
      for (int d = 0; d < D; ++d) {
        const double t =
            static_cast<double>(rows[i * D + d]) - static_cast<double>(rows[j * D + d]);
        acc = fma(t, t, acc);
      }
      const T v = static_cast<T>(acc);
      tri[k] = v;
      key = static_cast<int>(Bits<T>::of(v) >> (NBITS - RADIX));  // pass 0's digit: the top bits
    }
    count_key(hist, key);
  }
  __syncthreads();
  add_hist<DIST_THREADS>(hist, ws);
  if (!last_block(ws, &s_last)) return;
  take_hist<DIST_THREADS>(hist, ws);
  const Sel s = choose<DIST_THREADS>(hist, Sel{0, (m - 1) / 2, m}, RADIX, sums, &s_sel);
  if (tid == 0) {
    sel[0] = s.prefix;
    sel[1] = s.rank;
    sel[2] = s.count;
  }
}

template <class T>
__global__ void __launch_bounds__(SELECT_THREADS)
svgd_bandwidth_kernel(const T* __restrict__ tri, long long m, const long long* __restrict__ sel,
                      T inv_log, int capacity, typename Bits<T>::U* __restrict__ work,
                      long long chunk, unsigned* __restrict__ offs, unsigned* __restrict__ ws,
                      T* __restrict__ h) {
  using U = typename Bits<T>::U;
  constexpr int NBITS = 8 * sizeof(U);
  constexpr int PASSES = (NBITS + RADIX - 1) / RADIX;
  constexpr int NT = SELECT_THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  U* cand = reinterpret_cast<U*>(smem);  // the last block's `capacity` candidates
  __shared__ unsigned hist[BINS];
  __shared__ unsigned sums[32];
  __shared__ U mins[32];
  __shared__ Sel s_sel;
  __shared__ unsigned s_fill;
  __shared__ int s_next;
  __shared__ bool s_last;
  const U* __restrict__ bits = reinterpret_cast<const U*>(tri);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long k_lo = (m - 1) / 2, k_hi = m / 2;  // the two middle ranks
  const Sel s0{sel[0], sel[1], sel[2]};              // after pass 0 (S1)
  const int hi1 = digit_hi(NBITS, 1), lo1 = digit_lo(NBITS, 1);
  const U dmask1 = (U(1) << (hi1 - lo1)) - 1;

  // pass 1 over this block's slice; then its elements that share pass 0's
  // digit go to its region of `work`, in the order of their pass-1 digit (its
  // bins' offsets in offs[block], BINS + 1 of them)
  for (int b = tid; b < BINS; b += NT) hist[b] = 0;
  __syncthreads();
  const long long first = blockIdx.x * chunk;
  const long long end = first + chunk < m ? first + chunk : m;
  U* region = work + first;
  unsigned* my_offs = offs + static_cast<long long>(blockIdx.x) * (BINS + 1);
  for (long long base = first + 32 * warp; base < end; base += NT) {
    const long long e = base + lane;
    const U v = e < end ? bits[e] : U(0);
    const bool match = e < end && static_cast<long long>(v >> hi1) == s0.prefix;
    count_key(hist, match ? static_cast<int>((v >> lo1) & dmask1) : -1);
  }
  __syncthreads();
  add_hist<NT>(hist, ws);
  to_offsets<NT>(hist, sums, my_offs);
  for (long long e = first + tid; e < end; e += NT) {
    const U v = bits[e];
    if (static_cast<long long>(v >> hi1) == s0.prefix)
      region[atomicAdd(&hist[static_cast<int>((v >> lo1) & dmask1)], 1u)] = v;
  }
  if (!last_block(ws, &s_last)) return;

  // the last block: pick pass 1's bin, then passes 2 on over its elements
  take_hist<NT>(hist, ws);
  Sel s = choose<NT>(hist, s0, hi1 - lo1, sums, &s_sel);
  const int b1 = static_cast<int>(s.prefix & static_cast<long long>(dmask1));
  const long long base1 = k_lo - s.rank, count1 = s.count;  // pass 1's set: ranks, size
  if (tid == 0) s_next = BINS;  // the next non-empty bin of pass 1 after b1
  __syncthreads();
  for (int b = b1 + 1 + tid; b < BINS; b += NT)
    if (hist[b] != 0) atomicMin(&s_next, b);
  __syncthreads();
  const int next = s_next;
  for (int b = tid; b < BINS; b += NT) hist[b] = 0;
  const int regions = gridDim.x;
  // f(ok, v) for every element of pass 1's bin `bin` (ok false on a lane past
  // the end), by every lane of every warp (warp-uniform trips)
  auto each_in_bin = [&](int bin, auto&& f) {
    for (int r = warp; r < regions; r += NT / 32) {
      const unsigned* o = offs + static_cast<long long>(r) * (BINS + 1);
      const long long lo = __ldcg(&o[bin]), hi = __ldcg(&o[bin + 1]);
      const U* reg = work + r * chunk;
      for (long long base = lo; base < hi; base += 32 * ITEMS) {
        U v[ITEMS];
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          const long long e = base + 32 * i + lane;
          v[i] = e < hi ? __ldcg(&reg[e]) : U(0);
        }
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) f(base + 32 * i + lane < hi, v[i]);
      }
    }
  };
  // pass 1's set into shared memory where it fits
  const bool in_smem = count1 <= capacity;
  if (in_smem) {
    if (tid == 0) s_fill = 0;
    __syncthreads();
    each_in_bin(b1, [&](bool ok, U v) {
      const unsigned in = __ballot_sync(FULL, ok);
      unsigned at = 0;
      if (lane == 0 && in != 0) at = atomicAdd(&s_fill, static_cast<unsigned>(__popc(in)));
      at = __shfl_sync(FULL, at, 0);
      if (ok) cand[at + __popc(in & ((1u << lane) - 1))] = v;
    });
  }
  __syncthreads();
  // f(ok, v) for every element of pass 1's set
  auto each = [&](auto&& f) {
    if (in_smem) {
      for (long long base = 32 * warp; base < count1; base += NT) {
        const long long e = base + lane;
        f(e < count1, e < count1 ? cand[e] : U(0));
      }
    } else {
      each_in_bin(b1, f);
    }
  };
  for (int p = 2; p < PASSES; ++p) {
    const int hi = digit_hi(NBITS, p), lo = digit_lo(NBITS, p);
    const U dmask = (U(1) << (hi - lo)) - 1;
    each([&](bool ok, U v) {
      const bool match = ok && static_cast<long long>(v >> hi) == s.prefix;
      count_key(hist, match ? static_cast<int>((v >> lo) & dmask) : -1);
    });
    __syncthreads();
    s = choose<NT>(hist, s, hi - lo, sums, &s_sel);
    for (int b = tid; b < BINS; b += NT) hist[b] = 0;
    __syncthreads();
  }
  const U v_lo = static_cast<U>(s.prefix);
  U v_hi = v_lo;
  // rank k_hi = k_lo + 1: a duplicate of v_lo when more than k_hi elements are
  // <= v_lo, else the least value above it: in pass 1's set when it holds
  // rank k_hi, else in pass 1's next non-empty bin, else anywhere
  if (k_hi != k_lo && (k_lo - s.rank) + s.count <= k_hi) {
    U above = ~U(0);
    auto least = [&](bool ok, U v) {
      if (ok && v > v_lo && v < above) above = v;
    };
    if (k_hi < base1 + count1) {
      each(least);
    } else if (next < BINS) {
      each_in_bin(next, least);
    } else {
      for (long long e = tid; e < m; e += NT) least(true, bits[e]);
    }
    v_hi = block_min(above, mins);
  }
  if (tid == 0) {
    // the plain version's arithmetic on the card: sqrt, 0.5 (a + b), med * med,
    // times ATen's reciprocal of log P, clamp_min (NaN passes)
    const T med = T(0.5) * (sqrt(Bits<T>::value(v_lo)) + sqrt(Bits<T>::value(v_hi)));
    const T v = (med * med) * inv_log;
    const T floor = static_cast<T>(1e-12);
    h[0] = (v != v) ? v : (v < floor ? floor : v);
  }
}

template <class T>
struct Update {
  const T* x;       // (P, D) every particle
  const T* xt;      // (D, P) the same, transposed (S1)
  const T* gt;      // (D, P) the masked gradients, transposed (S1)
  const T* h;       // 0-d bandwidth (S2)
  const T* mu;      // (B, D) moments of rows [row0, row0 + B)
  const T* nu;
  const T* nu_max;
  const long long* count;
  int P, D, row0, B;
  T lr, one_minus_b1, b1, one_minus_b2, b2, eps;
  T* x_out;
  T* mu_out;
  T* nu_out;
  T* nu_max_out;
  long long* count_out;
};

template <class T>
__global__ void __launch_bounds__(UPDATE_WARPS * 32) svgd_update_kernel(Update<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = a.P, D = a.D, b = blockIdx.x;
  double* xr = reinterpret_cast<double*>(smem);  // the row's coordinates
  double* part = xr + D;                         // (UPDATE_WARPS, 2, D) the warps' sums
  if (b == 0 && tid == 0) a.count_out[0] = a.count[0] + 1;
  const long long r = a.row0 + b;
  for (int d = tid; d < D; d += UPDATE_WARPS * 32) xr[d] = static_cast<double>(a.x[r * D + d]);
  for (int i = tid; i < 2 * UPDATE_WARPS * D; i += UPDATE_WARPS * 32) part[i] = 0.0;
  __syncthreads();
  const double h = static_cast<double>(a.h[0]);
  // tiles of UPDATE_WARPS * 32 * COLS columns; lane l of warp w takes columns
  // tile + 32 (COLS w + c) + l, c < COLS
  for (int tile = 0; tile < P; tile += UPDATE_WARPS * 32 * COLS) {
    const int jw = tile + 32 * COLS * warp + lane;
    // K[r, j] = exp(-sq / h), sq over the coordinates in order (S1's), CH at a time
    double sq[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) sq[c] = 0.0;
    for (int d0 = 0; d0 < D; d0 += CH) {
      T v[CH][COLS];
#pragma unroll
      for (int e = 0; e < CH; ++e)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int j = jw + 32 * c, d = d0 + e;
          v[e][c] = j < P && d < D ? a.xt[static_cast<long long>(d) * P + j] : T(0);
        }
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        if (d0 + e < D) {
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const double t = static_cast<double>(v[e][c]) - xr[d0 + e];
            sq[c] = fma(t, t, sq[c]);
          }
        }
      }
    }
    double k[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) k[c] = jw + 32 * c < P ? exp(-sq[c] / h) : 0.0;
    // the tile's sums of K g and K (x_j - x_r), CH coordinates at a time: the
    // lane's columns in order, then a butterfly over the lanes
    for (int d0 = 0; d0 < D; d0 += CH) {
      T gv[CH][COLS], xv[CH][COLS];
#pragma unroll
      for (int e = 0; e < CH; ++e)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int j = jw + 32 * c, d = d0 + e;
          const long long q = static_cast<long long>(d) * P + j;
          const bool ok = j < P && d < D;
          gv[e][c] = ok ? a.gt[q] : T(0);
          xv[e][c] = ok ? a.xt[q] : T(0);
        }
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        const double xd = d0 + e < D ? xr[d0 + e] : 0.0;
        double att = 0.0, rep = 0.0;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          att = fma(k[c], static_cast<double>(gv[e][c]), att);
          rep = fma(k[c], static_cast<double>(xv[e][c]) - xd, rep);
        }
        for (int o = 16; o > 0; o >>= 1) {
          att += __shfl_xor_sync(FULL, att, o);
          rep += __shfl_xor_sync(FULL, rep, o);
        }
        if (lane == 0 && d0 + e < D) {
          part[(2 * warp) * D + d0 + e] += att;
          part[(2 * warp + 1) * D + d0 + e] += rep;
        }
      }
    }
  }
  __syncthreads();
  if (warp != 0) return;
  const double two_over_h = 2.0 / h;
  const T n = static_cast<T>(a.count[0] + 1);
  const T c1 = T(1) - pow(a.b1, n), c2 = T(1) - pow(a.b2, n);
  for (int d = lane; d < D; d += 32) {
    double at = 0.0, re = 0.0;
    for (int w = 0; w < UPDATE_WARPS; ++w) {
      at += part[(2 * w) * D + d];
      re += part[(2 * w + 1) * D + d];
    }
    // amsgrad in T on the descent direction -phi (svgd.py's AMSGrad.update)
    const long long q = static_cast<long long>(b) * D + d;
    const T gd = static_cast<T>(-(at - two_over_h * re) / P);
    const T xd = a.x[r * D + d];
    const T mu = a.one_minus_b1 * gd + a.b1 * a.mu[q];
    const T nu = a.one_minus_b2 * (gd * gd) + a.b2 * a.nu[q];
    const T mu_hat = mu / c1, nu_hat = nu / c2, old = a.nu_max[q];
    // torch.maximum: NaN if either is (old + nu_hat is then NaN)
    const T nu_max = (old != old || nu_hat != nu_hat) ? old + nu_hat : (old > nu_hat ? old : nu_hat);
    a.x_out[q] = xd + (-a.lr) * (mu_hat / (sqrt(nu_max) + a.eps));
    a.mu_out[q] = mu;
    a.nu_out[q] = nu;
    a.nu_max_out[q] = nu_max;
  }
}

namespace {

int smem_limit() {
  static int limits[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (limits[dev] == 0)
    cudaDeviceGetAttribute(&limits[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limits[dev];
}

// raise `kernel`'s dynamic shared memory limit to `bytes` once per device and
// size (static and dynamic shared memory above 48 KB together need it; the
// first launch is eager, so a CUDA graph's capture makes no such call)
template <class K>
int allow_smem(K kernel, size_t bytes) {
  static size_t allowed[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (bytes == 0 || dev < 0 || dev >= 64 || allowed[dev] >= bytes) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) allowed[dev] = bytes;
  return static_cast<int>(e);
}

// S3's shared bytes a block (a row): the row's coordinates and the warps' sums, in double
size_t update_smem(int D) {
  return (1 + 2 * UPDATE_WARPS) * static_cast<size_t>(D) * sizeof(double);
}

// the dynamic shared bytes `kernel` may take: what the card's opt-in limit leaves
// beside its static shared memory
template <class K>
size_t room(K kernel) {
  static size_t rooms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (rooms[dev] == 0) {
    cudaFuncAttributes attr;
    cudaFuncGetAttributes(&attr, kernel);
    rooms[dev] = static_cast<size_t>(smem_limit()) - attr.sharedSizeBytes;
  }
  return rooms[dev];
}

// S2's candidate capacity (elements) in its last block's shared memory
template <class T>
int select_capacity() {
  return static_cast<int>(room(svgd_bandwidth_kernel<T>) / sizeof(T));
}

// S1's dynamic shared bytes: the cloud, where it fits, else none
template <class T>
size_t distances_smem(int P, int D) {
  const size_t bytes = static_cast<size_t>(P) * D * sizeof(T);
  return bytes <= room(svgd_distances_kernel<T>) ? bytes : 0;
}

long long pairs(int P) { return static_cast<long long>(P) * (P - 1) / 2; }

bool valid(int elem, int P, int D) {
  return (elem == 4 || elem == 8) && P >= 2 && D >= 1 && pairs(P) < (1LL << 31) &&
         static_cast<long long>(P) * D < (1LL << 31);
}

// a launch's histogram and ticket, zero before it starts (a node of a CUDA graph
// under capture)
int zero_workspace(void* ws, cudaStream_t st) {
  return static_cast<int>(cudaMemsetAsync(ws, 0, (BINS + 1) * sizeof(unsigned), st));
}

long long select_chunk(int P) { return (pairs(P) + SELECT_BLOCKS - 1) / SELECT_BLOCKS; }

template <class T>
int distances(const void* x, const void* g, int P, int D, void* tri, void* xt, void* gt,
              void* sel, void* ws, cudaStream_t st) {
  const long long m = pairs(P), n = static_cast<long long>(P) * D;
  const long long work = (m > n ? m : n) + DIST_THREADS - 1;
  const int blocks = static_cast<int>(work / DIST_THREADS < DIST_BLOCKS ? work / DIST_THREADS
                                                                        : DIST_BLOCKS);
  const size_t bytes = distances_smem<T>(P, D);
  int e = allow_smem(svgd_distances_kernel<T>, bytes);
  if (e == 0) e = zero_workspace(ws, st);
  if (e != 0) return e;
  svgd_distances_kernel<T><<<blocks, DIST_THREADS, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), P, D, m, bytes > 0,
      static_cast<T*>(tri), static_cast<T*>(xt), static_cast<T*>(gt),
      static_cast<long long*>(sel), static_cast<unsigned*>(ws));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int bandwidth(const void* tri, const void* sel, int P, double inv_log, void* work,
              void* offs, void* ws, void* h, cudaStream_t st) {
  const int capacity = select_capacity<T>();
  const size_t bytes = static_cast<size_t>(capacity) * sizeof(T);
  int e = allow_smem(svgd_bandwidth_kernel<T>, bytes);
  if (e == 0) e = zero_workspace(ws, st);
  if (e != 0) return e;
  using U = typename Bits<T>::U;
  svgd_bandwidth_kernel<T><<<SELECT_BLOCKS, SELECT_THREADS, bytes, st>>>(
      static_cast<const T*>(tri), pairs(P), static_cast<const long long*>(sel),
      static_cast<T>(inv_log), capacity, static_cast<U*>(work), select_chunk(P),
      static_cast<unsigned*>(offs), static_cast<unsigned*>(ws), static_cast<T*>(h));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int update(const Update<T>& u, cudaStream_t st) {
  const size_t bytes = update_smem(u.D);
  if (bytes > static_cast<size_t>(smem_limit())) return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(svgd_update_kernel<T>, bytes);
  if (e != 0) return e;
  svgd_update_kernel<T><<<u.B, UPDATE_WARPS * 32, bytes, st>>>(u);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
Update<T> update_args(const void* x, const void* xt, const void* gt, const void* h, int P,
                      int D, int row0, int B, const void* mu, const void* nu,
                      const void* nu_max, const long long* count, double lr, double b1,
                      double b2, double eps, void* x_out, void* mu_out, void* nu_out,
                      void* nu_max_out, long long* count_out) {
  // the constants as the plain version casts them: each Python float to T
  return Update<T>{static_cast<const T*>(x), static_cast<const T*>(xt),
                   static_cast<const T*>(gt), static_cast<const T*>(h),
                   static_cast<const T*>(mu), static_cast<const T*>(nu),
                   static_cast<const T*>(nu_max), count, P, D, row0, B,
                   static_cast<T>(lr), static_cast<T>(1.0 - b1), static_cast<T>(b1),
                   static_cast<T>(1.0 - b2), static_cast<T>(b2), static_cast<T>(eps),
                   static_cast<T*>(x_out), static_cast<T*>(mu_out), static_cast<T*>(nu_out),
                   static_cast<T*>(nu_max_out), count_out};
}

}  // namespace

// S1.  elem: 4 (float) or 8 (double); tri holds P (P - 1) / 2 values, xt and gt (D, P),
// sel 3 values (pass 0's prefix, rank and count, for S2); ws 2^RADIX + 1 unsigned
// of scratch (the launch's histogram and ticket, zeroed here first)
extern "C" int phlash_svgd_distances(int elem, const void* x, const void* g, int P, int D,
                                     void* tri, void* xt, void* gt, void* sel, void* ws,
                                     void* stream) {
  if (!valid(elem, P, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem == 4 ? distances<float>(x, g, P, D, tri, xt, gt, sel, ws, st)
                   : distances<double>(x, g, P, D, tri, xt, gt, sel, ws, st);
}

// S2.  inv_log: ATen's reciprocal of log(P) in T (the plain version divides by it so);
// work: P (P - 1) / 2 elements of scratch, offs: SELECT_BLOCKS x (2^RADIX + 1) unsigned
// of scratch, ws: 2^RADIX + 1 unsigned of scratch (as S1's)
extern "C" int phlash_svgd_bandwidth(int elem, const void* tri, const void* sel, int P,
                                     double inv_log, void* work, void* offs, void* ws, void* h,
                                     void* stream) {
  if (!valid(elem, P, 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem == 4 ? bandwidth<float>(tri, sel, P, inv_log, work, offs, ws, h, st)
                   : bandwidth<double>(tri, sel, P, inv_log, work, offs, ws, h, st);
}

// S3.  rows [row0, row0 + B) of the cloud; mu, nu, nu_max and the outputs (B, D)
extern "C" int phlash_svgd_update(int elem, const void* x, const void* xt, const void* gt,
                                  const void* h, int P, int D, int row0, int B, const void* mu,
                                  const void* nu, const void* nu_max, const long long* count,
                                  double lr, double b1, double b2, double eps, void* x_out,
                                  void* mu_out, void* nu_out, void* nu_max_out,
                                  long long* count_out, void* stream) {
  if (!valid(elem, P, D) || B < 1 || row0 < 0 || row0 + B > P)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == 4)
    return update(update_args<float>(x, xt, gt, h, P, D, row0, B, mu, nu, nu_max, count, lr,
                                     b1, b2, eps, x_out, mu_out, nu_out, nu_max_out, count_out),
                  st);
  return update(update_args<double>(x, xt, gt, h, P, D, row0, B, mu, nu, nu_max, count, lr, b1,
                                    b2, eps, x_out, mu_out, nu_out, nu_max_out, count_out),
                st);
}

// The geometry at (P, D) on the current device: out = {S1's threads a block (a thread a
// pair), S2's threads a block, S2's blocks, S2's shared-memory candidates in float, in
// double, S3's threads a block (a block a row), S3's shared bytes a block, the device's
// opt-in shared bytes a block}.  Returns 0, or 1 when S3's shared memory exceeds the
// opt-in limit (S3 would be refused).
extern "C" int phlash_svgd_geometry(int P, int D, long long* out) {
  out[0] = DIST_THREADS;
  out[1] = SELECT_THREADS;
  out[2] = SELECT_BLOCKS;
  out[3] = select_capacity<float>();
  out[4] = select_capacity<double>();
  out[5] = UPDATE_WARPS * 32;
  out[6] = static_cast<long long>(update_smem(D));
  out[7] = smem_limit();
  return update_smem(D) > static_cast<size_t>(smem_limit()) ? 1 : 0;
}
