// Route and histogram kernels of the binned tree engine, written for Hopper
// (sm_90a). They compute what ops/hist_pallas.py's Pallas kernels compute
// on the TPU, redesigned for the GPU rather than carried over block by block.
//
// Layouts (shared with h2o3_tpu_torch/ops/hist_cuda.py):
//   codes   uint8 (c_pad, n_pad), column-major planes: codes[c * n_pad + r]
//   heap    int32 (n_pad,)  heap node id of every row
//   stats   f32 or int32 (4, n_pad) rows 0 = w, 1 = w*grad, 2 = w*hess,
//                 3 = spare (0); int32 holds the int8-quantized stats
//   scale   f64   (3,)       power-of-two fixed-point scale of each stat row
//                 (float stats)
//   tbl     f32   (8, lp)    row 0 = split column, row 1 = did-split
//   route_f f32   (lp, n_bins) 1.0 = code goes right
//   valtab  f32   (8, nodes_p) row 0 = leaf values (emit_f only)
//   hist    (l_pad, c_pad, 4, n_bins), zeroed by the caller: int64 fixed
//                 point for float stats (stat s in units of 1 / scale[s]),
//                 int32 for int stats; the wrapper hands back the f32 value
//   side    f32   hist's shape, zeroed by the caller: the sum of the
//                 non-finite stats that reached each bin (float stats)
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of its launch (or the
// error of setting the kernel's shared-memory limit).

#include <cstdint>
#include <mutex>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

// Stat rows accumulated by the histogram: w, w*grad, w*hess. Row 3 of the
// stats panel is the spare slot of the TPU layout; it is never read and its
// output row stays as the caller zeroed it.
constexpr int kStats = 3;
constexpr int kRouteThreads = 256;
// Launch bound of the fused and shallow-window kernels, whose launches take
// 512 or 1024 threads (the wrapper's choice).
constexpr int kMaxThreads = 1024;
constexpr unsigned kFullWarp = 0xffffffffu;

// ---------------------------------------------------------------------------
// Route of one row (shared by route_kernel and fused_kernel): a row of a
// leaf in [base, base + n_leaves) that split moves to child
// 2h + 1 + goes_right, where goes_right = route_f[leaf, code of the split
// column]; every other row keeps its id.
__device__ __forceinline__ int route_one(const uint8_t* __restrict__ codes,
                                         const float* __restrict__ tbl,
                                         const float* __restrict__ route_f,
                                         int h, int64_t r, int64_t n_pad,
                                         int c_pad, int lp, int n_bins,
                                         int base, int n_leaves) {
  const int leaf = h - base;
  if (leaf < 0 || leaf >= n_leaves || !(__ldg(&tbl[lp + leaf]) > 0.5f)) return h;
  int col = static_cast<int>(__ldg(&tbl[leaf]));
  col = min(max(col, 0), c_pad - 1);
  // codes >= n_bins are outside the contract; clamp so they never read past
  // the leaf's row of the table
  const int code = min(static_cast<int>(codes[static_cast<int64_t>(col) * n_pad + r]),
                       n_bins - 1);
  const bool right = __ldg(&route_f[static_cast<int64_t>(leaf) * n_bins + code]) > 0.5f;
  return 2 * h + 1 + (right ? 1 : 0);
}

// ---------------------------------------------------------------------------
// Route (replaces hist_pallas.py sbh_route_pallas, both forms: the terminal
// pass with the margin update is route_kernel<true>, the others
// route_rows_kernel below).
//
// Bound: bytes. Per row it reads the heap id (4 B) and, for rows of a leaf
// that split, one code byte of the split column; it writes the new heap id
// (4 B), and with kEmitF reads and writes the margin (8 B). The split
// tables are a few KB to 128 KB and are read through the read-only cache.
// Design: one thread per row, coalesced heap/F traffic; the code byte is a
// gather from the uint8 plane, coalesced among neighbouring rows that share
// a leaf (rows stay in their original order, so neighbours often do). The
// TPU kernel's one-hot matmuls and 4-codes-per-word packing existed only
// because the TPU has no vector gather; both are gone here.
template <bool kEmitF>
__global__ void __launch_bounds__(kRouteThreads)
route_kernel(const uint8_t* __restrict__ codes,
             const int32_t* __restrict__ heap,
             const float* __restrict__ tbl,
             const float* __restrict__ route_f,
             const float* __restrict__ valtab,
             const float* __restrict__ f_in,
             int32_t* __restrict__ heap_out,
             float* __restrict__ f_out,
             int64_t n_pad, int c_pad, int lp, int n_bins, int base, int n_leaves,
             float eta) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_pad) return;
  const int nh = route_one(codes, tbl, route_f, heap[r], r, n_pad, c_pad, lp,
                           n_bins, base, n_leaves);
  heap_out[r] = nh;
  if (kEmitF) f_out[r] = f_in[r] + eta * __ldg(&valtab[nh]);
}

// The non-terminal route, redesigned (route_kernel<false> before it).
// route_kernel's thread waits on four loads in a chain (heap id, the leaf's
// split, the code byte, route_f[leaf, code]) for one row, so at 11M rows
// the card holds few bytes in flight and waits on two HBM round trips per
// wave. Here a thread takes kRows rows a step (kRows / 4 int4 heap loads,
// each coalesced across the warp) and issues all their code-byte gathers
// before it uses any, the grid (one wave of resident blocks) walks the rows
// grid-stride, and each block first stages the split column of each leaf
// (-1 where it did not split) in shared memory; route_f[leaf, code] is read
// through the read-only cache, where the level's table stays. Staging
// route_f too, as a bitmask of n_leaves x n_bins bits, ran slower at every
// layout: every block builds the whole table before it routes a row, and
// at one wave of blocks that build costs more than its lookups save.
// Bound: bytes, as route_kernel; each gather moves a 32-byte sector of the
// split column's plane, which the bound does not count (chip_smoke.py
// prints the sectors a launch touches: about 1.03M at HIGGS levels 6-7,
// 33 MB beside the heap's 88 MB).
// Layout, timed at HIGGS levels 6 and 7 (chip_smoke.py phase 5, NVIDIA
// H100 80GB HBM3, 700 W): 8 rows a thread-step and 512 threads 0.049-0.067
// ms a launch, 0.055-0.057 ms the mean of run (b)'s two; 4 rows
// 0.050-0.064; the one-row-a-thread kernel this replaces took 0.070-0.074.
// One wave of grid-stride blocks leaves no spare blocks to even out a slow
// SM, so launches vary more than that kernel's did.
template <int kRows>
__global__ void __launch_bounds__(kMaxThreads)
route_rows_kernel(const uint8_t* __restrict__ codes,
                  const int32_t* __restrict__ heap,
                  const float* __restrict__ tbl,
                  const float* __restrict__ route_f,
                  int32_t* __restrict__ heap_out,
                  int64_t n_pad, int c_pad, int lp, int n_bins, int base,
                  int n_leaves) {
  static_assert(kRows % 4 == 0, "rows come in int4 steps");
  constexpr int kVec = kRows / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  int* const s_col = reinterpret_cast<int*>(smem);              // n_leaves
  for (int i = threadIdx.x; i < n_leaves; i += blockDim.x) {
    int col = -1;
    if (__ldg(&tbl[lp + i]) > 0.5f)
      col = min(max(static_cast<int>(__ldg(&tbl[i])), 0), c_pad - 1);
    s_col[i] = col;
  }
  __syncthreads();
  // 1 when code c of leaf l goes right
  const auto right = [&](int l, int c) {
    return __ldg(&route_f[static_cast<int64_t>(l) * n_bins + c]) > 0.5f ? 1 : 0;
  };

  const int4* __restrict__ heap4 = reinterpret_cast<const int4*>(heap);
  int4* __restrict__ out4 = reinterpret_cast<int4*>(heap_out);
  const int64_t n4 = n_pad >> 2;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kVec * blockDim.x;
  for (int64_t q0 = static_cast<int64_t>(blockIdx.x) * kVec * blockDim.x + threadIdx.x;
       q0 < n4; q0 += step) {
    int h[kRows], leaf[kRows], code[kRows];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int64_t q = q0 + static_cast<int64_t>(v) * blockDim.x;
      const int4 h4 = q < n4 ? heap4[q] : make_int4(-1, -1, -1, -1);
      h[4 * v] = h4.x;
      h[4 * v + 1] = h4.y;
      h[4 * v + 2] = h4.z;
      h[4 * v + 3] = h4.w;
    }
    // every gather first, then the uses
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t r = 4 * (q0 + static_cast<int64_t>(k >> 2) * blockDim.x) + (k & 3);
      const int l = h[k] - base;
      const int col = l >= 0 && l < n_leaves ? s_col[l] : -1;
      leaf[k] = col >= 0 ? l : -1;
      code[k] = col >= 0 ? codes[static_cast<int64_t>(col) * n_pad + r] : 0;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (leaf[k] >= 0) {
        // codes >= n_bins are outside the contract; clamp as route_one does
        const int c = min(code[k], n_bins - 1);
        h[k] = 2 * h[k] + 1 + right(leaf[k], c);
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int64_t q = q0 + static_cast<int64_t>(v) * blockDim.x;
      if (q < n4)
        out4[q] = make_int4(h[4 * v], h[4 * v + 1], h[4 * v + 2], h[4 * v + 3]);
    }
  }
  // the last n_pad % 4 rows, one a thread of block 0
  const int64_t r = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && r < n_pad) {
    int nh = heap[r];
    const int l = nh - base;
    const int col = l >= 0 && l < n_leaves ? s_col[l] : -1;
    if (col >= 0) {
      const int c = min(static_cast<int>(codes[static_cast<int64_t>(col) * n_pad + r]),
                        n_bins - 1);
      nh = 2 * nh + 1 + right(l, c);
    }
    heap_out[r] = nh;
  }
}

// ---------------------------------------------------------------------------
// Shared pieces of the histogram kernels.
//
// Accumulators. A bin that holds most rows (a dominant level, a constant or
// padding column) takes one add per row, and f32 adds of 16K values into
// one address lost 8e-5 of the bin (measured at 11M rows), so no f32 sum
// is used:
//   * int stats (the int8 path) sum in int32, exactly;
//   * float stats sum in 64-bit fixed
//     point (Fixed): stat row s of a row becomes q = round(x * scale[s]),
//     with scale[s] the power of two that keeps n_pad * max|x| * scale[s]
//     <= 2^62 (hist_cuda.hist_scale). The scaling is exact, so q rounds
//     once, by at most 2^-(e+1) < n_pad * max|x| / 2^62 of x; integer sums
//     are exact and order-free (the total fits: |sum q| <= 2^62 + n_pad/2),
//     so every launch on the same inputs gives the same bits. The f64 sums
//     these replace compiled to compare-and-swap loops
//     (ATOMS.CAST.SPIN.64) and ran at a quarter of the int32 forms' speed.
using Fixed = unsigned long long;       // two's complement int64 bits

// Values a row adds to the histogram, one per stat row and row of a 4-row
// step, and the mask of the values that cannot be summed there.
template <typename T> struct Values;

template <> struct Values<int32_t> {
  using Acc = int32_t;
  __device__ explicit Values(const double*) {}
  template <int N>
  __device__ unsigned operator()(const int32_t x[kStats][N], const int[N],
                                 Acc v[kStats][N]) const {
#pragma unroll
    for (int s = 0; s < kStats; ++s)
#pragma unroll
      for (int k = 0; k < N; ++k) v[s][k] = x[s][k];
    return 0;
  }
};

template <> struct Values<float> {
  using Acc = Fixed;
  // The fixed-point adds wait on an atomic's returned word, and a block of
  // 8-byte windows takes most of the SM's shared memory, so one block is
  // all an SM holds: 1024 threads (64 registers each, no spills) hide that
  // latency, and ran faster than 512 on the card.
  static constexpr int kThreads = 1024;
  // scale[s] = s1[s] * s2[s], both powers of two that f32 holds (scale is
  // 2^-98 .. 2^211; s2 is 1 unless scale > 2^127)
  float s1[kStats], s2[kStats];
  __device__ explicit Values(const double* __restrict__ s) {
#pragma unroll
    for (int i = 0; i < kStats; ++i) {
      const double si = __ldg(s + i);
      s1[i] = static_cast<float>(fmin(si, 0x1p127));
      s2[i] = static_cast<float>(si / static_cast<double>(s1[i]));
    }
  }
  // round(x * scale), rounded once: both products are exact (|x * scale|
  // <= 2^62, and where x * s1 underflows the value rounds to 0 anyway).
  // Below 2^31 the f32 -> int32 conversion rounds it (to nearest even);
  // from 2^31 up, y holds an integer, its 24-bit significand shifted left.
  // (Conversions to 64-bit integers run at a quarter of the 32-bit rate on
  // Hopper, per the CUDA programming guide's throughput table.)
  __device__ static long long fixed(float x, float s1, float s2) {
    const float y = (x * s1) * s2;
    if (fabsf(y) < 0x1p31f) return __float2int_rn(y);
    const unsigned b = __float_as_uint(y);
    const long long m = static_cast<long long>((b & 0x7fffffu) | 0x800000u)
                        << (((b >> 23) & 0xffu) - 150);
    return (b >> 31) ? -m : m;
  }
  // A NaN or +-inf stat has no fixed-point value: it adds 0 here and goes
  // to the side buffer (bit s * N + k of the mask) for rows in the window.
  template <int N>
  __device__ unsigned operator()(const float x[kStats][N], const int slot[N],
                                 Acc v[kStats][N]) const {
    unsigned nf = 0;
#pragma unroll
    for (int s = 0; s < kStats; ++s)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (isfinite(x[s][k])) {
          v[s][k] = static_cast<Fixed>(fixed(x[s][k], s1[s], s2[s]));
        } else {
          v[s][k] = 0;
          if (slot[k] >= 0) nf |= 1u << (s * N + k);
        }
      }
    return nf;
  }
};

// Window histograms [win][3][n_bins] in shared memory, one accumulator per
// (slot, stat, bin) index i; window k of a block starts k windows into the
// dynamic shared memory.
//   int32: native ATOMS.ADD.
//   Fixed: a 64-bit atomicAdd on shared memory also compiles to
//     ATOMS.CAST.SPIN.64 for sm_90a, so a value is added as two native
//     32-bit ATOMS.ADD on its words: the low word's add returns the old
//     word, and its carry (old + lo < old, unsigned) goes into the high
//     word with the high half. The sum is exact modulo 2^64, and the true
//     total fits int64. A zero low half (a weight of exactly 1 at scale
//     2^37 has one) skips the low add, a zero high half with no carry the
//     high add. (Keeping the low and high words in two planes, so that
//     lanes adding into random bins spread over all 32 banks, ran slower
//     on the card than words side by side.)
template <typename Acc> struct Window {
  Acc* p;
  __device__ Window(unsigned char* smem, int k, int nsh)
      : p(reinterpret_cast<Acc*>(smem) + static_cast<size_t>(k) * nsh) {}
  __device__ void add(int i, Acc v) const { atomicAdd(p + i, v); }
  // add a, b, c at i, i + stride, i + 2 * stride (one key's three stats)
  __device__ void add3(int i, int stride, Acc a, Acc b, Acc c) const {
    add(i, a);
    add(i + stride, b);
    add(i + 2 * stride, c);
  }
  __device__ Acc get(int i) const { return p[i]; }
};

template <> struct Window<Fixed> {
  Fixed* p;
  __device__ Window(unsigned char* smem, int k, int nsh)
      : p(reinterpret_cast<Fixed*>(smem) + static_cast<size_t>(k) * nsh) {}
  __device__ void add(int i, Fixed v) const {
    unsigned* w = reinterpret_cast<unsigned*>(p + i);
    const unsigned lo = static_cast<unsigned>(v);
    unsigned hi = static_cast<unsigned>(v >> 32);
    if (lo != 0) {
      const unsigned old = atomicAdd(w, lo);
      hi += old + lo < old ? 1u : 0u;
    }
    if (hi != 0) atomicAdd(w + 1, hi);
  }
  // add a, b, c at i, i + stride, i + 2 * stride (one key's three stats):
  // the three low words' adds first, so that they are in flight together,
  // then the high words with their carries (add() one at a time waits on
  // each low word before the next value's add can start)
  __device__ void add3(int i, int stride, Fixed a, Fixed b, Fixed c) const {
    const Fixed v[3] = {a, b, c};
    unsigned hi[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const unsigned lo = static_cast<unsigned>(v[s]);
      hi[s] = static_cast<unsigned>(v[s] >> 32);
      if (lo != 0) {
        const unsigned old = atomicAdd(reinterpret_cast<unsigned*>(p + i + s * stride), lo);
        hi[s] += old + lo < old ? 1u : 0u;
      }
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
      if (hi[s] != 0) atomicAdd(reinterpret_cast<unsigned*>(p + i + s * stride) + 1, hi[s]);
  }
  __device__ Fixed get(int i) const { return p[i]; }
};

// N consecutive elements (N = 2 or 4) in one vector load.
template <typename T, int N> struct VecN;
template <> struct VecN<float, 2> { using type = float2; };
template <> struct VecN<int32_t, 2> { using type = int2; };
template <> struct VecN<uint8_t, 2> { using type = uchar2; };
template <> struct VecN<float, 4> { using type = float4; };
template <> struct VecN<int32_t, 4> { using type = int4; };
template <> struct VecN<uint8_t, 4> { using type = uchar4; };

template <int N, typename T, typename U>
__device__ __forceinline__ void load_n(const T* __restrict__ p, U out[N]) {
  const typename VecN<T, N>::type v = *reinterpret_cast<const typename VecN<T, N>::type*>(p);
  out[0] = v.x;
  out[1] = v.y;
  if constexpr (N == 4) {
    out[2] = v.z;
    out[3] = v.w;
  }
}

// Window slot of a row's heap id h for leaves [base, base + n_leaves) (with
// `half`, even leaves only at slot leaf >> 1), relative to the window
// starting at w0 of width win; -1 when the row is outside it.
__device__ __forceinline__ int window_slot(int h, int base, int n_leaves,
                                           bool half, int w0, int win) {
  int leaf = h - base;
  bool ok = leaf >= 0 && leaf < n_leaves;
  if (half) {
    ok = ok && (leaf & 1) == 0;
    leaf >>= 1;
  }
  const int s = leaf - w0;
  return ok && s >= 0 && s < win ? s : -1;
}

// Fold the values of 4 consecutive rows into a window histogram, one
// shared atomic per (row, stat).
template <typename Acc>
__device__ __forceinline__ void fold4(const Window<Acc>& sh, const int slot[4],
                                      const uchar4 c4, const Acc v[kStats][4],
                                      int n_bins) {
  const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // codes >= n_bins are outside the contract: dropped, never written
    // past the window's shared histogram
    if (slot[k] < 0 || cs[k] >= n_bins) continue;
    const int i = slot[k] * kStats * n_bins + cs[k];
    sh.add(i, v[0][k]);
    sh.add(i + n_bins, v[1][k]);
    sh.add(i + 2 * n_bins, v[2][k]);
  }
}

// Fold the values of N consecutive rows into a window histogram: rows in a
// run that share one (slot, bin) key are summed in registers first and
// take one add per stat (add3), so a constant or padding column (every row
// in bin 0) costs 1/N of the atomics.
template <int N, typename Acc>
__device__ __forceinline__ void fold_runs(const Window<Acc>& sh, const int slot[N],
                                          const int cs[N], const Acc v[kStats][N],
                                          int n_bins) {
  int key = -1;
  Acc aw = 0, ag = 0, ah = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (slot[k] < 0 || cs[k] >= n_bins) continue;
    const int kk = slot[k] * kStats * n_bins + cs[k];
    if (kk != key) {
      if (key >= 0) sh.add3(key, n_bins, aw, ag, ah);
      key = kk;
      aw = ag = ah = 0;
    }
    aw += v[0][k];
    ag += v[1][k];
    ah += v[2][k];
  }
  if (key >= 0) sh.add3(key, n_bins, aw, ag, ah);
}

// fold_runs for a whole warp, with warp aggregation (agg): when the N rows
// of every lane share one (slot, bin) key (a constant or padding column:
// at level 0 every row of the column in bin 0), the warp sums its 32 N
// rows in registers (shuffles) and one lane adds the sums, where the lanes
// would otherwise queue 32 atomics on one address. A shuffle of lane 0's
// key and one vote test the case: __match_any_sync would return the same
// full mask, at a higher cost. Every lane of the warp must call it.
template <int N, typename Acc>
__device__ __forceinline__ void fold_warp(const Window<Acc>& sh, const int slot[N],
                                          const int cs[N], const Acc v[kStats][N],
                                          int n_bins, bool agg) {
  if (agg) {
    const int key = slot[0] * kStats * n_bins + cs[0];
    bool one = slot[0] >= 0 && cs[0] < n_bins;
#pragma unroll
    for (int k = 1; k < N; ++k) one = one && cs[k] == cs[0] && slot[k] == slot[0];
    const int key0 = __shfl_sync(kFullWarp, one ? key : -1, 0);
    if (__all_sync(kFullWarp, one && key == key0)) {
      Acc a[kStats];
#pragma unroll
      for (int s = 0; s < kStats; ++s) {
        a[s] = v[s][0];
#pragma unroll
        for (int k = 1; k < N; ++k) a[s] += v[s][k];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a[s] += __shfl_xor_sync(kFullWarp, a[s], o);
      }
      if ((threadIdx.x & 31) == 0) sh.add3(key0, n_bins, a[0], a[1], a[2]);
      return;
    }
  }
  fold_runs<N>(sh, slot, cs, v, n_bins);
}

// Non-finite stats of an N-row step (mask nf from Values<float>) into the
// side buffer at their (slot, column, stat, bin), with global f32 atomics:
// a sum of NaN and +-inf values is what the f64 sum of the bin would be.
template <int N>
__device__ __forceinline__ void add_nonfinite(float* __restrict__ side, unsigned nf,
                                              const float x[kStats][N],
                                              const int slot[N], const int cs[N],
                                              int c, int c_pad, int n_bins, int w0) {
#pragma unroll
  for (int s = 0; s < kStats; ++s)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (!((nf >> (s * N + k)) & 1u) || cs[k] >= n_bins) continue;
      const int64_t o =
          ((static_cast<int64_t>(w0 + slot[k]) * c_pad + c) * 4 + s) * n_bins + cs[k];
      atomicAdd(side + o, x[s][k]);
    }
}

__device__ __forceinline__ void add_nonfinite(float* __restrict__ side, unsigned nf,
                                              const float x[kStats][4],
                                              const int slot[4], const uchar4 c4,
                                              int c, int c_pad, int n_bins, int w0) {
  const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
  add_nonfinite<4>(side, nf, x, slot, cs, c, c_pad, n_bins, w0);
}

// Zero `nwin` windows of nsh accumulators.
template <typename Acc>
__device__ __forceinline__ void zero_windows(unsigned char* smem, int nwin, int nsh) {
  unsigned* z = reinterpret_cast<unsigned*>(smem);
  const int words = static_cast<int>(nwin * nsh * sizeof(Acc) / sizeof(unsigned));
  for (int i = threadIdx.x; i < words; i += blockDim.x) z[i] = 0;
}

// Add `ncopy` shared copies of `ncol` window histograms (window k * ncol + j
// is copy k of column c0 + j) and flush the non-zero bins into the output
// (l_pad, c_pad, 4, n_bins) at slots w0 .. w0 + win, columns c0 .. c0 +
// ncol, with global atomics (RED.E.ADD.64 for Fixed, native).
template <typename Acc>
__device__ __forceinline__ void flush_window(unsigned char* smem, int ncopy,
                                             int ncol, int nsh, Acc* __restrict__ hist,
                                             int c0, int c_pad, int n_bins, int w0) {
  for (int j = 0; j < ncol; ++j) {
    for (int i = threadIdx.x; i < nsh; i += blockDim.x) {
      Acc v = 0;
      for (int k = 0; k < ncopy; ++k) v += Window<Acc>(smem, k * ncol + j, nsh).get(i);
      if (v == 0) continue;
      const int b = i % n_bins;
      const int s = (i / n_bins) % kStats;
      const int slot = w0 + i / (kStats * n_bins);
      const int64_t o =
          ((static_cast<int64_t>(slot) * c_pad + c0 + j) * 4 + s) * n_bins + b;
      atomicAdd(hist + o, v);
    }
  }
}

// One block of a dense or fused level pass: rows [r0, r0 + rows_per_block),
// columns c0 .. c0 + group, leaf window w0 .. w0 + win. Per 4-row step it
// loads the heap once (and with kRoute routes the rows by the previous
// level's splits), loads the stats and turns them into values once, then
// folds them into one shared window per column of the group, reading that
// column's 4 code bytes. With kRoute, the column-group-0, window-0 block of
// each row chunk writes the routed ids to heap_out. kGroup > 0 fixes the
// group at compile time (the int8 fused kernel: its column loop unrolls),
// 0 takes `group` at run time.
template <typename T, bool kRoute, int kGroup = 0>
__device__ __forceinline__ void level_pass(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ heap,
    const float* __restrict__ tbl, const float* __restrict__ route_f,
    const T* __restrict__ stats, const double* __restrict__ scale,
    int32_t* __restrict__ heap_out, typename Values<T>::Acc* __restrict__ hist,
    float* __restrict__ side, int64_t n_pad, int c_pad, int lp, int n_bins,
    int base_r, int L_r, int base_h, int L_h, bool half, int win, int group,
    int64_t rows_per_block) {
  using Acc = typename Values<T>::Acc;
  static_assert(kGroup == 0 || !std::is_same<T, float>::value,
                "the f32 forms take their group at run time");
  extern __shared__ __align__(16) unsigned char smem[];   // group windows
  const int c0 = blockIdx.x * group;
  const int ncol = min(group, c_pad - c0);
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int w0 = blockIdx.z * win;
  const bool writer = kRoute && blockIdx.x == 0 && blockIdx.z == 0;
  const int nsh = win * kStats * n_bins;
  zero_windows<Acc>(smem, ncol, nsh);
  const Values<T> values(scale);
  __syncthreads();

  const int64_t r1 = r0 + rows_per_block < n_pad ? r0 + rows_per_block : n_pad;
  const uint8_t* __restrict__ cgroup = codes + static_cast<int64_t>(c0) * n_pad;
  for (int64_t r = r0 + 4 * static_cast<int64_t>(threadIdx.x); r < r1;
       r += 4 * static_cast<int64_t>(blockDim.x)) {
    const int4 h4 = *reinterpret_cast<const int4*>(heap + r);
    int hs[4] = {h4.x, h4.y, h4.z, h4.w};
    int slot[4];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kRoute) {
        hs[k] = route_one(codes, tbl, route_f, hs[k], r + k, n_pad, c_pad, lp,
                          n_bins, base_r, L_r);
      }
      slot[k] = window_slot(hs[k], base_h, L_h, half, w0, win);
      any = any || slot[k] >= 0;
    }
    if (writer) {
      *reinterpret_cast<int4*>(heap_out + r) = make_int4(hs[0], hs[1], hs[2], hs[3]);
    }
    if (!any) continue;
    T x[kStats][4];
    load_n<4>(stats + r, x[0]);
    load_n<4>(stats + n_pad + r, x[1]);
    load_n<4>(stats + 2 * n_pad + r, x[2]);
    Acc v[kStats][4];
    const unsigned nf = values(x, slot, v);
    if constexpr (kGroup > 0) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < ncol) {
          const uchar4 c4 = *reinterpret_cast<const uchar4*>(cgroup + j * n_pad + r);
          fold4(Window<Acc>(smem, j, nsh), slot, c4, v, n_bins);
        }
      }
    } else {
      for (int j = 0; j < ncol; ++j) {
        const uchar4 c4 = *reinterpret_cast<const uchar4*>(cgroup + j * n_pad + r);
        fold4(Window<Acc>(smem, j, nsh), slot, c4, v, n_bins);
        if constexpr (std::is_same<T, float>::value) {
          if (nf) add_nonfinite(side, nf, x, slot, c4, c0 + j, c_pad, n_bins, w0);
        }
      }
    }
  }
  __syncthreads();
  flush_window(smem, 1, ncol, nsh, hist, c0, c_pad, n_bins, w0);
}

// ---------------------------------------------------------------------------
// Histogram (replaces hist_pallas.py sbh_hist_pallas / _hist_pallas; the
// int32 form, for sbh_hist_pallas_i8, is hist_i8_kernel below).
//
// hist[slot, c, s, b] = sum of stats[s, r] over rows r whose leaf maps to
// `slot` and whose code in column c is b. Leaf of a row: heap - base, in
// [0, n_leaves); with `half`, only even leaves count, at slot leaf >> 1.
//
// Bound: bytes. Each row's heap id (4 B), three stats (12 B) and one code
// byte per column are read once in the ideal pass; the output is small.
// What costs instead is the shared-memory atomics: three per (row, column).
// Design: grid (column group, row chunk, leaf window). A block owns the
// histograms of `group` columns for a window of `win` leaf slots in shared
// memory (group x win x 3 x n_bins accumulators), folds its chunk of rows
// into them with shared-memory atomics (level_pass), then flushes the
// non-zero bins into the output with global atomics. blockIdx.x (fastest)
// walks the column groups, so the blocks in flight share one row chunk and
// its heap/stats stay in L2 instead of being re-read from HBM once per
// column. Each thread takes 4 consecutive rows per step (int4 heap, uchar4
// codes, 16-byte stats). Float stats sum in 64-bit fixed point (see
// Values<float>), with native 32-bit atomics in place of an f64 sum's
// compare-and-swap loops. Every window pass reads all the rows, so it takes
// the widest window that 227 KB holds (37 slots at 256 bins: level 6's 32
// left children in one pass, level 7's 64 in two), then as many columns of
// it as fit (hist_cuda.level_grid); chip_smoke.py times narrower windows
// with two columns per block beside it.
// The TPU kernel kept a whole window block resident across a sequential row
// sweep and accumulated one-hot products on the MXU (bf16 panels); blocks
// here run in parallel in no order, so the cross-block sum is the atomic
// flush. The sums are exact integers, so every launch gives the same bits.
template <typename T>
__global__ void __launch_bounds__(Values<T>::kThreads)
hist_kernel(const uint8_t* __restrict__ codes,
            const int32_t* __restrict__ heap,
            const T* __restrict__ stats,
            const double* __restrict__ scale,
            typename Values<T>::Acc* __restrict__ hist,
            float* __restrict__ side,
            int64_t n_pad, int c_pad, int n_bins, int base, int n_leaves,
            int half, int win, int group, int64_t rows_per_block) {
  level_pass<T, false>(codes, heap, nullptr, nullptr, stats, scale, nullptr,
                       hist, side, n_pad, c_pad, 0, n_bins, 0, 0, base, n_leaves,
                       half != 0, win, group, rows_per_block);
}

// ---------------------------------------------------------------------------
// int8 histogram (replaces hist_pallas.py sbh_hist_pallas_i8): the same
// function over int32 stats in [-127, 127] (the int8-quantized stats of
// int8_hist), summed exactly in int32.
//
// Bound: bytes, as hist_kernel. What cost the earlier form (hist_kernel's
// level_pass with one column per block and 96 KB windows) was re-reading:
// each of the 32 column blocks of a row chunk loaded every row's heap id
// and three stats again (16 B a row, 5.6 GB per pass at 11M rows), level
// 7's 64 left children took two passes, and each of ~3,600 blocks flushed
// a 96 KB window with global atomics. Design, in two launches:
//   1. pack_i8_kernel reads each row's heap id and stats once and writes
//      one word a row: its slot in the histogram (byte 0, relative to a
//      band of at most 256 slots) and its three stats as int8 (bytes 1-3,
//      the TPU kernel's own cast); a row outside the band, or with zero
//      stats, packs to stats 0 and adds nothing. At 11M rows the words
//      (44 MB) stay in the 50 MB L2 for the second launch, and a block
//      re-reads 4 B a row where it read 16.
//   2. hist_i8_kernel<G>: grid (column group, row chunk, leaf window), a
//      group of G columns fixed at compile time (its column loop unrolls)
//      and a window of `win` slots, both within 227 KB (hist_cuda
//      dense_i8_grid: level 6's 32 slots x 2 columns, level 7's 64 slots
//      x 1 column in one pass); the row chunks are sized so that the grid
//      fills whole waves of the SMs and each block flushes once. A slot's
//      window starts `spad` words past the last one's end, so that lanes
//      of one column in different slots (a constant column puts every row
//      in one bin) spread over the shared-memory banks.
// The sums are exact int32, so every layout gives the plain version's
// bits, and the JAX twin's. 32-column groups spilled at the 64 registers
// of 1024 threads and are not built (with_group<16>); 28-32 registers up
// to 16 columns, no spills.
// Layout, timed at HIGGS levels 6 and 7 of run (c) (11M rows, 32 columns,
// 256 bins; chip_smoke.py phase 5, NVIDIA H100 80GB HBM3, 700 W), pack
// launch included; the one-column kernel this replaces took 1.21-1.22 and
// 1.92 ms on the same card:
//   * level 6: 32 slots x 2 columns 0.70 ms; 16 x 4 (two passes) 1.14; 8 x
//     8 (four) 1.97-1.98; level 7: 64 x 1 (one pass) 0.79-0.80; 32 x 2 (two
//     passes) 1.24-1.25; 16 x 4 2.06-2.08: at a fixed 227 KB, a pass more
//     costs more than a wider group saves;
//   * 1024 threads against 512: 0.70 against 1.27 ms (level 6), 0.79-0.80
//     against 1.41-1.46 (level 7): one block of 192 KB an SM, so 512
//     threads leave half the warps idle;
//   * without the slot padding (spad = 0) 2.22 and 2.31-2.32 ms: a slot's
//     window is 768 words, a multiple of the 32 banks, so a constant
//     column's lanes in different slots all hit one bank;
//   * 2 and 4 waves of blocks: 0.73 and 0.76 ms at level 6, 0.83 and
//     0.87-0.88 at level 7, against one (more flushes).
constexpr int kPackThreads = 256;

__global__ void __launch_bounds__(kPackThreads)
pack_i8_kernel(const int32_t* __restrict__ heap, const int32_t* __restrict__ stats,
               uint32_t* __restrict__ packed, int64_t n_pad, int base, int n_leaves,
               int half, int b0, int nband) {
  const int64_t step = 4 * static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = 4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
       r < n_pad; r += step) {
    int hs[4], x[kStats][4];
    load_n<4>(heap + r, hs);
#pragma unroll
    for (int s = 0; s < kStats; ++s) load_n<4>(stats + s * n_pad + r, x[s]);
    unsigned p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int slot = window_slot(hs[k], base, n_leaves, half != 0, b0, nband);
      p[k] = slot < 0 ? 0u
                      : static_cast<unsigned>(slot) |
                            (static_cast<unsigned>(x[0][k]) & 0xffu) << 8 |
                            (static_cast<unsigned>(x[1][k]) & 0xffu) << 16 |
                            (static_cast<unsigned>(x[2][k])) << 24;
    }
    *reinterpret_cast<uint4*>(packed + r) = make_uint4(p[0], p[1], p[2], p[3]);
  }
}

template <int kGroup>
__global__ void __launch_bounds__(kMaxThreads)
hist_i8_kernel(const uint8_t* __restrict__ codes, const uint32_t* __restrict__ packed,
               int32_t* __restrict__ hist, int64_t n_pad, int c_pad, int n_bins,
               int b0, int win, int spad, int64_t rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];   // kGroup windows
  int* const sh = reinterpret_cast<int*>(smem);
  const int c0 = blockIdx.x * kGroup;
  const int ncol = min(kGroup, c_pad - c0);
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int w0 = blockIdx.z * win;
  const int sstride = kStats * n_bins + spad;   // words per slot
  const int nsh = win * sstride;                // words per column window
  for (int i = threadIdx.x; i < kGroup * nsh; i += blockDim.x) sh[i] = 0;
  __syncthreads();

  const int64_t r1 = r0 + rows_per_block < n_pad ? r0 + rows_per_block : n_pad;
  const uint8_t* __restrict__ cgroup = codes + static_cast<int64_t>(c0) * n_pad;
  for (int64_t r = r0 + 4 * static_cast<int64_t>(threadIdx.x); r < r1;
       r += 4 * static_cast<int64_t>(blockDim.x)) {
    const uint4 p4 = *reinterpret_cast<const uint4*>(packed + r);
    const unsigned p[4] = {p4.x, p4.y, p4.z, p4.w};
    int at[4];                         // slot * sstride, or -1
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = static_cast<int>(p[k] & 0xffu) - w0;
      const bool in = (p[k] >> 8) != 0 && s >= 0 && s < win;
      at[k] = in ? s * sstride : -1;
      any = any || in;
    }
    if (!any) continue;
    int v[kStats][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[0][k] = static_cast<int8_t>(p[k] >> 8);
      v[1][k] = static_cast<int8_t>(p[k] >> 16);
      v[2][k] = static_cast<int8_t>(p[k] >> 24);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < ncol) {
        const uchar4 c4 = *reinterpret_cast<const uchar4*>(cgroup + j * n_pad + r);
        const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
        int* const wj = sh + j * nsh;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // codes >= n_bins are outside the contract: dropped
          if (at[k] < 0 || cs[k] >= n_bins) continue;
          int* const b = wj + at[k] + cs[k];
          atomicAdd(b, v[0][k]);
          atomicAdd(b + n_bins, v[1][k]);
          atomicAdd(b + 2 * n_bins, v[2][k]);
        }
      }
    }
  }
  __syncthreads();
  // flush the non-zero bins: output slot b0 + w0 + slot, column c0 + j
  for (int j = 0; j < ncol; ++j) {
    for (int i = threadIdx.x; i < nsh; i += blockDim.x) {
      const int v = sh[j * nsh + i];
      if (v == 0) continue;
      const int slot = i / sstride, rem = i - slot * sstride;
      const int s = rem / n_bins, b = rem - s * n_bins;
      const int64_t o =
          ((static_cast<int64_t>(b0 + w0 + slot) * c_pad + c0 + j) * 4 + s) * n_bins + b;
      atomicAdd(hist + o, v);
    }
  }
}

// ---------------------------------------------------------------------------
// Shallow-window histogram (replaces hist_pallas.py sbh_hist_radix /
// _radix_kernel, f32 and int8 forms).
//
// The same function as hist_kernel, dispatched (as in the JAX package) only
// where the effective leaf window is at most 2: level 0 (one slot, every
// row) and the first half levels. The TPU kernel factored each code into
// two nibbles to cut the cost of its one-hot compares; Hopper has no such
// cost, so that factorization is gone.
//
// Bound: bytes, as hist_kernel. What costs here instead is contention:
// every row of a block's chunk adds into the same one or two slots, and
// rows of a constant or padding column into one address. Design: grid
// (column group, row chunk). A block takes kGroup columns (fixed at compile
// time, so the column loop unrolls) and keeps `ncopy` private copies of
// each column's window in shared memory, one per warp or per group of
// warps where fewer fit; per step it loads the heap and the stats of its
// rows and turns them into values once for all the columns of its group.
// Runs of rows sharing one (slot, bin) key are summed in registers before
// their atomics (a run's three low words added before their high words),
// and a warp whose rows all share one key sums them in registers and adds
// once (fold_warp, `agg`); the copies are added once, before the flush.
// Float stats sum in exact 64-bit fixed point as in hist_kernel
// (Values<float>, Window<Fixed>), int32 stats in int32, and NaN and +-inf
// go to the side buffer. The copies partition the rows, so their total
// stays within hist_scale's bound and the sum is exact and order-free:
// every launch, copy count and grouping gives the same bits. The wrapper
// sizes the row chunks so that the grid fills whole waves of the SMs, and
// each block flushes once.
//
// On the card (cuobjdump -sass, chip_smoke.py phase 1): every shared
// atomic of radix_kernel<float, G> is ATOMS.ADD, none ATOMS.CAS*. Its f32
// form takes 2 rows a step (kRadixRows): with 4, the 64-bit values held
// across the column loop took it past the 64 registers of 1024 threads
// (spills from G = 4 up); with 2 it stays within them up to G = 16.
// Layout, timed at HIGGS level 0 (11M rows, 32 columns; chip_smoke.py
// phase 5, NVIDIA H100 80GB HBM3, 700 W; the f32 form, then the int8 one):
//   * 1024 threads against 512: 1.81 against 3.18 ms (G = 16), 0.67
//     against 1.06 (G = 32): at 512 threads the copies fill the shared
//     memory and an SM holds one block of 16 warps;
//   * G = 16 with 2 copies 1.81 ms; G = 1 with a copy per warp 3.04, G = 2
//     2.34, G = 4 2.00, G = 8 1.87. int8: G = 32 with 2 copies 0.666, G = 1
//     0.990, G = 8 0.659;
//   * warp aggregation on against off: 1.81 against 2.03 ms, int8 0.666
//     against 0.728 (4 of HIGGS's 32 padded columns are constant);
//   * the low and high words in two planes (every bank for the low words'
//     adds) ran no faster, as for the dense kernel.
// So: 1024 threads, the widest group that leaves room for two copies (16
// for f32, 32 for int8, at one slot and 256 bins), aggregation on.

// Rows a thread takes per step of the shallow-window kernel (4 for int32
// stats, 2 for f32), and the widest column group it is built for (16 for
// f32: at 32 the 2-row form spilled too; 32 for int32).
template <typename T> constexpr int kRadixRows = std::is_same<T, float>::value ? 2 : 4;
template <typename T> constexpr int kRadixMaxGroup = std::is_same<T, float>::value ? 16 : 32;

template <typename T, int kGroup>
__global__ void __launch_bounds__(kMaxThreads)
radix_kernel(const uint8_t* __restrict__ codes,
             const int32_t* __restrict__ heap,
             const T* __restrict__ stats,
             const double* __restrict__ scale,
             typename Values<T>::Acc* __restrict__ hist,
             float* __restrict__ side,
             int64_t n_pad, int c_pad, int n_bins, int base, int n_leaves,
             int half, int win, int ncopy, int agg, int64_t rows_per_block) {
  using Acc = typename Values<T>::Acc;
  constexpr int N = kRadixRows<T>;
  extern __shared__ __align__(16) unsigned char smem[];   // ncopy x ncol windows
  const int c0 = blockIdx.x * kGroup;
  const int ncol = min(kGroup, c_pad - c0);
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int nsh = win * kStats * n_bins;
  zero_windows<Acc>(smem, ncopy * ncol, nsh);
  const Values<T> values(scale);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int copy = (threadIdx.x >> 5) % ncopy;
  const int64_t r1 = r0 + rows_per_block < n_pad ? r0 + rows_per_block : n_pad;
  const uint8_t* __restrict__ cgroup = codes + static_cast<int64_t>(c0) * n_pad;
  // the loop runs while the warp's first row is in the chunk, so all its
  // lanes take the same steps (fold_warp needs every lane); a lane past the
  // chunk's end (n_pad and the chunk are multiples of 4) has no rows
  for (int64_t rw = r0 + N * static_cast<int64_t>(threadIdx.x - lane); rw < r1;
       rw += N * static_cast<int64_t>(blockDim.x)) {
    const int64_t r = rw + N * lane;
    int slot[N];
    bool any = false;
#pragma unroll
    for (int k = 0; k < N; ++k) slot[k] = -1;
    if (r < r1) {
      int hs[N];
      load_n<N>(heap + r, hs);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        slot[k] = window_slot(hs[k], base, n_leaves, half != 0, 0, win);
        any = any || slot[k] >= 0;
      }
    }
    if (!__any_sync(kFullWarp, any)) continue;
    T x[kStats][N] = {};
    if (any) {
#pragma unroll
      for (int s = 0; s < kStats; ++s) load_n<N>(stats + s * n_pad + r, x[s]);
    }
    Acc v[kStats][N];
    const unsigned nf = values(x, slot, v);
    // the column's codes, one plane further per column (each address from
    // the last, so none is held across the row loop)
    const uint8_t* __restrict__ cj = cgroup + r;
#pragma unroll
    for (int j = 0; j < kGroup; ++j, cj += n_pad) {
      if (j < ncol) {
        int cs[N];
#pragma unroll
        for (int k = 0; k < N; ++k) cs[k] = 0;
        if (any) load_n<N>(cj, cs);
        fold_warp<N>(Window<Acc>(smem, copy * ncol + j, nsh), slot, cs, v, n_bins,
                     agg != 0);
        if constexpr (std::is_same<T, float>::value) {
          if (nf) {
            // rare: the stats are loaded again rather than held in
            // registers across the columns
            T y[kStats][N];
#pragma unroll
            for (int s = 0; s < kStats; ++s) load_n<N>(stats + s * n_pad + r, y[s]);
            add_nonfinite<N>(side, nf, y, slot, cs, c0 + j, c_pad, n_bins, 0);
          }
        }
      }
    }
  }
  __syncthreads();
  flush_window(smem, ncopy, ncol, nsh, hist, c0, c_pad, n_bins, 0);
}

// ---------------------------------------------------------------------------
// Level-fused route + histogram (replaces hist_pallas.py
// sbh_route_hist_fused_pallas / _fused_kernel, f32 and int8 forms).
//
// Routes the rows of leaves [base_r, base_r + L_r) by their splits (as
// route_kernel), then sums the half (left-children) histogram of leaves
// [base_h, base_h + L_h) over the UPDATED heap, in one pass: the heap is
// read once for both phases and the separate route launch is gone.
//
// Bound: bytes: the heap read and written once, the split column's byte of
// each row of a split leaf, the codes and three stats of the rows summed,
// and the output. What costs instead is the shared-memory atomics, as in
// hist_kernel. Design: hist_kernel's grid (column group, row chunk, leaf
// window) and level_pass. The histogram's blocks are split over column
// groups and windows but the heap is per row, so every block computes the
// routed ids of its rows in registers from the OLD heap and the split
// tables, once per 4-row step for all the columns of its group (with one
// column per block, every row would be routed once per column); the f32
// form's group is as many columns as 227 KB holds at the level's window
// (32 at one slot down to 2 at 16). The int32 form is fused_i8_kernel
// below. Exactly
// one block per row chunk (column group 0, window 0) writes the new
// heap, to a separate buffer, and nothing in the launch reads it. Rows of
// leaves that did not split keep an id in [base_r, base_r + L_r), outside
// the histogram's leaves, and are not summed. Float stats sum in 64-bit
// fixed point, as in hist_kernel. The TPU kernel ran one sequential row
// sweep with the whole level's histogram resident in VMEM, hence its
// 16-leaf cap, kept here as the dispatch gate (at 16 leaves one column's
// 8-byte window is 96 KB).
template <typename T>
__global__ void __launch_bounds__(Values<T>::kThreads)
fused_kernel(const uint8_t* __restrict__ codes,
             const int32_t* __restrict__ heap,
             const float* __restrict__ tbl,
             const float* __restrict__ route_f,
             const T* __restrict__ stats,
             const double* __restrict__ scale,
             int32_t* __restrict__ heap_out,
             typename Values<T>::Acc* __restrict__ hist,
             float* __restrict__ side,
             int64_t n_pad, int c_pad, int lp, int n_bins, int base_r, int L_r,
             int base_h, int L_h, int win, int group, int64_t rows_per_block) {
  level_pass<T, true>(codes, heap, tbl, route_f, stats, scale, heap_out, hist,
                      side, n_pad, c_pad, lp, n_bins, base_r, L_r, base_h, L_h,
                      true, win, group, rows_per_block);
}

// The int32 form (int8-quantized stats): level_pass with its group of
// columns a power of two fixed at compile time (kGroup, 1 to 32), so each
// 4-row step routes its rows and loads their stats once for the group,
// where one column per block routed every row once per column; a run-time
// column loop cost the int32 forms registers and speed. The group is as many columns as 96 KB holds at the level's
// window (32 at one slot down to 2 at 16; hist_cuda.level_grid), 1024
// threads; 30-40 registers, no spills. Timed at HIGGS levels 1-5 (11M
// rows; chip_smoke.py phase 5, NVIDIA H100 80GB HBM3, 700 W): 1.13, 0.99,
// 1.04, 1.04, 1.24 ms; one column per block 1.36-1.62; the groups of a
// 227 KB budget (32, 32, 16, 8, 4 columns) 1.13, 1.20, 1.06, 1.11, 1.39;
// 512 threads 1.11, 0.92, 1.00, 1.27, 1.52. The shallow-window kernel's
// run fold ran slower here. The sums are int32, exact: every group gives
// the plain version's bits.
template <int kGroup>
__global__ void __launch_bounds__(kMaxThreads)
fused_i8_kernel(const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ heap,
                const float* __restrict__ tbl,
                const float* __restrict__ route_f,
                const int32_t* __restrict__ stats,
                int32_t* __restrict__ heap_out,
                int32_t* __restrict__ hist,
                int64_t n_pad, int c_pad, int lp, int n_bins, int base_r, int L_r,
                int base_h, int L_h, int win, int64_t rows_per_block) {
  level_pass<int32_t, true, kGroup>(codes, heap, tbl, route_f, stats, nullptr,
                                    heap_out, hist, nullptr, n_pad, c_pad, lp,
                                    n_bins, base_r, L_r, base_h, L_h, true, win,
                                    kGroup, rows_per_block);
}

// Dynamic shared memory above 48 KB has to be allowed once per kernel
// (cudaFuncSetAttribute); this keeps the largest size allowed so far for
// each kernel it has seen.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  constexpr size_t kDefault = 48 * 1024;
  if (smem <= kDefault) return cudaSuccess;
  static std::mutex mu;
  static const void* seen[32];
  static size_t allowed[32];
  static int n_seen = 0;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < n_seen && seen[i] != kernel) ++i;
  if (i < n_seen && allowed[i] >= smem) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (i == n_seen) {
    if (n_seen == 32) return cudaSuccess;  // allowed, just not remembered
    seen[n_seen++] = kernel;
  }
  allowed[i] = smem;
  return cudaSuccess;
}

unsigned grid_rows(int64_t n_pad, int64_t rows_per_block) {
  return static_cast<unsigned>((n_pad + rows_per_block - 1) / rows_per_block);
}

// Column groups the int32 fused kernel and the shallow-window kernel are
// instantiated for: f(std::integral_constant<int, G>) for G = group up to
// kMaxGroup, or cudaErrorInvalidValue for a group without an instantiation.
template <int kMaxGroup = 32, typename F>
int with_group(int group, F&& f) {
  switch (group) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32:
      if constexpr (kMaxGroup >= 32) return f(std::integral_constant<int, 32>());
      [[fallthrough]];
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory of `ncopy` copies of `group` column windows, 0 for a
// layout the launch cannot take.
template <typename T>
size_t window_smem(int c_pad, int n_bins, int win, int group, int ncopy) {
  if (group < 1 || group > c_pad || win < 1 || ncopy < 1) return 0;
  return static_cast<size_t>(ncopy) * group * win * kStats * n_bins *
         sizeof(typename Values<T>::Acc);
}

bool threads_ok(int threads) { return threads == 512 || threads == kMaxThreads; }

dim3 level_grid(int c_pad, int group, int64_t n_pad, int64_t rows_per_block,
                int n_windows) {
  return dim3(static_cast<unsigned>((c_pad + group - 1) / group),
              grid_rows(n_pad, rows_per_block), static_cast<unsigned>(n_windows));
}

int launch_hist(const void* codes, const void* heap, const void* stats,
                const void* scale, void* hist, void* side, int64_t n_pad,
                int c_pad, int n_bins, int base, int n_leaves, int half, int win,
                int n_windows, int group, int64_t rows_per_block, void* stream) {
  const size_t smem = window_smem<float>(c_pad, n_bins, win, group, 1);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(hist_kernel<float>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  hist_kernel<float><<<level_grid(c_pad, group, n_pad, rows_per_block, n_windows),
                       Values<float>::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(heap),
      static_cast<const float*>(stats), static_cast<const double*>(scale),
      static_cast<Fixed*>(hist), static_cast<float*>(side), n_pad, c_pad, n_bins,
      base, n_leaves, half, win, group, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

// The int8 histogram over one band of at most 256 slots: the pack launch,
// then the histogram's, both on `stream` (see hist_i8_kernel).
int launch_hist_i8(const void* codes, const void* heap, const void* stats,
                   void* packed, void* hist, int64_t n_pad, int c_pad, int n_bins,
                   int base, int n_leaves, int half, int b0, int nband, int win,
                   int n_windows, int group, int spad, int threads,
                   int pack_blocks, int64_t rows_per_block, void* stream) {
  if (win < 1 || nband < 1 || nband > 256 || spad < 0 || n_pad % 4 ||
      rows_per_block < 4 || rows_per_block % 4 || pack_blocks < 1 ||
      !threads_ok(threads) || group > c_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(group) * win * (kStats * n_bins + spad) *
                      sizeof(int32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pk = static_cast<uint32_t*>(packed);
  const auto* cd = static_cast<const uint8_t*>(codes);
  // 32 columns spilled at the 64 registers of 1024 threads
  return with_group<16>(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    const cudaError_t e = allow_smem(reinterpret_cast<const void*>(hist_i8_kernel<G>), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    pack_i8_kernel<<<pack_blocks, kPackThreads, 0, st>>>(
        static_cast<const int32_t*>(heap), static_cast<const int32_t*>(stats), pk,
        n_pad, base, n_leaves, half, b0, nband);
    const cudaError_t ep = cudaGetLastError();
    if (ep != cudaSuccess) return static_cast<int>(ep);
    hist_i8_kernel<G><<<level_grid(c_pad, G, n_pad, rows_per_block, n_windows),
                        threads, smem, st>>>(
        cd, pk, static_cast<int32_t*>(hist), n_pad, c_pad, n_bins, b0, win, spad,
        rows_per_block);
    return static_cast<int>(cudaGetLastError());
  });
}

// The non-terminal route (route_rows_kernel<rows>): `blocks` blocks of
// `threads` threads, rows 4 or 8 a thread-step.
int launch_route_rows(const void* codes, const void* heap, const void* tbl,
                      const void* route_f, void* heap_out, int64_t n_pad, int c_pad,
                      int lp, int n_bins, int base, int n_leaves, int rows,
                      int threads, int blocks, void* stream) {
  if (blocks < 1 || !(threads == 256 || threads_ok(threads)) || n_leaves < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n_leaves) * sizeof(int);
  auto go = [&](auto kernel) {
    const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(heap),
        static_cast<const float*>(tbl), static_cast<const float*>(route_f),
        static_cast<int32_t*>(heap_out), n_pad, c_pad, lp, n_bins, base, n_leaves);
    return static_cast<int>(cudaGetLastError());
  };
  switch (rows) {
    case 4: return go(route_rows_kernel<4>);
    case 8: return go(route_rows_kernel<8>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_radix(const void* codes, const void* heap, const void* stats,
                 const void* scale, void* hist, void* side, int64_t n_pad,
                 int c_pad, int n_bins, int base, int n_leaves, int half, int win,
                 int group, int ncopy, int threads, int agg,
                 int64_t rows_per_block, void* stream) {
  using Acc = typename Values<T>::Acc;
  const size_t smem = window_smem<T>(c_pad, n_bins, win, group, ncopy);
  if (smem == 0 || !threads_ok(threads) || ncopy > threads / 32 || rows_per_block % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  // the f32 form's 32-column group would take it past 64 registers
  return with_group<kRadixMaxGroup<T>>(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    const cudaError_t e =
        allow_smem(reinterpret_cast<const void*>(radix_kernel<T, G>), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>((c_pad + G - 1) / G),
                    grid_rows(n_pad, rows_per_block));
    radix_kernel<T, G><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(heap),
        static_cast<const T*>(stats), static_cast<const double*>(scale),
        static_cast<Acc*>(hist), static_cast<float*>(side), n_pad, c_pad, n_bins,
        base, n_leaves, half, win, ncopy, agg, rows_per_block);
    return static_cast<int>(cudaGetLastError());
  });
}

int launch_fused(const void* codes, const void* heap, const void* tbl,
                 const void* route_f, const void* stats, const void* scale,
                 void* heap_out, void* hist, void* side, int64_t n_pad, int c_pad,
                 int lp, int n_bins, int base_r, int L_r, int base_h, int L_h,
                 int win, int n_windows, int group, int threads,
                 int64_t rows_per_block, void* stream) {
  const size_t smem = window_smem<float>(c_pad, n_bins, win, group, 1);
  if (smem == 0 || !threads_ok(threads)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(fused_kernel<float>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_kernel<float><<<level_grid(c_pad, group, n_pad, rows_per_block, n_windows),
                        threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(heap),
      static_cast<const float*>(tbl), static_cast<const float*>(route_f),
      static_cast<const float*>(stats), static_cast<const double*>(scale),
      static_cast<int32_t*>(heap_out), static_cast<Fixed*>(hist),
      static_cast<float*>(side), n_pad, c_pad, lp, n_bins, base_r, L_r, base_h,
      L_h, win, group, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

int launch_fused_i8(const void* codes, const void* heap, const void* tbl,
                    const void* route_f, const void* stats, void* heap_out,
                    void* hist, int64_t n_pad, int c_pad, int lp, int n_bins,
                    int base_r, int L_r, int base_h, int L_h, int win,
                    int n_windows, int group, int threads,
                    int64_t rows_per_block, void* stream) {
  const size_t smem = window_smem<int32_t>(c_pad, n_bins, win, group, 1);
  if (smem == 0 || !threads_ok(threads)) return static_cast<int>(cudaErrorInvalidValue);
  return with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    const cudaError_t e =
        allow_smem(reinterpret_cast<const void*>(fused_i8_kernel<G>), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_i8_kernel<G><<<level_grid(c_pad, G, n_pad, rows_per_block, n_windows),
                         threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(heap),
        static_cast<const float*>(tbl), static_cast<const float*>(route_f),
        static_cast<const int32_t*>(stats), static_cast<int32_t*>(heap_out),
        static_cast<int32_t*>(hist), n_pad, c_pad, lp, n_bins, base_r, L_r,
        base_h, L_h, win, rows_per_block);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

int h2o3_route(const void* codes, const void* heap, const void* tbl,
               const void* route_f, const void* valtab, const void* f_in,
               void* heap_out, void* f_out, int64_t n_pad, int c_pad, int lp,
               int n_bins, int base, int n_leaves, float eta, int emit_f,
               int rows, int threads, int blocks, void* stream) {
  if (!emit_f)
    return launch_route_rows(codes, heap, tbl, route_f, heap_out, n_pad, c_pad, lp,
                             n_bins, base, n_leaves, rows, threads, blocks, stream);
  const dim3 grid(static_cast<unsigned>((n_pad + kRouteThreads - 1) / kRouteThreads));
  route_kernel<true><<<grid, kRouteThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(heap),
      static_cast<const float*>(tbl), static_cast<const float*>(route_f),
      static_cast<const float*>(valtab), static_cast<const float*>(f_in),
      static_cast<int32_t*>(heap_out), static_cast<float*>(f_out), n_pad, c_pad, lp,
      n_bins, base, n_leaves, eta);
  return static_cast<int>(cudaGetLastError());
}

// f32 stats, hist int64 fixed point by scale, side f32; `group` columns
// per block.
int h2o3_hist(const void* codes, const void* heap, const void* stats,
              const void* scale, void* hist, void* side, int64_t n_pad,
              int c_pad, int n_bins, int base, int n_leaves, int half, int win,
              int n_windows, int group, int64_t rows_per_block, void* stream) {
  return launch_hist(codes, heap, stats, scale, hist, side, n_pad, c_pad, n_bins,
                     base, n_leaves, half, win, n_windows, group, rows_per_block,
                     stream);
}

// int32 stats in [-127, 127], hist int32, for slots b0 .. b0 + nband of
// the histogram (nband <= 256); `packed` is n_pad words of scratch.
int h2o3_hist_i8(const void* codes, const void* heap, const void* stats,
                 void* packed, void* hist, int64_t n_pad, int c_pad, int n_bins,
                 int base, int n_leaves, int half, int b0, int nband, int win,
                 int n_windows, int group, int spad, int threads, int pack_blocks,
                 int64_t rows_per_block, void* stream) {
  return launch_hist_i8(codes, heap, stats, packed, hist, n_pad, c_pad, n_bins, base,
                        n_leaves, half, b0, nband, win, n_windows, group, spad,
                        threads, pack_blocks, rows_per_block, stream);
}

// As h2o3_hist, for windows of at most 2 slots: `group` columns (1, 2, 4,
// ..., 32) and `ncopy` window copies per block, 512 or 1024 threads, agg !=
// 0 for warp aggregation.
int h2o3_radix(const void* codes, const void* heap, const void* stats,
               const void* scale, void* hist, void* side, int64_t n_pad,
               int c_pad, int n_bins, int base, int n_leaves, int half, int win,
               int group, int ncopy, int threads, int agg,
               int64_t rows_per_block, int int8, void* stream) {
  return int8 ? launch_radix<int32_t>(codes, heap, stats, scale, hist, side, n_pad,
                                      c_pad, n_bins, base, n_leaves, half, win,
                                      group, ncopy, threads, agg, rows_per_block,
                                      stream)
              : launch_radix<float>(codes, heap, stats, scale, hist, side, n_pad,
                                    c_pad, n_bins, base, n_leaves, half, win,
                                    group, ncopy, threads, agg, rows_per_block,
                                    stream);
}

// As h2o3_hist, plus the route tables and the new heap; 512 or 1024
// threads. The int32 form takes a group of 1, 2, 4, ..., 32 columns.
int h2o3_fused(const void* codes, const void* heap, const void* tbl,
               const void* route_f, const void* stats, const void* scale,
               void* heap_out, void* hist, void* side, int64_t n_pad, int c_pad,
               int lp, int n_bins, int base_r, int L_r, int base_h, int L_h,
               int win, int n_windows, int group, int threads,
               int64_t rows_per_block, int int8, void* stream) {
  return int8 ? launch_fused_i8(codes, heap, tbl, route_f, stats, heap_out, hist,
                                n_pad, c_pad, lp, n_bins, base_r, L_r, base_h,
                                L_h, win, n_windows, group, threads,
                                rows_per_block, stream)
              : launch_fused(codes, heap, tbl, route_f, stats, scale, heap_out,
                             hist, side, n_pad, c_pad, lp, n_bins, base_r, L_r,
                             base_h, L_h, win, n_windows, group, threads,
                             rows_per_block, stream);
}

}  // extern "C"
