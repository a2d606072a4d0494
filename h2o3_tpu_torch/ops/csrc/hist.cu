// Route and histogram kernels of the binned tree engine, written for Hopper
// (sm_90a). They compute what ops/hist_pallas.py's sbh_route_pallas and
// sbh_hist_pallas compute on the TPU, redesigned for the GPU rather than
// carried over block by block.
//
// Layouts (shared with h2o3_tpu_torch/ops/hist_cuda.py):
//   codes   uint8 (c_pad, n_pad), column-major planes: codes[c * n_pad + r]
//   heap    int32 (n_pad,)  heap node id of every row
//   stats   f32   (4, n_pad) rows 0 = w, 1 = w*grad, 2 = w*hess, 3 = spare (0)
//   tbl     f32   (8, lp)    row 0 = split column, row 1 = did-split
//   route_f f32   (lp, n_bins) 1.0 = code goes right
//   valtab  f32   (8, nodes_p) row 0 = leaf values (emit_f only)
//   hist    f64   (l_pad, c_pad, 4, n_bins), zeroed by the caller; the
//                 wrapper hands back its f32 cast
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Stat rows accumulated by the histogram: w, w*grad, w*hess. Row 3 of the
// stats panel is the spare slot of the TPU layout; it is never read and its
// output row stays as the caller zeroed it.
constexpr int kStats = 3;
constexpr int kRouteThreads = 256;
constexpr int kHistThreads = 512;

// ---------------------------------------------------------------------------
// Route (replaces hist_pallas.py sbh_route_pallas, both forms).
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
  const int h = heap[r];
  const int leaf = h - base;
  int nh = h;
  if (leaf >= 0 && leaf < n_leaves && __ldg(&tbl[lp + leaf]) > 0.5f) {
    int col = static_cast<int>(__ldg(&tbl[leaf]));
    col = min(max(col, 0), c_pad - 1);
    // codes >= n_bins are outside the contract; clamp so they never read
    // past the leaf's row of the table
    const int code = min(static_cast<int>(codes[static_cast<int64_t>(col) * n_pad + r]),
                         n_bins - 1);
    const bool right =
        __ldg(&route_f[static_cast<int64_t>(leaf) * n_bins + code]) > 0.5f;
    nh = 2 * h + 1 + (right ? 1 : 0);
  }
  heap_out[r] = nh;
  if (kEmitF) f_out[r] = f_in[r] + eta * __ldg(&valtab[nh]);
}

// ---------------------------------------------------------------------------
// Histogram (replaces hist_pallas.py sbh_hist_pallas / _hist_pallas).
//
// hist[slot, c, s, b] = sum of stats[s, r] over rows r whose leaf maps to
// `slot` and whose code in column c is b. Leaf of a row: heap - base, in
// [0, n_leaves); with `half`, only even leaves count, at slot leaf >> 1.
//
// Bound: bytes. Each row's heap id (4 B), three stats (12 B) and one code
// byte per column are read once in the ideal pass; the output is small.
// Design: grid (column, row chunk, leaf window). A block owns one column's
// histogram for a window of `win` leaf slots in shared memory
// (win x 3 x n_bins f64, up to 96 KB), folds its chunk of rows into it with
// shared-memory atomics, then flushes the non-zero bins into the output
// with global atomics. Both sums are f64: a bin that holds most rows (a
// dominant level, a constant or padding column) takes one add per row of
// the block's chunk, and 16K f32 adds of one value into one address lost
// 8e-5 of the bin (measured at 11M rows); in f64 the rounding left is the
// final cast to f32. blockIdx.x (fastest) walks the columns, so the
// blocks in flight share one row chunk and its heap/stats stay in L2
// instead of being re-read from HBM once per column. Each thread takes 4
// consecutive rows per step (int4 heap, uchar4 codes, float4 stats).
// The TPU kernel kept a whole window block resident across a sequential row
// sweep and accumulated one-hot products on the MXU; blocks here run in
// parallel in no order, so the cross-block sum is the atomic flush.
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const uint8_t* __restrict__ codes,
            const int32_t* __restrict__ heap,
            const float* __restrict__ stats,
            double* __restrict__ hist,
            int64_t n_pad, int c_pad, int n_bins, int base, int n_leaves,
            int half, int win, int64_t rows_per_block) {
  extern __shared__ double sh[];                // [win][kStats][n_bins]
  const int c = blockIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int w0 = blockIdx.z * win;
  const int nsh = win * kStats * n_bins;
  for (int i = threadIdx.x; i < nsh; i += blockDim.x) sh[i] = 0.0;
  __syncthreads();

  const int64_t r1 = r0 + rows_per_block < n_pad ? r0 + rows_per_block : n_pad;
  const uint8_t* __restrict__ crow = codes + static_cast<int64_t>(c) * n_pad;
  const float* __restrict__ s_w = stats;
  const float* __restrict__ s_g = stats + n_pad;
  const float* __restrict__ s_h = stats + 2 * n_pad;
  for (int64_t r = r0 + 4 * static_cast<int64_t>(threadIdx.x); r < r1;
       r += 4 * static_cast<int64_t>(blockDim.x)) {
    const int4 h4 = *reinterpret_cast<const int4*>(heap + r);
    const int hs[4] = {h4.x, h4.y, h4.z, h4.w};
    int slot[4];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int leaf = hs[k] - base;
      bool ok = leaf >= 0 && leaf < n_leaves;
      if (half) {
        ok = ok && (leaf & 1) == 0;
        leaf >>= 1;
      }
      const int s = leaf - w0;
      ok = ok && s >= 0 && s < win;
      slot[k] = ok ? s : -1;
      any = any || ok;
    }
    if (!any) continue;
    const uchar4 c4 = *reinterpret_cast<const uchar4*>(crow + r);
    const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
    const float4 w4 = *reinterpret_cast<const float4*>(s_w + r);
    const float4 g4 = *reinterpret_cast<const float4*>(s_g + r);
    const float4 e4 = *reinterpret_cast<const float4*>(s_h + r);
    const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
    const float gs[4] = {g4.x, g4.y, g4.z, g4.w};
    const float es[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // codes >= n_bins are outside the contract: dropped, never written
      // past the window's shared histogram
      if (slot[k] < 0 || cs[k] >= n_bins) continue;
      double* dst = sh + slot[k] * kStats * n_bins + cs[k];
      atomicAdd(dst, static_cast<double>(ws[k]));
      atomicAdd(dst + n_bins, static_cast<double>(gs[k]));
      atomicAdd(dst + 2 * n_bins, static_cast<double>(es[k]));
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nsh; i += blockDim.x) {
    const double v = sh[i];
    if (v == 0.0) continue;
    const int b = i % n_bins;
    const int s = (i / n_bins) % kStats;
    const int slot = w0 + i / (kStats * n_bins);
    const int64_t o =
        ((static_cast<int64_t>(slot) * c_pad + c) * 4 + s) * n_bins + b;
    atomicAdd(hist + o, v);
  }
}

}  // namespace

extern "C" {

int h2o3_route(const void* codes, const void* heap, const void* tbl,
               const void* route_f, const void* valtab, const void* f_in,
               void* heap_out, void* f_out, int64_t n_pad, int c_pad, int lp,
               int n_bins, int base, int n_leaves, float eta, int emit_f,
               void* stream) {
  const dim3 grid(static_cast<unsigned>((n_pad + kRouteThreads - 1) / kRouteThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cd = static_cast<const uint8_t*>(codes);
  const auto* hp = static_cast<const int32_t*>(heap);
  const auto* tb = static_cast<const float*>(tbl);
  const auto* rf = static_cast<const float*>(route_f);
  const auto* vt = static_cast<const float*>(valtab);
  const auto* fi = static_cast<const float*>(f_in);
  auto* ho = static_cast<int32_t*>(heap_out);
  auto* fo = static_cast<float*>(f_out);
  if (emit_f) {
    route_kernel<true><<<grid, kRouteThreads, 0, st>>>(
        cd, hp, tb, rf, vt, fi, ho, fo, n_pad, c_pad, lp, n_bins, base,
        n_leaves, eta);
  } else {
    route_kernel<false><<<grid, kRouteThreads, 0, st>>>(
        cd, hp, tb, rf, vt, fi, ho, fo, n_pad, c_pad, lp, n_bins, base,
        n_leaves, eta);
  }
  return static_cast<int>(cudaGetLastError());
}

int h2o3_hist(const void* codes, const void* heap, const void* stats,
              void* hist, int64_t n_pad, int c_pad, int n_bins, int base,
              int n_leaves, int half, int win, int n_windows,
              int64_t rows_per_block, void* stream) {
  const size_t smem = static_cast<size_t>(win) * kStats * n_bins * sizeof(double);
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid(static_cast<unsigned>(c_pad),
                  static_cast<unsigned>((n_pad + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>(n_windows));
  hist_kernel<<<grid, kHistThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(heap),
      static_cast<const float*>(stats), static_cast<double*>(hist), n_pad,
      c_pad, n_bins, base, n_leaves, half, win, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
