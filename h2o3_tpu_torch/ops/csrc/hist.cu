// Route and histogram kernels of the binned tree engine, written for Hopper
// (sm_90a). They compute what ops/hist_pallas.py's Pallas kernels compute
// on the TPU, redesigned for the GPU rather than carried over block by block.
//
// Layouts (shared with h2o3_tpu_torch/ops/hist_cuda.py):
//   codes   uint8 (c_pad, n_pad), column-major planes: codes[c * n_pad + r]
//   heap    int32 (n_pad,)  heap node id of every row
//   stats   f32 or int32 (4, n_pad) rows 0 = w, 1 = w*grad, 2 = w*hess,
//                 3 = spare (0); int32 holds the int8-quantized stats
//   tbl     f32   (8, lp)    row 0 = split column, row 1 = did-split
//   route_f f32   (lp, n_bins) 1.0 = code goes right
//   valtab  f32   (8, nodes_p) row 0 = leaf values (emit_f only)
//   hist    f64 (float stats) or int32 (int stats), (l_pad, c_pad, 4,
//                 n_bins), zeroed by the caller; the wrapper hands back the
//                 f64 sums' f32 cast
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of its launch (or the
// error of setting the kernel's shared-memory limit).

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

// Stat rows accumulated by the histogram: w, w*grad, w*hess. Row 3 of the
// stats panel is the spare slot of the TPU layout; it is never read and its
// output row stays as the caller zeroed it.
constexpr int kStats = 3;
constexpr int kRouteThreads = 256;
constexpr int kHistThreads = 512;
constexpr int kWarps = kHistThreads / 32;

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
  const int nh = route_one(codes, tbl, route_f, heap[r], r, n_pad, c_pad, lp,
                           n_bins, base, n_leaves);
  heap_out[r] = nh;
  if (kEmitF) f_out[r] = f_in[r] + eta * __ldg(&valtab[nh]);
}

// ---------------------------------------------------------------------------
// Shared pieces of the histogram kernels.
//
// T is the stats type (float, or int32 for the int8-quantized stats) and Acc
// the accumulator: f64 for float stats, int32 for int stats. Both sums are
// order-independent in effect: the int32 sums exactly, and a bin that holds
// most rows (a dominant level, a constant or padding column) takes one add
// per row of the block's chunk, where 16K f32 adds of one value into one
// address lost 8e-5 of the bin (measured at 11M rows); in f64 the rounding
// left is the final cast to f32.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int32_t> { using type = int4; };

template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, T out[4]) {
  const typename Vec4<T>::type v = *reinterpret_cast<const typename Vec4<T>::type*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
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

// Fold 4 consecutive rows into a shared window histogram sh[win][3][n_bins].
// With kRuns, rows in a run that share one (slot, bin) key are summed in
// registers first and take one shared atomic per stat: a constant or
// padding column (every row in bin 0) then costs a quarter of the atomics.
template <bool kRuns, typename T, typename Acc>
__device__ __forceinline__ void fold4(Acc* __restrict__ sh, const int slot[4],
                                      const uchar4 c4, const T ws[4],
                                      const T gs[4], const T es[4],
                                      int n_bins) {
  const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
  if (!kRuns) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // codes >= n_bins are outside the contract: dropped, never written
      // past the window's shared histogram
      if (slot[k] < 0 || cs[k] >= n_bins) continue;
      Acc* dst = sh + slot[k] * kStats * n_bins + cs[k];
      atomicAdd(dst, static_cast<Acc>(ws[k]));
      atomicAdd(dst + n_bins, static_cast<Acc>(gs[k]));
      atomicAdd(dst + 2 * n_bins, static_cast<Acc>(es[k]));
    }
    return;
  }
  int key = -1;
  Acc aw = 0, ag = 0, ah = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (slot[k] < 0 || cs[k] >= n_bins) continue;
    const int kk = slot[k] * kStats * n_bins + cs[k];
    if (kk != key) {
      if (key >= 0) {
        atomicAdd(sh + key, aw);
        atomicAdd(sh + key + n_bins, ag);
        atomicAdd(sh + key + 2 * n_bins, ah);
      }
      key = kk;
      aw = ag = ah = 0;
    }
    aw += static_cast<Acc>(ws[k]);
    ag += static_cast<Acc>(gs[k]);
    ah += static_cast<Acc>(es[k]);
  }
  if (key >= 0) {
    atomicAdd(sh + key, aw);
    atomicAdd(sh + key + n_bins, ag);
    atomicAdd(sh + key + 2 * n_bins, ah);
  }
}

// Add `ncopy` shared copies of a window histogram [win][3][n_bins] and flush
// the non-zero bins into the output (l_pad, c_pad, 4, n_bins) at slots
// w0 .. w0 + win, column c, with global atomics.
template <typename Acc>
__device__ __forceinline__ void flush_window(const Acc* __restrict__ sh, int ncopy,
                                             int nsh, Acc* __restrict__ hist,
                                             int c, int c_pad, int n_bins, int w0) {
  for (int i = threadIdx.x; i < nsh; i += blockDim.x) {
    Acc v = 0;
    for (int k = 0; k < ncopy; ++k) v += sh[k * nsh + i];
    if (v == 0) continue;
    const int b = i % n_bins;
    const int s = (i / n_bins) % kStats;
    const int slot = w0 + i / (kStats * n_bins);
    const int64_t o = ((static_cast<int64_t>(slot) * c_pad + c) * 4 + s) * n_bins + b;
    atomicAdd(hist + o, v);
  }
}

// ---------------------------------------------------------------------------
// Histogram (replaces hist_pallas.py sbh_hist_pallas / _hist_pallas, and with
// int32 stats sbh_hist_pallas_i8).
//
// hist[slot, c, s, b] = sum of stats[s, r] over rows r whose leaf maps to
// `slot` and whose code in column c is b. Leaf of a row: heap - base, in
// [0, n_leaves); with `half`, only even leaves count, at slot leaf >> 1.
//
// Bound: bytes. Each row's heap id (4 B), three stats (12 B) and one code
// byte per column are read once in the ideal pass; the output is small.
// Design: grid (column, row chunk, leaf window). A block owns one column's
// histogram for a window of `win` leaf slots in shared memory
// (win x 3 x n_bins accumulators, up to 96 KB), folds its chunk of rows
// into it with shared-memory atomics, then flushes the non-zero bins into
// the output with global atomics. blockIdx.x (fastest) walks the columns,
// so the blocks in flight share one row chunk and its heap/stats stay in L2
// instead of being re-read from HBM once per column. Each thread takes 4
// consecutive rows per step (int4 heap, uchar4 codes, 16-byte stats).
// The TPU kernel kept a whole window block resident across a sequential row
// sweep and accumulated one-hot products on the MXU (bf16 panels for f32
// stats, int8 panels with exact int32 sums for the int8 form); blocks here
// run in parallel in no order, so the cross-block sum is the atomic flush.
// The int32 form is exact, so kernel, plain version and the JAX twin agree
// bit for bit.
template <typename T, typename Acc>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const uint8_t* __restrict__ codes,
            const int32_t* __restrict__ heap,
            const T* __restrict__ stats,
            Acc* __restrict__ hist,
            int64_t n_pad, int c_pad, int n_bins, int base, int n_leaves,
            int half, int win, int64_t rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* sh = reinterpret_cast<Acc*>(smem);           // [win][kStats][n_bins]
  const int c = blockIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int w0 = blockIdx.z * win;
  const int nsh = win * kStats * n_bins;
  for (int i = threadIdx.x; i < nsh; i += blockDim.x) sh[i] = 0;
  __syncthreads();

  const int64_t r1 = r0 + rows_per_block < n_pad ? r0 + rows_per_block : n_pad;
  const uint8_t* __restrict__ crow = codes + static_cast<int64_t>(c) * n_pad;
  for (int64_t r = r0 + 4 * static_cast<int64_t>(threadIdx.x); r < r1;
       r += 4 * static_cast<int64_t>(blockDim.x)) {
    const int4 h4 = *reinterpret_cast<const int4*>(heap + r);
    const int hs[4] = {h4.x, h4.y, h4.z, h4.w};
    int slot[4];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      slot[k] = window_slot(hs[k], base, n_leaves, half, w0, win);
      any = any || slot[k] >= 0;
    }
    if (!any) continue;
    T ws[4], gs[4], es[4];
    load4(stats + r, ws);
    load4(stats + n_pad + r, gs);
    load4(stats + 2 * n_pad + r, es);
    fold4<false>(sh, slot, *reinterpret_cast<const uchar4*>(crow + r), ws, gs,
                 es, n_bins);
  }
  __syncthreads();
  flush_window(sh, 1, nsh, hist, c, c_pad, n_bins, w0);
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
// (column, row chunk); the block keeps `ncopy` private copies of the window
// histogram in shared memory (one per warp, or per group of warps where
// fewer fit), so the warps of a block never contend with each other; runs
// of rows sharing one (slot, bin) key are summed in registers before their
// atomics; the copies are added once, before the flush.
template <typename T, typename Acc>
__global__ void __launch_bounds__(kHistThreads)
radix_kernel(const uint8_t* __restrict__ codes,
             const int32_t* __restrict__ heap,
             const T* __restrict__ stats,
             Acc* __restrict__ hist,
             int64_t n_pad, int c_pad, int n_bins, int base, int n_leaves,
             int half, int win, int ncopy, int64_t rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* sh = reinterpret_cast<Acc*>(smem);    // [ncopy][win][kStats][n_bins]
  const int c = blockIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int nsh = win * kStats * n_bins;
  for (int i = threadIdx.x; i < ncopy * nsh; i += blockDim.x) sh[i] = 0;
  __syncthreads();

  Acc* mine = sh + ((threadIdx.x >> 5) % ncopy) * nsh;
  const int64_t r1 = r0 + rows_per_block < n_pad ? r0 + rows_per_block : n_pad;
  const uint8_t* __restrict__ crow = codes + static_cast<int64_t>(c) * n_pad;
  for (int64_t r = r0 + 4 * static_cast<int64_t>(threadIdx.x); r < r1;
       r += 4 * static_cast<int64_t>(blockDim.x)) {
    const int4 h4 = *reinterpret_cast<const int4*>(heap + r);
    const int hs[4] = {h4.x, h4.y, h4.z, h4.w};
    int slot[4];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      slot[k] = window_slot(hs[k], base, n_leaves, half, 0, win);
      any = any || slot[k] >= 0;
    }
    if (!any) continue;
    T ws[4], gs[4], es[4];
    load4(stats + r, ws);
    load4(stats + n_pad + r, gs);
    load4(stats + 2 * n_pad + r, es);
    fold4<true>(mine, slot, *reinterpret_cast<const uchar4*>(crow + r), ws, gs,
                es, n_bins);
  }
  __syncthreads();
  flush_window(sh, ncopy, nsh, hist, c, c_pad, n_bins, 0);
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
// and the output. Design: hist_kernel's grid (column, row chunk, leaf
// window). The histogram's blocks are split over columns and windows but
// the heap is per row, so every block recomputes the routed id of its rows
// in registers from the OLD heap and the split tables; exactly one block
// per row chunk (column 0, window 0) writes the new heap, to a separate
// buffer, and nothing in the launch reads it. The other blocks' gathers of
// the split column's byte hit L2, since the blocks in flight share a row
// chunk. Rows of leaves that did not split keep an id in
// [base_r, base_r + L_r), outside the histogram's leaves, and are not
// summed. The TPU kernel ran one sequential row sweep with the whole
// level's histogram resident in VMEM, hence its 16-leaf cap, kept here as
// the dispatch gate (at 16 leaves the f64 window is 96 KB).
template <typename T, typename Acc>
__global__ void __launch_bounds__(kHistThreads)
fused_kernel(const uint8_t* __restrict__ codes,
             const int32_t* __restrict__ heap,
             const float* __restrict__ tbl,
             const float* __restrict__ route_f,
             const T* __restrict__ stats,
             int32_t* __restrict__ heap_out,
             Acc* __restrict__ hist,
             int64_t n_pad, int c_pad, int lp, int n_bins, int base_r, int L_r,
             int base_h, int L_h, int win, int64_t rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* sh = reinterpret_cast<Acc*>(smem);           // [win][kStats][n_bins]
  const int c = blockIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int w0 = blockIdx.z * win;
  const bool writer = blockIdx.x == 0 && blockIdx.z == 0;
  const int nsh = win * kStats * n_bins;
  for (int i = threadIdx.x; i < nsh; i += blockDim.x) sh[i] = 0;
  __syncthreads();

  const int64_t r1 = r0 + rows_per_block < n_pad ? r0 + rows_per_block : n_pad;
  const uint8_t* __restrict__ crow = codes + static_cast<int64_t>(c) * n_pad;
  for (int64_t r = r0 + 4 * static_cast<int64_t>(threadIdx.x); r < r1;
       r += 4 * static_cast<int64_t>(blockDim.x)) {
    const int4 h4 = *reinterpret_cast<const int4*>(heap + r);
    const int hs[4] = {h4.x, h4.y, h4.z, h4.w};
    int nh[4];
    int slot[4];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      nh[k] = route_one(codes, tbl, route_f, hs[k], r + k, n_pad, c_pad, lp,
                        n_bins, base_r, L_r);
      slot[k] = window_slot(nh[k], base_h, L_h, true, w0, win);
      any = any || slot[k] >= 0;
    }
    if (writer) {
      *reinterpret_cast<int4*>(heap_out + r) = make_int4(nh[0], nh[1], nh[2], nh[3]);
    }
    if (!any) continue;
    T ws[4], gs[4], es[4];
    load4(stats + r, ws);
    load4(stats + n_pad + r, gs);
    load4(stats + 2 * n_pad + r, es);
    fold4<false>(sh, slot, *reinterpret_cast<const uchar4*>(crow + r), ws, gs,
                 es, n_bins);
  }
  __syncthreads();
  flush_window(sh, 1, nsh, hist, c, c_pad, n_bins, w0);
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

template <typename T, typename Acc>
int launch_hist(const void* codes, const void* heap, const void* stats,
                void* hist, int64_t n_pad, int c_pad, int n_bins, int base,
                int n_leaves, int half, int win, int n_windows,
                int64_t rows_per_block, void* stream) {
  const size_t smem = static_cast<size_t>(win) * kStats * n_bins * sizeof(Acc);
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(hist_kernel<T, Acc>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(c_pad), grid_rows(n_pad, rows_per_block),
                  static_cast<unsigned>(n_windows));
  hist_kernel<T, Acc><<<grid, kHistThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(heap),
      static_cast<const T*>(stats), static_cast<Acc*>(hist), n_pad, c_pad,
      n_bins, base, n_leaves, half, win, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc>
int launch_radix(const void* codes, const void* heap, const void* stats,
                 void* hist, int64_t n_pad, int c_pad, int n_bins, int base,
                 int n_leaves, int half, int win, int ncopy,
                 int64_t rows_per_block, void* stream) {
  if (ncopy < 1 || ncopy > kWarps) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(ncopy) * win * kStats * n_bins * sizeof(Acc);
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(radix_kernel<T, Acc>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(c_pad), grid_rows(n_pad, rows_per_block));
  radix_kernel<T, Acc><<<grid, kHistThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(heap),
      static_cast<const T*>(stats), static_cast<Acc*>(hist), n_pad, c_pad,
      n_bins, base, n_leaves, half, win, ncopy, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc>
int launch_fused(const void* codes, const void* heap, const void* tbl,
                 const void* route_f, const void* stats, void* heap_out,
                 void* hist, int64_t n_pad, int c_pad, int lp, int n_bins,
                 int base_r, int L_r, int base_h, int L_h, int win,
                 int n_windows, int64_t rows_per_block, void* stream) {
  const size_t smem = static_cast<size_t>(win) * kStats * n_bins * sizeof(Acc);
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(fused_kernel<T, Acc>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(c_pad), grid_rows(n_pad, rows_per_block),
                  static_cast<unsigned>(n_windows));
  fused_kernel<T, Acc><<<grid, kHistThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(heap),
      static_cast<const float*>(tbl), static_cast<const float*>(route_f),
      static_cast<const T*>(stats), static_cast<int32_t*>(heap_out),
      static_cast<Acc*>(hist), n_pad, c_pad, lp, n_bins, base_r, L_r, base_h,
      L_h, win, rows_per_block);
  return static_cast<int>(cudaGetLastError());
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

// int8 != 0: stats int32, hist int32; else stats f32, hist f64.
int h2o3_hist(const void* codes, const void* heap, const void* stats,
              void* hist, int64_t n_pad, int c_pad, int n_bins, int base,
              int n_leaves, int half, int win, int n_windows,
              int64_t rows_per_block, int int8, void* stream) {
  return int8 ? launch_hist<int32_t, int32_t>(codes, heap, stats, hist, n_pad, c_pad,
                                              n_bins, base, n_leaves, half, win,
                                              n_windows, rows_per_block, stream)
              : launch_hist<float, double>(codes, heap, stats, hist, n_pad, c_pad,
                                           n_bins, base, n_leaves, half, win,
                                           n_windows, rows_per_block, stream);
}

int h2o3_radix(const void* codes, const void* heap, const void* stats,
               void* hist, int64_t n_pad, int c_pad, int n_bins, int base,
               int n_leaves, int half, int win, int ncopy,
               int64_t rows_per_block, int int8, void* stream) {
  return int8 ? launch_radix<int32_t, int32_t>(codes, heap, stats, hist, n_pad, c_pad,
                                               n_bins, base, n_leaves, half, win,
                                               ncopy, rows_per_block, stream)
              : launch_radix<float, double>(codes, heap, stats, hist, n_pad, c_pad,
                                            n_bins, base, n_leaves, half, win,
                                            ncopy, rows_per_block, stream);
}

int h2o3_fused(const void* codes, const void* heap, const void* tbl,
               const void* route_f, const void* stats, void* heap_out,
               void* hist, int64_t n_pad, int c_pad, int lp, int n_bins,
               int base_r, int L_r, int base_h, int L_h, int win, int n_windows,
               int64_t rows_per_block, int int8, void* stream) {
  return int8 ? launch_fused<int32_t, int32_t>(codes, heap, tbl, route_f, stats,
                                               heap_out, hist, n_pad, c_pad, lp,
                                               n_bins, base_r, L_r, base_h, L_h,
                                               win, n_windows, rows_per_block, stream)
              : launch_fused<float, double>(codes, heap, tbl, route_f, stats,
                                            heap_out, hist, n_pad, c_pad, lp,
                                            n_bins, base_r, L_r, base_h, L_h, win,
                                            n_windows, rows_per_block, stream);
}

}  // extern "C"
