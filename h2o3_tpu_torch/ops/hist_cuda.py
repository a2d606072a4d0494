"""Route and histogram passes of the binned tree engine: hand-written CUDA
kernels for Hopper (csrc/hist.cu) and their plain PyTorch versions.

Counterpart of h2o3_tpu/ops/hist_pallas.py. Per tree level the grower
  * routes rows by the previous level's splits (`sbh_route`): every row
    carries one int32 heap id, and a row of a leaf that split moves to
    child 2*heap+1+goes_right; the terminal pass (`emit_f=True`) also adds
    eta * leaf value to the row's margin F;
  * accumulates per-(leaf, column, bin) sums of the stats rows
    (w, w*grad, w*hess) over the uint8 code plane (`sbh_hist`); with
    `half=True` only even leaves (left children) are summed, at slot
    leaf >> 1, and the caller derives the right children by subtraction.
    `sbh_hist_i8` takes int32 stats in [-127, 127] (the int8-quantized
    stats of `int8_hist`) and sums them exactly in int32. The kernels sum
    f32 stats exactly too, in 64-bit fixed point: stat row s of a row adds
    round(x * scale[s]) (`hist_scale`), and the wrapper hands back the f32
    value of the sum.
  * or does both in one pass (`sbh_route_hist`): route level d-1, then the
    half histogram of level d over the updated heap.

Three kernels compute the histogram function: the dense one
(`sbh_hist_dense`), the shallow-window one (`sbh_hist_radix`, effective
windows of at most 2 leaves) and the level-fused route+histogram
(`sbh_route_hist_fused`, windows of at most 16). The dispatchers
`sbh_hist`, `sbh_hist_i8` and `sbh_route_hist` choose among them by the
JAX package's shape gates (`_radix_shape_ok`, `_fused_applicable`), so the
launches per level match its dispatch; `radix=False` / `fused=False` force
the dense / sequential kernels, as there.

Each wrapper runs the plain version for a tensor on the CPU (for the
histograms the kernels' own fixed-point function, `sbh_hist_plain_fixed`),
launches its CUDA kernel for a tensor on a CUDA device, and raises for
anything else.
There is no probe and no fallback from the kernel to the plain version.
The TPU kernels' 4-codes-per-word packing (a Mosaic tiling workaround) is
not used: the kernels read the uint8 plane directly.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import torch

from h2o3_tpu_torch.ops import _build

# Leaf-window width of one histogram pass (hist_pallas.GW): the output is
# (L_pad, C_pad, 4, n_bins) with L_pad = npass * gwe, gwe = min(l_eff, GW).
GW = 64
S_STATS = 4
# Leaf slots one CUDA block keeps in shared memory for one column: win x 3
# stats x n_bins accumulators within this budget (96 KB = 16 slots of 8-byte
# or 32 of int32 accumulators at 256 bins).
_SMEM_BUDGET = 96 * 1024
# Shared memory a block may use on Hopper (227 KB), and an SM holds (228
# KB, less 1 KB that each resident block reserves). A dense or fused block
# of the f32 forms takes all of it: the widest window of 8-byte
# accumulators it holds, then as many columns of that window as fit
# (level_grid). The int8 fused form takes _SMEM_BUDGET windows and as many
# columns of them as I8_FUSED_BUDGET holds, in a power-of-two group; the
# int8 dense form has its own layout (dense_i8_grid).
SMEM_MAX = 232448
_SMEM_SM = 233472
_BLOCK_RESERVED = 1024
_HIST_ROW_ALIGN = 4
# Column groups the int32 fused kernel and the shallow-window kernel are
# built for (compile-time column loops, csrc/hist.cu with_group); the
# shallow-window kernel's f32 form stops at 16 (kRadixMaxGroup).
GROUPS = (1, 2, 4, 8, 16, 32)
RADIX_GROUPS = {False: GROUPS[:-1], True: GROUPS}
# the int8 dense kernel's groups: 32 columns spilled at 1024 threads
I8_DENSE_GROUPS = GROUPS[:-1]
# Budget of the int8 fused kernel's column group, and threads of a fused
# block (chip_smoke.py phase 5 times both budgets and 512 threads).
I8_FUSED_BUDGET = _SMEM_BUDGET
FUSED_THREADS = 1024
# The shallow-window kernel: threads per block, warp aggregation, and the
# fewest window copies a block keeps (its group is the widest it is built
# for that leaves room for them).
RADIX_THREADS = 1024
RADIX_AGG = True
RADIX_MIN_COPIES = 2
# The int8 dense histogram (csrc/hist.cu hist_i8_kernel): threads per
# block, padding words between the slot windows of a column, the grid's
# waves of resident blocks, and the slots one packed row word addresses.
I8_DENSE_THREADS = 1024
I8_DENSE_SPAD = 1
I8_DENSE_WAVES = 1
I8_BAND = 256
_PACK_THREADS = 256
# The non-terminal route (csrc/hist.cu route_rows_kernel): rows a thread
# takes per step and threads per block; the grid is one wave of resident
# blocks, walked grid-stride.
ROUTE_ROWS = 8
ROUTE_THREADS = 512
_SMS = 132                      # an H100 SXM's SMs, where no card is asked
# The int8 histogram sums |stat| <= 127 per row in int32: exact while
# 127 * rows < 2**31, about 16.9M rows.
I8_MAX_ROWS = (2 ** 31 - 1) // 127

# Shape gates of the JAX package's dispatch (hist_pallas.py:663-674,
# 753-761), without its compile probes: the port's kernels always build.
RADIX_NH = 16
RADIX_MAX_WINDOW = 2
FUSE_MAX_WINDOW = 16
_FUSE_VMEM_OUT = 6 * 2 ** 20
PACK = 4                        # codes per packed word on the TPU
WORD_TILE = 8

# Kernel launches, counted where each wrapper launches its kernel (never
# on the plain path). Read and reset by chip_smoke.py and the card tests.
LAUNCHES = {"route": 0, "route_f": 0, "hist": 0, "hist_i8": 0, "radix": 0,
            "fused": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The level reducer: while one is set on a thread (`level_reduce`), every
# histogram launch hands its raw accumulators — the int64 fixed-point sums
# and the f32 side buffer of the non-finite stats, or the int32 sums of the
# int8 stats — to it before they are turned into the f32 histogram (on the
# CPU too: the wrappers' plain version there is the kernels' function,
# `sbh_hist_plain_fixed`). A cloud of several ranks sums them over its
# world there, exactly (models/tree/binned.py).
_REDUCE = threading.local()


@contextlib.contextmanager
def level_reduce(fn):
    """Set `fn(acc, side) -> (acc, side)` as this thread's level reducer
    for the block."""
    prev = getattr(_REDUCE, "fn", None)
    _REDUCE.fn = fn
    try:
        yield
    finally:
        _REDUCE.fn = prev


def _reducer():
    return getattr(_REDUCE, "fn", None)


def hist_layout(L: int, half: bool):
    """(l_eff, gwe, npass, L_pad) of one histogram call."""
    l_eff = (L + 1) // 2 if half else L
    gwe = min(l_eff, GW)
    npass = max(1, -(-l_eff // gwe))
    return l_eff, gwe, npass, npass * gwe


def packed_words(c_pad: int) -> int:
    """Words of the JAX package's packed code plane for c_pad columns
    (hist_pallas.packed_words): the fused gate's output cap is counted over
    the packed width 4 * packed_words(c_pad), as there."""
    w = -(-c_pad // PACK)
    return w if w <= WORD_TILE else -(-w // WORD_TILE) * WORD_TILE


def hist_scale(stats, n_rows=None):
    """Fixed-point scale of the f32 dense and fused kernels: f64 (3,) on
    stats' device, scale[s] = 2**e with e the largest integer such that
    n_rows * M_s * 2**e <= 2**62, where M_s is the largest finite
    |stats[s]| (non-finite values are left out; scale 1 where M_s is 0).
    n_rows defaults to the stats' row count. Device ops only: nothing waits
    for the card. Exact in f64 for n_rows < 2**29."""
    return fixed_point_scale(stats[:3],
                             stats.shape[1] if n_rows is None else n_rows)


def fixed_point_scale(rows, n_rows):
    """hist_scale's rule for every row of `rows` (s, m): f64 (s,), 2**e
    with e the largest integer such that n_rows * M * 2**e <= 2**62 for
    the row's largest finite magnitude M (1 where M is 0)."""
    n = int(n_rows)
    a = rows.abs()
    m = torch.where(a < float("inf"), a, torch.zeros_like(a)).amax(dim=1)
    return pow2_scale(m.to(torch.float64) * n)


def pow2_scale(t):
    """The scale for sums bounded by t (f64, any shape): 2**e elementwise,
    with e the largest integer such that t * 2**e <= 2**62 (1 where t is
    0 or not finite, at most 2**1023), so every such sum of values at
    that scale fits int64."""
    mant, ex = torch.frexp(t)
    # t = mant * 2**ex with mant in [0.5, 1): t * 2**e <= 2**62 holds up to
    # e = 62 - ex, and up to 63 - ex when mant is exactly 0.5
    e = (62 - ex + (mant == 0.5).to(ex.dtype)).to(torch.int64)
    e = torch.where((t > 0) & (t < float("inf")), e,
                    torch.zeros_like(e)).clamp(max=1023)
    # 2**e built from its bits (torch.ldexp rounds through f32)
    return ((e + 1023) << 52).view(torch.float64)


def column_group(win: int, n_bins: int, c_pad: int, budget: int,
                 acc_bytes: int = 8) -> int:
    """Columns one dense or fused block takes: as many windows of win x 3 x
    n_bins accumulators as fit `budget` bytes of shared memory, at least
    one and at most c_pad."""
    return max(1, min(c_pad, budget // (win * 3 * acc_bytes * n_bins)))


def _pow2_floor(x: int) -> int:
    return 1 << (int(x).bit_length() - 1)


def level_grid(l_eff: int, n_bins: int, c_pad: int, int8: bool,
               group=None):
    """(win, n_windows, group, rows_per_block) of an f32 dense launch or a
    fused launch (the int8 dense launch: dense_i8_grid). int8: hist_grid's
    window at 4 bytes within _SMEM_BUDGET, and by default as many columns
    of it as I8_FUSED_BUDGET holds, rounded down to a power of two (the
    int32 fused kernel's groups are fixed at compile time: a given `group`
    must be one of GROUPS). f32: within SMEM_MAX, the widest window (fewest
    passes over the rows), then as many columns as fit; a given `group`
    narrows the window to fit that many."""
    if int8:
        win, n_windows, rows = hist_grid(l_eff, n_bins, 4)
        if group is None:
            group = min(GROUPS[-1], _pow2_floor(column_group(
                win, n_bins, c_pad, I8_FUSED_BUDGET, 4)))
        elif group not in GROUPS:
            raise ValueError(f"group={group}: the int8 forms take a group "
                             f"in {GROUPS}")
        elif group * win * 3 * 4 * n_bins > SMEM_MAX:
            raise ValueError(f"group={group} of {win}-slot windows exceeds "
                             f"{SMEM_MAX} bytes of shared memory")
    elif group is None:
        win, n_windows, rows = hist_grid(l_eff, n_bins, 8, SMEM_MAX)
        group = column_group(win, n_bins, c_pad, SMEM_MAX)
    else:
        win, n_windows, rows = hist_grid(
            l_eff, n_bins, 8, SMEM_MAX // max(1, int(group)))
    if not 1 <= group <= c_pad:
        raise ValueError(f"group={group} outside [1, {c_pad}]")
    return win, n_windows, int(group), rows


def dense_i8_grid(nband: int, n_bins: int, c_pad: int, group=None,
                  win=None, threads=None, spad=None, waves=None,
                  n_pad: int = 0, sms: int = _SMS):
    """(win, n_windows, group, threads, spad, rows_per_block) of one int8
    dense launch over a band of nband <= I8_BAND slots. A block keeps
    `group` column windows of `win` slots, each slot 3 x n_bins int32 and
    `spad` padding words, within SMEM_MAX. By default the window is the
    widest that one column's 227 KB holds (the band in as few passes over
    the rows as fit, windows of equal width), then as many columns of it as
    fit, rounded down to a power of two (the kernel's compile-time groups,
    I8_DENSE_GROUPS); a given `group` narrows the window to fit, a given
    `win` takes as many columns as fit. The row chunks are sized so that
    the grid of column groups x windows x row chunks fills `waves` waves
    of resident blocks on `sms` SMs (at least one 4-row step per
    thread)."""
    if not 1 <= nband <= I8_BAND:
        raise ValueError(f"nband={nband} outside [1, {I8_BAND}]")
    threads = I8_DENSE_THREADS if threads is None else int(threads)
    if threads not in (512, 1024):
        raise ValueError(f"threads={threads}: 512 or 1024")
    spad = I8_DENSE_SPAD if spad is None else int(spad)
    waves = I8_DENSE_WAVES if waves is None else int(waves)
    if spad < 0 or waves < 1:
        raise ValueError(f"spad={spad}, waves={waves}")
    slot_bytes = (3 * n_bins + spad) * 4
    fit = SMEM_MAX // slot_bytes                  # slot-columns a block holds
    if group is not None and (group not in I8_DENSE_GROUPS
                              or group > c_pad):
        raise ValueError(f"group={group}: one of {I8_DENSE_GROUPS}, at most "
                         f"{c_pad}")
    if win is None:
        per_col = fit // (group or 1)
        if per_col < 1:
            raise ValueError(f"group={group} of one-slot windows exceeds "
                             f"{SMEM_MAX} bytes of shared memory")
        n_windows = -(-nband // per_col)
        win = -(-nband // n_windows)
    else:
        win = min(int(win), nband)
        n_windows = -(-nband // win)
    if group is None:
        group = min(I8_DENSE_GROUPS[-1], _pow2_floor(max(1, min(
            c_pad, fit // win))))
    smem = group * win * slot_bytes
    if win < 1 or smem > SMEM_MAX:
        raise ValueError(f"group={group} of {win}-slot windows exceeds "
                         f"{SMEM_MAX} bytes of shared memory")
    types = -(-c_pad // group) * n_windows
    per_sm = max(1, min(2048 // threads,
                        _SMEM_SM // (smem + _BLOCK_RESERVED)))
    chunks = max(1, waves * sms * per_sm // types)
    rows = -(-max(n_pad, 1) // chunks)
    rows = max(4 * threads, -(-rows // 4) * 4)
    return win, n_windows, int(group), threads, spad, rows


def route_grid(n_pad: int, rows=None, threads=None, sms: int = _SMS):
    """(rows, threads, blocks) of one non-terminal route launch: `rows`
    per thread-step (4 or 8), `threads` per block (256, 512 or 1024), and
    as many blocks as one wave of `sms` SMs holds (2048 threads an SM),
    fewer where the rows run out."""
    rows = ROUTE_ROWS if rows is None else int(rows)
    threads = ROUTE_THREADS if threads is None else int(threads)
    if rows not in (4, 8):
        raise ValueError(f"rows={rows}: 4 or 8")
    if threads not in (256, 512, 1024):
        raise ValueError(f"threads={threads}: 256, 512 or 1024")
    need = -(-max(n_pad, 1) // (rows * threads))
    return rows, threads, max(1, min(need, sms * (2048 // threads)))


def _radix_shape_ok(l_eff: int, n_bins: int) -> bool:
    return (l_eff <= RADIX_MAX_WINDOW and n_bins % RADIX_NH == 0
            and n_bins // RADIX_NH >= 8)


def _radix_applicable(L: int, n_bins: int, half: bool) -> bool:
    return _radix_shape_ok(hist_layout(L, half)[0], n_bins)


def _fused_applicable(L_h: int, n_bins: int, c_pack: int) -> bool:
    l_eff = (L_h + 1) // 2
    return (l_eff <= FUSE_MAX_WINDOW
            and c_pack * l_eff * S_STATS * n_bins * 4 <= _FUSE_VMEM_OUT)


# ===========================================================================
# Plain PyTorch versions
def sbh_route_plain(codes, heap, tbl, route_f, valtab=None, F=None, *, base,
                    L, eta=0.0, emit_f=False):
    """Tensor-gather route (hist_pallas.sbh_route_xla). Returns
    (newheap, newF); newF is None when emit_f is False, as from the
    kernel."""
    leaf = heap - base
    active = (leaf >= 0) & (leaf < L)
    leaf_c = torch.where(active, leaf, torch.zeros_like(leaf)).long()
    col = tbl[0, leaf_c].to(torch.int64).clamp(0, codes.shape[0] - 1)
    did = (tbl[1, leaf_c] > 0.5) & active
    code = torch.gather(codes, 0, col[None, :])[0].long()
    n_bins = route_f.shape[1]
    go = route_f.reshape(-1)[leaf_c * n_bins + code] > 0.5
    newheap = torch.where(did, 2 * heap + 1 + go.to(heap.dtype), heap)
    if not emit_f:
        return newheap, None
    return newheap, F + eta * valtab[0, newheap.long()]


def _hist_slots(heap, *, base, L, half, L_pad):
    """Slot of every row in [0, L_pad), or L_pad for rows outside."""
    leaf = heap.long() - base
    ok = (leaf >= 0) & (leaf < L)
    if half:
        ok = ok & ((leaf & 1) == 0)
        leaf = leaf >> 1
    return torch.where(ok, leaf, torch.full_like(leaf, L_pad))


def sbh_hist_plain(codes, heap, stats, *, base, L, n_bins, half=False):
    """index_add_ over the flattened (slot, bin) index, one column at a
    time (hist_pallas.sbh_hist_xla). Stat row 3 stays zero. Sums in the
    stats' dtype: f32, f64, or int32 for the int8-quantized stats."""
    c_pad, n_pad = codes.shape
    _, _, _, L_pad = hist_layout(L, half)
    slot = _hist_slots(heap, base=base, L=L, half=half, L_pad=L_pad)
    src = stats[:3].t()
    out = torch.zeros((L_pad, c_pad, S_STATS, n_bins), dtype=stats.dtype,
                      device=stats.device)
    for c in range(c_pad):
        acc = torch.zeros(((L_pad + 1) * n_bins, 3), dtype=stats.dtype,
                          device=stats.device)
        acc.index_add_(0, slot * n_bins + codes[c].long(), src)
        out[:, c, :3] = acc.view(L_pad + 1, n_bins, 3)[:L_pad] \
            .permute(0, 2, 1)
    return out


def sbh_hist_plain_fixed(codes, heap, stats, *, base, L, n_bins, half=False,
                         int8=False, scale=None):
    """The histogram kernels' own function, the wrappers' plain version on
    the CPU: int8 stats sum exactly in int32; f32 stats go to int64 fixed
    point at `scale` (hist_scale of the stats when None), each value
    rounded once to the nearest integer (ties to even) as the kernels
    round it, a NaN or +-inf stat to the f32 side buffer. Returns what the
    kernel wrapper returns: the accumulators, through the thread's level
    reducer, as the f32 (or int32) histogram, (L_pad, C_pad, 4, n_bins).
    `sbh_hist_plain`, which sums in the stats' own dtype, is the reference
    the kernels are held against."""
    if int8:
        return _level_result(sbh_hist_plain(codes, heap, stats, base=base,
                                            L=L, n_bins=n_bins, half=half),
                             None, None)
    if scale is None:
        scale = hist_scale(stats)
    c_pad, n_pad = codes.shape
    _, _, _, L_pad = hist_layout(L, half)
    slot = _hist_slots(heap, base=base, L=L, half=half, L_pad=L_pad)
    x = stats[:3].t()
    fin = torch.isfinite(x)
    q = torch.where(fin, torch.round(x.double() * scale[None, :]),
                    torch.zeros((), dtype=torch.float64,
                                device=x.device)).to(torch.int64)
    any_nf = not bool(fin.all())
    nf = torch.where(fin, torch.zeros_like(x), x)
    shape = (L_pad, c_pad, S_STATS, n_bins)
    acc = torch.zeros(shape, dtype=torch.int64, device=stats.device)
    side = torch.zeros(shape, dtype=torch.float32, device=stats.device)
    for c in range(c_pad):
        idx = slot * n_bins + codes[c].long()
        a = torch.zeros(((L_pad + 1) * n_bins, 3), dtype=torch.int64,
                        device=stats.device).index_add_(0, idx, q)
        acc[:, c, :3] = a.view(L_pad + 1, n_bins, 3)[:L_pad].permute(0, 2, 1)
        if any_nf:
            s = torch.zeros(((L_pad + 1) * n_bins, 3), dtype=torch.float32,
                            device=stats.device).index_add_(0, idx, nf)
            side[:, c, :3] = s.view(L_pad + 1, n_bins,
                                    3)[:L_pad].permute(0, 2, 1)
    return _level_result(acc, side, scale)


def sbh_route_hist_plain(codes, heap, tbl, route_f, stats, *, base_r, L_r,
                         base_h, L_h, n_bins):
    """The sequential pair the fused kernel replaces: route, then the half
    histogram over the new heap."""
    newheap, _ = sbh_route_plain(codes, heap, tbl, route_f, base=base_r,
                                 L=L_r)
    return newheap, sbh_hist_plain(codes, newheap, stats, base=base_h, L=L_h,
                                   n_bins=n_bins, half=True)


# ===========================================================================
# CUDA wrappers
def _lib():
    lib = _build.load("hist")
    if not getattr(lib, "_h2o3_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.h2o3_route.argtypes = [vp] * 8 + [i64, i32, i32, i32, i32, i32,
                                              ctypes.c_float] + [i32] * 4 \
            + [vp]
        lib.h2o3_route.restype = i32
        lib.h2o3_hist.argtypes = [vp] * 6 + [i64] + [i32] * 8 + [i64, vp]
        lib.h2o3_hist.restype = i32
        lib.h2o3_hist_i8.argtypes = [vp] * 5 + [i64] + [i32] * 13 + [i64,
                                                                    vp]
        lib.h2o3_hist_i8.restype = i32
        lib.h2o3_radix.argtypes = [vp] * 6 + [i64] + [i32] * 10 + [i64, i32,
                                                                   vp]
        lib.h2o3_radix.restype = i32
        lib.h2o3_fused.argtypes = [vp] * 9 + [i64] + [i32] * 11 + [i64, i32,
                                                                   vp]
        lib.h2o3_fused.restype = i32
        lib._h2o3_typed = True
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _device_kind(t):
    if t.device.type == "cpu":
        return "cpu"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no route/hist implementation for device {t.device}")


def _check_i8_rows(n_pad: int):
    """The int32 sums of |stat| <= 127 stay exact only up to I8_MAX_ROWS
    rows; raise past it rather than wrap."""
    if n_pad > I8_MAX_ROWS:
        raise ValueError(f"int8 histogram over {n_pad} rows: 127 * rows "
                         f"overflows int32 past {I8_MAX_ROWS} rows")


def _check_hist_inputs(codes, heap, stats, n_bins, int8):
    """Validate the inputs every histogram kernel takes; returns
    (device, c_pad, n_pad)."""
    dev = codes.device
    c_pad, n_pad = codes.shape
    _check("codes", codes, torch.uint8, (c_pad, n_pad), dev)
    _check("heap", heap, torch.int32, (n_pad,), dev)
    _check("stats", stats, torch.int32 if int8 else torch.float32,
           (S_STATS, n_pad), dev)
    if n_pad % _HIST_ROW_ALIGN:
        raise ValueError(f"n_pad={n_pad} is not a multiple of "
                         f"{_HIST_ROW_ALIGN}")
    if not 0 < n_bins <= 256:
        raise ValueError(f"n_bins={n_bins} outside (0, 256]")
    return dev, c_pad, n_pad


def _check_tables(tbl, route_f, n_bins, L, dev):
    lp = route_f.shape[0]
    _check("tbl", tbl, torch.float32, (8, lp), dev)
    _check("route_f", route_f, torch.float32, (lp, n_bins), dev)
    if not 0 < L <= lp:
        raise ValueError(f"L={L} outside the table width {lp}")
    return lp


def _level_out(L_pad, c_pad, n_bins, int8, stats, scale, dev):
    """Zeroed accumulators of a histogram launch and its scale:
    (int32 sums, None, None) for int stats; for f32 stats the int64
    fixed-point sums, the f32 side buffer of the non-finite stats and the
    f64 (3,) scale (hist_scale of the stats when `scale` is None)."""
    shape = (L_pad, c_pad, S_STATS, n_bins)
    if int8:
        return torch.zeros(shape, dtype=torch.int32, device=dev), None, None
    if scale is None:
        scale = hist_scale(stats)
    _check("scale", scale, torch.float64, (3,), dev)
    return (torch.zeros(shape, dtype=torch.int64, device=dev),
            torch.zeros(shape, dtype=torch.float32, device=dev), scale)


def _level_result(acc, side, scale):
    """The f32 histogram of a histogram launch: the fixed-point sums
    over their scale in f64, cast once; a bin that a NaN or +-inf stat
    reached takes the side buffer's sum there, as an f64 sum would. The
    thread's level reducer, when set, sees the accumulators first."""
    red = _reducer()
    if red is not None:
        acc, side = red(acc, side)
    if side is None:
        return acc
    inv = torch.cat([scale.reciprocal(), scale.new_ones(1)])
    out = (acc.to(torch.float64) * inv.view(1, 1, S_STATS, 1)) \
        .to(torch.float32)
    return torch.where(side != 0, side, out)


def _ptr_or_null(t):
    return ctypes.c_void_p(0) if t is None else _ptr(t)


def sbh_route(codes, heap, tbl, route_f, valtab=None, F=None, *, base, L,
              eta=0.0, emit_f=False, rows=None, threads=None):
    """Route rows of leaves [base, base+L) by their splits.

    codes uint8 (C_pad, n_pad); heap int32 (n_pad,); tbl f32 (8, Lp) with
    row 0 = split column and row 1 = did-split; route_f f32 (Lp, n_bins)
    with 1.0 = goes right (numeric thresholds, categorical sets and the NA
    direction alike). With emit_f: valtab f32 (8, nodes_p) and F f32
    (n_pad,). Returns (newheap, newF), newF is None without emit_f.
    `rows` and `threads` choose the non-terminal kernel's launch layout
    (route_grid), never the result; the plain version and the emit_f
    kernel take neither."""
    if emit_f and (rows is not None or threads is not None):
        raise ValueError("rows and threads choose the non-terminal route's "
                         "layout; emit_f takes neither")
    route_grid(heap.shape[0], rows, threads)    # raises on a bad layout
    if _device_kind(codes) == "cpu":
        return sbh_route_plain(codes, heap, tbl, route_f, valtab, F,
                               base=base, L=L, eta=eta, emit_f=emit_f)
    dev = codes.device
    c_pad, n_pad = codes.shape
    n_bins = route_f.shape[1]
    _check("codes", codes, torch.uint8, (c_pad, n_pad), dev)
    _check("heap", heap, torch.int32, (n_pad,), dev)
    lp = _check_tables(tbl, route_f, n_bins, L, dev)
    newheap = torch.empty_like(heap)
    if emit_f:
        if valtab is None or F is None:
            raise ValueError("emit_f needs valtab and F")
        _check("valtab", valtab, torch.float32, (8, valtab.shape[1]), dev)
        _check("F", F, torch.float32, (n_pad,), dev)
        if 2 * (base + L) + 1 > valtab.shape[1]:
            raise ValueError("valtab narrower than the children of the level")
        newF = torch.empty_like(F)
        vt, fi, fo = _ptr(valtab), _ptr(F), _ptr(newF)
        nr = nt = nb = 0
    else:
        newF = None
        vt = fi = fo = ctypes.c_void_p(0)
        nr, nt, nb = route_grid(n_pad, rows, threads, _sm_count(dev))
    rc = _lib().h2o3_route(_ptr(codes), _ptr(heap), _ptr(tbl), _ptr(route_f),
                           vt, fi, _ptr(newheap), fo, n_pad, c_pad, lp,
                           n_bins, base, L, float(eta), int(bool(emit_f)),
                           nr, nt, nb, _stream(dev))
    _raise_on(rc, "route")
    LAUNCHES["route_f" if emit_f else "route"] += 1
    return newheap, newF


def hist_grid(l_eff: int, n_bins: int, acc_bytes: int = 8,
              budget: int = _SMEM_BUDGET):
    """(win, n_windows, rows_per_block) of one histogram launch: the widest
    leaf window that fits `budget` bytes of shared memory at `acc_bytes`
    per accumulator (8 for f64 and fixed point, 4 for int32), and a row
    chunk long enough that the per-block flush stays small next to the row
    work."""
    win = max(1, min(l_eff, budget // (3 * acc_bytes * n_bins)))
    n_windows = -(-l_eff // win)
    rows = max(16384, 8 * win * 3 * n_bins)
    rows = -(-rows // 1024) * 1024
    return win, n_windows, rows


def radix_grid(l_eff: int, n_bins: int, c_pad: int, int8: bool,
               group=None, threads=None, n_pad: int = 0, sms: int = _SMS):
    """(win, group, ncopy, threads, rows_per_block) of one shallow-window
    launch. A block takes `group` columns (one of RADIX_GROUPS[int8]; by
    default the widest that leaves room for RADIX_MIN_COPIES copies of
    their windows) and keeps `ncopy` private copies of each column's whole
    window (l_eff <= 2 slots), one per warp where SMEM_MAX allows. The row
    chunks are sized so that the grid over n_pad rows fills whole waves of
    `sms` SMs (at least 4 rows per thread)."""
    acc = 4 if int8 else 8
    win = max(1, l_eff)
    threads = RADIX_THREADS if threads is None else int(threads)
    if threads not in (512, 1024):
        raise ValueError(f"threads={threads}: 512 or 1024")
    slot_bytes = win * 3 * acc * n_bins           # one column's window
    groups = RADIX_GROUPS[bool(int8)]
    if group is None:
        group = min(groups[-1], _pow2_floor(max(1, min(
            c_pad, SMEM_MAX // (RADIX_MIN_COPIES * slot_bytes)))))
    elif group not in groups or group > c_pad:
        raise ValueError(f"group={group}: one of {groups}, at most {c_pad}")
    ncopy = min(threads // 32, SMEM_MAX // (group * slot_bytes))
    if ncopy < 1:
        raise ValueError(f"group={group} of {win}-slot windows exceeds "
                         f"{SMEM_MAX} bytes of shared memory")
    rows = _wave_rows(n_pad, -(-c_pad // group), ncopy * group * slot_bytes,
                     threads, sms)
    return win, group, ncopy, threads, rows


def _wave_rows(n_pad: int, col_blocks: int, smem: int, threads: int,
              sms: int = _SMS) -> int:
    """Rows per block of a grid of col_blocks x row chunks that fills whole
    waves of `sms` SMs, each holding as many blocks of `smem` bytes and
    `threads` threads as it can (up to 2048 threads): each block then
    zeroes and flushes its shared windows once per wave. At least one
    4-row step per thread."""
    per_sm = max(1, min(2048 // threads, _SMEM_SM // (smem + _BLOCK_RESERVED)))
    slots = sms * per_sm
    chunks = slots // math.gcd(slots, col_blocks)
    rows = -(-n_pad // chunks)
    return max(4 * threads, -(-rows // 4) * 4)


def sbh_hist_dense(codes, heap, stats, *, base, L, n_bins, half=False,
                   int8=False, scale=None, group=None, win=None,
                   threads=None, spad=None, waves=None):
    """The dense histogram kernel (every window width). hist[l, c, s, b] =
    sum of stats[s, r] over rows with heap == base + l (half: heap ==
    base + 2l) and codes[c, r] == b, for s in 0..2; row 3 stays zero.
    codes uint8 (C_pad, n_pad); heap int32 (n_pad,); stats f32 (4, n_pad),
    or with int8 int32 in [-127, 127] (the kernel, like the TPU kernel,
    sums their int8 casts). `scale`: the f32 form's fixed-point scale,
    hist_scale(stats) (computed here when None). `group`: columns per
    block (level_grid, or with int8 dense_i8_grid); `win`, `threads`,
    `spad` and `waves` choose the int8 form's launch layout
    (dense_i8_grid). None of them changes the result. Returns (L_pad,
    C_pad, 4, n_bins), f32 or int32. The plain version takes none of
    them."""
    if not int8 and any(v is not None for v in (win, threads, spad, waves)):
        raise ValueError("win, threads, spad and waves choose the int8 "
                         "form's layout")
    l_eff, _, _, L_pad = hist_layout(L, half)
    layout = dict(group=group, win=win, threads=threads, spad=spad,
                  waves=waves)
    if int8:
        _check_i8_rows(codes.shape[1])
        # a layout the kernel cannot take raises on every device
        dense_i8_grid(min(l_eff, I8_BAND), n_bins, codes.shape[0], **layout)
    if _device_kind(codes) == "cpu":
        return sbh_hist_plain_fixed(codes, heap, stats, base=base, L=L,
                                    n_bins=n_bins, half=half, int8=int8,
                                    scale=scale)
    dev, c_pad, n_pad = _check_hist_inputs(codes, heap, stats, n_bins, int8)
    acc, side, scale = _level_out(L_pad, c_pad, n_bins, int8, stats, scale,
                                  dev)
    if int8:
        _hist_dense_i8(codes, heap, stats, acc, base=base, L=L, half=half,
                       n_bins=n_bins, l_eff=l_eff, layout=layout)
    else:
        win, n_windows, g, rows = level_grid(l_eff, n_bins, c_pad, False,
                                             group)
        rc = _lib().h2o3_hist(_ptr(codes), _ptr(heap), _ptr(stats),
                              _ptr(scale), _ptr(acc), _ptr(side), n_pad,
                              c_pad, n_bins, base, L, int(bool(half)), win,
                              n_windows, g, rows, _stream(dev))
        _raise_on(rc, "hist")
    LAUNCHES["hist_i8" if int8 else "hist"] += 1
    return _level_result(acc, side, scale)


def _hist_dense_i8(codes, heap, stats, acc, *, base, L, half, n_bins, l_eff,
                   layout):
    """Launch the int8 dense kernel into acc, one band of at most I8_BAND
    slots at a time (the pack launch, then the histogram's; one band up
    to 256 slots, which covers every level of a depth-10 tree)."""
    dev = codes.device
    c_pad, n_pad = codes.shape
    sms = _sm_count(dev)
    packed = torch.empty(n_pad, dtype=torch.int32, device=dev)
    pack_blocks = max(1, min(-(-n_pad // (4 * _PACK_THREADS)),
                             sms * (2048 // _PACK_THREADS)))
    for b0 in range(0, l_eff, I8_BAND):
        nband = min(I8_BAND, l_eff - b0)
        win, n_windows, g, nt, spad, rows = dense_i8_grid(
            nband, n_bins, c_pad, n_pad=n_pad, sms=sms, **layout)
        rc = _lib().h2o3_hist_i8(
            _ptr(codes), _ptr(heap), _ptr(stats), _ptr(packed), _ptr(acc),
            n_pad, c_pad, n_bins, base, L, int(bool(half)), b0, nband, win,
            n_windows, g, spad, nt, pack_blocks, rows, _stream(dev))
        _raise_on(rc, "hist_i8")


def sbh_hist_radix(codes, heap, stats, *, base, L, n_bins, half=False,
                   int8=False, scale=None, group=None, threads=None,
                   agg=None):
    """The shallow-window histogram kernel (hist_pallas.sbh_hist_radix):
    the same function as sbh_hist_dense, for effective windows of at most
    RADIX_MAX_WINDOW leaves. Returns exactly (l_eff, C_pad, 4, n_bins), f32
    or int32. `scale` as in sbh_hist_dense; `group`, `threads` (radix_grid)
    and `agg` (warp aggregation, default RADIX_AGG) choose the launch
    layout, never the result. The plain version takes none of them."""
    l_eff = hist_layout(L, half)[0]
    if not _radix_shape_ok(l_eff, n_bins):
        raise ValueError(f"radix histogram needs a window <= "
                         f"{RADIX_MAX_WINDOW} and n_bins a multiple of "
                         f"{RADIX_NH} >= {8 * RADIX_NH}: l_eff={l_eff}, "
                         f"n_bins={n_bins}")
    if int8:
        _check_i8_rows(codes.shape[1])
    if _device_kind(codes) == "cpu":
        return sbh_hist_plain_fixed(codes, heap, stats, base=base, L=L,
                                    n_bins=n_bins, half=half, int8=int8,
                                    scale=scale)
    dev, c_pad, n_pad = _check_hist_inputs(codes, heap, stats, n_bins, int8)
    acc, side, scale = _level_out(l_eff, c_pad, n_bins, int8, stats, scale,
                                  dev)
    win, g, ncopy, nt, rows = radix_grid(
        l_eff, n_bins, c_pad, int8, group, threads, n_pad, _sm_count(dev))
    rc = _lib().h2o3_radix(_ptr(codes), _ptr(heap), _ptr(stats),
                           _ptr_or_null(scale), _ptr(acc), _ptr_or_null(side),
                           n_pad, c_pad, n_bins, base, L, int(bool(half)),
                           win, g, ncopy, nt,
                           int(RADIX_AGG if agg is None else bool(agg)), rows,
                           int(bool(int8)), _stream(dev))
    _raise_on(rc, "radix")
    LAUNCHES["radix"] += 1
    return _level_result(acc, side, scale)


def sbh_route_hist_fused(codes, heap, tbl, route_f, stats, *, base_r, L_r,
                         base_h, L_h, n_bins, int8=False, scale=None,
                         group=None, threads=None):
    """The level-fused kernel (hist_pallas.sbh_route_hist_fused_pallas):
    route the splits of leaves [base_r, base_r+L_r), then the half
    (left-children) histogram of leaves [base_h, base_h+L_h) over the
    updated heap, in one pass. `scale` as in sbh_hist_dense; `group`
    (level_grid) and `threads` (512 or 1024, default FUSED_THREADS) choose
    the launch layout, never the result.
    Returns (newheap int32 (n_pad,), hist (l_eff, C_pad, 4, n_bins) f32,
    or int32 with int8)."""
    l_eff = (L_h + 1) // 2
    if l_eff > FUSE_MAX_WINDOW:
        raise ValueError(f"fused level needs L_h <= {2 * FUSE_MAX_WINDOW}, "
                         f"got {L_h}")
    if route_f.shape[1] != n_bins:
        raise ValueError(f"route_f has {route_f.shape[1]} bins, expected "
                         f"{n_bins}")
    if int8:
        _check_i8_rows(codes.shape[1])
    if _device_kind(codes) == "cpu":
        newheap, _ = sbh_route_plain(codes, heap, tbl, route_f, base=base_r,
                                     L=L_r)
        return newheap, sbh_hist_plain_fixed(
            codes, newheap, stats, base=base_h, L=L_h, n_bins=n_bins,
            half=True, int8=int8, scale=scale)
    dev, c_pad, n_pad = _check_hist_inputs(codes, heap, stats, n_bins, int8)
    lp = _check_tables(tbl, route_f, n_bins, L_r, dev)
    newheap = torch.empty_like(heap)
    acc, side, scale = _level_out(l_eff, c_pad, n_bins, int8, stats, scale,
                                  dev)
    win, n_windows, g, rows = level_grid(l_eff, n_bins, c_pad, int8, group)
    nt = FUSED_THREADS if threads is None else int(threads)
    if nt not in (512, 1024):
        raise ValueError(f"threads={threads}: 512 or 1024")
    rc = _lib().h2o3_fused(_ptr(codes), _ptr(heap), _ptr(tbl), _ptr(route_f),
                           _ptr(stats), _ptr_or_null(scale), _ptr(newheap),
                           _ptr(acc), _ptr_or_null(side), n_pad, c_pad, lp,
                           n_bins, base_r, L_r, base_h, L_h, win, n_windows,
                           g, nt, rows, int(bool(int8)), _stream(dev))
    _raise_on(rc, "fused")
    LAUNCHES["fused"] += 1
    return newheap, _level_result(acc, side, scale)


# ===========================================================================
# Dispatch (hist_pallas.py sbh_hist, sbh_hist_i8, sbh_route_hist)
def sbh_hist(codes, heap, stats, *, base, L, n_bins, half=False,
             radix=None, scale=None):
    """f32 histogram. `radix`: None (auto) or True take the shallow-window
    kernel wherever the window qualifies, False never. `scale`: the
    kernels' fixed-point scale (hist_scale), computed per launch when
    None."""
    if radix is not False and _radix_applicable(L, n_bins, half):
        return sbh_hist_radix(codes, heap, stats, base=base, L=L,
                              n_bins=n_bins, half=half, scale=scale)
    return sbh_hist_dense(codes, heap, stats, base=base, L=L, n_bins=n_bins,
                          half=half, scale=scale)


def sbh_hist_i8(codes, heap, stats_i8, *, base, L, n_bins, half=False,
                radix=None):
    """int8-stats histogram: int32 stats in [-127, 127], exact int32 sums
    (the same function as sbh_hist over integer stats). `radix` as in
    sbh_hist."""
    if radix is not False and _radix_applicable(L, n_bins, half):
        return sbh_hist_radix(codes, heap, stats_i8, base=base, L=L,
                              n_bins=n_bins, half=half, int8=True)
    return sbh_hist_dense(codes, heap, stats_i8, base=base, L=L,
                          n_bins=n_bins, half=half, int8=True)


def sbh_route_hist(codes, heap, tbl, route_f, stats, *, base_r, L_r, base_h,
                   L_h, n_bins, int8=False, fused=None, radix=None,
                   scale=None):
    """One level pass: route the previous level's splits, then the new
    level's half (left-children) histogram over the updated heap. `fused`:
    None (auto) or True take the fused kernel wherever the level qualifies,
    False always the sequential pair (route, then sbh_hist / sbh_hist_i8
    with `radix`). Unlike the JAX package's, it takes no `any_cat` or
    `na_code`: route_f encodes numeric thresholds, categorical sets and the
    NA direction alike. `scale`: the f32 kernels' fixed-point scale
    (hist_scale of the stats), computed per launch when None. Returns
    (newheap, hist)."""
    if int8:
        _check_i8_rows(codes.shape[1])
    if fused is not False and _fused_applicable(
            L_h, n_bins, PACK * packed_words(codes.shape[0])):
        return sbh_route_hist_fused(codes, heap, tbl, route_f, stats,
                                    base_r=base_r, L_r=L_r, base_h=base_h,
                                    L_h=L_h, n_bins=n_bins, int8=int8,
                                    scale=scale)
    newheap, _ = sbh_route(codes, heap, tbl, route_f, base=base_r, L=L_r)
    kw = dict(base=base_h, L=L_h, n_bins=n_bins, half=True, radix=radix)
    if int8:
        return newheap, sbh_hist_i8(codes, newheap, stats, **kw)
    return newheap, sbh_hist(codes, newheap, stats, scale=scale, **kw)
