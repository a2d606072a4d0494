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

Each wrapper runs the plain version for a tensor on the CPU, launches its
CUDA kernel for a tensor on a CUDA device, and raises for anything else.
There is no fallback from the kernel to the plain version. The TPU kernels'
4-codes-per-word packing (a Mosaic tiling workaround) is not used: the
kernels read the uint8 plane directly.
"""

from __future__ import annotations

import ctypes

import torch

from h2o3_tpu_torch.ops import _build

# Leaf-window width of one histogram pass (hist_pallas.GW): the output is
# (L_pad, C_pad, 4, n_bins) with L_pad = npass * gwe, gwe = min(l_eff, GW).
GW = 64
S_STATS = 4
# Leaf slots one CUDA block keeps in shared memory: win x 3 stats x n_bins
# f64 within this budget (96 KB = 16 slots at 256 bins).
_SMEM_BUDGET = 96 * 1024
_HIST_ROW_ALIGN = 4

# Kernel launches, counted where each wrapper launches its kernel (never
# on the plain path). Read and reset by chip_smoke.py and the card tests.
LAUNCHES = {"route": 0, "route_f": 0, "hist": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def hist_layout(L: int, half: bool):
    """(l_eff, gwe, npass, L_pad) of one histogram call."""
    l_eff = (L + 1) // 2 if half else L
    gwe = min(l_eff, GW)
    npass = max(1, -(-l_eff // gwe))
    return l_eff, gwe, npass, npass * gwe


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
    time (hist_pallas.sbh_hist_xla). Stat row 3 stays zero."""
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


# ===========================================================================
# CUDA wrappers
def _lib():
    lib = _build.load("hist")
    if not getattr(lib, "_h2o3_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.h2o3_route.argtypes = [vp] * 8 + [i64, i32, i32, i32, i32, i32,
                                              ctypes.c_float, i32, vp]
        lib.h2o3_route.restype = i32
        lib.h2o3_hist.argtypes = [vp] * 4 + [i64, i32, i32, i32, i32, i32,
                                             i32, i32, i64, vp]
        lib.h2o3_hist.restype = i32
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


def _device_kind(t):
    if t.device.type == "cpu":
        return "cpu"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no route/hist implementation for device {t.device}")


def sbh_route(codes, heap, tbl, route_f, valtab=None, F=None, *, base, L,
              eta=0.0, emit_f=False):
    """Route rows of leaves [base, base+L) by their splits.

    codes uint8 (C_pad, n_pad); heap int32 (n_pad,); tbl f32 (8, Lp) with
    row 0 = split column and row 1 = did-split; route_f f32 (Lp, n_bins)
    with 1.0 = goes right (numeric thresholds, categorical sets and the NA
    direction alike). With emit_f: valtab f32 (8, nodes_p) and F f32
    (n_pad,). Returns (newheap, newF), newF is None without emit_f."""
    if _device_kind(codes) == "cpu":
        return sbh_route_plain(codes, heap, tbl, route_f, valtab, F,
                               base=base, L=L, eta=eta, emit_f=emit_f)
    dev = codes.device
    c_pad, n_pad = codes.shape
    lp, n_bins = route_f.shape
    _check("codes", codes, torch.uint8, (c_pad, n_pad), dev)
    _check("heap", heap, torch.int32, (n_pad,), dev)
    _check("tbl", tbl, torch.float32, (8, lp), dev)
    _check("route_f", route_f, torch.float32, (lp, n_bins), dev)
    if not 0 < L <= lp:
        raise ValueError(f"L={L} outside the table width {lp}")
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
    else:
        newF = None
        vt = fi = fo = ctypes.c_void_p(0)
    rc = _lib().h2o3_route(_ptr(codes), _ptr(heap), _ptr(tbl), _ptr(route_f),
                           vt, fi, _ptr(newheap), fo, n_pad, c_pad, lp,
                           n_bins, base, L, float(eta), int(bool(emit_f)),
                           _stream(dev))
    _raise_on(rc, "route")
    LAUNCHES["route_f" if emit_f else "route"] += 1
    return newheap, newF


def hist_grid(l_eff: int, n_bins: int):
    """(win, n_windows, rows_per_block) of one histogram launch: the widest
    leaf window that fits the shared-memory budget, and a row chunk long
    enough that the per-block flush stays small next to the row work."""
    win = max(1, min(l_eff, _SMEM_BUDGET // (3 * 8 * n_bins)))
    n_windows = -(-l_eff // win)
    rows = max(16384, 8 * win * 3 * n_bins)
    rows = -(-rows // 1024) * 1024
    return win, n_windows, rows


def sbh_hist(codes, heap, stats, *, base, L, n_bins, half=False):
    """hist[l, c, s, b] = sum of stats[s, r] over rows with heap == base + l
    (half: heap == base + 2l) and codes[c, r] == b, for s in 0..2; row 3
    stays zero. codes uint8 (C_pad, n_pad); heap int32 (n_pad,); stats f32
    (4, n_pad). Returns f32 (L_pad, C_pad, 4, n_bins)."""
    if _device_kind(codes) == "cpu":
        return sbh_hist_plain(codes, heap, stats, base=base, L=L,
                              n_bins=n_bins, half=half)
    dev = codes.device
    c_pad, n_pad = codes.shape
    _check("codes", codes, torch.uint8, (c_pad, n_pad), dev)
    _check("heap", heap, torch.int32, (n_pad,), dev)
    _check("stats", stats, torch.float32, (S_STATS, n_pad), dev)
    if n_pad % _HIST_ROW_ALIGN:
        raise ValueError(f"n_pad={n_pad} is not a multiple of "
                         f"{_HIST_ROW_ALIGN}")
    if not 0 < n_bins <= 256:
        raise ValueError(f"n_bins={n_bins} outside (0, 256]")
    l_eff, _, _, L_pad = hist_layout(L, half)
    # the kernel sums in f64 (see hist.cu) and hands back the f32 cast
    acc = torch.zeros((L_pad, c_pad, S_STATS, n_bins), dtype=torch.float64,
                      device=dev)
    win, n_windows, rows = hist_grid(l_eff, n_bins)
    rc = _lib().h2o3_hist(_ptr(codes), _ptr(heap), _ptr(stats), _ptr(acc),
                          n_pad, c_pad, n_bins, base, L, int(bool(half)),
                          win, n_windows, rows, _stream(dev))
    _raise_on(rc, "hist")
    LAUNCHES["hist"] += 1
    return acc.to(torch.float32)
