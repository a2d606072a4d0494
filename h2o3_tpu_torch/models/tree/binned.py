"""Binned tree engine of the port (h2o3_tpu/models/tree/binned.py).

Features are quantized once into a uint8 code plane (C_pad, n_pad) against
global quantile edges; each tree grows level by level on that plane. Level
0 takes the root's histogram (ops.hist_cuda sbh_hist, the shallow-window
kernel by default). Every later level is one `sbh_route_hist` pass: route
the rows by the previous level's splits and accumulate the left children's
histograms over the new heap (the fused kernel up to 16 left children,
the route and dense histogram pair beyond), then derive the right children
by sibling subtraction. Each level ends with the split search of every leaf
(find_splits_binned). The terminal pass routes the last level and adds
eta * leaf value to each row's margin.

The grower's flags mean what they mean in the JAX package: `int8_stats`
quantizes the stats to int8 per tree and sums the histograms exactly in
int32 (off unless asked for); `use_radix_shallow` and `fused_level` are on
unless False, which forces the dense histogram and the sequential pair.
The flags choose kernels, never the function: every combination grows
the same tree.

Three trainers grow on it, as in the JAX package: `gbm_chunk_trainer`
(one tree a step), `gbm_multi_chunk_trainer` (K class trees an iteration)
and `drf_chunk_trainer` (bagged trees with out-of-bag sums).

Sharded growth (models/tree/binned.py:385-434 of the JAX package): in a
cloud of several ranks (parallel/mesh) each rank grows on the code plane
of its own row block (`RowBlock`) and every global quantity is reduced
over the world so that the trees are the one-process trees bit for bit:
the f32 kernels' fixed-point scale is the scale of the global stats (an
all-reduce MAX of each stat row's largest magnitude, over the padded
global row count), the int8 quantization's absmax likewise; each level's
histogram is summed over the world in ONE all-reduce of the kernels'
exact accumulators (int64 fixed point, or int32 with int8) before the
sibling subtraction (`hist_cuda.level_reduce`; the buffer carries one
more element, the count of ranks whose side buffer of non-finite stats
holds a sum, and only when it is not 0 does a second all-reduce sum the
side buffers); and the trainers' per-row draws are drawn at the global
padded length and sliced to the block, so the generator's stream is the
one process's. The histograms of one process are the kernels' exact
function on every device (on the CPU through `sbh_hist_plain_fixed`), so
the one-process trees are the reference the world's are equal to.

Differences from the JAX package: its `lax.scan` over trees and classes
is a Python loop, the random draws come from a torch.Generator, and the
shards are processes (torch.distributed over gloo), not a device mesh.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.ops import hist_cuda as HC
from h2o3_tpu_torch.parallel import mrtask as MR

COL_TILE = 8
# Row granule of the code plane: n_pad is a multiple of it.
ROW_GRANULE = 512


# ===========================================================================
# Quantization (GlobalQuantilesCalc analog)
@dataclass
class BinSpec:
    """Per-column binning of a training frame."""
    edges: np.ndarray        # (C, b_val-1) f32 ascending cut points
    is_cat: np.ndarray       # (C,) bool, categorical (codes = level ids)
    b_val: int               # number of value bins; NA code == b_val
    n_bins: int              # padded bin count (multiple of 128)
    c_pad: int               # padded column count (multiple of COL_TILE)


def make_bins(X, is_cat, nbins: int, sample: int = 1 << 18) -> BinSpec:
    """Global quantile edges from a row sample. X: (n, C) f32 numpy with
    NaN NAs. Categorical columns are identity-binned (code == level id)."""
    n, C = X.shape
    b_val = int(min(nbins, 255))
    stride = max(1, n // sample)
    Xs = np.asarray(X[::stride][:sample], np.float32)
    edges = np.zeros((C, b_val - 1), np.float32)
    qs = np.linspace(0.0, 1.0, b_val + 1)[1:-1]
    for c in range(C):
        if is_cat[c]:
            edges[c] = np.arange(1, b_val, dtype=np.float32) - 0.5
            continue
        col = Xs[:, c]
        col = col[~np.isnan(col)]
        if col.size == 0:
            edges[c] = np.arange(1, b_val, dtype=np.float32)
            continue
        edges[c] = np.quantile(col, qs).astype(np.float32)
    nb = max(128, -(-(b_val + 1) // 128) * 128)
    cp = -(-C // COL_TILE) * COL_TILE
    return BinSpec(edges=edges, is_cat=np.asarray(is_cat, bool),
                   b_val=b_val, n_bins=nb, c_pad=cp)


def padded_rows(n: int) -> int:
    """Slots for n data rows + 1 dummy, a multiple of ROW_GRANULE."""
    return -(-(n + 1) // ROW_GRANULE) * ROW_GRANULE


def quantize(X: torch.Tensor, spec: BinSpec, n_pad: int | None = None):
    """(n, C) f32 -> (C_pad, n_pad) uint8 codes on X's device:
    code = number of edges < x (0..b_val-1), NA -> b_val; padding rows and
    columns are code 0."""
    n, C = X.shape
    n_pad = padded_rows(n) if n_pad is None else n_pad
    edges = torch.as_tensor(spec.edges, device=X.device)
    out = torch.zeros((spec.c_pad, n_pad), dtype=torch.uint8, device=X.device)
    for c in range(C):
        x = X[:, c].contiguous()
        code = torch.searchsorted(edges[c], x, right=False)
        code = torch.where(torch.isnan(x), torch.full_like(code, spec.b_val),
                           code)
        out[c, :n] = code.clamp(0, spec.b_val).to(torch.uint8)
    return out


def pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-pad a per-row vector to the quantize() row layout."""
    return torch.nn.functional.pad(x, (0, n_pad - x.shape[0]))


@dataclass
class RowBlock:
    """This rank's block of a frame's rows: global rows [lo, lo + n) of
    n_global (parallel/mesh.Cloud.row_block)."""
    lo: int
    n: int
    n_global: int

    @property
    def n_pad_global(self) -> int:
        return padded_rows(self.n_global)


def row_uniform(grower, like: torch.Tensor, generator=None):
    """U(0, 1) per row of the padded layout of `like`: drawn at the
    one-process length and sliced to this rank's block when the grower
    grows one (the generator's stream is the one process's)."""
    rb = grower.rows
    if rb is None:
        return torch.rand(like.shape, generator=generator,
                          device=like.device)
    u = torch.rand((rb.n_pad_global,), generator=generator,
                   device=like.device)
    out = torch.ones(like.shape, dtype=u.dtype, device=like.device)
    out[: rb.n] = u[rb.lo: rb.lo + rb.n]
    return out


def _level_buffer(acc, side):
    """A level's all-reduce buffer: the three summed stat rows of its
    accumulators (row 3 is zero), then 1 when this rank's side buffer
    holds a non-finite stat's sum."""
    nf = acc.new_zeros(1) if side is None else \
        side.ne(0).any().reshape(1).to(acc.dtype)
    return torch.cat([acc[:, :, :3].reshape(-1), nf])


def _world_level_sum(acc, side):
    """The level reducer of a world of several ranks: the exact
    accumulators summed over the world through the MRTask funnel, in ONE
    all-reduce; the side buffers in a second one only when some rank
    holds a non-finite stat."""
    buf = MR.map_reduce(_level_buffer, acc, side)
    L, c, _, b = acc.shape
    acc[:, :, :3] = buf[:-1].view(L, c, 3, b)
    if side is not None and int(buf[-1]):
        side = MR.map_reduce(torch.clone, side)
    return acc, side


# ===========================================================================
# Split search over binned histograms
def _se_gain(wl, gl, wr, gr_, wp, gp, lam):
    def score(w_, g_):
        return torch.where(w_ > 0, g_ * g_ / torch.clamp(w_ + lam, min=1e-30),
                           torch.zeros_like(g_))
    return score(wl, gl) + score(wr, gr_) - score(wp, gp)


def find_splits_binned(hist, is_cat, mono, cmask, lo, hi, *, b_val, min_rows,
                       msi, lam, use_hess, any_cat=True):
    """Best split of every leaf over (column, threshold or category subset,
    NA direction) — DTree.bestCol.

    hist (L, C_pad, 4, BP) with stat rows 0=w 1=wg 2=wh; is_cat (C_pad,)
    bool; mono (C_pad,) int in {-1, 0, 1}; cmask (L, C_pad) bool; lo, hi
    (L,) f32 monotone bounds. Returns per-leaf tensors: did, col, bin, nal,
    route (L, BP) bool, val_l, val_r, val_t, gain, w_t, w_l, wg_l, wh_l."""
    L, C, _, BP = hist.shape
    dev = hist.device
    w, wg, wh = hist[:, :, 0, :], hist[:, :, 1, :], hist[:, :, 2, :]
    den = wh if use_hess else w
    B = b_val
    v_w, na_w = w[..., :B], w[..., B]
    v_wg, na_wg = wg[..., :B], wg[..., B]
    v_wh, na_wh = wh[..., :B], wh[..., B]
    v_den, na_den = den[..., :B], den[..., B]

    # parent totals (identical for every real column; column 0 is real)
    w_t = v_w[:, 0].sum(-1) + na_w[:, 0]
    wg_t = v_wg[:, 0].sum(-1) + na_wg[:, 0]
    wh_t = v_wh[:, 0].sum(-1) + na_wh[:, 0]
    den_t = v_den[:, 0].sum(-1) + na_den[:, 0]
    val_t = wg_t / torch.clamp(wh_t, min=1e-30)
    ninf = torch.tensor(-float("inf"), device=dev)

    if any_cat:
        # categorical: bins ordered by mean gradient (empty bins last);
        # stable like jnp.argsort so ties keep bin order
        ratio = torch.where(v_den > 1e-30,
                            v_wg / torch.clamp(v_den, min=1e-30),
                            torch.full_like(v_wg, float("inf")))
        order = torch.argsort(ratio, dim=-1, stable=True)
        sc_w = torch.gather(v_w, -1, order)
        sc_wg = torch.gather(v_wg, -1, order)
        sc_den = torch.gather(v_den, -1, order)

    def eval_axis(aw, awg, aden):
        cl_w = torch.cumsum(aw, -1)[..., :-1]
        cl_wg = torch.cumsum(awg, -1)[..., :-1]
        cl_den = torch.cumsum(aden, -1)[..., :-1]
        m = mono[None, :, None]

        def gains(nal):
            lw = cl_w + na_w[..., None] if nal else cl_w
            lg = cl_wg + na_wg[..., None] if nal else cl_wg
            ld = cl_den + na_den[..., None] if nal else cl_den
            rw = w_t[:, None, None] - lw
            rg = wg_t[:, None, None] - lg
            rd = den_t[:, None, None] - ld
            g = _se_gain(ld, lg, rd, rg, den_t[:, None, None],
                         wg_t[:, None, None], lam)
            ok = (lw >= min_rows) & (rw >= min_rows)
            vl = lg / torch.clamp(ld, min=1e-30)
            vr = rg / torch.clamp(rd, min=1e-30)
            mok = (m == 0) | ((vr - vl) * m >= 0)
            return torch.where(ok & mok, g, ninf)

        g0, g1 = gains(False), gains(True)
        return torch.maximum(g0, g1), g1 > g0

    gn_num, nal_num = eval_axis(v_w, v_wg, v_den)
    if any_cat:
        gn_cat, nal_cat = eval_axis(sc_w, sc_wg, sc_den)
        catC = is_cat[None, :, None]
        gain_all = torch.where(catC, gn_cat, gn_num)
        nal_all = torch.where(catC, nal_cat, nal_num)
    else:
        gain_all, nal_all = gn_num, nal_num
    gain_all = torch.where(cmask[:, :, None], gain_all, ninf)

    flat = gain_all.reshape(L, C * (B - 1))
    best = torch.argmax(flat, dim=1)
    bgain = flat.gather(1, best[:, None])[:, 0]
    bcol = torch.div(best, B - 1, rounding_mode="floor")
    bbin = best % (B - 1)
    bnal = nal_all.reshape(L, C * (B - 1)).gather(1, best[:, None])[:, 0]
    did = torch.isfinite(bgain) & (bgain > max(msi, 0.0))

    # routing table: route[l, code] = goes right
    lid = torch.arange(L, device=dev)

    def takeL(a):                      # (L, C, X) -> (L, X) at bcol
        return a[lid, bcol]

    bin_ids = torch.arange(BP, device=dev)[None, :]
    num_right = bin_ids > bbin[:, None]
    if any_cat:
        rank_of_bin = torch.argsort(takeL(order), dim=-1, stable=True)
        rank_pad = torch.nn.functional.pad(rank_of_bin, (0, BP - B),
                                           value=BP)
        cat_right = rank_pad > bbin[:, None]
        route = torch.where(is_cat[bcol][:, None], cat_right, num_right)
    else:
        route = num_right
    route[:, B] = ~bnal                # NA code: by the chosen NA direction
    route = route & did[:, None]       # no split: every row stays

    # child values (Newton wg/wh), clamped to the monotone bounds
    goes_left = ~route[:, :B]
    na_pick = lambda a: torch.where(bnal, a[lid, bcol],   # noqa: E731
                                    torch.zeros_like(w_t))
    w_l = (takeL(v_w) * goes_left).sum(-1) + na_pick(na_w)
    g_l = (takeL(v_wg) * goes_left).sum(-1) + na_pick(na_wg)
    h_l = (takeL(v_wh) * goes_left).sum(-1) + na_pick(na_wh)
    val_l = g_l / torch.clamp(h_l, min=1e-30)
    g_r = wg_t - g_l
    h_r = wh_t - h_l
    val_r = g_r / torch.clamp(h_r, min=1e-30)
    val_l = torch.minimum(torch.maximum(val_l, lo), hi)
    val_r = torch.minimum(torch.maximum(val_r, lo), hi)
    val_tc = torch.minimum(torch.maximum(val_t, lo), hi)

    zero = torch.zeros_like(bgain)
    return dict(did=did, col=bcol.to(torch.int32), bin=bbin.to(torch.int32),
                nal=bnal, route=route,
                gain=torch.where(did, torch.clamp(bgain, min=0.0), zero),
                val_l=val_l, val_r=val_r, val_t=val_tc,
                w_t=w_t, w_l=w_l, wg_l=g_l, wh_l=h_l)


# ===========================================================================
class BinnedGrower:
    """Grows one tree level by level on the code plane; per-row state is
    one int32 heap id and rows are never reordered."""

    def __init__(self, spec: BinSpec, *, max_depth: int, min_rows: float,
                 min_split_improvement: float, reg_lambda: float = 0.0,
                 use_hess_denom: bool = False,
                 monotone: np.ndarray | None = None, device=None,
                 int8_stats: bool | None = None,
                 use_radix_shallow: bool | None = None,
                 fused_level: bool | None = None,
                 rows: RowBlock | None = None):
        self.int8 = False if int8_stats is None else bool(int8_stats)
        # sharded growth: this rank's row block
        self.rows = rows
        self.use_radix = None if use_radix_shallow in (None, True) else False
        self.fused = None if fused_level in (None, True) else False
        self.spec = spec
        self.D = int(max_depth)
        self.nodes = 2 ** (self.D + 1) - 1
        self.min_rows = float(min_rows)
        self.msi = float(min_split_improvement)
        self.lam = float(reg_lambda)
        self.use_hess = bool(use_hess_denom)
        self.device = torch.device(device or "cpu")
        mono = np.zeros(spec.c_pad, np.int32) if monotone is None else \
            np.asarray(monotone, np.int32)
        self.mono = torch.as_tensor(mono, device=self.device)
        self.is_cat_dev = torch.as_tensor(
            np.pad(spec.is_cat, (0, spec.c_pad - spec.is_cat.size)),
            device=self.device)

    def _scale(self, stats):
        """hist_scale of the stats; of the world's stats (an all-reduce
        MAX of each row's largest finite magnitude, over the global padded
        row count) when this rank grows one block."""
        if self.rows is None:
            return HC.hist_scale(stats)
        a = stats[:3].abs()
        m = torch.where(a < float("inf"), a, torch.zeros_like(a)).amax(dim=1)
        m = MR.shard_max(m)
        return HC.pow2_scale(m.to(torch.float64) * self.rows.n_pad_global)

    def layout(self, n: int) -> int:
        return padded_rows(n)

    def grow(self, codes, stats, F, **kw):
        """Grow ONE tree and apply its margin update (`_grow`), each level
        summed over the world when this grower grows one row block."""
        with HC.level_reduce(_world_level_sum) if self.rows is not None \
                else contextlib.nullcontext():
            return self._grow(codes, stats, F, **kw)

    def _grow(self, codes, stats, F, *, eta, clip_val, generator=None,
              mtries: int = 0, tree_mask=None):
        """Grow ONE tree and apply its margin update.

        codes uint8 (C_pad, n_pad); stats f32 (4, n_pad) rows w, w*grad,
        w*hess, 0; F f32 (n_pad,). Returns dict(col, bin, nal, route, val,
        cover, gains, F, heap). `generator` draws the per-level column
        subsets when 0 < mtries < number of columns."""
        spec, D, dev = self.spec, self.D, codes.device
        C = spec.c_pad
        n_pad = codes.shape[1]
        BP = spec.n_bins
        nodes = self.nodes
        big = 3e38
        nodes_p = -(-(nodes + 1) // 128) * 128
        heap = torch.zeros(n_pad, dtype=torch.int32, device=dev)
        colA = torch.full((nodes,), -1, dtype=torch.int32, device=dev)
        binA = torch.full((nodes,), -1, dtype=torch.int32, device=dev)
        nalA = torch.zeros(nodes, dtype=torch.bool, device=dev)
        routeA = torch.zeros((nodes, BP), dtype=torch.bool, device=dev)
        # one spare slot at index `nodes` takes the child writes of leaves
        # that did not split (the JAX `mode="drop"` scatter), cut off below
        valA = torch.zeros(nodes + 1, dtype=torch.float32, device=dev)
        coverA = torch.zeros(nodes + 1, dtype=torch.float32, device=dev)
        gains = torch.zeros(C + 1, dtype=torch.float32, device=dev)
        c_real = int(spec.is_cat.size)
        creal_mask = torch.arange(C, device=dev) < c_real
        lo = torch.full((1,), -big, dtype=torch.float32, device=dev)
        hi = torch.full((1,), big, dtype=torch.float32, device=dev)
        any_cat = bool(spec.is_cat.any())
        if self.int8:
            # per-tree, per-stat-row symmetric quantization; the stats are
            # fixed for the tree, so one pass serves every level (the
            # world's absmax in a cloud of several ranks)
            absmax = stats.abs().amax(dim=1, keepdim=True)
            if self.rows is not None:
                absmax = MR.shard_max(absmax)
            scale = 127.0 / absmax.clamp(min=1e-30)
            stats_in = torch.round(stats * scale).clamp(-127, 127) \
                .to(torch.int32)
            inv = absmax.clamp(min=1e-30)[:, 0] / 127.0
            hist_fn = HC.sbh_hist_i8
            hkw = {}
        else:
            stats_in = stats
            hist_fn = HC.sbh_hist
            # the f32 histogram kernels' fixed-point scale, once per tree
            # for the same reason (kept on the device); of the global
            # stats in a cloud of several ranks
            hkw = {"scale": self._scale(stats)}
        # hist_prev keeps the level's full histogram in its native dtype
        # (int32 with int8: the sibling subtraction stays exact)
        prev = hist_prev = did_prev = None
        for d in range(D):
            L = 1 << d
            base = L - 1
            if d == 0:
                hacc = hist_fn(codes, heap, stats_in, base=base, L=L,
                               n_bins=BP, radix=self.use_radix,
                               **hkw)[:L, :C]
            else:
                # one level pass: route the previous level, histogram the
                # LEFT children over the new heap; right = parent - left
                # (routing moves every row of a split leaf to a child)
                heap, left = HC.sbh_route_hist(
                    codes, heap, prev[0], prev[1], stats_in,
                    base_r=(L >> 1) - 1, L_r=L >> 1, base_h=base, L_h=L,
                    n_bins=BP, int8=self.int8, fused=self.fused,
                    radix=self.use_radix, **hkw)
                left = left[: L >> 1, :C]
                par = torch.where(did_prev[:, None, None, None], hist_prev,
                                  torch.zeros_like(hist_prev))
                hacc = torch.stack([left, par - left], dim=1) \
                    .reshape(L, *left.shape[1:])
            hist_prev = hacc
            # the int8 histogram is dequantized once per level
            hist = hacc.float() * inv[None, None, :, None] if self.int8 \
                else hacc

            if mtries and mtries < c_real:
                r = torch.rand((L, C), generator=generator, device=dev)
                r = torch.where(creal_mask[None], r, torch.full_like(r, 2.0))
                kth = torch.sort(r, dim=1).values[:, mtries - 1:mtries]
                cmask = r <= kth
            else:
                cmask = creal_mask[None].expand(L, C)
            if tree_mask is not None:
                cmask = cmask & tree_mask[None, :]

            s = find_splits_binned(
                hist, self.is_cat_dev, self.mono, cmask, lo, hi,
                b_val=spec.b_val, min_rows=self.min_rows, msi=self.msi,
                lam=self.lam, use_hess=self.use_hess, any_cat=any_cat)
            did = s["did"]
            did_prev = did
            tgt = base + torch.arange(L, device=dev)
            colA[tgt] = torch.where(did, s["col"], -1)
            binA[tgt] = torch.where(did, s["bin"], -1)
            nalA[tgt] = s["nal"]
            routeA[tgt] = s["route"]
            valA[tgt] = s["val_t"]
            coverA[tgt] = s["w_t"]
            spare = torch.full_like(tgt, nodes)
            kidL = torch.where(did, 2 * tgt + 1, spare)
            kidR = torch.where(did, 2 * tgt + 2, spare)
            valA[kidL] = s["val_l"]
            valA[kidR] = s["val_r"]
            coverA[kidL] = s["w_l"]
            coverA[kidR] = s["w_t"] - s["w_l"]
            gains.index_add_(0, torch.where(did, s["col"].long(),
                                            torch.full_like(tgt, C)),
                             s["gain"])

            # routing tables of this level for the next route pass
            Lp = max(8, L)
            tbl = torch.zeros((8, Lp), dtype=torch.float32, device=dev)
            tbl[0, :L] = s["col"].float()
            tbl[1, :L] = did.float()
            tbl[2, :L] = s["bin"].float()
            tbl[3, :L] = s["nal"].float()
            route_f = torch.zeros((Lp, BP), dtype=torch.float32, device=dev)
            route_f[:L] = s["route"].float()
            prev = (tbl, route_f)

            # monotone bounds for the children
            mc = self.mono[s["col"].long()]
            mid = 0.5 * (s["val_l"] + s["val_r"])
            lo_l = torch.where(mc < 0, torch.maximum(lo, mid), lo)
            hi_l = torch.where(mc > 0, torch.minimum(hi, mid), hi)
            lo_r = torch.where(mc > 0, torch.maximum(lo, mid), lo)
            hi_r = torch.where(mc < 0, torch.minimum(hi, mid), hi)
            lo = torch.stack([torch.where(did, lo_l, lo),
                              torch.where(did, lo_r, lo)], 1).reshape(2 * L)
            hi = torch.stack([torch.where(did, hi_l, hi),
                              torch.where(did, hi_r, hi)], 1).reshape(2 * L)

        # terminal pass: route the last level + the margin update
        L = 1 << D
        valA, coverA = valA[:nodes], coverA[:nodes]
        valt = valA.clamp(-clip_val, clip_val) if clip_val else valA
        valtab = torch.zeros((8, nodes_p), dtype=torch.float32, device=dev)
        valtab[0, :nodes] = valt
        heap, F = HC.sbh_route(codes, heap, prev[0], prev[1], valtab, F,
                               base=(L >> 1) - 1, L=L >> 1, eta=eta,
                               emit_f=True)
        return dict(col=colA, bin=binA, nal=nalA, route=routeA, val=valt,
                    cover=coverA, gains=gains[:C], F=F, heap=heap)


# ===========================================================================
def _grad_hess_binned(dist, F, y):
    """ComputePredAndRes on the padded margin vector (GBM.java:981)."""
    if dist == "gaussian":
        return y - F, torch.ones_like(F)
    if dist in ("bernoulli", "quasibinomial"):
        p = torch.sigmoid(F)
        return y - p, p * (1 - p)
    if dist == "poisson":
        mu = torch.exp(F.clamp(-30, 30))
        return y - mu, mu
    if dist == "gamma":
        mu = torch.exp(F.clamp(-30, 30))
        return y / mu - 1.0, y / mu
    if dist == "tweedie":
        mu = torch.exp(F.clamp(-30, 30))
        rmu = torch.sqrt(mu)
        return y / rmu - rmu, 0.5 * (y / rmu + rmu)
    if dist == "laplace":
        return torch.sign(y - F), torch.ones_like(F)
    raise NotImplementedError(f"binned engine distribution {dist}")


def pack_route(route, n_bins, b_val=None):
    """(nodes, BP) bool -> (nodes, BP//32) go-right bitset words, values of
    the JAX package's uint32 words held in int64 (torch's uint32 support is
    thin). With b_val, slots >= b_val-1 replicate slot b_val-1 so clipped
    high-cardinality level ids route like training's capped codes."""
    nodes = route.shape[0]
    r = route[:, :n_bins]
    if b_val is not None and b_val < n_bins:
        r = torch.cat([r[:, : b_val - 1],
                       r[:, b_val - 1: b_val].expand(nodes,
                                                     n_bins - b_val + 1)], 1)
    r = r.reshape(nodes, n_bins // 32, 32).to(torch.int64)
    shifts = torch.arange(32, device=route.device, dtype=torch.int64)
    return (r << shifts).sum(-1)


def _tree_col_mask(grower: BinnedGrower, generator, col_rate_tree: float):
    """Per-tree column subset (col_sample_rate_per_tree), or None."""
    if col_rate_tree >= 1.0:
        return None
    c_real = int(grower.spec.is_cat.size)
    C = grower.spec.c_pad
    k = max(1, int(round(col_rate_tree * c_real)))
    r = torch.rand((C,), generator=generator, device=grower.device)
    r = torch.where(torch.arange(C, device=grower.device) < c_real, r,
                    torch.full_like(r, 2.0))
    kth = torch.sort(r).values[k - 1]
    return r <= kth


def gbm_chunk_trainer(grower: BinnedGrower, n: int, *, dist: str, eta: float,
                      sample_rate: float, mtries: int, k_trees: int,
                      clip_val: float = 19.0, col_rate_tree: float = 1.0):
    """The K-tree training step: returns run(codes, y1, w1, F, generator)
    -> (F, trees), where trees = (col, bin, nal, catbit words, val, gains,
    cover), each stacked over the K trees. codes from `quantize`; y1, w1, F
    are (n_pad,) f32 with zeros beyond row n."""
    cv = 0.0 if dist == "gaussian" else clip_val

    def run(codes, y1, w1, F, generator=None):
        trees = []
        for _ in range(k_trees):
            g, h = _grad_hess_binned(dist, F, y1)
            if sample_rate < 1.0:
                u = row_uniform(grower, w1, generator)
                wt = w1 * (u < sample_rate)
            else:
                wt = w1
            stats = torch.stack([wt, wt * g, wt * h, torch.zeros_like(wt)])
            tmask = _tree_col_mask(grower, generator, col_rate_tree)
            out = grower.grow(codes, stats, F, eta=eta, clip_val=cv,
                              generator=generator, mtries=mtries,
                              tree_mask=tmask)
            F = out["F"]
            trees.append(_tree_parts(grower, out))
        return F, tuple(torch.stack(parts) for parts in zip(*trees))

    return run


# ===========================================================================
# Multinomial boosting: K class trees per iteration (SharedTree.java:548-561
# builds the K trees of an iteration as one layer), each grown through the
# same kernels as a single-output tree.
def gbm_multi_chunk_trainer(grower: BinnedGrower, n: int, *, n_classes: int,
                            eta: float, sample_rate: float, mtries: int,
                            k_iters: int, clip_val: float = 19.0,
                            col_rate_tree: float = 1.0):
    """The K-class step: returns run(codes, y1, w1, F, generator) -> (F,
    trees). F is (n_pad, K) f32 margins and y1 (n_pad,) class ids as f32;
    trees are stacked with leading dims (k_iters, K). Per iteration: one
    softmax, one row sample and one per-tree column mask shared by the K
    class trees; class k's tree grows on (w, w*res*(K-1)/K, w*|res|(1-|res|))
    with F = 0 and eta = 1, so the terminal route emits the leaf value of
    every row, which is the class's margin step."""
    K = int(n_classes)
    kscale = (K - 1) / K       # GammaPass multinomial leaf scale (GBM.java)

    def run(codes, y1, w1, F, generator=None):
        onehot = torch.nn.functional.one_hot(y1.long(), K).to(F.dtype)
        zero = torch.zeros_like(w1)
        iters = []
        for _ in range(k_iters):
            RK = onehot - torch.softmax(F, dim=1)           # residuals
            if sample_rate < 1.0:
                u = row_uniform(grower, w1, generator)
                wt = w1 * (u < sample_rate)
            else:
                wt = w1
            tmask = _tree_col_mask(grower, generator, col_rate_tree)
            trees, dF = [], []
            for k in range(K):
                res = RK[:, k].contiguous()
                absr = res.abs()
                stats = torch.stack([wt, wt * res * kscale,
                                     wt * (absr * (1.0 - absr)), zero])
                out = grower.grow(codes, stats, zero, eta=1.0,
                                  clip_val=clip_val, generator=generator,
                                  mtries=mtries, tree_mask=tmask)
                trees.append(_tree_parts(grower, out))
                dF.append(out["F"])
            F = F + eta * torch.stack(dF, dim=1)
            iters.append(tuple(torch.stack(p) for p in zip(*trees)))
        return F, tuple(torch.stack(p) for p in zip(*iters))

    return run


def _tree_parts(grower: BinnedGrower, out):
    """A grown tree as the trainers return it: (col, bin, nal, catbit
    words, val, gains, cover)."""
    return (out["col"], out["bin"], out["nal"],
            pack_route(out["route"], grower.spec.n_bins, grower.spec.b_val),
            out["val"], out["gains"], out["cover"])


# ===========================================================================
# DRF: independent trees, leaf = in-bag response mean, OOB accumulation
# (hex/tree/drf/DRF.java:78 doOOBScoring() = true, the reference default).
def draw_inbag(w1: torch.Tensor, sample_rate: float, generator=None):
    """One tree's in-bag rows: Bernoulli(sample_rate) per row, a bool
    tensor like w1 (the one draw of DRF's bagging, kept apart so that a
    test can hand in masks of its own)."""
    u = torch.rand(w1.shape, generator=generator, device=w1.device)
    return u < sample_rate


def drf_chunk_trainer(grower: BinnedGrower, n: int, *, sample_rate: float,
                      mtries: int, k_trees: int, col_rate_tree: float = 1.0):
    """The DRF step: returns run(codes, y1, w1, oob_sum, oob_cnt,
    generator) -> (oob_sum, oob_cnt, trees). Per tree: an in-bag mask
    (`draw_inbag`); stats (w, w*y, w) so that the Newton leaf value wg/wh
    is the in-bag mean response (the class frequency for a 0/1 response);
    grow() with F = 0, eta = 1 and no clipping emits each row's leaf value,
    which is added to (oob_sum, oob_cnt) on rows out of the bag with a
    positive weight."""

    def run(codes, y1, w1, oob_sum, oob_cnt, generator=None):
        zero = torch.zeros_like(w1)
        trees = []
        for _ in range(k_trees):
            # a row block draws at the world's length (row_uniform)
            inbag = draw_inbag(w1, sample_rate, generator) \
                if grower.rows is None else \
                row_uniform(grower, w1, generator) < sample_rate
            wt = w1 * inbag
            stats = torch.stack([wt, wt * y1, wt, zero])
            tmask = _tree_col_mask(grower, generator, col_rate_tree)
            out = grower.grow(codes, stats, zero, eta=1.0, clip_val=0.0,
                              generator=generator, mtries=mtries,
                              tree_mask=tmask)
            oob = (~inbag) & (w1 > 0)
            oob_sum = oob_sum + torch.where(oob, out["F"], zero)
            oob_cnt = oob_cnt + oob.to(oob_cnt.dtype)
            trees.append(_tree_parts(grower, out))
        return oob_sum, oob_cnt, tuple(torch.stack(p) for p in zip(*trees))

    return run
