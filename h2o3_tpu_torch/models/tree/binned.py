"""Binned tree engine of the port (h2o3_tpu/models/tree/binned.py).

Features are quantized once into a uint8 code plane (C_pad, n_pad) against
global quantile edges; each tree grows level by level on that plane. Per
level: route the rows by the previous level's splits (ops.hist_cuda
sbh_route), accumulate the left children's histograms (sbh_hist with
half=True), derive the right children by sibling subtraction, and search
the best split of every leaf (find_splits_binned). The terminal pass
routes the last level and adds eta * leaf value to each row's margin.

Differences from the JAX package: the K-tree `lax.scan` is a Python loop,
there is no mesh (the sharded psum path is a later slice), and the level
runs the sequential route-then-histogram pair only; the radix, fused and
int8 kernels are later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.ops import hist_cuda as HC

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
                 monotone: np.ndarray | None = None, device=None):
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

    def layout(self, n: int) -> int:
        return padded_rows(n)

    def grow(self, codes, stats, F, *, eta, clip_val, generator=None,
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
        prev = hist_prev = did_prev = None
        for d in range(D):
            L = 1 << d
            base = L - 1
            if d == 0:
                hacc = HC.sbh_hist(codes, heap, stats, base=base, L=L,
                                   n_bins=BP)[:L, :C]
            else:
                # route the previous level, then histogram the LEFT
                # children over the new heap; right = parent - left
                # (routing moves every row of a split leaf to a child)
                heap, _ = HC.sbh_route(codes, heap, prev[0], prev[1],
                                       base=(L >> 1) - 1, L=L >> 1)
                left = HC.sbh_hist(codes, heap, stats, base=base, L=L,
                                   n_bins=BP, half=True)[: L >> 1, :C]
                par = torch.where(did_prev[:, None, None, None], hist_prev,
                                  0.0)
                hacc = torch.stack([left, par - left], dim=1) \
                    .reshape(L, *left.shape[1:])
            hist_prev = hacc

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
                hacc, self.is_cat_dev, self.mono, cmask, lo, hi,
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
                u = torch.rand(w1.shape, generator=generator,
                               device=w1.device)
                wt = w1 * (u < sample_rate)
            else:
                wt = w1
            stats = torch.stack([wt, wt * g, wt * h, torch.zeros_like(wt)])
            tmask = _tree_col_mask(grower, generator, col_rate_tree)
            out = grower.grow(codes, stats, F, eta=eta, clip_val=cv,
                              generator=generator, mtries=mtries,
                              tree_mask=tmask)
            F = out["F"]
            trees.append((out["col"], out["bin"], out["nal"],
                          pack_route(out["route"], grower.spec.n_bins,
                                     grower.spec.b_val),
                          out["val"], out["gains"], out["cover"]))
        return F, tuple(torch.stack(parts) for parts in zip(*trees))

    return run
