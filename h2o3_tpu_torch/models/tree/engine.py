"""The adaptive tree engine of the port, dense heap-order tree storage and
ensemble scoring (h2o3_tpu/models/tree/engine.py).

Node 0 is the root and the children of node i are 2i+1 and 2i+2; every
node carries the value a row takes when it stops there. Scoring is a
fixed-depth gather walk.

The adaptive engine (`TreeGrower`) grows one tree a level at a time, as
H2O's UniformAdaptive histograms do: each leaf takes the min and max of
its in-sample rows per column, every row is binned into B equal bins of
its own leaf's range (NA in bin B), and the split search scans the
per-(leaf, column, bin) sums of (w, w·y, w·y²). XGBoost, the isolation
forest, DRF deeper than 10 or multinomial, and GBM off the binned engine
grow on it. The JAX package computes all of it in XLA with no Pallas
kernel, so it is plain PyTorch here; a level works on the in-sample rows
and the leaves that hold them only, the histogram is a scatter-add
(`index_add_`) over a combined leaf·column·bin index in exact 64-bit
fixed point (the same bits in any order of the adds, so a tree is the
same from run to run and on the card and the CPU), and the histogram and
split search run over blocks of leaves when a level's histogram would
pass `HIST_CELLS`. Every random choice inside a level (DRF's per-node
column sample) comes in as a tensor that the caller draws (`Draws`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.ops import hist_cuda as HC

# Trees walked together in one batch of gathers; bounds the (trees, rows)
# temporaries at large row counts.
_TREE_BATCH = 16
# Leaf-column-slot cells of one histogram block: a level whose histogram
# would hold more runs its histogram and split search over blocks of
# leaves (each block's split search holds about a dozen temporaries of
# its size). Leaves are independent, so the blocks give the same result.
HIST_CELLS = 1 << 25
# Leaves up to which a level's ranges are reduced leaf by leaf over rows
# sorted by leaf, rather than by a scatter whose atomics queue on few
# slots (chip_smoke.py times both forms; PERF.md has the numbers)
SORTED_RANGE_LEAVES = 64
# Rows x columns of one scatter-add of the histogram (its int64 index and
# its int64 copy of the stats)
_SCATTER_ELEMS = 1 << 26
_BIG = 3.0e38


@dataclass
class TreeArrays:
    """One ensemble's trees as stacked tensors in heap node order."""
    col: torch.Tensor        # (T, nodes) int32, -1 = leaf
    thr: torch.Tensor        # (T, nodes) f32: numeric split goes right if x > thr
    na_left: torch.Tensor    # (T, nodes) bool
    value: torch.Tensor      # (T, nodes) f32
    depth: int
    cover: torch.Tensor | None = None     # (T, nodes) f32 training weight
    # categorical SET splits: per-node go-right bitset over level ids, the
    # JAX package's uint32 words held in int64, and the categorical columns
    catbits: torch.Tensor | None = None   # (T, nodes, W) int64
    col_is_cat: np.ndarray | None = None  # (C,) bool, host metadata

    @property
    def ntrees(self) -> int:
        return int(self.col.shape[0])

    def to(self, device) -> "TreeArrays":
        mv = (lambda t: None if t is None else t.to(device))  # noqa: E731
        return TreeArrays(col=mv(self.col), thr=mv(self.thr),
                          na_left=mv(self.na_left), value=mv(self.value),
                          depth=self.depth, cover=mv(self.cover),
                          catbits=mv(self.catbits),
                          col_is_cat=self.col_is_cat)


def stack_trees(tree_list, depth) -> TreeArrays:
    """Stack per-tree (col, thr, nal, val[, cover]) tensors into one
    ensemble."""
    cover = None
    if len(tree_list[0]) >= 5:
        cover = torch.stack([t[4] for t in tree_list])
    return TreeArrays(col=torch.stack([t[0] for t in tree_list]),
                      thr=torch.stack([t[1] for t in tree_list]),
                      na_left=torch.stack([t[2] for t in tree_list]),
                      value=torch.stack([t[3] for t in tree_list]),
                      depth=depth, cover=cover)


def _walk(XT, col, thr, nal, depth, catbits=None, iscat=None):
    """Walk a batch of trees; returns each row's terminal node per tree
    (Tb, n). Categorical SET-split nodes route by bitset membership."""
    Tb = col.shape[0]
    n = XT.shape[1]
    dev = XT.device
    tix = torch.arange(Tb, device=dev)[:, None]
    node = torch.zeros((Tb, n), dtype=torch.int64, device=dev)
    nb = None if catbits is None else catbits.shape[-1] * 32
    for _ in range(depth):
        c = col[tix, node].long()
        leafish = c < 0
        cc = c.clamp(min=0)
        x = torch.gather(XT, 0, cc)
        isna = torch.isnan(x)
        right = x > thr[tix, node]
        if catbits is not None:
            code = torch.nan_to_num(x).clamp(0, nb - 1).long()
            word = catbits[tix, node, code // 32]
            bit = (word >> (code % 32)) & 1
            right = torch.where(iscat[cc], bit == 1, right)
        right = torch.where(isna, ~nal[tix, node], right)
        child = 2 * node + 1 + right.long()
        node = torch.where(leafish, node, child)
    return node


def predict_ensemble(X: torch.Tensor, trees: TreeArrays,
                     weights=None) -> torch.Tensor:
    """sum_t weight_t * value[t, leaf_t(row)] for X (n, C) f32 NaN-NA.
    Categorical SET-split nodes route by bitset membership of the level id.
    Trees are summed in order, like the JAX package's scan."""
    dev = X.device
    T = trees.ntrees
    tw = (torch.as_tensor(weights, dtype=torch.float32, device=dev)
          if weights is not None else torch.ones(T, device=dev))
    has_cat = (trees.catbits is not None and trees.col_is_cat is not None
               and bool(np.any(np.asarray(trees.col_is_cat))))
    iscat = (torch.as_tensor(np.asarray(trees.col_is_cat, bool), device=dev)
             if has_cat else None)
    XT = X.t().contiguous()
    out = torch.zeros(X.shape[0], dtype=torch.float32, device=dev)
    for t0 in range(0, T, _TREE_BATCH):
        sl = slice(t0, min(T, t0 + _TREE_BATCH))
        node = _walk(XT, trees.col[sl], trees.thr[sl], trees.na_left[sl],
                     trees.depth, trees.catbits[sl] if has_cat else None,
                     iscat)
        vals = trees.value[sl].gather(1, node)
        for k in range(vals.shape[0]):
            out = out + tw[t0 + k] * vals[k]
    return out


def predict_leaf_ids(X: torch.Tensor, trees: TreeArrays):
    """Per-(tree, row) terminal node ids and depths, (T, n) each: the cover
    rebuild of a restart. Numeric splits only, as the JAX package's walk;
    a heap node's depth is floor(log2(node + 1))."""
    XT = X.t().contiguous()
    nodes = torch.cat([
        _walk(XT, trees.col[t0:t0 + _TREE_BATCH],
              trees.thr[t0:t0 + _TREE_BATCH],
              trees.na_left[t0:t0 + _TREE_BATCH], trees.depth)
        for t0 in range(0, trees.ntrees, _TREE_BATCH)])
    return nodes, torch.log2(nodes.double() + 1).floor().to(torch.int32)


def fma32(a, b, c):
    """a·b + c of f32 operands rounded once to f32, as the fused
    multiply-add that the JAX package's compiled f32 code uses there (its
    x·k/B also becomes x·k·f32(1/B)), so the thresholds come out in the
    same bits."""
    return (a.double() * b + c.double()).to(torch.float32)


# ===========================================================================
# The adaptive engine's building blocks. Each takes the JAX package's
# arguments and gives its results in its f32 order of operations.
def _ranges(Xs, ls, L):
    """Per-(leaf, col) min and max of the rows Xs (n_s, C) in leaves ls,
    all < L: NaN counts as +3e38 for the min and -3e38 for the max, and a
    leaf with no row gets +inf and -inf (the identities of the JAX
    package's segment reductions). Up to SORTED_RANGE_LEAVES leaves the
    rows are sorted by leaf and each leaf's rows reduced as one slice (a
    scatter min of millions of rows into a few slots queues on its
    atomics); more leaves take a scatter min/max."""
    n, C = Xs.shape
    inf = torch.full((L, C), float("inf"), device=Xs.device)
    if n == 0:
        return inf, -inf
    if L > SORTED_RANGE_LEAVES:
        nan = torch.isnan(Xs)
        idx = ls[:, None].expand(-1, C)
        mx = (-inf).scatter_reduce_(0, idx, torch.where(nan, -_BIG, Xs),
                                    "amax")
        return inf.scatter_reduce_(0, idx, torch.where(nan, _BIG, Xs),
                                   "amin"), mx
    if L > 1:
        Xs = Xs.index_select(0, torch.argsort(ls))
        ends = torch.cumsum(torch.bincount(ls, minlength=L), 0).tolist()
    else:
        ends = [n]
    nan = torch.isnan(Xs)
    xmin = torch.where(nan, _BIG, Xs)
    xmax = torch.where(nan, -_BIG, Xs)
    mns, mxs, a = [], [], 0
    for l, b in enumerate(ends):
        mns.append(xmin[a:b].amin(0) if b > a else inf[l])
        mxs.append(xmax[a:b].amax(0) if b > a else -inf[l])
        a = b
    return torch.stack(mns), torch.stack(mxs)


def leaf_ranges(X, lv, L):
    """Per-(leaf, col) min/max over in-sample rows (lv == L: excluded)."""
    keep = lv < L
    return _ranges(X[keep], lv[keep], L)


def bin_rows(X, lv, mn, mx, B):
    """Adaptive binning: row r, col c -> bin in [0, B) of its leaf's range;
    NA -> bin B. int16 (int32 past 32,767 bins)."""
    safe = lv.clamp(max=mn.shape[0] - 1)
    span = torch.clamp(mx - mn, min=1e-30)[safe]
    t = X - mn[safe]
    t.div_(span).mul_(B).floor_().clamp_(0, B - 1)
    b = t.to(torch.int16 if B < 2 ** 15 else torch.int32)
    return b.masked_fill_(torch.isnan(X), B)


def _to_fixed(values, n_rows):
    """values (m, k) f32 in 64-bit fixed point at a power-of-two scale per
    column that no sum of n_rows of them can overflow
    (`hist_cuda.hist_scale`, as the binned kernels sum). Returns (int64
    (m, k), scale (k,) f64, the non-finite values (f32, 0 elsewhere) or
    None when every value is finite)."""
    if values.shape[0] == 0:
        return values.long(), torch.ones(values.shape[1], dtype=torch.float64,
                                         device=values.device), None
    scale = HC.hist_scale(values.t(), n_rows)
    finite = torch.isfinite(values)
    fixed = torch.round(torch.where(finite, values, 0.0).double() * scale)
    rest = None if bool(finite.all()) else torch.where(finite, 0.0, values)
    return fixed.long(), scale, rest


def _from_fixed(acc, scale, side):
    out = (acc.double() / scale).to(torch.float32)
    return out if side is None else out + side


def segment_sum(index, values, size):
    """(size, k) f32: the sums of values (m, k) f32 by index (m,), exact in
    64-bit fixed point, so every order of the adds (a card's atomics, the
    CPU's loop) gives the same bits; non-finite values add in f32 beside."""
    fixed, scale, rest = _to_fixed(values, values.shape[0])
    shape = (size, values.shape[1])
    acc = torch.zeros(shape, dtype=torch.int64, device=values.device) \
        .index_add_(0, index, fixed)
    side = None if rest is None else torch.zeros(
        shape, device=values.device).index_add_(0, index, rest)
    return _from_fixed(acc, scale, side)


def build_histograms(bins, lv, stats, L, B):
    """hist (L, C, B+1, 3): the sums of each row's (w, w·y, w·y²) into its
    (leaf, column, bin) slot, one scatter-add (`index_add_`) over the
    combined leaf·C·(B+1) + column·(B+1) + bin index, over blocks of
    columns (the JAX package's deep-level segment sum; its one-hot matmul
    form exists for the TPU's matrix unit only). Rows with lv == L are
    left out. The sums are exact, in 64-bit fixed point at a power-of-two
    scale per stat that no sum can overflow (`hist_cuda.hist_scale`, as
    the binned kernels sum; `segment_sum`), so every order of the adds
    gives the same bits; non-finite stats add in f32 beside them."""
    n, C = bins.shape
    nb = B + 1
    dev = bins.device
    fixed, scale, rest = _to_fixed(stats, n)
    acc = torch.zeros(((L + 1) * C * nb, 3), dtype=torch.int64, device=dev)
    side = None if rest is None else torch.zeros(acc.shape, device=dev)
    base = lv.long() * (C * nb)
    cb = max(1, min(C, _SCATTER_ELEMS // max(n, 1)))
    for c0 in range(0, C, cb):
        c1 = min(C, c0 + cb)
        off = torch.arange(c0, c1, device=dev) * nb
        idx = (base[:, None] + off[None, :] + bins[:, c0:c1]).reshape(-1)
        acc.index_add_(0, idx, fixed[:, None, :].expand(n, c1 - c0, 3)
                       .reshape(-1, 3))
        if rest is not None:
            side.index_add_(0, idx, rest[:, None, :].expand(n, c1 - c0, 3)
                            .reshape(-1, 3))
    hist = _from_fixed(acc[: L * C * nb], scale,
                       None if side is None else side[: L * C * nb])
    return hist.view(L, C, nb, 3)


def find_best_splits(hist, mn, mx, min_rows, min_split_improvement,
                     col_mask, B, reg_lambda=0.0):
    """DecidedNode.bestCol over every (leaf, col, threshold, NA side).
    col_mask: (L, C) bool, the columns each leaf may split on. Returns per
    leaf: did, gain, col, thr, na_left, leaf_w, leaf_wy. A split at t in
    [0, B-1) sends bins <= t left (and NA when na_left). With reg_lambda
    the SE reduction is XGBoost's structure score (w = sum h, wy = sum g)."""
    w, wy, wyy = hist[..., 0], hist[..., 1], hist[..., 2]
    main_w, na_w = w[..., :B], w[..., B]
    main_wy, na_wy = wy[..., :B], wy[..., B]
    main_wyy, na_wyy = wyy[..., :B], wyy[..., B]

    def se(w_, wy_, wyy_):
        den = torch.clamp(w_ + reg_lambda, min=1e-30)
        return wyy_ - torch.where(w_ > 0, wy_ * wy_ / den, 0.0)

    tot_w = main_w.sum(-1) + na_w                       # (L, C)
    tot_wy = main_wy.sum(-1) + na_wy
    tot_wyy = main_wyy.sum(-1) + na_wyy
    se_parent = se(tot_w, tot_wy, tot_wyy)
    cl_w = torch.cumsum(main_w, -1)[..., :-1]           # (L, C, B-1)
    cl_wy = torch.cumsum(main_wy, -1)[..., :-1]
    cl_wyy = torch.cumsum(main_wyy, -1)[..., :-1]

    def gains(nal):
        lw, lwy, lwyy = cl_w, cl_wy, cl_wyy
        if nal:
            lw = lw + na_w[..., None]
            lwy = lwy + na_wy[..., None]
            lwyy = lwyy + na_wyy[..., None]
        rw = tot_w[..., None] - lw
        rwy = tot_wy[..., None] - lwy
        rwyy = tot_wyy[..., None] - lwyy
        g = se_parent[..., None] - se(lw, lwy, lwyy) - se(rw, rwy, rwyy)
        ok = (lw >= min_rows) & (rw >= min_rows)
        return torch.where(ok, g, float("-inf"))

    g_right = gains(False)
    g_left = gains(True)
    g = torch.maximum(g_right, g_left)
    na_left = g_left > g_right
    g = torch.where(col_mask[:, :, None], g, float("-inf"))
    L, C = tot_w.shape
    flat = g.reshape(L, C * (B - 1))
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    best_col = best // (B - 1)
    best_bin = best % (B - 1)
    best_nal = na_left.reshape(L, C * (B - 1)).gather(1, best[:, None])[:, 0]
    # the threshold: the upper edge of bin t in the leaf's range
    lmn = mn.gather(1, best_col[:, None])[:, 0]
    lmx = mx.gather(1, best_col[:, None])[:, 0]
    thr = fma32((lmx - lmn) * (best_bin + 1).to(torch.float32),
                float(np.float32(1.0 / B)), lmn)
    did = torch.isfinite(best_gain) & \
        (best_gain > max(min_split_improvement, 0.0))
    return (did, best_gain, best_col.to(torch.int32), thr, best_nal,
            tot_w[:, 0], tot_wy[:, 0])


def _split_leaves(Xs, ls, ss, La, mn, mx, cmask, B, min_rows, msi,
                  reg_lambda):
    """Binning, histograms and split search of La leaves (rows Xs in
    leaves ls < La, stats ss), over blocks of leaves when the histogram
    would pass HIST_CELLS cells. A stable sort keeps each leaf's rows in
    their order, so a block sums as the whole level would."""
    C = Xs.shape[1]
    per = max(1, HIST_CELLS // (C * (B + 1)))
    if La <= per:
        bins = bin_rows(Xs, ls, mn, mx, B)
        hist = build_histograms(bins, ls, ss, La, B)
        return find_best_splits(hist, mn, mx, min_rows, msi, cmask, B,
                                reg_lambda)
    order = torch.argsort(ls, stable=True)
    ends = torch.cumsum(torch.bincount(ls, minlength=La), 0).cpu().tolist()
    outs = []
    for l0 in range(0, La, per):
        l1 = min(La, l0 + per)
        rows = order[(ends[l0 - 1] if l0 else 0): ends[l1 - 1]]
        lb = ls[rows] - l0
        bins = bin_rows(Xs[rows], lb, mn[l0:l1], mx[l0:l1], B)
        hist = build_histograms(bins, lb, ss[rows], l1 - l0, B)
        outs.append(find_best_splits(hist, mn[l0:l1], mx[l0:l1], min_rows,
                                     msi, cmask[l0:l1], B, reg_lambda))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def in_sample_rows(active, w_in, leaf):
    """The rows a level sums (active, weight > 0), the leaves that hold
    them (sorted) and each such row's index among those leaves. Returns
    (rows or None when every row is in, leaves, compact leaf per row)."""
    in_sample = active & (w_in > 0)
    n_in = int(in_sample.sum())
    rows = None if n_in == in_sample.shape[0] else \
        in_sample.nonzero()[:, 0]
    lv = leaf if rows is None else leaf[rows]
    leaves, inv = torch.unique(lv, sorted=True, return_inverse=True)
    return rows, leaves, inv


def route_rows(X, leaf, heap, active, did, bcol, thr, nal):
    """Route every row of a split leaf (out-of-bag rows too: they need the
    tree's prediction); rows of terminal leaves freeze. Per-leaf tables
    are (L,); leaf and heap are int64."""
    c = bcol[leaf].long()
    x = X.gather(1, c[:, None])[:, 0]
    go_right = torch.where(torch.isnan(x), ~nal[leaf], x > thr[leaf]).long()
    splits = did[leaf] & active
    leaf = torch.where(splits, 2 * leaf + go_right, 0)
    heap = torch.where(splits, 2 * heap + 1 + go_right, heap)
    return leaf, heap, splits


def _level_step(X, stats, w_in, leaf, heap, active, colA, thrA, nalA, valA,
                gains, col_mask, r, *, d, B, mtries, min_rows,
                min_split_improvement, reg_lambda=0.0):
    """One level of one tree (the JAX package's fused level program). r:
    the (2^d, C) uniforms of DRF's per-node column sample, or None when
    every column is open. Writes the level's nodes into colA, thrA, nalA
    and valA (in place) and returns (leaf, heap, active, colA, thrA,
    nalA, valA, gains). A leaf without in-sample rows is terminal with
    value 0, as in the JAX package; its threshold is left 0 (no row
    reaches its children)."""
    L = 2 ** d
    C = X.shape[1]
    dev = X.device
    rows, leaves, ls = in_sample_rows(active, w_in, leaf)
    La = int(leaves.shape[0])
    Xs = X if rows is None else X[rows]
    ss = stats if rows is None else stats[rows]
    mn, mx = _ranges(Xs, ls, La)
    if mtries > 0 and mtries < C:
        rl = r[leaves]
        kth = torch.kthvalue(rl, mtries, dim=1, keepdim=True).values
        cmask = (rl <= kth) & col_mask[None, :]
    else:
        cmask = col_mask[None, :].expand(La, C)
    did, gain, bcol, thr, nal, lw, lwy = _split_leaves(
        Xs, ls, ss, La, mn, mx, cmask, B, min_rows, min_split_improvement,
        reg_lambda)
    base = L - 1
    lvl_val = torch.where(lw > 0, lwy / torch.clamp(lw, min=1e-30), 0.0)
    colA[base + leaves] = torch.where(did, bcol, -1)
    thrA[base + leaves] = thr
    nalA[base + leaves] = nal
    valA[base + leaves] = lvl_val
    gains += segment_sum(bcol.long(), torch.where(
        did, torch.clamp(gain, min=0.0), 0.0)[:, None], C)[:, 0]
    # per-leaf tables over all L leaves for the route
    did_L = torch.zeros(L, dtype=torch.bool, device=dev)
    did_L[leaves] = did
    col_L = torch.zeros(L, dtype=torch.int32, device=dev)
    col_L[leaves] = bcol
    thr_L = torch.zeros(L, dtype=torch.float32, device=dev)
    thr_L[leaves] = thr
    nal_L = torch.zeros(L, dtype=torch.bool, device=dev)
    nal_L[leaves] = nal
    leaf, heap, active = route_rows(X, leaf, heap, active, did_L, col_L,
                                    thr_L, nal_L)
    return leaf, heap, active, colA, thrA, nalA, valA, gains


def _final_leaves(stats, leaf, active, w_in, valA, *, D):
    """Values of the leaves at depth D: their in-sample response means."""
    L = 2 ** D
    lv = torch.where(active & (w_in > 0), leaf, L)
    sums = segment_sum(lv, stats[:, :2], L + 1)[:L]
    vals = torch.where(sums[:, 0] > 0,
                       sums[:, 1] / torch.clamp(sums[:, 0], min=1e-30), 0.0)
    valA[L - 1:] = vals
    return valA


def gamma_pass(heap, w, res, hess, val, *, nodes, scale=1.0,
               reg_lambda=0.0, reg_alpha=0.0):
    """GammaPass (GBM.java:1235): the Newton leaf sum w·res / sum w·hess;
    with reg_lambda and reg_alpha XGBoost's leaf weight
    sign(G)·max(|G|−α, 0)/(H+λ). Nodes no row reaches keep `val`."""
    num, den = segment_sum(heap, torch.stack([w * res, w * hess], 1),
                           nodes).unbind(1)
    if reg_alpha:
        num = torch.sign(num) * torch.clamp(num.abs() - reg_alpha, min=0.0)
    den = den + reg_lambda
    return torch.where(den > 1e-10,
                       torch.clamp(scale * num / torch.clamp(den, min=1e-10),
                                   -19, 19), val).to(torch.float32)


def node_covers(heap, w, *, nodes, D):
    """Per-node training weight (TreeSHAP's cover): the terminal weights of
    the rows, then each level's children summed into their parents."""
    cov = segment_sum(heap, w[:, None], nodes)[:, 0]
    for d in range(D - 1, -1, -1):
        lo, hi = 2 ** d - 1, 2 ** (d + 1) - 1
        cov[lo:hi] += cov[2 * lo + 1: 2 * hi + 1].view(hi - lo, 2).sum(1)
    return cov


# ===========================================================================
class Draws:
    """The random draws of tree growth, from one torch.Generator, landing
    on `device`. The JAX package draws each of these from a jax.random key
    inside its programs; here each comes in as a tensor, so a test can
    hand both packages the same draws (by replacing this object)."""

    def __init__(self, gen: torch.Generator, device=None):
        self.gen = gen
        self.device = torch.device(device) if device is not None \
            else gen.device

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.gen,
                          device=self.gen.device).to(self.device)

    def rows(self, n):
        """(n,) uniforms of a tree's (an iteration's) row sample."""
        return self._rand(n)

    def cols(self, C):
        """(C,) uniforms of a tree's column sample."""
        return self._rand(C)

    def levels(self):
        """One tree's per-level column-sample draws: a function of
        (d, L, C) giving (L, C) uniforms."""
        return lambda d, L, C: self._rand(L, C)

    def iso_level(self, d, L, C):
        """The isolation forest's level draws: (L, C) uniforms picking each
        leaf's column, (L,) placing its threshold."""
        return self._rand(L, C), self._rand(L)


class TreeGrower:
    """Grows one tree level by level on the adaptive engine. It stops as
    soon as no row is active (one host read a level): a finished tree
    runs no deeper level, and nodes below its leaves stay col -1."""

    def __init__(self, nbins: int, max_depth: int, min_rows: float,
                 min_split_improvement: float, reg_lambda: float = 0.0):
        self.B = int(nbins)
        self.D = int(max_depth)
        self.min_rows = float(min_rows)
        self.msi = float(min_split_improvement)
        self.reg_lambda = float(reg_lambda)
        self.nodes = 2 ** (self.D + 1) - 1

    def grow(self, X, w, grad, col_mask=None, draw=None, mtries: int = 0):
        """X: (n, C) f32, NaN = NA; w: (n,) in-sample weights (0 = out of
        bag); grad: (n,) the regression target (residual or gradient);
        draw(d, L, C): the (L, C) uniforms of the per-node column sample,
        needed when 0 < mtries < C. Returns (col, thr, na_left, value,
        heap, gains): heap is each row's terminal node, so value[heap] is
        the tree's prediction of the training rows."""
        n, C = X.shape
        dev = X.device
        sampled = 0 < mtries < C
        if sampled and draw is None:
            raise ValueError("mtries < C needs the level draws (draw=)")
        stats = torch.stack([w, w * grad, w * grad * grad], dim=1)
        leaf = torch.zeros(n, dtype=torch.int64, device=dev)
        heap = torch.zeros(n, dtype=torch.int64, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        colA = torch.full((self.nodes,), -1, dtype=torch.int32, device=dev)
        thrA = torch.zeros(self.nodes, dtype=torch.float32, device=dev)
        nalA = torch.zeros(self.nodes, dtype=torch.bool, device=dev)
        valA = torch.zeros(self.nodes, dtype=torch.float32, device=dev)
        gains = torch.zeros(C, dtype=torch.float32, device=dev)
        if col_mask is None:
            col_mask = torch.ones(C, dtype=torch.bool, device=dev)
        for d in range(self.D):
            r = draw(d, 2 ** d, C) if sampled else None
            leaf, heap, active, colA, thrA, nalA, valA, gains = _level_step(
                X, stats, w, leaf, heap, active, colA, thrA, nalA, valA,
                gains, col_mask, r, d=d, B=self.B, mtries=int(mtries),
                min_rows=self.min_rows, min_split_improvement=self.msi,
                reg_lambda=self.reg_lambda)
            if not bool(active.any()):
                return colA, thrA, nalA, valA, heap, gains
        valA = _final_leaves(stats, leaf, active, w, valA, D=self.D)
        return colA, thrA, nalA, valA, heap, gains
