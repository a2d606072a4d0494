"""Sort, group-by and merge on the card: the Rapids mungers' hot path
(h2o3_tpu/ops/device_sort.py; water/rapids/Merge.java, RadixOrder.java
and ast/prims/mungers/AstGroup.java).

The JAX package orders rows with one `jnp.lexsort` over the key columns;
torch has no lexsort, so `lexsort_rows` runs one stable sort a key, from
the last key to the first. Every key is normalised by `+ 0.0` first: the
JAX package's sort comparator treats -0.0 and +0.0 as equal (it
canonicalises them), and a radix sort over the float's bits on the card
would not, so without it a descending key (multiplied by -1, which turns
every 0 into -0.0) could reorder tied rows. NA keys become 3e38, so they
sort last and group (and join) together.

Group sums are exact in 64-bit fixed point at a scale for each group
(`group_sums`), so two runs give the same bits on the card; the JAX
package sums in f32. Variances take two passes over those sums. Minima
and maxima are `scatter_reduce`. A join is counted on the card and sized by
one scalar readback, then its pairs
are expanded on the card (`repeat_interleave`); the JAX package expands
them in host numpy, with the same pairs in the same order.

`merge_frames_pandas` is the port's own form of the join the JAX
package hands to pandas (right and outer joins, a key of strings, a side
with no rows): pandas' rows, column names (`_x`/`_y` on a clash) and
types (categorical and string columns come back categorical over the
levels present, every numeric column numeric). Outer joins come out in
sorted key order, right joins in right-row order; an inner or left join
there comes out in left-row order (pandas 3 returns an inner join in its
hash table's order; the rows are the same).
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, StrVec, Vec, T_CAT, T_NUM, T_STR

_BIG = 3.0e38


# ===========================================================================
def lexsort_rows(K: torch.Tensor) -> torch.Tensor:
    """Stable row order of the key matrix K (n, k), column 0 first: one
    stable sort a key from the last to the first (zeros normalised)."""
    n = K.shape[0]
    order = torch.arange(n, device=K.device)
    for j in range(K.shape[1] - 1, -1, -1):
        key = K[:, j].index_select(0, order) + 0.0
        order = order.index_select(0, torch.sort(key, stable=True).indices)
    return order


def na_last(M: torch.Tensor) -> torch.Tensor:
    """Keys with NaN -> 3e38, so NAs sort last and group together."""
    return torch.where(torch.isnan(M), torch.full_like(M, _BIG), M)


def _key_matrix(f: Frame, idxs, nrows: int) -> torch.Tensor:
    """(n, k) f32 key matrix on the card, NAs last."""
    return na_last(f.matrix([f.names[j] for j in idxs])[:nrows])


def device_order(f: Frame, idxs, ascending=None) -> torch.Tensor:
    """Row order by the key columns; NAs last in either direction."""
    n = f.nrows
    M = f.matrix([f.names[j] for j in idxs])[:n]
    isna = torch.isnan(M)
    if ascending is not None:
        sign = torch.tensor([1.0 if a else -1.0 for a in ascending],
                            dtype=M.dtype, device=M.device)
        M = M * sign[None, :]
    return lexsort_rows(torch.where(isna, _BIG, M))


def take_str(v: StrVec, idx: torch.Tensor, ok=None) -> StrVec:
    """Rows `idx` of a string column (NA where `ok` is False), its levels
    cut to those the rows use: `StrVec.encode` of the gathered strings,
    without the strings."""
    codes = v.codes.index_select(0, idx)
    if ok is not None:
        codes = torch.where(ok, codes, torch.full_like(codes, -1))
    present = torch.unique(codes[codes >= 0])
    tbl = torch.full((max(len(v.levels_arr), 1),), -1, dtype=codes.dtype,
                     device=codes.device)
    tbl[present.long()] = torch.arange(present.numel(), dtype=codes.dtype,
                                       device=codes.device)
    safe = codes.clamp(min=0).long()
    out = torch.where(codes >= 0, tbl[safe], codes)
    levels = v.levels_arr[present.cpu().numpy()] if present.numel() \
        else np.asarray([], object)
    return StrVec(out, levels, int(idx.numel()))


def take_rows_device(f: Frame, order: torch.Tensor) -> Frame:
    """A row permutation or selection of every column, on the card."""
    names, vecs = [], []
    for c, v in zip(f.names, f.vecs):
        if v.type == T_STR:
            vecs.append(take_str(v, order))
        else:
            vecs.append(Vec.from_tensor(v.as_f32().index_select(0, order),
                                        v.type, v.domain))
        names.append(c)
    return Frame(names, vecs)


def sort_frame(f: Frame, idxs, ascending=None) -> Frame:
    return take_rows_device(f, device_order(f, idxs, ascending))


# ===========================================================================
def _group_ids(K: torch.Tensor):
    """Sorted order, each row's group id, the sorted ids, the sorted keys
    and the group starts of a key matrix (ids in sorted key order)."""
    n = K.shape[0]
    order = lexsort_rows(K)
    Ks = K.index_select(0, order)
    new = torch.ones(n, dtype=torch.bool, device=K.device)
    if n > 1:
        new[1:] = (Ks[1:] != Ks[:-1]).any(dim=1)
    gid_sorted = torch.cumsum(new.long(), 0) - 1
    gid = torch.empty_like(gid_sorted).scatter_(0, order, gid_sorted)
    return order, gid, gid_sorted, Ks, new


def group_sums(x, gid, ng, bound):
    """(ng,) f64: the sums of x (m,) by group, exact in 64-bit fixed point
    at a power-of-two scale for each group (`hist_cuda.pow2_scale` of
    `bound`, each group's size times its largest magnitude or more). No
    order of the adds (a card's atomics) changes a bit, and a group of
    small values keeps its precision beside a group of large ones.
    Non-finite values add beside."""
    from h2o3_tpu_torch.ops.hist_cuda import pow2_scale
    fin = torch.isfinite(x)
    scale = pow2_scale(bound.double())
    fixed = torch.round(torch.where(fin, x, 0.0).double()
                        * scale.index_select(0, gid)).long()
    acc = torch.zeros(ng, dtype=torch.int64, device=x.device) \
        .index_add_(0, gid, fixed)
    out = acc.double() / scale
    if not bool(fin.all()):
        out += torch.zeros_like(out).index_add_(
            0, gid, torch.where(fin, 0.0, x).double())
    return out


def group_stats(col, gid, ng, var=True):
    """size, count, sum, min, max, mean and (where `var`) var of one
    column by group, f32: the sums exact (`group_sums`, each group's
    scale from its min and max), var in two passes (the JAX package takes
    s2 - n·mean² in f32, the same value less its cancellation)."""
    ok = ~torch.isnan(col)
    x = torch.where(ok, col, torch.zeros_like(col))
    size = torch.bincount(gid, minlength=ng).double()
    cnt = torch.bincount(gid, weights=ok.to(torch.float64), minlength=ng)
    empty = cnt == 0
    inf = torch.full((ng,), float("inf"), device=col.device)
    mn = inf.scatter_reduce(0, gid, torch.where(ok, col, inf[:1]), "amin")
    mx = (-inf).scatter_reduce(0, gid, torch.where(ok, col, -inf[:1]),
                               "amax")
    mn = torch.where(empty, 0.0, mn).double()
    mx = torch.where(empty, 0.0, mx).double()
    s = group_sums(x, gid, ng, size * torch.maximum(mn.abs(), mx.abs()))
    nan = torch.full_like(s, float("nan"))
    mean = torch.where(empty, nan, s / torch.clamp(cnt, min=1.0))
    out = [size, cnt, s, torch.where(empty, nan, mn),
           torch.where(empty, nan, mx), mean, None]
    if var:
        d = torch.where(ok, x.double() - mean.index_select(0, gid), 0.0)
        dmax = torch.maximum(mx - mean, mean - mn)
        ss = group_sums(d * d, gid, ng, size * dmax * dmax)
        out[6] = torch.where(cnt > 1, ss / torch.clamp(cnt - 1.0, min=1.0),
                             nan)
    return tuple(None if t is None else t.to(torch.float32) for t in out)


AGGS = ("sum", "mean", "min", "max", "var", "sd", "nrow", "count")


def pick_stat(stats, fn_name):
    """One of AGGS from `group_stats`' tuple (nrow and count are both the
    group's size, NA rows counted)."""
    size, cnt, s, mn, mx, mean, var = stats
    if fn_name == "sd":
        return torch.sqrt(torch.clamp(var, min=0.0))
    return {"sum": s, "mean": mean, "min": mn, "max": mx, "var": var,
            "nrow": size, "count": size}[fn_name]


def group_by_device(f: Frame, by_idxs, aggs):
    """Per-group aggregates on the card (AstGroup).

    aggs: (fn_name, col_idx) with fn in sum/mean/min/max/var/sd/nrow/count
    (nrow and count are both the group's size, NA rows counted). Returns
    (out_names, out_cols as f32 tensors on the card, key_domains), or
    None when an aggregate is not one of these (the caller's host path
    takes it). Groups come in sorted key order, NA keys last."""
    n = f.nrows
    K = _key_matrix(f, by_idxs, n)
    _, gid, gid_sorted, Ks, new = _group_ids(K)
    ng = int(gid_sorted[-1]) + 1 if n else 0
    key_rows = Ks[new]
    key_rows = torch.where(key_rows >= _BIG, torch.full_like(key_rows,
                                                             float("nan")),
                           key_rows)
    out_names = [f.names[j] for j in by_idxs]
    out_cols = [key_rows[:, k] for k in range(len(by_idxs))]
    cache = {}
    need_var = {cj for fn_name, cj in aggs if fn_name in ("var", "sd")}
    for fn_name, cj in aggs:
        if fn_name not in AGGS:
            return None
        if cj not in cache:
            cache[cj] = group_stats(f.vecs[cj].as_f32(), gid, ng,
                                    cj in need_var)
        out_names.append(f"{fn_name}_{f.names[cj]}")
        out_cols.append(pick_stat(cache[cj], fn_name))
    doms = {kd: f.vecs[j].levels() for kd, j in enumerate(by_idxs)
            if f.vecs[j].type == T_CAT}
    return out_names, out_cols, doms


# ===========================================================================
def _expand(reps: torch.Tensor):
    """(owner, within) of sum(reps) output rows: row t belongs to unit
    owner[t] and is its within[t]-th row (one scalar readback)."""
    total = int(reps.sum())
    dev = reps.device
    owner = torch.repeat_interleave(torch.arange(reps.numel(), device=dev),
                                    reps, output_size=total)
    offs = torch.cumsum(reps, 0) - reps
    within = torch.arange(total, device=dev) - offs.index_select(0, owner)
    return owner, within


def _ordered(g: torch.Tensor, ng: int):
    """Rows sorted by group (stable), each group's first position and
    size."""
    cnt = torch.bincount(g, minlength=ng)
    return torch.argsort(g, stable=True), torch.cumsum(cnt, 0) - cnt, cnt


def _cat_lut(vl, vr) -> np.ndarray:
    """The right codes' keys in the left's level numbering: a shared level
    takes the left code, the others distinct ids that match nothing
    (a categorical against a numeric key joins nothing)."""
    ldom = list(vl.domain) if vl.domain is not None else []
    rdom = list(vr.domain) if vr.domain is not None else []
    lut = np.full(max(len(rdom), 1), 2e9, np.float32)
    pos = {lv: i for i, lv in enumerate(ldom)}
    nxt = float(len(ldom))
    for j, lv in enumerate(rdom):
        if lv in pos:
            lut[j] = pos[lv]
        else:
            lut[j] = 1e9 + nxt
            nxt += 1.0
    return lut


def merge_frames(lf: Frame, rf: Frame, by_l, by_r, all_l=False):
    """Sort-merge join on the card (Merge.java): both sides' keys in one
    group numbering, each left row matched to its group's right rows in
    right-row order, one scalar readback for the output size. Inner and
    left joins; None for a side with no rows (`merge_frames_pandas`
    takes it). Categorical keys join by level. NA keys match each other,
    as in the JAX package (its docstring says they never match)."""
    nl, nr = lf.nrows, rf.nrows
    if nr == 0 or nl == 0:
        return None
    KL = _key_matrix(lf, by_l, nl)
    KR = _key_matrix(rf, by_r, nr).clone()
    for k, (il, ir) in enumerate(zip(by_l, by_r)):
        vl, vr = lf.vecs[il], rf.vecs[ir]
        if vl.type == T_CAT or vr.type == T_CAT:
            lut = _cat_lut(vl, vr)
            codes = KR[:, k].clamp(0, len(lut) - 1).long()
            remapped = torch.from_numpy(lut).to(KR.device)[codes]
            KR[:, k] = torch.where(KR[:, k] >= _BIG, KR[:, k], remapped)
    _, gid, gid_sorted, _, _ = _group_ids(torch.cat([KL, KR], 0))
    ng = int(gid_sorted[-1]) + 1
    li, ri = _join_pairs(gid[:nl], gid[nl:], ng,
                           "left" if all_l else "inner")
    has = ri >= 0
    ri = ri.clamp(min=0)
    names, vecs = [], []
    for c, v in zip(lf.names, lf.vecs):
        if v.type == T_STR:
            vecs.append(take_str(v, li))
        else:
            vecs.append(Vec.from_tensor(v.as_f32().index_select(0, li),
                                        v.type, v.domain))
        names.append(c)
    rkey_names = {rf.names[j] for j in by_r}
    for c, v in zip(rf.names, rf.vecs):
        if c in rkey_names:
            continue                    # the join keys come from the left
        nm = c if c not in names else c + "_y"
        if v.type == T_STR:
            vecs.append(take_str(v, ri, has))
        else:
            col = v.as_f32().index_select(0, ri)
            vecs.append(Vec.from_tensor(
                torch.where(has, col, torch.full_like(col, float("nan"))),
                v.type, v.domain))
        names.append(nm)
    return Frame(names, vecs)


# ===========================================================================
def _is_text(v) -> bool:
    return v.type in (T_CAT, T_STR)


def _text_levels(v) -> list:
    return list(v.levels_arr) if v.type == T_STR else (v.levels() or [])


def _text_codes(v) -> torch.Tensor:
    """int64 codes of a categorical or string column, -1 for NA."""
    if v.type == T_STR:
        return v.codes.long()
    x = v.as_f32()
    return torch.where(torch.isnan(x), -1, x.clamp(min=0)).long()


def _pandas_keys(lf, rf, by_l, by_r):
    """Both sides' key matrices as pandas compares them: numbers by value,
    categorical and string keys by their text, ordered as text."""
    dev = lf.vecs[0].device
    KL, KR = [], []
    for il, ir in zip(by_l, by_r):
        vl, vr = lf.vecs[il], rf.vecs[ir]
        if _is_text(vl) != _is_text(vr):
            raise ValueError(
                f"cannot merge a {vl.type} key ({lf.names[il]}) with a "
                f"{vr.type} key ({rf.names[ir]})")
        if not _is_text(vl):
            KL.append(vl.as_f32())
            KR.append(vr.as_f32())
            continue
        ll, rl = _text_levels(vl), _text_levels(vr)
        union = sorted(set(ll) | set(rl))
        pos = {s: i for i, s in enumerate(union)}
        for v, lv, out in ((vl, ll, KL), (vr, rl, KR)):
            tbl = torch.tensor([pos[s] for s in lv] or [0],
                               dtype=torch.float32, device=dev)
            codes = _text_codes(v)
            out.append(torch.where(codes >= 0, tbl[codes.clamp(min=0)],
                                   float("nan")))
    return na_last(torch.stack(KL, 1)), na_last(torch.stack(KR, 1))


def _join_pairs(gl, gr, ng, how):
    """(li, ri) row pairs of a join, -1 where a side has no row: a left
    join in left-row order (right matches in right-row order), a right
    join in right-row order, an outer join group by group in sorted key
    order (left-major within a group)."""
    r_order, r_start, cr = _ordered(gr, ng)

    def side(order, start, g, within, ok):
        if not order.numel():
            return torch.full_like(g, -1)
        i = order.index_select(0, torch.clamp(start.index_select(0, g)
                                              + within,
                                              max=order.numel() - 1))
        return torch.where(ok, i, -1)

    if how in ("inner", "left"):
        match = cr.index_select(0, gl)
        owner, within = _expand(match if how == "inner"
                                else torch.clamp(match, min=1))
        g = gl.index_select(0, owner)
        return owner, side(r_order, r_start, g, within,
                           match.index_select(0, owner) > 0)
    l_order, l_start, cl = _ordered(gl, ng)
    if how == "right":
        match = cl.index_select(0, gr)
        owner, within = _expand(torch.clamp(match, min=1))
        g = gr.index_select(0, owner)
        return side(l_order, l_start, g, within,
                    match.index_select(0, owner) > 0), owner
    wl, wr = torch.clamp(cl, min=1), torch.clamp(cr, min=1)
    g, within = _expand(wl * wr)
    w = wr.index_select(0, g)
    return (side(l_order, l_start, g, within // w, cl.index_select(0, g) > 0),
            side(r_order, r_start, g, within % w, cr.index_select(0, g) > 0))


def _text_out(parts, n, dev) -> Vec:
    """A categorical column over the levels present, sorted, from
    (codes, levels, rows) parts: pandas' strings read back by
    `Vec.from_numpy` (the empty string is NA there too)."""
    codes = torch.full((n,), -1, dtype=torch.int64, device=dev)
    names = sorted({lv[int(c)] for cd, lv, _ in parts
                    for c in torch.unique(cd[cd >= 0]).tolist()} - {""})
    pos = {s: i for i, s in enumerate(names)}
    for cd, lv, rows in parts:
        tbl = torch.tensor([pos.get(s, -1) for s in lv] or [-1],
                           dtype=torch.int64, device=dev)
        val = torch.where(cd >= 0, tbl[cd.clamp(min=0)], -1)
        codes[rows] = val
    x = torch.where(codes >= 0, codes.to(torch.float32), float("nan"))
    return Vec.from_tensor(x, T_CAT, names)


def merge_frames_pandas(lf: Frame, rf: Frame, by_l, by_r, how: str) -> Frame:
    """A join as the JAX package's pandas path computes it (`left.merge(
    right, left_on, right_on, how)` and `Frame.from_pandas`), on the
    card: NA keys match each other; a key of one name on both sides is
    one column (its value from whichever side has the row); other names
    both sides share take `_x` and `_y`."""
    nl, nr = lf.nrows, rf.nrows
    dev = (lf.vecs or rf.vecs)[0].device
    KL, KR = _pandas_keys(lf, rf, by_l, by_r)
    if nl + nr:
        _, gid, gid_sorted, _, _ = _group_ids(torch.cat([KL, KR], 0))
        ng = int(gid_sorted[-1]) + 1
    else:
        gid, ng = torch.zeros(0, dtype=torch.long, device=dev), 0
    li, ri = _join_pairs(gid[:nl], gid[nl:], ng, how)
    n = int(li.numel())
    lkeys = [lf.names[i] for i in by_l]
    rkeys = [rf.names[i] for i in by_r]
    merged = {a for a, b in zip(lkeys, rkeys) if a == b}
    overlap = (set(lf.names) & set(rf.names)) - merged

    def gather(v, idx):
        ok = idx >= 0
        safe = idx.clamp(min=0)
        if _is_text(v):
            cd = _text_codes(v)
            cd = cd.index_select(0, safe) if cd.numel() else \
                torch.full_like(idx, -1)
            return ("text", torch.where(ok, cd, -1), _text_levels(v))
        x = v.as_f32()
        x = x.index_select(0, safe) if x.numel() else \
            torch.full(idx.shape, float("nan"), device=dev)
        return ("num", torch.where(ok, x, float("nan")), None)

    def build(parts):
        if parts[0][0] == "num":
            out = torch.full((n,), float("nan"), device=dev)
            for _, x, _, rows in parts:
                out[rows] = x[rows]
            return Vec.from_tensor(out, T_NUM)
        return _text_out([(cd[rows], lv, rows) for _, cd, lv, rows in parts],
                         n, dev)

    everything = torch.ones(n, dtype=torch.bool, device=dev)
    names, vecs = [], []
    for c, v in zip(lf.names, lf.vecs):
        kind, x, lv = gather(v, li)
        parts = [(kind, x, lv, everything)]
        if c in merged:                 # the key: from the right where the
            rv = rf.vec(rkeys[lkeys.index(c)])     # left has no row
            rkind, rx, rlv = gather(rv, ri)
            parts = [(kind, x, lv, li >= 0), (rkind, rx, rlv, li < 0)]
        names.append(c + "_x" if c in overlap else c)
        vecs.append(build(parts))
    for c, v in zip(rf.names, rf.vecs):
        if c in merged:
            continue
        kind, x, lv = gather(v, ri)
        names.append(c + "_y" if c in overlap else c)
        vecs.append(build([(kind, x, lv, everything)]))
    return Frame(names, vecs)
