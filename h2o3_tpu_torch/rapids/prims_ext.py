"""Rapids primitives, the second tranche of the port
(h2o3_tpu/rapids/prims_ext.py; water/rapids/ast/prims/**), registered
into the same PRIMS table: advmath (AstCor, AstDistance, moments, AstMad,
AstMode, the k-fold columns, AstDifLag1, AstPerfectAUC, stratified
splits), the hyperbolic and gamma family, mungers (AstCut, AstMelt,
AstPivot, AstRelevel, AstFillNA, AstRankWithinGroupBy, AstDdply, …),
string, time, the NA-counting reducers and the misc prims.

The JAX package's module-level munger kernels are torch here, on the
card: `_cut_kernel` is one `searchsorted`; `_fillna_kernel` (a `lax.scan`
over rows) is a running maximum of each column's last valid row
(`cummax`) and one gather, a NA filled from the last valid value when it
lies at most `maxlen` rows before (backward: the same over the flipped
rows); `_rank_kernel` is a stable multi-key sort and a running maximum
of the group starts; `_pivot_fill` scatters the row index of each cell
and keeps the last row's value where two rows land on one cell (the JAX
package's `.at[].set` leaves the winner unspecified). Prims the JAX
package computes in host numpy are host numpy here, over the same f32
values. `ddply` is repaired: the JAX package's imports a name that does
not exist, and its lambda check expects a tag its parser never makes, so
it always raises. `PermutationVarImp` waits for `explain_data.py`.
"""

from __future__ import annotations

import math
import re
from datetime import datetime, timezone

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, Vec, T_CAT, T_NUM, T_STR, \
    T_TIME
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.rapids.rapids import (
    PRIMS, prim, _apply_lambda, _col_np, _dev_frame, _eval, _new_frame,
    _numeric_cols, _reduce_op, _unary_op, _vnp)


def _f(x) -> Frame:
    assert isinstance(x, Frame), f"expected frame, got {type(x)}"
    return x


def _col0(fr: Frame) -> np.ndarray:
    return _col_np(fr, 0)[: fr.nrows]


def _mat(fr: Frame) -> np.ndarray:
    return fr.matrix(_numeric_cols(fr)).cpu().numpy().astype(np.float64)


# ===========================================================================
# math (prims/math): the hyperbolic and gamma family
@prim("acosh")
def _acosh(a, e): return _unary_op(a, e, torch.acosh)


@prim("asinh")
def _asinh(a, e): return _unary_op(a, e, torch.asinh)


@prim("atanh")
def _atanh(a, e): return _unary_op(a, e, torch.atanh)


@prim("cospi")
def _cospi(a, e): return _unary_op(a, e, lambda x: torch.cos(math.pi * x))


@prim("sinpi")
def _sinpi(a, e): return _unary_op(a, e, lambda x: torch.sin(math.pi * x))


@prim("tanpi")
def _tanpi(a, e): return _unary_op(a, e, lambda x: torch.tan(math.pi * x))


@prim("lgamma")
def _lgamma(a, e): return _unary_op(a, e, torch.lgamma)


@prim("digamma")
def _digamma(a, e): return _unary_op(a, e, torch.digamma)


@prim("trigamma")
def _trigamma(a, e):
    return _unary_op(a, e, lambda x: torch.polygamma(1, x))


# ===========================================================================
# advmath (prims/advmath)
@prim("cor")
def _cor(a, e):
    """(cor fr1 fr2 use method): AstCor; Pearson over 'complete.obs'
    rows."""
    x = _f(_eval(a[0], e))
    y = x
    if len(a) > 1:
        cand = _eval(a[1], e)      # a symbol evaluates to its frame
        if isinstance(cand, Frame):
            y = cand
    X = _mat(x)
    Y = _mat(y)
    ok = ~(np.isnan(X).any(1) | np.isnan(Y).any(1))
    X, Y = X[ok], Y[ok]
    Xc = X - X.mean(0)
    Yc = Y - Y.mean(0)
    num = Xc.T @ Yc
    den = np.sqrt((Xc ** 2).sum(0))[:, None] * np.sqrt((Yc ** 2).sum(0))
    C = num / np.maximum(den, 1e-300)
    if C.size == 1:
        return float(C[0, 0])
    return _new_frame(y.names, [C[:, j] for j in range(C.shape[1])])


@prim("distance")
def _distance(a, e):
    """(distance fr1 fr2 measure): AstDistance, every pair of rows."""
    x = _mat(_f(_eval(a[0], e)))
    y = _mat(_f(_eval(a[1], e)))
    measure = _eval(a[2], e) if len(a) > 2 else "l2"
    if measure in ("l2", "euclidean"):
        d2 = (x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None] - 2 * x @ y.T
        D = np.sqrt(np.maximum(d2, 0))
    elif measure in ("l1", "manhattan"):
        D = np.abs(x[:, None, :] - y[None, :, :]).sum(-1)
    else:  # cosine
        nx = np.linalg.norm(x, axis=1, keepdims=True)
        ny = np.linalg.norm(y, axis=1, keepdims=True)
        D = 1 - (x @ y.T) / np.maximum(nx * ny.T, 1e-300)
    return _new_frame([f"C{j+1}" for j in range(D.shape[1])],
                      [D[:, j] for j in range(D.shape[1])])


def _moments(col):
    col = col[~np.isnan(col)]
    n = col.size
    mu = col.mean() if n else np.nan
    sd = col.std(ddof=1) if n > 1 else np.nan
    return col, n, mu, sd


@prim("skewness")
def _skewness(a, e):
    fr = _f(_eval(a[0], e))
    out = []
    for j in range(len(_numeric_cols(fr))):
        col, n, mu, sd = _moments(_mat(fr)[:, j])
        out.append(float((((col - mu) / sd) ** 3).sum() * n
                         / ((n - 1) * (n - 2))) if n > 2 else np.nan)
    return out[0] if len(out) == 1 else out


@prim("kurtosis")
def _kurtosis(a, e):
    fr = _f(_eval(a[0], e))
    out = []
    for j in range(len(_numeric_cols(fr))):
        col, n, mu, sd = _moments(_mat(fr)[:, j])
        out.append(float((((col - mu) / sd) ** 4).mean() * n ** 2
                         * (n + 1) / ((n - 1) * (n - 2) * (n - 3)))
                   if n > 3 else np.nan)
    return out[0] if len(out) == 1 else out


@prim("h2o.mad")
def _mad(a, e):
    col = _col0(_f(_eval(a[0], e)))
    col = col[~np.isnan(col)]
    med = np.median(col)
    return float(1.4826 * np.median(np.abs(col - med)))


@prim("mode")
def _mode(a, e):
    col = _col0(_f(_eval(a[0], e)))
    vals, cnt = np.unique(col[~np.isnan(col)], return_counts=True)
    return float(vals[np.argmax(cnt)])


@prim("difflag1")
def _difflag1(a, e):
    fr = _f(_eval(a[0], e))
    col = _col0(fr)
    out = np.empty_like(col)
    out[0] = np.nan
    out[1:] = col[1:] - col[:-1]
    return _new_frame(fr.names[:1], [out])


@prim("kfold_column")
def _kfold(a, e):
    fr = _f(_eval(a[0], e))
    k = int(_eval(a[1], e))
    seed = int(_eval(a[2], e)) if len(a) > 2 else -1
    rng = np.random.default_rng(seed if seed > 0 else None)
    return _new_frame(["fold"],
                      [rng.integers(0, k, fr.nrows).astype(np.float64)])


@prim("modulo_kfold_column")
def _mod_kfold(a, e):
    fr = _f(_eval(a[0], e))
    k = int(_eval(a[1], e))
    return _new_frame(["fold"],
                      [(np.arange(fr.nrows) % k).astype(np.float64)])


@prim("stratified_kfold_column")
def _strat_kfold(a, e):
    fr = _f(_eval(a[0], e))
    k = int(_eval(a[1], e))
    seed = int(_eval(a[2], e)) if len(a) > 2 else -1
    y = _col0(fr)
    rng = np.random.default_rng(seed if seed > 0 else None)
    fold = np.zeros(fr.nrows, np.float64)
    for lvl in np.unique(y[~np.isnan(y)]):
        idx = np.where(y == lvl)[0]
        rng.shuffle(idx)
        fold[idx] = np.arange(idx.size) % k
    return _new_frame(["fold"], [fold])


@prim("h2o.random_stratified_split")
def _strat_split(a, e):
    fr = _f(_eval(a[0], e))
    ratio = float(_eval(a[1], e))
    seed = int(_eval(a[2], e)) if len(a) > 2 else -1
    y = _col0(fr)
    rng = np.random.default_rng(seed if seed > 0 else None)
    out = np.zeros(fr.nrows, np.float64)
    for lvl in np.unique(y[~np.isnan(y)]):
        idx = np.where(y == lvl)[0]
        rng.shuffle(idx)
        out[idx[: int(round(ratio * idx.size))]] = 1.0
    return _new_frame(["test_train_split"], [out])


def _midranks(p: np.ndarray) -> np.ndarray:
    """1-based ranks, ties at their mean rank (scipy's rankdata)."""
    order = np.argsort(p, kind="stable")
    sp = p[order]
    new = np.concatenate([[True], sp[1:] != sp[:-1]])
    gid = np.cumsum(new) - 1
    first = np.flatnonzero(new)
    last = np.append(first[1:], sp.size) - 1
    r = np.empty(p.size)
    r[order] = ((first + last) / 2.0 + 1.0)[gid]
    return r


@prim("perfectAUC")
def _perfect_auc(a, e):
    p = _col0(_f(_eval(a[0], e)))
    y = _col0(_f(_eval(a[1], e)))
    ok = ~(np.isnan(p) | np.isnan(y))
    p, y = p[ok], y[ok]
    r = _midranks(p)
    npos = (y == 1).sum()
    nneg = (y == 0).sum()
    return float((r[y == 1].sum() - npos * (npos + 1) / 2)
                 / max(npos * nneg, 1))


# ===========================================================================
# mungers (prims/mungers): the card's kernels
def _cut_kernel(col, br, nb):
    codes = torch.searchsorted(br, col.contiguous(), right=False) - 1
    bad = (codes < 0) | (codes >= nb) | torch.isnan(col)
    return torch.where(bad, float("nan"), codes.to(torch.float32))


def _fillna_kernel(M, fwd, maxlen):
    """Each NA filled from its column's last valid value (forward) or
    next one (backward) when that lies at most `maxlen` rows away."""
    # columns as rows: a scan along the contiguous dimension runs in
    # parallel on the card (along dim 0 of an (n, 1) matrix it is serial)
    Mi = (M if fwd else torch.flip(M, [0])).t().contiguous()
    n = Mi.shape[1]
    valid = ~torch.isnan(Mi)
    pos = torch.arange(n, device=M.device)[None, :].expand_as(Mi)
    last = torch.cummax(torch.where(valid, pos, -1), dim=1).values
    src = Mi.gather(1, last.clamp(min=0))
    fill = ~valid & (last >= 0) & (pos - last <= maxlen)
    out = torch.where(fill, src, Mi).t()
    return out if fwd else torch.flip(out, [0])


def _rank_kernel(G, S):
    """1-based rank of each row within its group (G's rows) in the order
    of S, ascending; a NaN group value starts a group of its own (NaN !=
    NaN), as in the JAX package."""
    from h2o3_tpu_torch.ops.device_sort import lexsort_rows
    n = G.shape[0]
    order = lexsort_rows(torch.cat([G, S], 1))
    Gs = G.index_select(0, order)
    newg = torch.ones(n, dtype=torch.bool, device=G.device)
    if n > 1:
        newg[1:] = (Gs[1:] != Gs[:-1]).any(dim=1)
    pos = torch.arange(n, device=G.device)
    start = torch.cummax(torch.where(newg, pos, 0), 0).values
    rank_sorted = (pos - start + 1).to(torch.float32)
    return torch.zeros(n, device=G.device).scatter_(0, order, rank_sorted)


def _uniq_sorted(x, size):
    """jnp.unique(sort(x), size=size): the distinct values (NaN once,
    last), padded to `size` with the smallest."""
    fin = x[~torch.isnan(x)]
    u = torch.unique(fin)
    if bool(torch.isnan(x).any()):
        u = torch.cat([u, u.new_full((1,), float("nan"))])
    if u.numel() < size:
        u = torch.cat([u, u[:1].expand(size - u.numel())])
    return u[:size]


def _n_distinct(x) -> int:
    """The JAX package's unique count: sorted neighbours that differ (each
    NaN counts, since NaN != NaN)."""
    s = torch.sort(x).values
    return int((s[1:] != s[:-1]).sum()) + 1 if s.numel() else 0


def _pivot_fill(uniq_i, iv, inv_c, vv, ui, uc):
    inv_i = torch.searchsorted(uniq_i, iv.contiguous()).long()
    cell = inv_i * uc + inv_c.long()
    ok = (cell >= 0) & (cell < ui * uc)
    rows = torch.arange(iv.numel(), device=iv.device)
    last = torch.full((ui * uc,), -1, dtype=torch.long, device=iv.device) \
        .scatter_reduce(0, cell[ok], rows[ok], "amax")
    out = torch.where(last >= 0, vv[last.clamp(min=0)], float("nan"))
    return out.reshape(ui, uc)


@prim("cut")
def _cut(a, e):
    """(cut fr breaks labels include.lowest right digits): AstCut, one
    searchsorted on the card."""
    fr = _f(_eval(a[0], e))
    breaks = [float(b) for b in _eval(a[1], e)]
    col = fr.matrix(fr.names[:1])[:, 0]
    nb = len(breaks) - 1
    br = torch.tensor(breaks, dtype=torch.float32, device=col.device)
    lab = _eval(a[2], e) if len(a) > 2 else None
    if not isinstance(lab, list) or not lab:
        lab = [f"({breaks[i]},{breaks[i+1]}]" for i in range(nb)]
    return _dev_frame(fr.names[:1], [_cut_kernel(col, br, nb)],
                      domains={0: [str(x) for x in lab]})


@prim("h2o.fillna")
def _fillna(a, e):
    """(h2o.fillna fr method axis maxlen): AstFillNA forward or backward,
    every numeric column at once on the card."""
    fr = _f(_eval(a[0], e))
    method = str(_eval(a[1], e)) if len(a) > 1 else "forward"
    maxlen = int(_eval(a[3], e)) if len(a) > 3 else 1
    cols = _numeric_cols(fr)
    out = _fillna_kernel(fr.matrix(cols), method.lower().startswith("f"),
                         maxlen)
    return _dev_frame(cols, [out[:, j] for j in range(len(cols))])


@prim("append")
def _append(a, e):
    fr = _f(_eval(a[0], e))
    col = _eval(a[1], e)
    name = str(_eval(a[2], e)) if len(a) > 2 else "C1"
    if isinstance(col, Frame):
        v = col.vecs[0]
    else:
        v = Vec.from_numpy(np.full(fr.nrows, float(col)))
    return Frame(fr.names + [name], list(fr.vecs) + [v])


@prim("columnsByType")
def _cols_by_type(a, e):
    fr = _f(_eval(a[0], e))
    want = str(_eval(a[1], e)).lower() if len(a) > 1 else "numeric"
    sel = {"numeric": T_NUM, "categorical": T_CAT, "string": T_STR,
           "time": T_TIME}.get(want, T_NUM)
    idx = [float(j) for j, v in enumerate(fr.vecs) if v.type == sel]
    return _new_frame(["C1"], [np.asarray(idx, np.float64)])


@prim("filterNACols")
def _filter_na_cols(a, e):
    fr = _f(_eval(a[0], e))
    frac = float(_eval(a[1], e)) if len(a) > 1 else 0.1
    keep = [float(j) for j, v in enumerate(fr.vecs)
            if np.isnan(_vnp(v)[: fr.nrows]).mean() < frac]
    return _new_frame(["C1"], [np.asarray(keep, np.float64)])


@prim("flatten")
def _flatten(a, e):
    fr = _f(_eval(a[0], e))
    if fr.nrows == 1 and len(fr.vecs) == 1:
        v = fr.vecs[0]
        x = _vnp(v)[0]
        if v.type == T_CAT and not np.isnan(x):
            return v.domain[int(x)]
        return float(x)
    return fr


@prim("naCnt")
def _nacnt(a, e):
    fr = _f(_eval(a[0], e))
    return [float(np.isnan(_vnp(v)[: fr.nrows]).sum()) for v in fr.vecs]


@prim("dropdup", "drop_duplicates")
def _dropdup(a, e):
    fr = _f(_eval(a[0], e))
    M = _mat(fr)
    _, idx = np.unique(M, axis=0, return_index=True)
    idx = np.sort(idx)
    cols = _numeric_cols(fr)
    return _new_frame(cols, [M[idx, j] for j in range(M.shape[1])])


@prim("topn")
def _topn(a, e):
    """(topn fr col nPercent getBottomN): AstTopN."""
    fr = _f(_eval(a[0], e))
    cidx = int(_eval(a[1], e))
    pct = float(_eval(a[2], e)) if len(a) > 2 else 10.0
    bottom = bool(_eval(a[3], e)) if len(a) > 3 else False
    col = _col_np(fr, cidx)[: fr.nrows]
    k = max(1, int(round(fr.nrows * pct / 100.0)))
    order = np.argsort(col, kind="stable")
    if not bottom:
        order = order[::-1]
    pick = order[:k]
    return _new_frame(["Row Indices", fr.names[cidx]],
                      [pick.astype(np.float64), col[pick]])


@prim("relevel")
def _relevel(a, e):
    """(relevel col level): `level` becomes the first domain value."""
    fr = _f(_eval(a[0], e))
    lvl = str(_eval(a[1], e))
    v = fr.vecs[0]
    dom = list(v.domain)
    assert lvl in dom, f"level {lvl} not in domain"
    new_dom = [lvl] + [d for d in dom if d != lvl]
    remap = np.array([new_dom.index(d) for d in dom], np.float64)
    col = _vnp(v)[: fr.nrows]
    out = np.where(np.isnan(col), np.nan,
                   remap[np.nan_to_num(col).astype(int)])
    return _new_frame(fr.names[:1], [out], domains={0: new_dom})


@prim("relevel.by.freq")
def _relevel_freq(a, e):
    fr = _f(_eval(a[0], e))
    v = fr.vecs[0]
    col = _vnp(v)[: fr.nrows]
    dom = list(v.domain)
    cnt = np.zeros(len(dom))
    ok = ~np.isnan(col)
    np.add.at(cnt, col[ok].astype(int), 1)
    order = np.argsort(-cnt, kind="stable")
    new_dom = [dom[i] for i in order]
    remap = np.empty(len(dom), np.float64)
    remap[order] = np.arange(len(dom))
    out = np.where(ok, remap[np.nan_to_num(col).astype(int)], np.nan)
    return _new_frame(fr.names[:1], [out], domains={0: new_dom})


@prim("rename")
def _rename(a, e):
    key_old = _eval(a[0], e)
    key_new = str(_eval(a[1], e))
    fr = key_old if isinstance(key_old, Frame) else DKV.get(str(key_old))
    DKV.put(key_new, fr)
    return fr


@prim("setDomain")
def _set_domain(a, e):
    fr = _f(_eval(a[0], e))
    dom = _eval(a[-1], e)
    return _new_frame(fr.names[:1], [_vnp(fr.vecs[0])[: fr.nrows]],
                      domains={0: [str(d) for d in dom]})


@prim("setLevel")
def _set_level(a, e):
    fr = _f(_eval(a[0], e))
    lvl = str(_eval(a[1], e))
    dom = list(fr.vecs[0].domain)
    return _new_frame(fr.names[:1],
                      [np.full(fr.nrows, float(dom.index(lvl)))],
                      domains={0: dom})


@prim("nlevels")
def _nlevels(a, e):
    v = _f(_eval(a[0], e)).vecs[0]
    return float(len(v.domain) if v.type == T_CAT else 0)


@prim("is.factor")
def _is_factor(a, e):
    fr = _eval(a[0], e)
    return bool(isinstance(fr, Frame) and fr.vecs[0].type == T_CAT)


@prim("is.numeric")
def _is_numeric(a, e):
    fr = _eval(a[0], e)
    return bool(isinstance(fr, Frame)
                and fr.vecs[0].type in (T_NUM, T_TIME))


@prim("is.character")
def _is_character(a, e):
    fr = _eval(a[0], e)
    return bool(isinstance(fr, Frame) and fr.vecs[0].type == T_STR)


@prim("any.factor")
def _any_factor(a, e):
    return bool(any(v.type == T_CAT for v in _f(_eval(a[0], e)).vecs))


@prim("any.na")
def _any_na(a, e):
    fr = _f(_eval(a[0], e))
    return bool(any(bool(torch.isnan(v.as_f32()).any())
                    for v in fr.vecs if v.type != T_STR))


@prim("seq")
def _seq(a, e):
    frm = float(_eval(a[0], e))
    to = float(_eval(a[1], e))
    by = float(_eval(a[2], e)) if len(a) > 2 else 1.0
    return _new_frame(["C1"], [np.arange(frm, to + by * 0.5, by,
                                         dtype=np.float64)])


@prim("seq_len")
def _seq_len(a, e):
    n = int(_eval(a[0], e))
    return _new_frame(["C1"], [np.arange(1, n + 1, dtype=np.float64)])


@prim("rep_len")
def _rep_len(a, e):
    x = _eval(a[0], e)
    n = int(_eval(a[1], e))
    out = np.resize(_col0(x), n) if isinstance(x, Frame) \
        else np.full(n, float(x))
    return _new_frame(["C1"], [out.astype(np.float64)])


@prim("which")
def _which(a, e):
    col = _col0(_f(_eval(a[0], e)))
    idx = np.where(np.nan_to_num(col) != 0)[0]
    return _new_frame(["C1"], [idx.astype(np.float64)])


@prim("which.max")
def _which_max(a, e):
    M = _mat(_f(_eval(a[0], e)))
    return _new_frame(["which.max"],
                      [np.nanargmax(M, axis=1).astype(np.float64)])


@prim("which.min")
def _which_min(a, e):
    M = _mat(_f(_eval(a[0], e)))
    return _new_frame(["which.min"],
                      [np.nanargmin(M, axis=1).astype(np.float64)])


@prim("t")
def _transpose(a, e):
    M = _mat(_f(_eval(a[0], e))).T
    return _new_frame([f"C{j+1}" for j in range(M.shape[1])],
                      [M[:, j] for j in range(M.shape[1])])


@prim("sumaxis")
def _sumaxis(a, e):
    fr = _f(_eval(a[0], e))
    na_rm = bool(_eval(a[1], e)) if len(a) > 1 else True
    axis = int(_eval(a[2], e)) if len(a) > 2 else 0
    M = _mat(fr)
    s = np.nansum(M, axis=axis) if na_rm else M.sum(axis=axis)
    if axis == 0:
        return _new_frame(_numeric_cols(fr), [np.asarray([v]) for v in s])
    return _new_frame(["sum"], [s])


@prim("melt")
def _melt(a, e):
    """(melt fr id_vars value_vars var_name value_name skipna): AstMelt,
    wide to long on the card (string id columns tiled on the host)."""
    fr = _f(_eval(a[0], e))
    idv = _eval(a[1], e)
    valv = _eval(a[2], e) if len(a) > 2 else None
    var_name = str(_eval(a[3], e)) if len(a) > 3 else "variable"
    value_name = str(_eval(a[4], e)) if len(a) > 4 else "value"
    idv = [fr.names[int(i)] for i in idv] if isinstance(idv, list) else []
    if isinstance(valv, list) and valv:
        valv = [fr.names[int(i)] for i in valv]
    else:
        valv = [c for c in fr.names if c not in idv]
    n = fr.nrows
    nv = len(valv)
    names = idv + [var_name, value_name]
    doms = {len(idv): valv}
    vecs = []
    for c in idv:
        v = fr.vec(c)
        if v.type == T_STR:
            vecs.append(Vec.from_numpy(np.tile(v.host_data[:n], nv),
                                       type=T_STR))
        else:
            vecs.append(Vec.from_tensor(
                torch.tile(v.as_f32(), (nv,)),
                T_CAT if v.domain is not None else T_NUM,
                list(v.domain) if v.domain is not None else None))
    dev = fr.vecs[0].device
    var = torch.repeat_interleave(
        torch.arange(nv, dtype=torch.float32, device=dev), n)
    val = torch.cat([fr.vec(c).as_f32() for c in valv])
    vecs.append(Vec.from_tensor(var, T_CAT, doms[len(idv)]))
    vecs.append(Vec.from_tensor(val, T_NUM))
    return Frame(names, vecs)


@prim("pivot")
def _pivot(a, e):
    """(pivot fr index column value): AstPivot, long to wide on the card
    (only the unique counts and the column labels reach the host). Two
    rows on one cell: the later row's value stays."""
    fr = _f(_eval(a[0], e))
    index = str(_eval(a[1], e))
    column = str(_eval(a[2], e))
    value = str(_eval(a[3], e))
    n = fr.nrows
    if fr.vec(index).type == T_STR or fr.vec(column).type == T_STR:
        # string keys: the host, as in the JAX package
        iv = _vnp(fr.vec(index))[:n]
        cv = _vnp(fr.vec(column))[:n]
        vv = _vnp(fr.vec(value))[:n]
        uniq_i, inv_i = np.unique(iv, return_inverse=True)
        uniq_c, inv_c = np.unique(cv, return_inverse=True)
        out = np.full((uniq_i.size, uniq_c.size), np.nan)
        out[inv_i, inv_c] = vv
        names = [index] + [str(c) for c in uniq_c]
        arrays = [uniq_i if iv.dtype == object
                  else uniq_i.astype(np.float64)] + \
            [out[:, j] for j in range(uniq_c.size)]
        return _new_frame(names, arrays)
    iv = fr.vec(index).as_f32()
    cv = fr.vec(column).as_f32()
    vv = fr.vec(value).as_f32()
    ui = _n_distinct(iv)                        # scalar readbacks only
    uniq_i = _uniq_sorted(iv, ui)
    cdom = fr.vec(column).domain
    if cdom is not None and len(cdom):
        uc = len(cdom)
        labels = list(cdom)
        inv_c = torch.nan_to_num(cv).to(torch.int32)
    else:
        uc = _n_distinct(cv)
        uniq_c = _uniq_sorted(cv, uc)
        labels = [str(float(x)) for x in uniq_c.cpu().numpy()]
        inv_c = torch.searchsorted(uniq_c, cv.contiguous()).to(torch.int32)
    out = _pivot_fill(uniq_i, iv, inv_c, vv, ui, uc)
    return _dev_frame([index] + labels,
                      [uniq_i] + [out[:, j] for j in range(uc)])


@prim("rank_within_groupby")
def _rank_within(a, e):
    """(rank_within_groupby fr groupby_cols sort_cols sort_orders
    new_colname sort_cols_sorted): AstRankWithinGroupBy, on the card.
    Every sort column ascends: `sort_orders` is read and not used, as in
    the JAX package. The frame's columns are reused, only the rank is
    new."""
    fr = _f(_eval(a[0], e))
    gcols = [int(i) for i in _eval(a[1], e)]
    scols = [int(i) for i in _eval(a[2], e)]
    new_col = str(_eval(a[4], e)) if len(a) > 4 else "New_Rank_column"
    G = fr.matrix([fr.names[j] for j in gcols])
    S = fr.matrix([fr.names[j] for j in scols])
    return Frame(fr.names + [new_col],
                 list(fr.vecs) + [Vec.from_tensor(_rank_kernel(G, S))])


@prim("ddply")
def _ddply(a, e):
    """(ddply fr [group cols] fun): a lambda over each group's rows (a
    frame of them), one value a group, groups in sorted key order."""
    fr = _f(_eval(a[0], e))
    gcols = [int(i) for i in _eval(a[1], e)]
    fun = a[2] if isinstance(a[2], tuple) else _eval(a[2], e)
    if not (isinstance(fun, tuple) and fun[0] == "lambda"):
        raise ValueError(f"ddply takes a lambda, got {fun!r}")
    n = fr.nrows
    gkey = np.stack([_col_np(fr, j)[:n] for j in gcols], 1)
    uniq, inv = np.unique(gkey, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    cols = [_vnp(v)[:n] for v in fr.vecs]
    results = []
    for g in range(uniq.shape[0]):
        mask = inv == g
        sub = _new_frame(fr.names, [c[mask] for c in cols])
        val = _apply_lambda(fun, [sub], e)
        results.append(float(val if not isinstance(val, Frame)
                             else _col0(val)[0]))
        DKV.remove(sub.key)
    arrays = [uniq[:, k].astype(np.float64)
              for k in range(uniq.shape[1])] + \
        [np.asarray(results, np.float64)]
    return _new_frame([fr.names[j] for j in gcols] + ["ddply_C1"], arrays)


# ===========================================================================
# string (prims/string)
def _str_col(fr):
    v = fr.vecs[0]
    if v.type == T_STR:
        return np.asarray(v.host_data, object), None
    assert v.type == T_CAT
    col = _vnp(v)[: fr.nrows]
    dom = np.asarray(v.domain, object)
    out = np.where(np.isnan(col), None,
                   dom[np.nan_to_num(col).astype(int)])
    return out, list(v.domain)


@prim("lstrip")
def _lstrip(a, e):
    fr = _f(_eval(a[0], e))
    chars = str(_eval(a[1], e)) if len(a) > 1 else None
    s, _ = _str_col(fr)
    out = np.array([x.lstrip(chars) if x is not None else None
                    for x in s], object)
    return _new_frame(fr.names[:1], [out])


@prim("rstrip")
def _rstrip(a, e):
    fr = _f(_eval(a[0], e))
    chars = str(_eval(a[1], e)) if len(a) > 1 else None
    s, _ = _str_col(fr)
    out = np.array([x.rstrip(chars) if x is not None else None
                    for x in s], object)
    return _new_frame(fr.names[:1], [out])


@prim("entropy")
def _entropy(a, e):
    fr = _f(_eval(a[0], e))
    s, _ = _str_col(fr)
    out = np.empty(len(s), np.float64)
    for i, x in enumerate(s):
        if not x:
            out[i] = np.nan if x is None else 0.0
            continue
        _, cnt = np.unique(list(x), return_counts=True)
        p = cnt / cnt.sum()
        out[i] = float(-(p * np.log2(p)).sum())
    return _new_frame(fr.names[:1], [out])


@prim("grep")
def _grep(a, e):
    """(grep fr regex ignore_case invert output_logical): AstGrep."""
    fr = _f(_eval(a[0], e))
    pattern = str(_eval(a[1], e))
    ignore_case = bool(_eval(a[2], e)) if len(a) > 2 else False
    invert = bool(_eval(a[3], e)) if len(a) > 3 else False
    logical = bool(_eval(a[4], e)) if len(a) > 4 else False
    s, _ = _str_col(fr)
    rx = re.compile(pattern, re.IGNORECASE if ignore_case else 0)
    hit = np.array([bool(rx.search(x)) if x is not None else False
                    for x in s])
    if invert:
        hit = ~hit
    if logical:
        return _new_frame(["C1"], [hit.astype(np.float64)])
    return _new_frame(["C1"], [np.where(hit)[0].astype(np.float64)])


@prim("strDistance")
def _str_distance(a, e):
    """(strDistance fr1 fr2 measure compare_empty): Levenshtein or the
    Jaccard distance of the character sets."""
    s1, _ = _str_col(_f(_eval(a[0], e)))
    s2, _ = _str_col(_f(_eval(a[1], e)))
    measure = str(_eval(a[2], e)) if len(a) > 2 else "lv"
    out = np.empty(len(s1), np.float64)
    for i in range(len(s1)):
        x, y = s1[i], s2[i % len(s2)]
        if x is None or y is None:
            out[i] = np.nan
        elif measure in ("lv", "levenshtein"):
            out[i] = _lev(x, y)
        else:
            sx, sy = set(x), set(y)
            out[i] = 1.0 - len(sx & sy) / max(len(sx | sy), 1)
    return _new_frame(["C1"], [out])


def _lev(x, y):
    m, n = len(x), len(y)
    if m == 0 or n == 0:
        return float(max(m, n))
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (x[i - 1] != y[j - 1]))
        prev = cur
    return float(prev[n])


@prim("tokenize")
def _tokenize(a, e):
    fr = _f(_eval(a[0], e))
    split = str(_eval(a[1], e)) if len(a) > 1 else "\\s+"
    s, _ = _str_col(fr)
    toks = []
    for x in s:
        if x is not None:
            toks += [t for t in re.split(split, x) if t]
        toks.append(None)          # the NA row between sentences
    return _new_frame(["C1"], [np.asarray(toks, object)])


@prim("num_valid_substrings")
def _num_valid_sub(a, e):
    fr = _f(_eval(a[0], e))
    words_path = _eval(a[1], e)
    words = set()
    try:
        with open(str(words_path)) as fh:
            words = {w.strip() for w in fh}
    except OSError:
        pass
    s, _ = _str_col(fr)
    out = np.empty(len(s), np.float64)
    for i, x in enumerate(s):
        if x is None:
            out[i] = np.nan
            continue
        out[i] = sum(x[lo:hi] in words for lo in range(len(x))
                     for hi in range(lo + 1, len(x) + 1))
    return _new_frame(["C1"], [out])


# ===========================================================================
# time (prims/time)
@prim("mktime")
def _mktime(a, e):
    """(mktime year month day hour minute second msec): ms since the
    epoch; month and day are 0-based, as in AstMktime."""
    parts = [_eval(x, e) for x in a]

    def arr(x, default):
        if isinstance(x, Frame):
            return _col0(x)
        return np.asarray([float(x if x is not None else default)])

    cols = [arr(p, 0) for p in parts]
    n = max(len(c) for c in cols)
    cols = [np.resize(c, n) for c in cols]
    while len(cols) < 7:
        cols.append(np.zeros(n))
    out = np.empty(n, np.float64)
    for i in range(n):
        y, mo, d, h, mi, s, ms = (int(c[i]) for c in cols[:7])
        dt = datetime(y, mo + 1, d + 1, h, mi, s, ms * 1000,
                      tzinfo=timezone.utc)
        out[i] = dt.timestamp() * 1000.0
    return _new_frame(["mktime"], [out])


@prim("moment")
def _moment(a, e):
    return _mktime(a, e)


@prim("millis")
def _millis(a, e):
    fr = _f(_eval(a[0], e))
    return _new_frame(fr.names[:1], [_col0(fr) * 1.0])


@prim("week")
def _week(a, e):
    fr = _f(_eval(a[0], e))
    out = np.array(
        [float(datetime.fromtimestamp(float(x) / 1000.0,
                                      tz=timezone.utc).isocalendar()[1])
         if not np.isnan(x) else np.nan for x in _col0(fr)])
    return _new_frame(fr.names[:1], [out])


@prim("as.Date")
def _as_date(a, e):
    fr = _f(_eval(a[0], e))
    fmt = str(_eval(a[1], e)) if len(a) > 1 else "%Y-%m-%d"
    # Java's time patterns as strptime's
    pyfmt = (fmt.replace("yyyy", "%Y").replace("MM", "%m")
             .replace("dd", "%d").replace("HH", "%H")
             .replace("mm", "%M").replace("ss", "%S"))
    s, _ = _str_col(fr)
    out = np.empty(len(s), np.float64)
    for i, x in enumerate(s):
        try:
            out[i] = datetime.strptime(x, pyfmt) \
                .replace(tzinfo=timezone.utc).timestamp() * 1000.0
        except (TypeError, ValueError):
            out[i] = np.nan
    return _new_frame(fr.names[:1], [out], types={0: T_TIME})


_TZ = ["UTC"]


@prim("getTimeZone")
def _get_tz(a, e):
    return _TZ[0]


@prim("setTimeZone")
def _set_tz(a, e):
    _TZ[0] = str(_eval(a[0], e))
    return _TZ[0]


@prim("listTimeZones")
def _list_tz(a, e):
    import zoneinfo
    zs = sorted(zoneinfo.available_timezones())
    return _new_frame(["Timezones"], [np.asarray(zs, object)])


# ===========================================================================
# reducers (the NA-counting forms) and misc
@prim("maxNA")
def _max_na(a, e):
    return _reduce_op(a, e, lambda A, live:
                      torch.where(live, A, -math.inf).max())


@prim("minNA")
def _min_na(a, e):
    return _reduce_op(a, e, lambda A, live:
                      torch.where(live, A, math.inf).min())


@prim("sumNA")
def _sum_na(a, e):
    return _reduce_op(a, e, lambda A, live: torch.where(live, A, 0.0).sum())


@prim("prod.na")
def _prod_na(a, e):
    return _reduce_op(a, e, lambda A, live:
                      torch.where(live, A, 1.0).prod())


@prim("match")
def _match(a, e):
    """(match fr table nomatch start_index): AstMatch."""
    fr = _f(_eval(a[0], e))
    table = _eval(a[1], e)
    nomatch = _eval(a[2], e) if len(a) > 2 else float("nan")
    start = int(_eval(a[3], e)) if len(a) > 3 else 1
    v = fr.vecs[0]
    table = table if isinstance(table, list) else [table]
    col = _vnp(v)[: fr.nrows]
    out = np.full(fr.nrows, np.nan)
    if v.type == T_CAT:
        lut = {lvl: i for i, lvl in enumerate(v.domain)}
        for rank, c in enumerate(lut.get(str(t), -1) for t in table):
            if c >= 0:
                out[col == c] = rank + start
    else:
        for rank, t in enumerate(float(t) for t in table):
            out[col == t] = rank + start
    if not (isinstance(nomatch, float) and math.isnan(nomatch)):
        out = np.where(np.isnan(out), float(nomatch), out)
    return _new_frame(fr.names[:1], [out])


@prim("ls")
def _ls(a, e):
    return _new_frame(["key"], [np.asarray(sorted(DKV.keys()), object)])


@prim("comma")
def _comma(a, e):
    out = None
    for x in a:
        out = _eval(x, e)
    return out


# ===========================================================================
# the last of the table (ast/prims to the whole registry)
PRIMS["%%"] = PRIMS["%"]          # AstMod's other name
PRIMS[","] = PRIMS["comma"]       # AstComma


@prim("none")
def _noop(a, e):
    """AstNoOp: the identity."""
    return _eval(a[0], e) if a else 0.0


@prim("assign")
def _assign_global(a, e):
    """AstAssign: a global key <- a copy of the frame (types read from
    the copy, as in the JAX package: a time column comes back numeric)."""
    key = a[0] if isinstance(a[0], str) else str(_eval(a[0], e))
    src = _eval(a[1], e)
    f = _new_frame(list(src.names),
                   [_vnp(src.vecs[j])[: src.nrows]
                    for j in range(src.ncols)],
                   domains={j: src.vecs[j].levels()
                            for j in range(src.ncols)
                            if src.vecs[j].type == T_CAT})
    DKV.remove(f.key)
    f.key = key
    DKV.put(key, f)
    e.session.register(key)
    return f


@prim("x")
def _mmult(a, e):
    """AstMMult: (x fr1 fr2), the matrix product on the card."""
    f1 = _eval(a[0], e)
    f2 = _eval(a[1], e)
    out = torch.matmul(f1.matrix(_numeric_cols(f1)),
                       f2.matrix(_numeric_cols(f2)))
    return _dev_frame([f"C{j+1}" for j in range(out.shape[1])],
                      [out[:, j] for j in range(out.shape[1])])


@prim("scale_inplace")
def _scale_inplace(a, e):
    """AstScaleInPlace: `scale` written back under the key the frame was
    looked up by (and under its own key where that differs)."""
    f = _eval(a[0], e)
    key = a[0] if isinstance(a[0], str) and DKV.get(a[0]) is f else f.key
    out = PRIMS["scale"](a, e)
    DKV.remove(out.key)
    out.key = key
    DKV.put(key, out)
    if f.key != key and DKV.get(f.key) is f:
        DKV.put(f.key, out)
    return out


@prim("setproperty")
def _setproperty(a, e):
    """AstSetProperty: a runtime property (`ai.h2o.` names too)."""
    from h2o3_tpu_torch.utils import config as _cfg
    value = _eval(a[1], e)
    _cfg.set_property(str(_eval(a[0], e)), value)
    return str(value)


@prim("model.reset.threshold")
def _reset_threshold(a, e):
    """AstModelResetThreshold: a binomial model's decision threshold set;
    the old one returned."""
    m = _eval(a[0], e)
    thr = float(_eval(a[1], e))
    old = getattr(m, "_default_threshold", 0.5)
    m._default_threshold = thr
    DKV.put(m.key, m)
    return float(old)


@prim("segment_models_as_frame")
def _segment_models_as_frame(a, e):
    """AstSegmentModelsAsFrame: a row a segment, its segment columns, its
    model key, status and error."""
    rows = _eval(a[0], e).as_list()
    seg_names = sorted({k for r in rows for k in r["segment"]})
    cols, names = [], []
    for sn in seg_names:
        names.append(sn)
        cols.append(np.asarray([r["segment"].get(sn) for r in rows],
                               object))
    for field in ("model", "status"):
        names.append(field if field != "model" else "model_id")
        cols.append(np.asarray([r.get(field) or "" for r in rows], object))
    names.append("errors")
    cols.append(np.asarray([r.get("error") or "" for r in rows], object))
    types = [T_NUM if np.asarray(c).dtype.kind in "fi" else T_STR
             for c in cols]
    cols = [c if t == T_NUM else np.asarray([str(x) for x in c], object)
            for c, t in zip(cols, types)]
    return _new_frame(names, cols, types=types)


@prim("PermutationVarImp")
def _perm_varimp(a, e):
    """AstPermutationVarImp: waits for the port of explain_data.py."""
    raise NotImplementedError(
        "PermutationVarImp needs explain_data.py, not yet ported "
        "(ROADMAP.md, queue 1 item 10)")


@prim("grouped_permute")
def _grouped_permute(a, e):
    """AstGroupedPermute: for each group-by value, the cross product of
    the 'D' rows and the 'C' rows of permuteBy (a 2-level categorical),
    amounts summed by permCol id: group columns, In, Out, InAmnt,
    OutAmnt."""
    fr = _eval(a[0], e)
    perm_col = int(_eval(a[1], e))
    gb = _eval(a[2], e)
    gb_cols = [int(g) for g in (gb if isinstance(gb, list) else [gb])]
    permute_by = int(_eval(a[3], e))
    keep_col = int(_eval(a[4], e))
    n = fr.nrows
    gid = _vnp(fr.vecs[gb_cols[0]])[:n]
    rid = _vnp(fr.vecs[perm_col])[:n]
    typ_codes = _vnp(fr.vecs[permute_by])[:n]
    dom = fr.vecs[permute_by].levels() or []
    is_d = np.asarray([dom[int(t)] == "D" if t == t and dom else int(t) == 0
                       for t in typ_codes])
    amt = _vnp(fr.vecs[keep_col])[:n]
    groups: dict = {}
    for i in range(n):
        g = groups.setdefault(gid[i], [{}, {}])
        side = 0 if is_d[i] else 1
        g[side][rid[i]] = g[side].get(rid[i], 0.0) + float(amt[i])
    out = [[] for _ in range(len(gb_cols) + 4)]
    for g, (dd, cc) in sorted(groups.items()):
        for rd, ad in sorted(dd.items()):
            for rc, ac in sorted(cc.items()):
                out[0].append(g)
                out[-4].append(rd)
                out[-3].append(rc)
                out[-2].append(ad)
                out[-1].append(ac)
    names = [fr.names[g] for g in gb_cols] + \
        ["In", "Out", "InAmnt", "OutAmnt"]
    doms = {0: fr.vecs[gb_cols[0]].levels(),
            len(gb_cols): fr.vecs[perm_col].levels(),
            len(gb_cols) + 1: fr.vecs[perm_col].levels()}
    doms = {k: v for k, v in doms.items() if v}
    return _new_frame(names, [np.asarray(c, np.float64) for c in out],
                      domains=doms)


def _paa(A, num_words):
    """Each row z-normalised (population sd), then the means of
    `num_words` equal segments (the last padded with NaN), NaN-aware."""
    def nanmean(x, dim):
        ok = ~torch.isnan(x)
        return torch.where(ok, x, 0.0).sum(dim, keepdim=True) \
            / ok.sum(dim, keepdim=True)
    nts, T = A.shape
    mu = nanmean(A, 1)
    sd = torch.sqrt(nanmean((A - mu) ** 2, 1))
    Z = (A - mu) / torch.where(sd > 0, sd, 1.0)
    k = -(-T // num_words)
    pad = torch.full((nts, k * num_words - T), float("nan"),
                     device=A.device)
    seg = torch.cat([Z, pad], 1).reshape(nts, num_words, k)
    return nanmean(seg, 2)[..., 0]


@prim("isax")
def _isax(a, e):
    """AstIsax: iSAX 2.0 over rows as time series, PAA into numWords
    segments symbolised against N(0,1) breakpoints up to maxCardinality:
    an iSax_index string and numWords symbol columns."""
    fr = _eval(a[0], e)
    num_words = int(_eval(a[1], e))
    max_card = int(_eval(a[2], e))
    if num_words <= 0 or max_card <= 0:
        raise ValueError("numWords and maxCardinality must be > 0")
    W = _paa(fr.matrix(_numeric_cols(fr)), num_words).cpu().numpy() \
        .astype(np.float64)
    from h2o3_tpu_torch.utils.stats import norm_ppf
    card = max(2, min(int(max_card), 64))
    bps = np.asarray([norm_ppf((i + 1) / card) for i in range(card - 1)])
    sym = np.stack([np.searchsorted(bps, W[:, j])
                    for j in range(num_words)], axis=1)
    idx = np.asarray(["^".join(str(int(s)) for s in row) for row in sym],
                     object)
    names = ["iSax_index"] + [f"c{j}" for j in range(num_words)]
    cols = [idx] + [sym[:, j].astype(np.float64) for j in range(num_words)]
    return _new_frame(names, cols, types=[T_STR] + [T_NUM] * num_words)


@prim("tf-idf")
def _tf_idf(a, e):
    """AstTfIdf: (tf-idf frame doc_id_idx text_idx preprocess
    case_sensitive) -> DocID, Word, TF, IDF, TF-IDF."""
    fr = _eval(a[0], e)
    doc_idx = int(_eval(a[1], e))
    txt_idx = int(_eval(a[2], e))
    preprocess = bool(_eval(a[3], e)) if len(a) > 3 else True
    case_sensitive = bool(_eval(a[4], e)) if len(a) > 4 else False
    n = fr.nrows
    docs = _vnp(fr.vecs[doc_idx])[:n]
    tv = fr.vecs[txt_idx]
    if tv.type == T_STR:
        txt = tv.to_numpy()[:n]
    elif tv.type == T_CAT:
        dom = tv.levels()
        txt = [dom[int(c)] if c == c else None for c in _vnp(tv)[:n]]
    else:
        raise ValueError("tf-idf text column must be string/categorical")
    pairs = []
    for d, t in zip(docs, txt):
        s = str(t) if t is not None else ""
        if not case_sensitive:
            s = s.lower()
        for w in (s.split() if preprocess else [s]):
            if w:
                pairs.append((float(d), w))
    if not pairs:
        raise ValueError("Empty input frame provided.")
    tf: dict = {}
    for d, w in pairs:
        tf[(d, w)] = tf.get((d, w), 0) + 1
    n_docs = len(set(d for d, _ in pairs))
    dfreq: dict = {}
    for (d, w) in tf:
        dfreq[w] = dfreq.get(w, 0) + 1
    rows = sorted(tf.items(), key=lambda kv: (kv[0][1], kv[0][0]))
    doc_c = np.asarray([d for (d, w), _ in rows])
    word_c = np.asarray([w for (d, w), _ in rows], object)
    tf_c = np.asarray([c for _, c in rows], np.float64)
    idf_c = np.asarray([math.log((n_docs + 1.0) / (dfreq[w] + 1.0))
                        for (_, w), _ in rows], np.float64)
    return _new_frame(["DocID", "Word", "TF", "IDF", "TF-IDF"],
                      [doc_c, word_c, tf_c, idf_c, tf_c * idf_c],
                      types=[T_NUM, T_STR, T_NUM, T_NUM, T_NUM])


@prim("run_tool")
def _run_tool(a, e):
    """AstRunTool: a registered maintenance tool by name."""
    from h2o3_tpu_torch.utils.tools import run_tool as _rt
    name = str(_eval(a[0], e))
    return _rt(name, [_eval(x, e) for x in a[1:]])
