"""Rapids, the Lisp-like frame expression language of the port
(h2o3_tpu/rapids/rapids.py; water/rapids/Rapids.java, Session.java,
ast/AstExec.java and ast/prims/**).

H2O's clients compile every frame expression to this grammar and send it
to /99/Rapids, so the same grammar is what makes a client work:

  expr := (op args…) | number | "str" | 'str' | id | %id | [num…]
        | {args . body}

with assignments (tmp= key expr) and (rm key).

Evaluation follows the JAX package prim for prim. Element-wise operators,
math, reducers, `ifelse` and `scale` run as torch ops on the frame's
columns on the card (scalars in f32, as `jnp.float32` computes them, so
`(+ 1 0.1)` is 1.100000023841858); sort, group-by and merge go through
`ops/device_sort.py`. Where the JAX package computes in host numpy it
does here too, on the same f32 values (`Vec.to_numpy` there is f32), so
those prims give its bits. Some results the JAX package sends through
host numpy stay on the card here with the same values: element-wise
results, row selections (`rows`, `na.omit`, a sort by string keys), and
the group-by of other aggregates (`median`, `mode`) or of string keys,
which sorts each group's values on the card instead of scanning the rows
once a group; its groups come in the JAX package's order (Python's
`sorted` of the key tuples). Its NA keys form one group, last (the JAX
package makes each NA-key row a group of its own, in an order its sort
leaves undefined), and its float aggregates are float64 sums rounded to
f32 (the JAX package sums the f32 values pairwise in f32).

Right and outer joins, and joins on string keys or with an empty side,
are the port's own (`device_sort.merge_frames_pandas`): the JAX package
hands them to pandas, which the card's machine does not have.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, Vec, T_CAT, T_NUM, T_STR, \
    T_UUID
from h2o3_tpu_torch.core.kvstore import DKV


# ===========================================================================
# Parser (Rapids.java)
class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1
        return self.s[self.i] if self.i < len(self.s) else ""

    def parse(self):
        c = self.peek()
        if c == "(":
            return self._list(")")
        if c == "[":
            return self._numlist()
        if c == "{":
            return self._fun()
        if c in "\"'":
            return self._string(c)
        return self._token()

    def _list(self, close):
        self.i += 1
        out = []
        while self.peek() != close:
            if not self.peek():
                raise ValueError("unterminated expression")
            out.append(self.parse())
        self.i += 1
        return out

    def _numlist(self):
        self.i += 1
        out = []
        while self.peek() != "]":
            if not self.peek():
                raise ValueError("unterminated [...] list")
            if self.peek() in "\"'":
                # string lists share the bracket syntax, as in
                # (countmatches col ["o"])
                out.append(self._string(self.peek())[1])
                continue
            tok = self._token()
            if isinstance(tok, str) and ":" in tok:   # a:b span
                a, b = tok.split(":")
                out.append(("span", float(a), float(b)))
            else:
                out.append(tok)
        self.i += 1
        return ("numlist", out)

    def _fun(self):
        self.i += 1
        parts = []
        while self.peek() != "}":
            parts.append(self.parse())
        self.i += 1
        # {arg1 arg2 . body}
        if "." in parts:
            dot = parts.index(".")
            return ("lambda", parts[:dot], parts[dot + 1])
        return ("lambda", parts[:-1], parts[-1])

    def _string(self, q):
        self.i += 1
        out = []
        while self.i < len(self.s) and self.s[self.i] != q:
            ch = self.s[self.i]
            if ch == "\\":
                self.i += 1
                if self.i >= len(self.s):
                    break
                ch = self.s[self.i]
            out.append(ch)
            self.i += 1
        if self.i >= len(self.s):
            raise ValueError("unterminated string literal")
        self.i += 1
        return ("str", "".join(out))

    def _token(self):
        self.peek()
        start = self.i
        while self.i < len(self.s) and not self.s[self.i].isspace() \
                and self.s[self.i] not in "()[]{}\"'":
            self.i += 1
        tok = self.s[start:self.i]
        if tok in ("True", "TRUE", "true"):
            return 1.0
        if tok in ("False", "FALSE", "false"):
            return 0.0
        if tok in ("NA", "NaN", "nan"):
            return float("nan")
        if tok.startswith("#"):          # the classic grammar's numbers
            try:
                return float(tok[1:])
            except ValueError:
                pass
        if tok.startswith("%") and len(tok) > 1 and \
                re.fullmatch(r"[A-Za-z_][A-Za-z0-9_.\-]*", tok[1:]):
            return tok[1:]       # the classic %id prefix ('%/%' is an op)
        try:
            return float(tok)
        except ValueError:
            return tok


def parse(expr: str):
    return _Parser(expr).parse()


# ===========================================================================
class Session:
    """A client's session: the temps it made, removed at its end
    (rapids/Session.java)."""

    def __init__(self, session_id: str = "default"):
        self.id = session_id
        self.tmps: set = set()

    def register(self, key: str):
        self.tmps.add(key)

    def end(self):
        for k in self.tmps:
            DKV.remove(k)
        self.tmps.clear()


_default_session = Session()


# ===========================================================================
# Evaluation
class Env:
    def __init__(self, session: Session):
        self.session = session
        self.locals: dict = {}


def rapids_exec(expr: str, session: Optional[Session] = None):
    """Rapids.exec: parse and evaluate; a float, str, Frame or list."""
    session = session or _default_session
    return _eval(parse(expr), Env(session))


def _eval(ast, env: Env):
    if isinstance(ast, float):
        return ast
    if isinstance(ast, tuple):
        if ast[0] == "str":
            return ast[1]
        if ast[0] == "numlist":
            return _expand_numlist(ast[1])
        if ast[0] == "lambda":
            return ast
        if ast[0] == "span":
            return list(np.arange(ast[1], ast[2] + 1))
    if isinstance(ast, str):
        if ast in env.locals:
            return env.locals[ast]
        obj = DKV.get(ast)
        if obj is not None:
            return obj
        return ast  # a bare symbol (a column name)
    if isinstance(ast, list):
        op = ast[0]
        if isinstance(op, (tuple, list)):
            op = _eval(op, env)
        if isinstance(op, tuple) and op[0] == "lambda":
            return _apply_lambda(op, [_eval(a, env) for a in ast[1:]], env)
        fn = PRIMS.get(op)
        if fn is None:
            raise ValueError(f"unknown Rapids op: {op!r}")
        return fn(ast[1:], env)
    raise ValueError(f"cannot evaluate {ast!r}")


def _expand_numlist(items):
    out = []
    for it in items:
        if isinstance(it, tuple) and it[0] == "span":
            out.extend(np.arange(it[1], it[2] + 1).tolist())
        else:
            out.append(it)
    return out


def _apply_lambda(lam, args, env: Env):
    _, params, body = lam
    sub = Env(env.session)
    sub.locals = dict(env.locals)
    for p, a in zip(params, args):
        sub.locals[p] = a
    return _eval(body, sub)


# ===========================================================================
# helpers
def _as_frame(v) -> Frame:
    if isinstance(v, Frame):
        return v
    if isinstance(v, (int, float)):
        return Frame(["C1"], [Vec.from_numpy(np.array([float(v)]))])
    raise TypeError(f"expected frame, got {type(v)}")


def _numeric_cols(f: Frame):
    return [n for n, v in zip(f.names, f.vecs) if v.type != T_STR]


def _vnp(v) -> np.ndarray:
    """A column on the host as the JAX package's `Vec.to_numpy` gives
    it: f32 values with NaN for NA, or the strings."""
    if v.type in (T_STR, T_UUID):
        return v.to_numpy()
    return v.as_f32().cpu().numpy()


def _col_np(f: Frame, j=0) -> np.ndarray:
    return _vnp(f.vecs[j])


def _frame_np(f: Frame) -> np.ndarray:
    """`Frame.to_numpy` of the JAX package: its columns side by side."""
    return np.column_stack([_vnp(v) for v in f.vecs])


def _select(f: Frame, idx) -> Frame:
    """Columns by position (a duplicated name keeps its own column)."""
    return Frame([f.names[i] for i in idx], [f.vecs[i] for i in idx])


def _new_frame(names, arrays, types=None, domains=None) -> Frame:
    """A Frame from host columns: object arrays are strings, a column with
    a domain categorical, the rest numeric. `types` is read as a dict
    only, as in the JAX package (a list is ignored)."""
    vecs = []
    for i, a in enumerate(arrays):
        t = (types or {}).get(i) if isinstance(types, dict) else None
        d = (domains or {}).get(i) if isinstance(domains, dict) else None
        if a.dtype == object:
            vecs.append(Vec.from_numpy(a, type=t or T_STR))
        elif d is not None:
            a = np.asarray(a, np.float64)
            mask = np.isnan(a)
            vecs.append(Vec._from_floats(np.where(mask, 0, a), mask, T_CAT,
                                         np.asarray(d, object)))
        else:
            vecs.append(Vec.from_numpy(a))
    return Frame(list(names), vecs)


def _dev_frame(names, cols, types=None, domains=None) -> Frame:
    """A Frame from f32 columns on the card (NaN = NA), no host round
    trip: categorical where a domain is given."""
    vecs = []
    for i, col in enumerate(cols):
        t = (types or {}).get(i)
        d = (domains or {}).get(i)
        vecs.append(Vec.from_tensor(col, t or (T_CAT if d is not None
                                               else T_NUM), d))
    return Frame(list(names), vecs)


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def _broadcast_op(args, env, fn):
    """An element-wise binary op over frames and scalars, on the card."""
    a = _eval(args[0], env)
    b = _eval(args[1], env)
    fa, fb = isinstance(a, Frame), isinstance(b, Frame)
    if not fa and not fb:
        return float(fn(_f32(a), _f32(b)))
    base = a if fa else b
    dev = base.vecs[0].device

    def get(x):
        if isinstance(x, Frame):
            return x.matrix(_numeric_cols(x))
        return _f32(x).to(dev)

    out = fn(get(a), get(b)).to(torch.float32)
    return _dev_frame(base.names, [out[:, j] for j in range(out.shape[1])])


def _unary_op(args, env, fn):
    a = _eval(args[0], env)
    if not isinstance(a, Frame):
        return float(fn(_f32(a)))
    out = fn(a.matrix(_numeric_cols(a))).to(torch.float32)
    return _dev_frame(a.names, [out[:, j] for j in range(out.shape[1])])


def _reduce_op(args, env, fn):
    """A whole-frame reducer on the card, fn(A, live) over its numeric
    columns (every row is live: the port pads no rows)."""
    a = _eval(args[0], env)
    A = a.matrix(_numeric_cols(a))
    return float(fn(A, torch.ones_like(A, dtype=torch.bool)))


# ===========================================================================
# The primitive registry (ast/prims/**)
PRIMS: dict = {}


def prim(*names):
    def deco(fn):
        for n in names:
            PRIMS[n] = fn
        return fn
    return deco


# ---- operators (prims/operators) ------------------------------------------
@prim("+")
def _add(a, e): return _broadcast_op(a, e, lambda x, y: x + y)


@prim("-")
def _sub(a, e): return _broadcast_op(a, e, lambda x, y: x - y)


@prim("*")
def _mul(a, e): return _broadcast_op(a, e, lambda x, y: x * y)


@prim("/")
def _div(a, e): return _broadcast_op(a, e, lambda x, y: x / y)


@prim("^", "**")
def _pow(a, e): return _broadcast_op(a, e, torch.pow)


@prim("%", "mod")
def _mod(a, e): return _broadcast_op(a, e, torch.remainder)  # Python-signed


def _floor_divide(x, y):
    """jnp.floor_divide of floats: (x - fmod(x, y)) / y, one less where
    the remainder's sign differs from y's, rounded away from zero (NaN
    for y = 0, where torch.floor_divide gives ±inf)."""
    mod = torch.fmod(x, y)
    div = (x - mod) / y
    div = torch.where((mod != 0) & (torch.sign(y) != torch.sign(mod)),
                      div - 1, div)
    return torch.where(div >= 0, torch.floor(div + 0.5),
                       torch.ceil(div - 0.5))


@prim("intDiv", "%/%")
def _intdiv(a, e): return _broadcast_op(a, e, _floor_divide)


def _cmp(fn):
    return lambda a, e: _broadcast_op(
        a, e, lambda x, y: fn(x, y).to(torch.float32))


PRIMS["=="] = _cmp(lambda x, y: x == y)
PRIMS["!="] = _cmp(lambda x, y: x != y)
PRIMS[">"] = _cmp(lambda x, y: x > y)
PRIMS[">="] = _cmp(lambda x, y: x >= y)
PRIMS["<"] = _cmp(lambda x, y: x < y)
PRIMS["<="] = _cmp(lambda x, y: x <= y)
PRIMS["&"] = _cmp(lambda x, y: (x != 0) & (y != 0))
PRIMS["|"] = _cmp(lambda x, y: (x != 0) | (y != 0))
PRIMS["&&"] = PRIMS["&"]
PRIMS["||"] = PRIMS["|"]


@prim("!", "not")
def _not(a, e):
    return _unary_op(a, e, lambda x: (x == 0).to(torch.float32))


# ---- math (prims/math) -----------------------------------------------------
# "gamma" is log-gamma, as in the JAX package (jax.scipy.special.gammaln)
_MATH = {
    "abs": torch.abs, "exp": torch.exp, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "expm1": torch.expm1, "sqrt": torch.sqrt, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "floor": torch.floor,
    "ceiling": torch.ceil, "trunc": torch.trunc,
    "sign": lambda x: torch.where(torch.isnan(x), x, torch.sign(x)),
    "gamma": torch.lgamma,
}
for name, f in _MATH.items():
    PRIMS[name] = (lambda ff: lambda a, e: _unary_op(a, e, ff))(f)


@prim("round")
def _round(a, e):
    digits = int(_eval(a[1], e)) if len(a) > 1 else 0
    m = 10.0 ** digits
    return _unary_op(a[:1], e, lambda x: torch.round(x * m) / m)


@prim("signif")
def _signif(a, e):
    digits = int(_eval(a[1], e)) if len(a) > 1 else 6

    def f(x):
        mag = torch.pow(10.0, digits - 1
                        - torch.floor(torch.log10(torch.abs(x))))
        return torch.where(x == 0, torch.zeros_like(x),
                           torch.round(x * mag) / mag)
    return _unary_op(a[:1], e, f)


# ---- reducers (prims/reducers) --------------------------------------------
@prim("sum")
def _sum(a, e):
    return _reduce_op(a, e, lambda A, live: torch.where(
        torch.isnan(A) | ~live, 0.0, A).sum())


@prim("mean")
def _mean(a, e):
    def f(A, live):
        ok = ~torch.isnan(A) & live
        return torch.where(ok, A, 0.0).sum() / torch.clamp(ok.sum(), min=1)
    return _reduce_op(a, e, f)


@prim("min")
def _min(a, e):
    return _reduce_op(a, e, lambda A, live: torch.where(
        torch.isnan(A) | ~live, math.inf, A).min())


@prim("max")
def _max(a, e):
    return _reduce_op(a, e, lambda A, live: torch.where(
        torch.isnan(A) | ~live, -math.inf, A).max())


@prim("sd")
def _sd(a, e):
    return float(_eval(a[0], e).vecs[0].sigma())


@prim("var")
def _var(a, e):
    return float(_eval(a[0], e).vecs[0].sigma()) ** 2


@prim("median")
def _median(a, e):
    return float(np.nanmedian(_col_np(_eval(a[0], e))))


@prim("prod")
def _prod(a, e):
    return _reduce_op(a, e, lambda A, live: torch.where(
        torch.isnan(A) | ~live, 1.0, A).prod())


@prim("all")
def _all(a, e):
    return _reduce_op(a, e, lambda A, live: torch.where(
        live, A != 0, True).all().to(torch.float32))


@prim("any")
def _any(a, e):
    return _reduce_op(a, e, lambda A, live: torch.where(
        live, A != 0, False).any().to(torch.float32))


def _make_cum(npfn):
    # host numpy over the f32 column, as the JAX package computes it
    def f(a, e):
        fr = _eval(a[0], e)
        return _new_frame(fr.names[:1], [npfn(_col_np(fr))])
    return f


PRIMS["cumsum"] = _make_cum(np.cumsum)
PRIMS["cumprod"] = _make_cum(np.cumprod)
PRIMS["cummin"] = _make_cum(np.minimum.accumulate)
PRIMS["cummax"] = _make_cum(np.maximum.accumulate)


# ---- frame structure (prims/mungers) ---------------------------------------
@prim("nrow")
def _nrow(a, e): return float(_eval(a[0], e).nrows)


@prim("ncol")
def _ncol(a, e): return float(_eval(a[0], e).ncols)


@prim("colnames", "names")
def _colnames(a, e): return list(_eval(a[0], e).names)


@prim("cols", "cols_py")
def _cols(a, e):
    f = _eval(a[0], e)
    sel = _eval(a[1], e)
    if isinstance(sel, str):
        return f[[sel]]
    if isinstance(sel, float):
        sel = [sel]
    if isinstance(sel, list):
        if sel and isinstance(sel[0], str):
            return f[list(sel)]
        idx = [int(s) for s in sel]
        if idx and idx[0] < 0:   # negative: drop
            drop = [-j - 1 for j in idx]
            return _select(f, [i for i in range(f.ncols) if i not in drop])
        return _select(f, idx)
    raise ValueError(sel)


@prim("rows")
def _rows(a, e):
    """Rows by a 0/1 mask frame (an NA mask row is taken: NaN != 0, as in
    the JAX package) or by positions (negative: dropped), on the card."""
    f = _eval(a[0], e)
    sel = _eval(a[1], e)
    dev = f.vecs[0].device
    if isinstance(sel, Frame):
        mask = sel.vecs[0].as_f32()[: f.nrows] != 0
        idx = torch.nonzero(mask).squeeze(1)
    elif isinstance(sel, list):
        idx = np.array([int(s) for s in sel], np.int64)
        if len(idx) and idx[0] < 0:
            keep = np.ones(f.nrows, bool)
            keep[-idx - 1] = False
            idx = np.nonzero(keep)[0]
        idx = torch.from_numpy(idx).to(dev)
    else:
        idx = torch.tensor([int(sel)], device=dev)
    return _take_rows(f, idx)


def _take_rows(f: Frame, idx) -> Frame:
    """Rows `idx` (positions, host or card) of every column, on the
    card."""
    from h2o3_tpu_torch.ops import device_sort as DS
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx, np.int64))
    return DS.take_rows_device(f, idx.to(f.vecs[0].device).long())


@prim("cbind")
def _cbind(a, e):
    frames = [_as_frame(_eval(x, e)) for x in a]
    names, vecs = [], []
    seen = set()
    for f in frames:
        for n, v in zip(f.names, f.vecs):
            nn = n
            k = 0
            while nn in seen:
                k += 1
                nn = f"{n}{k}"
            seen.add(nn)
            names.append(nn)
            vecs.append(v)
    return Frame(names, vecs)


@prim("rbind")
def _rbind(a, e):
    frames = [_as_frame(_eval(x, e)) for x in a]
    base = frames[0]
    names, vecs = [], []
    for j, c in enumerate(base.names):
        vts = [f.vecs[j] for f in frames]
        if vts[0].type == T_STR:
            data = np.concatenate([v.host_data for v in vts])
            vecs.append(Vec.from_numpy(data, type=T_STR))
        elif vts[0].type == T_CAT:
            # the union of the levels (ParseDataset's categorical merge)
            dom = sorted({lv for v in vts for lv in (v.levels() or [])})
            lut = {lv: i for i, lv in enumerate(dom)}
            cols = []
            for v in vts:
                x = _vnp(v).astype(np.float64)
                tbl = np.asarray([lut[d] for d in (v.levels() or [])]
                                 or [0], np.float64)
                ok = ~np.isnan(x)
                cols.append(np.where(ok, tbl[np.where(ok, x, 0)
                                             .astype(np.int64)], np.nan))
            col = np.concatenate(cols)
            mask = np.isnan(col)
            vecs.append(Vec._from_floats(np.where(mask, 0, col), mask, T_CAT,
                                         np.asarray(dom, object)))
        else:
            col = np.concatenate([_vnp(v) for v in vts]).astype(np.float64)
            mask = np.isnan(col)
            vecs.append(Vec._from_floats(np.where(mask, 0, col), mask,
                                         vts[0].type))
        names.append(c)
    return Frame(names, vecs)


@prim("setnames", "colnames=")
def _setnames(a, e):
    f = _eval(a[0], e)
    idx = _eval(a[1], e)
    names = _eval(a[2], e)
    if not isinstance(idx, list):
        idx = [idx]
    if not isinstance(names, list):
        names = [names]
    for i, n in zip(idx, names):
        f.names[int(i)] = n if isinstance(n, str) else str(n)
    f._matrix_cache.clear()
    return f


@prim("tmp=")
def _assign(a, e):
    key = a[0]
    val = _eval(a[1], e)
    if isinstance(val, Frame):
        if val.key and DKV.get(val.key) is val:
            # a prim that hands back its source frame (as.factor of a
            # categorical column): a fresh handle, the source keeps its key
            val = Frame(list(val.names), list(val.vecs))
        else:
            DKV.remove(val.key)
        val.key = key
    DKV.put(key, val)
    e.session.register(key)
    return val


@prim("rm")
def _rm(a, e):
    DKV.remove(a[0] if isinstance(a[0], str) else _eval(a[0], e))
    return 0.0


@prim(":=")
def _colassign(a, e):
    """(:= frame rhs col_idx row_idx): replace columns in place."""
    f = _eval(a[0], e)
    rhs = _eval(a[1], e)
    cols = _eval(a[2], e)
    if isinstance(cols, float):
        cols = [cols]
    for k, ci in enumerate(int(c) for c in cols):
        name = f"C{ci+1}" if ci >= f.ncols else f.names[ci]
        if isinstance(rhs, Frame):
            f[name] = rhs.vecs[min(k, rhs.ncols - 1)]
        else:
            f[name] = np.full(f.nrows, float(rhs))
    return f


@prim("is.na")
def _isna(a, e):
    return _unary_op(a, e, lambda x: torch.isnan(x).to(torch.float32))


@prim("ifelse")
def _ifelse(a, e):
    c = _eval(a[0], e)
    x = _eval(a[1], e)
    y = _eval(a[2], e)
    if not isinstance(c, Frame):
        return x if c else y
    C = c.matrix(_numeric_cols(c))

    def get(v):
        return v.matrix(_numeric_cols(v)) if isinstance(v, Frame) \
            else _f32(v).to(C.device)
    out = torch.where(C != 0, get(x), get(y)).to(torch.float32)
    return _dev_frame(c.names, [out[:, j] for j in range(out.shape[1])])


@prim("h2o.which")
def _which(a, e):
    f = _eval(a[0], e)
    idx = np.nonzero(_col_np(f) != 0)[0].astype(np.float64)
    return _new_frame(["which"], [idx])


@prim("na.omit")
def _naomit(a, e):
    f = _eval(a[0], e)
    keep = ~np.isnan(_frame_np(f)).any(axis=1)
    return _take_rows(f, np.nonzero(keep)[0])


@prim("unique")
def _unique(a, e):
    f = _eval(a[0], e)
    v = f.vecs[0]
    col = _col_np(f)
    u = np.unique(col[~np.isnan(col)])
    if v.type == T_CAT:
        return _new_frame(f.names[:1], [u], domains={0: v.levels()})
    return _new_frame(f.names[:1], [u])


@prim("table")
def _table(a, e):
    f = _eval(a[0], e)
    col = _col_np(f)
    v = f.vecs[0]
    vals, cnts = np.unique(col[~np.isnan(col)], return_counts=True)
    if v.type == T_CAT:
        dom = v.levels()
        labels = np.array([dom[int(x)] for x in vals], object)
        return _new_frame([f.names[0], "Count"],
                          [labels, cnts.astype(np.float64)])
    return _new_frame([f.names[0], "Count"],
                      [vals, cnts.astype(np.float64)])


# ---- type coercion ---------------------------------------------------------
@prim("as.factor", "asfactor")
def _asfactor(a, e):
    f = _eval(a[0], e)
    v = f.vecs[0]
    if v.type == T_CAT:
        return f
    if v.type == T_STR:
        return _new_frame(f.names[:1], [v.host_data])  # strings again
    col = _vnp(v)
    mask = np.isnan(col)
    uniq = np.unique(col[~mask])
    codes = np.where(mask, np.nan,
                     np.searchsorted(uniq, np.where(mask, uniq[0] if
                                                    uniq.size else 0, col)))
    dom = [("%g" % x) for x in uniq]
    return _new_frame(f.names[:1], [codes.astype(np.float64)],
                      domains={0: dom})


@prim("as.numeric", "asnumeric")
def _asnumeric(a, e):
    f = _eval(a[0], e)
    v = f.vecs[0]
    col = _vnp(v)
    if v.type == T_CAT:
        try:
            vals = np.array([float(d) for d in v.levels()] or [0.0])
            ok = ~np.isnan(col)
            col = np.where(ok, vals[np.where(ok, col, 0).astype(np.int64)],
                           np.nan)
        except ValueError:
            pass
    return _new_frame(f.names[:1], [col])


@prim("as.character", "ascharacter")
def _aschar(a, e):
    f = _eval(a[0], e)
    v = f.vecs[0]
    if v.type == T_CAT:
        dom = v.levels()
        out = np.array([None if math.isnan(c) else dom[int(c)]
                        for c in _vnp(v)], object)
    else:
        out = np.array(["%g" % x if not math.isnan(x) else None
                        for x in _vnp(v)], object)
    return _new_frame(f.names[:1], [out])


@prim("levels")
def _levels(a, e):
    return _eval(a[0], e).vecs[0].levels() or []


# ---- sort / merge / group-by (prims/mungers, the radix family) -------------
@prim("sort")
def _sort(a, e):
    f = _eval(a[0], e)
    by = _eval(a[1], e)
    asc = _eval(a[2], e) if len(a) > 2 else [1.0] * 99
    if not isinstance(by, list):
        by = [by]
    cols = [int(b) if isinstance(b, float) else f.col_idx(b) for b in by]
    ascending = [bool(asc[k]) if isinstance(asc, list) and k < len(asc)
                 else True for k in range(len(cols))]
    from h2o3_tpu_torch.ops import device_sort as DS
    if all(f.vecs[ci].type != T_STR for ci in cols):
        return DS.sort_frame(f, cols, ascending)
    keys = []
    for k, ci in enumerate(reversed(cols)):
        colv = _vnp(f.vecs[ci])
        keys.append(colv if ascending[len(cols) - 1 - k] else -colv)
    return _take_rows(f, np.lexsort(keys))


@prim("merge")
def _merge(a, e):
    """(merge left right all_left all_right by_left by_right method)"""
    lf = _eval(a[0], e)
    rf = _eval(a[1], e)
    all_l = bool(_eval(a[2], e)) if len(a) > 2 else False
    all_r = bool(_eval(a[3], e)) if len(a) > 3 else False
    by_l = _eval(a[4], e) if len(a) > 4 else []
    by_r = _eval(a[5], e) if len(a) > 5 else []
    if not by_l:
        common = [c for c in lf.names if c in rf.names]
        by_l = [lf.col_idx(c) for c in common]
        by_r = [rf.col_idx(c) for c in common]
    by_l = [int(x) for x in (by_l if isinstance(by_l, list) else [by_l])]
    by_r = [int(x) for x in (by_r if isinstance(by_r, list) else [by_r])]
    from h2o3_tpu_torch.ops import device_sort as DS
    keys_numeric = all(lf.vecs[i].type != T_STR for i in by_l) and \
        all(rf.vecs[i].type != T_STR for i in by_r)
    if keys_numeric and not all_r:
        out = DS.merge_frames(lf, rf, by_l, by_r, all_l=all_l)
        if out is not None:
            return out
    how = "outer" if (all_l and all_r) else \
        "left" if all_l else "right" if all_r else "inner"
    return DS.merge_frames_pandas(lf, rf, by_l, by_r, how)


@prim("GB", "group_by")
def _groupby(a, e):
    """(GB frame [by…] agg_fn agg_col na_handling …): AstGroup. The
    `na_handling` argument is read and not used, as in the JAX
    package."""
    from h2o3_tpu_torch.ops import device_sort as DS
    f = _eval(a[0], e)
    by = _eval(a[1], e)
    by = [int(b) for b in (by if isinstance(by, list) else [by])]
    aggs = []
    i = 2
    while i + 2 <= len(a):
        fn_name = _eval(a[i], e)
        col = int(_eval(a[i + 1], e))
        na = _eval(a[i + 2], e) if i + 2 < len(a) else "rm"
        aggs.append((fn_name, col, na))
        i += 3
    device_ok = all(f.vecs[j].type != T_STR for j in by) and \
        all(fn in DS.AGGS and f.vecs[cj].type != T_STR
            for fn, cj, _na in aggs)
    if device_ok and by:
        got = DS.group_by_device(f, by, [(fn, cj) for fn, cj, _ in aggs])
        if got is not None:
            names2, cols2, doms2 = got
            return _dev_frame(names2, cols2, domains=doms2)
    return _groupby_sorted(f, by, aggs)


def _groupby_sorted(f, by, aggs):
    """The group-by of any aggregate, the JAX package's host path
    (`sorted(set(key tuples))`, then each function over a group's rows)
    computed on the card: median and mode from the rows sorted by group
    and value once, every other aggregate as the device path computes it
    (`device_sort.group_stats`)."""
    from h2o3_tpu_torch.ops import device_sort as DS
    n = f.nrows
    keys = []
    for j in by:
        v = f.vecs[j]
        if v.type == T_STR:
            cd = v.codes
            keys.append(torch.where(cd >= 0, cd.to(torch.float32),
                                    float("nan")))
        else:
            keys.append(v.as_f32())
    out_names = [f.names[j] for j in by]
    if not keys or not n:         # no key tuples: no groups
        return _new_frame(out_names + [f"{fn}_{f.names[cj]}"
                                       for fn, cj, _ in aggs],
                          [np.zeros(0)] * (len(by) + len(aggs)))
    _, gid, gid_sorted, Ks, new = DS._group_ids(
        DS.na_last(torch.stack(keys, 1)))
    ng = int(gid_sorted[-1]) + 1
    key_rows = Ks[new]
    out_cols = []
    for kd, j in enumerate(by):
        kv = key_rows[:, kd]
        kv = torch.where(kv >= DS._BIG, float("nan"), kv)
        v = f.vecs[j]
        if v.type == T_STR:       # the strings come back categorical
            lv = v.levels_arr
            out_cols.append(np.array([None if c != c else lv[int(c)]
                                      for c in kv.cpu().numpy()]))
        else:
            out_cols.append(kv.cpu().numpy().astype(np.float64))
    size = torch.bincount(gid, minlength=ng)
    stats = {}
    need_var = {cj for fn, cj, _na in aggs if fn in ("var", "sd")}
    for fn_name, cj, _na in aggs:
        x = f.vecs[cj].as_f32()
        out_names.append(f"{fn_name}_{f.names[cj]}")
        if fn_name in DS.AGGS:
            if cj not in stats:
                stats[cj] = DS.group_stats(x, gid, ng, cj in need_var)
            col = DS.pick_stat(stats[cj], fn_name)
        else:
            col = _group_order_stat(fn_name, x, gid, ng, size)
        out_cols.append(col.cpu().numpy().astype(np.float64))
    doms = {kd: f.vecs[j].levels() for kd, j in enumerate(by)
            if f.vecs[j].type == T_CAT}
    return _new_frame(out_names, out_cols, domains=doms)


def _group_order_stat(fn_name, x, gid, ng, size):
    """The median or mode of x (f32, NaN = NA) by group, as numpy's
    nanmedian and bincount argmax give it over the group's f32 values."""
    if fn_name not in ("median", "mode"):
        raise KeyError(fn_name)
    ok = ~torch.isnan(x)
    cnt = torch.bincount(gid, weights=ok.to(torch.float64), minlength=ng)
    nan = torch.full((ng,), float("nan"), dtype=torch.float64,
                     device=x.device)
    # each group's valid values in order: sort by value, then by group
    xv = torch.trunc(x) if fn_name == "mode" else x
    o1 = torch.sort(xv + 0.0, stable=True).indices        # NaN last
    o2 = torch.sort(gid[o1], stable=True).indices
    order = o1[o2]
    vs, gs = xv[order], gid[order]
    start = torch.cumsum(size, 0) - size
    c = cnt.long()
    if fn_name == "median":
        lo = start + torch.clamp((c - 1) // 2, min=0)
        hi = start + torch.clamp(c // 2, min=0)
        last = max(vs.numel() - 1, 0)
        a_, b_ = vs[lo.clamp(max=last)], vs[hi.clamp(max=last)]
        med = torch.where(c % 2 == 1, a_, (a_ + b_) / 2)
        return torch.where(c > 0, med.double(), nan)
    # mode: the most frequent value (numpy's bincount argmax: the
    # smallest of the most frequent), over the values truncated to ints
    okv = torch.isfinite(vs)
    newrun = torch.ones_like(okv)
    newrun[1:] = (vs[1:] != vs[:-1]) | (gs[1:] != gs[:-1])
    rid = torch.cumsum(newrun.long(), 0) - 1
    nr = int(rid[-1]) + 1 if rid.numel() else 0
    rcount = torch.bincount(rid, weights=okv.double(), minlength=nr)
    rg = torch.zeros(nr, dtype=torch.long, device=x.device) \
        .scatter_(0, rid, gs)
    rv = torch.zeros(nr, dtype=vs.dtype, device=x.device) \
        .scatter_(0, rid, vs)
    best = torch.zeros(ng, dtype=torch.float64, device=x.device) \
        .scatter_reduce(0, rg, rcount, "amax")
    cand = torch.where((rcount == best[rg]) & (rcount > 0), rv.double(),
                       math.inf)
    mode = torch.full((ng,), math.inf, dtype=torch.float64,
                      device=x.device).scatter_reduce(0, rg, cand, "amin")
    return torch.where(c > 0, mode, nan)


@prim("quantile")
def _quantile(a, e):
    """(quantile fr probs ["interpolate"|...]): the port's exact
    quantiles (models/quantile.py), each numeric column."""
    from h2o3_tpu_torch.models.quantile import quantile as devq
    f = _eval(a[0], e)
    probs = _eval(a[1], e)
    probs = probs if isinstance(probs, list) else [probs]
    method = _eval(a[2], e) if len(a) > 2 else "interpolate"
    out_cols = [np.asarray(probs, np.float64)]
    names = ["Probs"]
    for c in _numeric_cols(f):
        out_cols.append(devq(f.matrix([c])[:, 0], probs,
                             combine_method=method))
        names.append(c)
    return _new_frame(names, out_cols)


@prim("h2o.impute")
def _impute(a, e):
    f = _eval(a[0], e)
    col = int(_eval(a[1], e))
    method = _eval(a[2], e) if len(a) > 2 else "mean"
    v = f.vecs[col]
    x = _vnp(v)
    if method == "median":
        fill = float(np.nanmedian(x))
    elif method == "mode":
        vals, cnt = np.unique(x[~np.isnan(x)], return_counts=True)
        fill = float(vals[cnt.argmax()])
    else:
        fill = float(np.nanmean(x))
    x = np.where(np.isnan(x), fill, x).astype(np.float64)
    f[f.names[col]] = Vec._from_floats(x, np.zeros(len(x), bool), v.type,
                                       v.domain)
    return f


# ---- string ops (prims/string) --------------------------------------------
def _str_map(args, env, fn):
    """A string function over a string column's dictionary (one gather on
    the card) or a categorical column's levels."""
    f = _eval(args[0], env)
    v = f.vecs[0]
    if v.type == T_STR:
        return Frame(f.names[:1], [v.map_values(fn)])
    if v.type == T_CAT:
        dom = [fn(d) for d in v.levels()]
        return _new_frame(f.names[:1], [_vnp(v)], domains={0: dom})
    raise TypeError("string op on numeric column")


def _level_text(v):
    """A categorical column's values as strings (None for NA)."""
    dom = np.asarray(v.levels() or [""], object)
    x = _vnp(v)
    ok = ~np.isnan(x)
    return np.where(ok, dom[np.where(ok, x, 0).astype(np.int64)], None)


@prim("toupper")
def _toupper(a, e): return _str_map(a, e, str.upper)


@prim("tolower")
def _tolower(a, e): return _str_map(a, e, str.lower)


@prim("trim")
def _trim(a, e): return _str_map(a, e, str.strip)


@prim("nchar", "strlen", "length")
def _nchar(a, e):
    f = _eval(a[0], e)
    v = f.vecs[0]
    if v.type == T_STR:
        return Frame(f.names[:1], [Vec.from_tensor(v.per_level_f32(len))])
    lens = np.array([float(len(d)) for d in v.levels()] or [0.0])
    x = _vnp(v)
    ok = ~np.isnan(x)
    out = np.where(ok, lens[np.where(ok, x, 0).astype(np.int64)], np.nan)
    return _new_frame(f.names[:1], [out])


@prim("replaceall", "gsub")
def _gsub(a, e):
    """(replaceall fr pattern replacement ignore_case): AstReplaceAll's
    argument order."""
    pat = _eval(a[1], e)
    rep = _eval(a[2], e)
    flags = re.IGNORECASE if (len(a) > 3 and bool(_eval(a[3], e))) else 0
    return _str_map(a[:1], e, lambda s: re.sub(pat, rep, s, flags=flags))


@prim("replacefirst", "sub")
def _sub_str(a, e):
    """(replacefirst fr pattern replacement ignore_case)."""
    pat = _eval(a[1], e)
    rep = _eval(a[2], e)
    flags = re.IGNORECASE if (len(a) > 3 and bool(_eval(a[3], e))) else 0
    return _str_map(a[:1], e,
                    lambda s: re.sub(pat, rep, s, count=1, flags=flags))


@prim("substring")
def _substring(a, e):
    start = int(_eval(a[1], e))
    end = int(_eval(a[2], e)) if len(a) > 2 else None
    return _str_map(a[:1], e, lambda s: s[start:end])


@prim("strsplit")
def _strsplit(a, e):
    f = _eval(a[0], e)
    pat = _eval(a[1], e)
    v = f.vecs[0]
    if v.type == T_STR:
        # the dictionary split once; each part a StrVec over the row codes
        lv_parts = [re.split(pat, s) for s in v.levels_arr]
        width = max((len(p) for p in lv_parts), default=0)
        by_level = {s: p for s, p in zip(v.levels_arr, lv_parts)}
        cols = [v.map_values_opt(
                    lambda s, j=j: (by_level[s][j]
                                    if j < len(by_level[s]) else None))
                for j in range(width)]
        return Frame([f"C{j+1}" for j in range(width)], cols)
    parts = [re.split(pat, s) if s is not None else []
             for s in _level_text(v)]
    width = max((len(p) for p in parts), default=0)
    cols = [np.array([p[j] if j < len(p) else None for p in parts], object)
            for j in range(width)]
    return _new_frame([f"C{j+1}" for j in range(width)], cols)


@prim("countmatches")
def _countmatches(a, e):
    f = _eval(a[0], e)
    pat = _eval(a[1], e)
    pats = pat if isinstance(pat, list) else [pat]
    v = f.vecs[0]

    def count(s):
        return float(sum(s.count(p) for p in pats))
    if v.type == T_STR:
        return Frame(f.names[:1], [Vec.from_tensor(v.per_level_f32(count))])
    out = np.array([np.nan if s is None else count(s)
                    for s in _level_text(v)])
    return _new_frame(f.names[:1], [out])


# ---- time ops (prims/time) -------------------------------------------------
def _time_parts(ms: np.ndarray, part: str) -> np.ndarray:
    """A part of epoch milliseconds (f32, as the column holds them), UTC,
    in numpy: year, month (1-12), day (1-31), hour, minute, second, and
    dayofweek (Monday 0); the JAX package reads them through pandas."""
    dt = ms.astype("datetime64[ms]")
    day = dt.astype("datetime64[D]")
    if part == "year":
        out = dt.astype("datetime64[Y]").astype(np.int64) + 1970
    elif part == "month":
        out = dt.astype("datetime64[M]").astype(np.int64) % 12 + 1
    elif part == "day":
        out = (day - dt.astype("datetime64[M]")).astype(np.int64) + 1
    elif part == "dayofweek":
        out = (day.astype(np.int64) + 3) % 7        # 1970-01-01: Thursday
    else:
        secs = (dt - day).astype("timedelta64[s]").astype(np.int64)
        out = {"hour": secs // 3600, "minute": secs // 60 % 60,
               "second": secs % 60}[part]
    return out.astype(np.float64)


def _time_part(args, env, part):
    f = _eval(args[0], env)
    ms = _col_np(f)
    with np.errstate(invalid="ignore"):
        out = _time_parts(ms, part)
    out[np.isnan(ms)] = np.nan
    return _new_frame(f.names[:1], [out])


for _p, _attr in [("year", "year"), ("month", "month"), ("day", "day"),
                  ("hour", "hour"), ("minute", "minute"),
                  ("second", "second"), ("dayOfWeek", "dayofweek")]:
    PRIMS[_p] = (lambda attr: lambda a, e: _time_part(a, e, attr))(_attr)


# ---- misc ------------------------------------------------------------------
@prim("getrow")
def _getrow(a, e):
    return [float(x) for x in _frame_np(_eval(a[0], e))[0]]


@prim("h2o.runif")
def _runif(a, e):
    f = _eval(a[0], e)
    seed = int(_eval(a[1], e)) if len(a) > 1 else -1
    rng = np.random.default_rng(seed if seed > 0 else None)
    return _new_frame(["rnd"], [rng.random(f.nrows)])


@prim("hist")
def _hist(a, e):
    f = _eval(a[0], e)
    breaks = _eval(a[1], e) if len(a) > 1 else "sturges"
    col = _col_np(f)
    col = col[~np.isnan(col)]
    if isinstance(breaks, list):
        counts, edges = np.histogram(col, bins=np.asarray(breaks))
    elif isinstance(breaks, float):
        counts, edges = np.histogram(col, bins=int(breaks))
    else:
        counts, edges = np.histogram(col, bins="sturges")
    return _new_frame(["breaks", "counts", "mids"],
                      [edges[1:].astype(np.float64),
                       counts.astype(np.float64),
                       ((edges[:-1] + edges[1:]) / 2).astype(np.float64)])


@prim("scale")
def _scale(a, e):
    f = _eval(a[0], e)
    center = _eval(a[1], e) if len(a) > 1 else True
    scale_ = _eval(a[2], e) if len(a) > 2 else True
    A = f.matrix(_numeric_cols(f))
    ok = ~torch.isnan(A)
    cnt = torch.clamp(ok.sum(0), min=1)
    mu = torch.where(ok, A, 0.0).sum(0) / cnt
    x = A - mu if center else A
    sd = torch.sqrt(torch.where(ok, x * x, 0.0).sum(0)
                    / torch.clamp(cnt - 1, min=1))
    out = x / torch.where(sd > 0, sd, 1.0) if scale_ else x
    return _dev_frame(f.names, [out[:, j] for j in range(out.shape[1])])


@prim("apply")
def _apply(a, e):
    f = _eval(a[0], e)
    margin = int(_eval(a[1], e))
    lam = _eval(a[2], e)
    if margin == 2:  # a column at a time
        outs = []
        for c in f.names:
            sub = f[[c]]
            r = _apply_lambda(lam, [sub], e)
            outs.append(float(r) if not isinstance(r, Frame)
                        else float(_col_np(r)[0]))
            DKV.remove(sub.key)
        return _new_frame(f.names, [np.array([o]) for o in outs])
    m = _frame_np(f)                 # margin 1: a row at a time
    outs = []
    for i in range(f.nrows):
        rowf = _new_frame(f.names, [m[i:i+1, j] for j in range(f.ncols)])
        r = _apply_lambda(lam, [rowf], e)
        outs.append(float(r) if not isinstance(r, Frame)
                    else float(_col_np(r)[0]))
        DKV.remove(rowf.key)
    return _new_frame(["apply"], [np.asarray(outs)])


# ---- the second tranche of the table (prims_ext registers into PRIMS) ------
from h2o3_tpu_torch.rapids import prims_ext  # noqa: E402,F401  (registers)
