"""h2o-py-style client surface — the h2o-py/h2o package rebuilt thin.

Reference: h2o-py's H2OFrame compiles every dataframe operation into a Rapids
expression sent over REST (`h2o-py/h2o/expr.py` lazy ExprNode DAG). Here the
controller IS the cluster, so the client evaluates the SAME Rapids expressions
in-process through `rapids_exec` (the REST path in api/server.py exposes the
identical surface for out-of-process clients). Every operation emits the
same Rapids text as the JAX package's client. Lazy DAG batching is
unnecessary — dispatch is already async on the card.

Usage mirrors h2o-py:

    from h2o3_tpu_torch import client as h2o
    h2o.init()
    fr = h2o.import_file("x.csv")
    fr["d"] = fr["a"] + fr["b"] * 2
    sub = fr[fr["a"] > 0.5]
    print(sub["d"].mean())
"""

from __future__ import annotations

import numpy as np

import h2o3_tpu_torch
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.rapids.rapids import rapids_exec


def init(**kw):
    """The cloud on `cuda:0` (raises without a card), or on the device
    `device=` names."""
    return h2o3_tpu_torch.init(**kw)


def import_file(path, **kw):
    return H2OFrame._wrap(h2o3_tpu_torch.import_file(path, **kw))


def get_frame(key):
    return H2OFrame._wrap(h2o3_tpu_torch.get_frame(key))


def H2OFrame_from(obj, destination_frame=None):
    from h2o3_tpu_torch.io.parser import upload_frame
    return H2OFrame._wrap(upload_frame(obj, destination_frame))


class H2OFrame:
    """Operator-overloaded view over a server Frame (h2o-py H2OFrame)."""

    def __init__(self, python_obj=None, destination_frame=None):
        if python_obj is not None:
            from h2o3_tpu_torch.io.parser import upload_frame
            self._fr = upload_frame(python_obj, destination_frame)
        else:
            self._fr = None

    @staticmethod
    def _wrap(fr: Frame) -> "H2OFrame":
        o = H2OFrame()
        o._fr = fr
        return o

    # ---- metadata -------------------------------------------------------
    @property
    def frame_id(self):
        return self._fr.key

    @property
    def names(self):
        return list(self._fr.names)

    @property
    def columns(self):
        return list(self._fr.names)

    @property
    def shape(self):
        return self._fr.shape

    @property
    def nrows(self):
        return self._fr.nrows

    @property
    def ncols(self):
        return self._fr.ncols

    @property
    def types(self):
        return self._fr.types

    @property
    def frame(self) -> Frame:
        return self._fr

    def __len__(self):
        return self._fr.nrows

    def head(self, rows=10):
        return self._fr.head(rows)

    def as_data_frame(self, use_pandas=True):
        """A pandas DataFrame (the JAX client's for either flag). Without
        pandas installed this raises rather than return another type."""
        try:
            import pandas  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "H2OFrame.as_data_frame needs pandas, which is not "
                "installed; read columns with .frame.vec(name).to_numpy()"
            ) from e
        return self._fr.as_data_frame()

    def summary(self):
        return self._fr.summary()

    def refresh(self):
        return self

    # ---- rapids plumbing -------------------------------------------------
    def _x(self, expr: str):
        out = rapids_exec(expr)
        return H2OFrame._wrap(out) if isinstance(out, Frame) else out

    @staticmethod
    def _ref(v):
        if isinstance(v, H2OFrame):
            return v._fr.key
        if isinstance(v, str):
            return f'"{v}"'
        if isinstance(v, bool):
            return "True" if v else "False"
        return repr(v)

    def _binop(self, op, rhs, reverse=False):
        a, b = (self._ref(rhs), self._fr.key) if reverse \
            else (self._fr.key, self._ref(rhs))
        return self._x(f"({op} {a} {b})")

    # ---- operators -------------------------------------------------------
    def __add__(self, o): return self._binop("+", o)
    def __radd__(self, o): return self._binop("+", o, True)
    def __sub__(self, o): return self._binop("-", o)
    def __rsub__(self, o): return self._binop("-", o, True)
    def __mul__(self, o): return self._binop("*", o)
    def __rmul__(self, o): return self._binop("*", o, True)
    def __truediv__(self, o): return self._binop("/", o)
    def __rtruediv__(self, o): return self._binop("/", o, True)
    def __pow__(self, o): return self._binop("^", o)
    def __mod__(self, o): return self._binop("%", o)
    def __eq__(self, o): return self._binop("==", o)    # noqa: E501 — frame semantics
    def __ne__(self, o): return self._binop("!=", o)
    def __gt__(self, o): return self._binop(">", o)
    def __ge__(self, o): return self._binop(">=", o)
    def __lt__(self, o): return self._binop("<", o)
    def __le__(self, o): return self._binop("<=", o)
    def __and__(self, o): return self._binop("&", o)
    def __or__(self, o): return self._binop("|", o)
    def __invert__(self): return self._x(f"(! {self._fr.key})")
    def __hash__(self):
        return id(self)

    # ---- selection -------------------------------------------------------
    def __getitem__(self, sel):
        if isinstance(sel, str):
            return H2OFrame._wrap(self._fr[sel])
        if isinstance(sel, list):
            if all(isinstance(s, str) for s in sel):
                return H2OFrame._wrap(self._fr[sel])
            idx = " ".join(str(int(i)) for i in sel)
            return self._x(f"(cols {self._fr.key} [{idx}])")
        if isinstance(sel, H2OFrame):  # boolean mask
            return self._x(f"(rows {self._fr.key} {sel._fr.key})")
        if isinstance(sel, int):
            return self._x(f"(cols {self._fr.key} [{sel}])")
        if isinstance(sel, slice):
            idx = list(range(*sel.indices(self.nrows)))
            lst = " ".join(str(i) for i in idx)
            return self._x(f"(rows {self._fr.key} [{lst}])")
        if isinstance(sel, tuple) and len(sel) == 2:
            rows, cols = sel
            sub = self[cols] if not isinstance(cols, tuple) else self
            return sub[rows] if not isinstance(rows, slice) or \
                rows != slice(None) else sub
        raise KeyError(sel)

    def __setitem__(self, name, value):
        if isinstance(value, H2OFrame):
            self._fr[name] = value._fr.vecs[0]
        else:
            self._fr[name] = value

    # ---- math / reducers -------------------------------------------------
    def _reduce(self, op):
        return rapids_exec(f"({op} {self._fr.key})")

    def sum(self, **kw): return self._reduce("sum")
    def mean(self, **kw): return self._reduce("mean")
    def min(self): return self._reduce("min")
    def max(self): return self._reduce("max")
    def sd(self): return self._reduce("sd")
    def var(self): return self._reduce("var")
    def median(self): return self._reduce("median")

    def isna(self):
        return self._x(f"(is.na {self._fr.key})")

    def log(self): return self._x(f"(log {self._fr.key})")
    def exp(self): return self._x(f"(exp {self._fr.key})")
    def sqrt(self): return self._x(f"(sqrt {self._fr.key})")
    def abs(self): return self._x(f"(abs {self._fr.key})")
    def floor(self): return self._x(f"(floor {self._fr.key})")
    def ceil(self): return self._x(f"(ceiling {self._fr.key})")

    # ---- munging ---------------------------------------------------------
    def asfactor(self):
        return self._x(f"(as.factor {self._fr.key})")

    def asnumeric(self):
        return self._x(f"(as.numeric {self._fr.key})")

    def ascharacter(self):
        return self._x(f"(as.character {self._fr.key})")

    def levels(self):
        return [v.levels() or [] for v in self._fr.vecs]

    def unique(self):
        return self._x(f"(unique {self._fr.key})")

    def table(self):
        return self._x(f"(table {self._fr.key})")

    def cbind(self, other):
        return self._x(f"(cbind {self._fr.key} {other._fr.key})")

    def rbind(self, other):
        return self._x(f"(rbind {self._fr.key} {other._fr.key})")

    def merge(self, other, all_x=False, all_y=False):
        return self._x(f"(merge {self._fr.key} {other._fr.key} "
                       f"{all_x} {all_y} [] [] 'auto')")

    def sort(self, by, ascending=True):
        cols = by if isinstance(by, list) else [by]
        idx = " ".join(str(self._fr.col_idx(c) if isinstance(c, str) else c)
                       for c in cols)
        asc = " ".join("1" if ascending else "0" for _ in cols)
        return self._x(f"(sort {self._fr.key} [{idx}] [{asc}])")

    def group_by(self, by):
        return GroupBy(self, by)

    def split_frame(self, ratios=(0.75,), seed=-1):
        rng = np.random.default_rng(seed if seed > 0 else None)
        n = self.nrows
        u = rng.random(n)
        edges = np.cumsum(list(ratios))
        outs = []
        prev = 0.0
        for e in list(edges) + [1.0]:
            idx = np.nonzero((u >= prev) & (u < e))[0]
            lst = " ".join(map(str, idx.tolist()))
            outs.append(self._x(f"(rows {self._fr.key} [{lst}])"))
            prev = e
        return outs

    def impute(self, column=0, method="mean"):
        ci = self._fr.col_idx(column) if isinstance(column, str) else column
        return self._x(f'(h2o.impute {self._fr.key} {ci} "{method}")')

    def scale(self, center=True, scale=True):
        return self._x(f"(scale {self._fr.key} {center} {scale})")

    def runif(self, seed=-1):
        return self._x(f"(h2o.runif {self._fr.key} {seed})")

    def __repr__(self):
        return f"<H2OFrame {self._fr!r}>"


class GroupBy:
    """h2o-py GroupBy builder → one (GB …) rapids call on .get_frame()."""

    def __init__(self, frame: H2OFrame, by):
        self._frame = frame
        by = by if isinstance(by, list) else [by]
        self._by = [frame._fr.col_idx(c) if isinstance(c, str) else c
                    for c in by]
        self._aggs = []

    def _add(self, op, col):
        ci = self._frame._fr.col_idx(col) if isinstance(col, str) else col
        self._aggs.append((op, ci))
        return self

    def sum(self, col): return self._add("sum", col)
    def mean(self, col): return self._add("mean", col)
    def count(self): return self._add("nrow", 0)
    def min(self, col): return self._add("min", col)
    def max(self, col): return self._add("max", col)
    def sd(self, col): return self._add("sd", col)
    def var(self, col): return self._add("var", col)
    def median(self, col): return self._add("median", col)

    def get_frame(self):
        by = " ".join(str(b) for b in self._by)
        aggs = " ".join(f'"{op}" {ci} "rm"' for op, ci in self._aggs)
        return self._frame._x(f"(GB {self._frame._fr.key} [{by}] {aggs})")


# ---------------------------------------------------------------------------
# h2o-py H2OFrame surface, continued: string ops, time ops, statistics,
# cumulative/rank transforms — each a thin AST builder over the same
# Rapids prims the reference client emits (h2o-py/h2o/frame.py).
def _extend_h2oframe():
    F = H2OFrame

    def _qstr(v):
        """Rapids string literal: the parser unescapes backslash
        sequences, so literal backslashes and quotes must be escaped or
        regex patterns like \\d+ silently lose their backslash."""
        return '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'

    def _unary(op):
        def m(self):
            return self._x(f"({op} {self._fr.key})")
        m.__name__ = op
        return m

    # string munging (h2o-py frame.py gsub/sub/trim/... emit these ASTs)
    for name, op in [("tolower", "tolower"), ("toupper", "toupper"),
                     ("trim", "trim"), ("lstrip", "lstrip"),
                     ("rstrip", "rstrip"), ("nchar", "strlen")]:
        setattr(F, name, _unary(op))

    def gsub(self, pattern, replacement, ignore_case=False):
        return self._x(f'(replaceall {self._fr.key} {_qstr(pattern)} '
                       f'{_qstr(replacement)} {ignore_case})')

    def sub(self, pattern, replacement, ignore_case=False):
        return self._x(f'(replacefirst {self._fr.key} {_qstr(pattern)} '
                       f'{_qstr(replacement)} {ignore_case})')

    def strsplit(self, pattern):
        return self._x(f'(strsplit {self._fr.key} {_qstr(pattern)})')

    def substring(self, start_index, end_index=1000000):
        return self._x(f"(substring {self._fr.key} {start_index} "
                       f"{end_index})")

    def countmatches(self, pattern):
        pats = pattern if isinstance(pattern, list) else [pattern]
        lst = " ".join(_qstr(p) for p in pats)
        return self._x(f"(countmatches {self._fr.key} [{lst}])")

    def grep(self, pattern, ignore_case=False, invert=False,
             output_logical=False):
        return self._x(f'(grep {self._fr.key} {_qstr(pattern)} '
                       f"{ignore_case} {invert} {output_logical})")

    F.gsub, F.sub, F.strsplit = gsub, sub, strsplit
    F.substring, F.countmatches, F.grep = substring, countmatches, grep

    # time accessors (AstTime family)
    for name in ("year", "month", "day", "hour", "minute", "second",
                 "week", "dayOfWeek"):
        setattr(F, name, _unary(name))

    # cumulative + rounding (AstCumu / AstRound)
    for name in ("cumsum", "cumprod", "cummax", "cummin"):
        setattr(F, name, _unary(name))

    def round(self, digits=0):
        return self._x(f"(round {self._fr.key} {digits})")

    def signif(self, digits=6):
        return self._x(f"(signif {self._fr.key} {digits})")

    F.round, F.signif = round, signif

    # statistics
    def cor(self, y=None, use="complete.obs", method="Pearson"):
        other = y._fr.key if isinstance(y, H2OFrame) else self._fr.key
        return self._x(f'(cor {self._fr.key} {other} "{use}" '
                       f'"{method}")')

    def entropy(self):
        # per-row Shannon entropy of string values (AstEntropy)
        return self._x(f"(entropy {self._fr.key})")

    def kurtosis(self, na_rm=True):
        return rapids_exec(f"(kurtosis {self._fr.key} {na_rm})")

    def skewness(self, na_rm=True):
        return rapids_exec(f"(skewness {self._fr.key} {na_rm})")

    def hist(self, breaks="sturges", plot=False):
        if isinstance(breaks, str):
            b = f'"{breaks}"'
        elif isinstance(breaks, (list, tuple)):
            b = "[" + " ".join(str(float(x)) for x in breaks) + "]"
        else:
            b = str(breaks)
        return self._x(f"(hist {self._fr.key} {b})")

    def na_omit(self):
        return self._x(f"(na.omit {self._fr.key})")

    def nacnt(self):
        out = rapids_exec(f"(naCnt {self._fr.key})")
        return out if isinstance(out, list) else [out]

    def match(self, table):
        vals = " ".join(_qstr(v) if isinstance(v, str) else str(v)
                        for v in table)
        return self._x(f"(match {self._fr.key} [{vals}])")

    def cut(self, breaks, labels=None, include_lowest=False, right=True,
            dig_lab=3):
        bs = " ".join(str(float(b)) for b in breaks)
        # prim signature: (cut fr breaks labels include.lowest right digits)
        lab = ("[" + " ".join(_qstr(v) for v in labels) + "]"
               if labels else "[]")
        return self._x(f"(cut {self._fr.key} [{bs}] {lab} "
                       f"{include_lowest} {right} {dig_lab})")

    def which(self):
        return self._x(f"(which {self._fr.key})")

    def any_na(self):
        return bool(rapids_exec(f"(any.na {self._fr.key})"))

    def t(self):
        return self._x(f"(t {self._fr.key})")

    F.cor, F.entropy, F.kurtosis, F.skewness = cor, entropy, kurtosis, skewness
    F.hist, F.na_omit, F.nacnt, F.match = hist, na_omit, nacnt, match
    F.cut, F.which, F.any_na, F.t = cut, which, any_na, t

    def rep_len(self, length_out):
        return self._x(f"(rep_len {self._fr.key} {length_out})")

    def topn(self, column=0, nPercent=10, grabTopN=-1):
        """h2o-py semantics: grabTopN=-1 -> top N%, 1 -> bottom N%;
        the prim's flag is bottom=truthy, hence the inversion."""
        ci = self._fr.col_idx(column) if isinstance(column, str) else column
        bottom = 1 if grabTopN > 0 else 0
        return self._x(f"(topn {self._fr.key} {ci} {nPercent} {bottom})")

    F.rep_len, F.topn = rep_len, topn


_extend_h2oframe()
del _extend_h2oframe
