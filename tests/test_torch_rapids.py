"""The port's Rapids language (rapids/rapids.py) against the JAX
package's, on the CPU: the parser's trees, sessions and temps, lambdas
and `apply`, and every prim of rapids.py, one parametrised test over the
prim names. The same frames, made from a numpy seed, are registered
under the same keys in both packages' stores, and each expression is
evaluated by both.

Tolerances (`TOL`): exact for the prims that select, move, compare,
count or compute in host numpy (the port computes those in numpy over
the same f32 values, or moves the same values on the card); 1e-6
relative for sums and means on the card (f32 sums in another order) and
for the last bits of torch's transcendental functions against XLA's;
1e-5 for `scale` (f32 sums of squares); the quantiles within 1e-6 (the
port's exact ranks and the JAX package's refinement agree at this
size); the group-by's host path within 1e-6 (float64 sums rounded once
against f32 pairwise sums).
"""

import math

import numpy as np
import pytest
import torch

import h2o3_tpu_torch
from h2o3_tpu.core import frame as JF
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu.rapids import rapids as JR
from h2o3_tpu_torch.core import frame as TF
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.rapids import rapids as TR

N = 40


@pytest.fixture(scope="module", autouse=True)
def cpu_cloud():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def frame_data(seed=11):
    """{key: {column: (values, type, levels)}}: the frames every
    expression reads."""
    rng = np.random.default_rng(seed)
    a = np.round(rng.normal(0, 3, N), 2)
    a[[3, 17]] = np.nan
    a[5] = 0.0
    b = np.round(rng.uniform(-5, 5, N), 1)
    b[[8]] = np.nan
    c = rng.integers(-4, 9, N).astype(np.float64)
    pos = np.round(rng.uniform(0.1, 9, N), 3)
    unit = np.round(rng.uniform(-0.95, 0.95, N), 3)
    g = rng.integers(0, 3, N).astype(np.float64)
    g[[4]] = np.nan
    h = rng.integers(0, 4, N).astype(np.float64)
    words = np.array(["alpha beta", "Gamma", "  delta ", "a,b,c", "banana",
                      None, "omega alpha"], object)
    s = words[rng.integers(0, len(words), N)]
    t = 1.58e12 + np.floor(rng.uniform(0, 4e9, N) / 1000) * 1000
    t[[2]] = np.nan
    d = np.array(["2020-01-15", "2019-12-31", "bad", None], object)
    return {
        "fnum": {"a": (a, "num", None), "b": (b, "num", None),
                 "c": (c, "num", None)},
        "fpos": {"p": (pos, "num", None), "q": (pos[::-1].copy(), "num",
                                                 None)},
        "funit": {"u": (unit, "num", None)},
        "fcat": {"g": (g, "enum", ["lo", "mid", "hi"]),
                 "x": (np.round(rng.normal(size=N), 3), "num", None),
                 "h": (h, "enum", ["1", "2", "10", "3.5"])},
        "fint": {"i": (c.copy(), "num", None)},
        "fstr": {"s": (s, "str", None)},
        "ftime": {"t": (t, "time", None)},
        "fdate": {"d": (d[rng.integers(0, 4, 8)], "str", None)},
        "fsmall": {"a": (a[:6].copy(), "num", None),
                   "b": (b[:6].copy(), "num", None)},
    }


def build(F, key, cols):
    vecs = []
    for v, t, lv in cols.values():
        if t == "str":
            vecs.append(F.Vec.from_numpy(np.asarray(v, object), type="str"))
            continue
        m = np.isnan(v)
        vecs.append(F.Vec._from_floats(np.where(m, 0.0, v), m, t, lv))
    return F.Frame(list(cols), vecs, key=key)


@pytest.fixture()
def frames():
    """Fresh frames under the same keys in both stores (prims mutate)."""
    data = frame_data()
    for key, cols in data.items():
        build(JF, key, cols)
        build(TF, key, cols)
    yield data
    for key in data:
        JDKV.remove(key)
        DKV.remove(key)


def values(v, n):
    if v.type in ("str", "uuid"):
        return list(v.to_numpy()[:n])
    x = v.as_f32()
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.asarray(x, np.float64)[:n]


def same(want, got, tol=0.0, what=""):
    """Results equal: frames by names, types, levels and values; lists
    element by element; numbers within `tol` relative (NaN = NaN)."""
    if isinstance(want, JF.Frame):
        assert isinstance(got, TF.Frame), what
        assert list(got.names) == list(want.names), what
        assert got.nrows == want.nrows, what
        for name, jv, tv in zip(want.names, want.vecs, got.vecs):
            assert tv.type == jv.type, (what, name)
            assert tv.levels() == jv.levels(), (what, name)
            a, b = values(jv, want.nrows), values(tv, got.nrows)
            if isinstance(a, list):
                assert b == a, (what, name)
            else:
                np.testing.assert_allclose(b, a, rtol=tol, atol=tol * 0.1,
                                           err_msg=f"{what} {name}")
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), what
        for x, y in zip(want, got):
            same(x, y, tol, what)
        return
    if isinstance(want, (float, int, np.floating, np.integer)) \
            and not isinstance(want, bool):
        if math.isnan(float(want)):
            assert math.isnan(float(got)), what
        else:
            assert got == pytest.approx(float(want), rel=tol, abs=tol * 0.1
                                        ), what
        return
    assert got == want, what


def both(expr):
    return JR.rapids_exec(expr), TR.rapids_exec(expr)


# ---------------------------------------------------------------------------
# Every prim of rapids.py: one or more expressions each, over the frames
# above; TOL gives the relative tolerance where it is not 0.
_OPS = ("+", "-", "*", "/", "^", "**", "%", "mod", "intDiv", "%/%", "==",
        "!=", ">", ">=", "<", "<=", "&", "|", "&&", "||")
_MATH = ("abs", "exp", "log", "log2", "log10", "log1p", "expm1", "sqrt",
         "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
         "tanh", "floor", "ceiling", "trunc", "sign", "gamma")
_ON_UNIT = ("asin", "acos")
_ON_POS = ("log", "log2", "log10", "sqrt", "gamma")


def _math_arg(m):
    return "funit" if m in _ON_UNIT else "fpos" if m in _ON_POS else "fnum"


RAPIDS_EXPRS = {
    **{op: [f"({op} fnum 2.5)", f"({op} -1.5 fnum)",
            f"({op} fnum fnum)", f"({op} 7 -3)", f"({op} 1 0.1)"]
       for op in _OPS},
    "!": ["(! fnum)", "(! 0)"], "not": ["(not fnum)"],
    **{m: [f"({m} {_math_arg(m)})", f"({m} 0.5)"] for m in _MATH},
    "round": ["(round fnum 1)", "(round 2.345 2)"],
    "signif": ["(signif fnum 2)", "(signif 1234.5 3)"],
    "sum": ["(sum fnum)"], "mean": ["(mean fnum)"], "min": ["(min fnum)"],
    "max": ["(max fnum)"], "sd": ["(sd fnum)"], "var": ["(var fnum)"],
    "median": ["(median fnum)"], "prod": ["(prod fsmall)"],
    "all": ["(all fnum)", "(all fpos)"], "any": ["(any fnum)"],
    "cumsum": ["(cumsum fnum)"], "cumprod": ["(cumprod fsmall)"],
    "cummin": ["(cummin fnum)"], "cummax": ["(cummax fnum)"],
    "nrow": ["(nrow fnum)"], "ncol": ["(ncol fnum)"],
    "colnames": ["(colnames fcat)"], "names": ["(names fnum)"],
    "cols": ["(cols fnum [0 2])", "(cols fnum [-1])", "(cols fnum \"b\")",
             "(cols fnum 1)"],
    "cols_py": ["(cols_py fcat [\"x\" \"g\"])"],
    "rows": ["(rows fcat (> (cols fnum [0]) 0))", "(rows fstr [0 2 4])",
             "(rows fnum [-1 -2])", "(rows fcat 3)"],
    "cbind": ["(cbind fnum fcat fnum)", "(cbind fpos fpos)"],
    "rbind": ["(rbind fnum fnum)", "(rbind fcat fcat)",
              "(rbind fstr fstr)"],
    "setnames": ["(setnames fnum [0 2] [\"x\" \"y\"])"],
    "colnames=": ["(colnames= fcat 1 \"z\")"],
    "tmp=": ["(tmp= t_1 (+ fnum 1))", "(tmp= t_2 fcat)"],
    "rm": ["(rm fsmall)"],
    ":=": ["(:= fnum 5 [1] [])", "(:= fnum (cols fpos [0]) [0 3] [])"],
    "is.na": ["(is.na fnum)"],
    "ifelse": ["(ifelse (> fnum 0) fnum -1)", "(ifelse 1 2 3)"],
    "h2o.which": ["(h2o.which (> (cols fnum [0]) 0))"],
    "na.omit": ["(na.omit fnum)"],
    "unique": ["(unique fint)", "(unique fcat)"],
    "table": ["(table fint)", "(table fcat)"],
    "as.factor": ["(as.factor fint)", "(as.factor fstr)"],
    "asfactor": ["(asfactor fpos)"],
    "as.numeric": ["(as.numeric (cols fcat [2]))", "(as.numeric fcat)"],
    "asnumeric": ["(asnumeric fint)"],
    "as.character": ["(as.character fcat)", "(as.character fnum)"],
    "ascharacter": ["(ascharacter fint)"],
    "levels": ["(levels fcat)", "(levels fnum)"],
    "sort": ["(sort fnum [0] [0])", "(sort fcat [0 1] [1 0])"],
    "merge": ["(merge fnum fint 1 0 [2] [0] \"auto\")",
              "(merge fnum fnum 0 0 [2] [2] \"auto\")",
              "(merge fnum fint 0 1 [2] [0] \"auto\")",
              "(merge fcat fcat 1 1 [2] [2] \"auto\")"],
    "GB": ["(GB fcat [0] sum 1 \"rm\" mean 1 \"rm\" nrow 1 \"rm\")",
           "(GB fcat [2] median 1 \"rm\" mode 2 \"rm\" sd 1 \"rm\")",
           "(GB fint [0] median 0 \"rm\" var 0 \"rm\" sum 0 \"rm\")"],
    "group_by": ["(group_by fnum [2] min 0 \"rm\" max 1 \"rm\" var 0 \"all\")",
                 "(group_by fint [0] count 0 \"rm\" median 0 \"rm\")"],
    "quantile": ["(quantile fnum [0.1 0.5 0.9] \"interpolate\")"],
    "h2o.impute": ["(h2o.impute fnum 0 \"mean\")",
                   "(h2o.impute fnum 1 \"median\")",
                   "(h2o.impute fcat 0 \"mode\")"],
    "toupper": ["(toupper fstr)", "(toupper fcat)"],
    "tolower": ["(tolower fstr)"], "trim": ["(trim fstr)"],
    "nchar": ["(nchar fstr)", "(nchar fcat)"], "strlen": ["(strlen fstr)"],
    "length": ["(length fcat)"],
    "replaceall": ["(replaceall fstr \"a\" \"X\" 0)"],
    "gsub": ["(gsub fstr \"A\" \"_\" 1)"],
    "replacefirst": ["(replacefirst fstr \"a\" \"X\" 0)"],
    "sub": ["(sub fcat \"i\" \"I\" 0)"],
    "substring": ["(substring fstr 1 3)", "(substring fcat 1)"],
    "strsplit": ["(strsplit fstr \" \")", "(strsplit fcat \"i\")"],
    "countmatches": ["(countmatches fstr \"a\")",
                     "(countmatches fcat [\"i\" \"o\"])"],
    **{p: [f"({p} ftime)"] for p in ("year", "month", "day", "hour",
                                      "minute", "second", "dayOfWeek")},
    "getrow": ["(getrow fnum)"],
    "h2o.runif": ["(h2o.runif fnum 42)"],
    "hist": ["(hist (cols fnum [0]) 5)", "(hist fpos [0 2 4 6 10])",
             "(hist fint)"],
    "scale": ["(scale fnum 1 1)", "(scale fnum 0 1)"],
    "apply": ["(apply fnum 2 {x . (sum x)})",
              "(apply fsmall 1 {x . (max x)})"],
}
TOL = {"sum": 1e-6, "mean": 1e-6, "sd": 1e-6, "var": 1e-6, "prod": 1e-6,
       "scale": 1e-5, "quantile": 1e-6, "GB": 1e-6, "group_by": 1e-6,
       "apply": 1e-6, "^": 1e-6, "**": 1e-6, "round": 1e-6, "signif": 1e-6,
       **{m: 1e-6 for m in _MATH}, "gamma": 1e-5}


def test_rapids_table_covers_every_prim_of_rapids_py():
    import test_torch_prims_ext as ext
    others = set(ext.EXT_EXPRS) | ext.RAISES | ext.SPECIAL
    assert set(RAPIDS_EXPRS) | others == set(JR.PRIMS) == set(TR.PRIMS)
    assert not set(RAPIDS_EXPRS) & others


@pytest.mark.parametrize("name", sorted(RAPIDS_EXPRS))
def test_prim_matches_jax(name, frames):
    for expr in RAPIDS_EXPRS[name]:
        want, got = both(expr)
        same(want, got, TOL.get(name, 0.0), expr)
    if name == "tmp=":
        assert DKV.get("t_1") is not None and JDKV.get("t_1") is not None
        assert DKV.get("fcat") is not None      # the source keeps its key
        for k in ("t_1", "t_2"):
            DKV.remove(k)
            JDKV.remove(k)


def test_sort_by_a_string_column_raises_in_both(frames):
    """np.lexsort of the strings (and -colv descending): inherited."""
    for R in (JR, TR):
        for asc in (0, 1):
            with pytest.raises(TypeError):
                R.rapids_exec(f"(sort fstr [0] [{asc}])")


def test_group_by_host_path_na_keys_form_one_group_last(frames):
    got = TR.rapids_exec("(GB fcat [0] median 1 \"rm\")")
    keys = got.vecs[0].to_numpy()
    assert got.nrows == 4 and np.isnan(keys[-1])
    x = frames["fcat"]["x"][0].astype(np.float32)
    g = frames["fcat"]["g"][0]
    assert got.vecs[1].to_numpy()[-1] == np.median(x[np.isnan(g)])


def test_group_by_host_path_matches_numpy_medians_and_modes():
    rng = np.random.default_rng(4)
    k = rng.integers(0, 30, 3000).astype(np.float64)
    x = np.round(rng.uniform(0, 100, 3000), 6)
    x[rng.random(3000) < 0.05] = np.nan
    m = rng.integers(0, 5, 3000).astype(np.float64)
    build(TF, "fgb", {"k": (k, "num", None), "x": (x, "num", None),
                      "m": (m, "num", None)})
    got = TR.rapids_exec("(GB fgb [0] median 1 \"rm\" mode 2 \"rm\" "
                         "sd 1 \"rm\")")
    x32 = x.astype(np.float32)
    for g in range(30):
        sel = k == g
        assert got.vecs[1].to_numpy()[g] == np.nanmedian(x32[sel])
        assert got.vecs[2].to_numpy()[g] == \
            np.bincount(m[sel].astype(int)).argmax()
        assert got.vecs[3].to_numpy()[g] == pytest.approx(
            np.nanstd(x[sel], ddof=1), rel=1e-6)
    DKV.remove("fgb")


# ---------------------------------------------------------------------------
PARSE_CORPUS = [
    "(+ 1 2)", "(tmp= py_1 (cols_py fr [0 1]))", "(rows fr [0:5 7])",
    "(GB fr [0] sum 1 \"all\" mean 2 'rm')", "{x y . (+ x y)}",
    "({x . (* x 2)} 3)", "[\"a\" 'b c' 1.5]", "(== #4 %fr)", "(%/% 7 2)",
    "(ifelse TRUE NA nan)", "(substring \"a\\\"b\" 1 2)", "[-1:-3]",
    "(apply fr 1 {row . (sum row)})", "(merge a b 1 0 [] [] \"auto\")",
    "  ( cols   fr\n [ 1 ] )  ", "(h2o.which False)", "{. 5}", "3.5e-2",
    "sym_bol.x", "(& 1 0)",
]


@pytest.mark.parametrize("expr", PARSE_CORPUS)
def test_parse_gives_the_jax_tree(expr):
    assert repr(TR.parse(expr)) == repr(JR.parse(expr))   # NaN == NaN


@pytest.mark.parametrize("bad", ["(+ 1 2", "[1 2", "\"abc"])
def test_parse_errors_as_jax(bad):
    with pytest.raises(ValueError):
        JR.parse(bad)
    with pytest.raises(ValueError):
        TR.parse(bad)


def test_session_temps_released_at_its_end(frames):
    s = TR.Session("s1")
    TR.rapids_exec("(tmp= tt_1 (* fnum 2))", s)
    TR.rapids_exec("(tmp= tt_2 (+ tt_1 1))", s)
    out = TR.rapids_exec("(sum tt_2)", s)
    assert out == pytest.approx(JR.rapids_exec(
        "(sum (+ (* fnum 2) 1))"), rel=1e-6)
    assert s.tmps == {"tt_1", "tt_2"}
    TR.rapids_exec("(rm tt_1)", s)
    assert DKV.get("tt_1") is None and DKV.get("tt_2") is not None
    s.end()
    assert DKV.get("tt_2") is None and not s.tmps


def test_lambdas_and_unknown_ops(frames):
    for expr in ("({x . (* x 2)} 3)", "({x y . (- x y)} 10 4)",
                 "({x . (sum (cols x [0]))} fnum)",
                 "(apply fcat 2 {col . (max col)})"):
        want, got = both(expr)
        same(want, got, 1e-6, expr)
    with pytest.raises(ValueError, match="unknown Rapids op"):
        TR.rapids_exec("(no_such_op 1)")


def test_top_level_rapids_entry_point(frames):
    assert h2o3_tpu_torch.rapids("(+ 1 0.1)") == 1.100000023841858
    got = h2o3_tpu_torch.rapids("(nrow fnum)")
    assert got == float(N)
