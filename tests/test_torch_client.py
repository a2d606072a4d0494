"""client.py of the port against the JAX package's, on the CPU: the twins
of the client-driven cases of test_pyunit_port.py, _munging.py,
test_client_frame_ext.py and test_psvm_client.py (the algorithm cases of
those files and of test_pyunit_port_algos.py train on `Frame`s, not
through the client, and have their twins in the estimators' tests).

Each case runs the same h2o-py calls through `h2o3_tpu.client` and
`h2o3_tpu_torch.client` (the port's cloud on the CPU) on the same data:
frames made from seeded numpy draws, and scikit-learn's iris and wine
tables written as CSV and read back through `import_file`. The results
must agree: integer, categorical and string values, names and shapes
equal; other numbers (f32 arithmetic and reductions, summed in another
order) within 1e-6 of the largest magnitude of the JAX result; sd and var
as `test_sd_and_var` states. Both
clients send the same Rapids text (`test_rapids_text_is_the_jax_clients`).
pandas is not used: `as_data_frame()` must raise ImportError without it.
"""

import sys

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu import client as JC
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu_torch import client as TC
from h2o3_tpu_torch.core.kvstore import DKV as TDKV

RTOL = 1e-6
IRIS_COLS = ["sepal_len", "sepal_wid", "petal_len", "petal_wid"]


def _write_csv(path, cols):
    names = list(cols)
    n = len(cols[names[0]])
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(n):
            f.write(",".join(str(cols[c][i]) if not isinstance(
                cols[c][i], float) else repr(cols[c][i]) for c in names)
                + "\n")
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from sklearn.datasets import load_iris, load_wine
    h2o3_tpu_torch.init(device="cpu")
    j_before, t_before = set(JDKV.keys()), set(TDKV.keys())
    d = tmp_path_factory.mktemp("client")
    iris = load_iris()
    cols = {c: iris.data[:, j].tolist() for j, c in enumerate(IRIS_COLS)}
    cols["species"] = list(np.asarray(iris.target_names)[iris.target])
    wine = load_wine()
    wcols = {c.replace("/", "_"): wine.data[:, j].tolist()
             for j, c in enumerate(wine.feature_names)}
    wcols["klass"] = [f"c{t}" for t in wine.target]
    na = dict(cols)
    na["sepal_len"] = [float("nan")] * 20 + cols["sepal_len"][20:]
    yield {"iris": _write_csv(d / "iris.csv", cols),
           "wine": _write_csv(d / "wine.csv", wcols),
           "iris_na": _write_csv(d / "iris_na.csv", na)}
    for k in set(JDKV.keys()) - j_before:
        JDKV.remove(k)
    for k in set(TDKV.keys()) - t_before:
        TDKV.remove(k)


@pytest.fixture(autouse=True)
def _clean_stores():
    j_before, t_before = set(JDKV.keys()), set(TDKV.keys())
    yield
    for k in set(JDKV.keys()) - j_before:
        JDKV.remove(k)
    for k in set(TDKV.keys()) - t_before:
        TDKV.remove(k)


def _df(h):
    rng = np.random.default_rng(7)
    n = 400
    return h.H2OFrame({
        "a": rng.normal(0, 1, n),
        "b": rng.normal(5, 2, n),
        "g": np.array(["u", "v", "w"], object)[rng.integers(0, 3, n)],
        "i": rng.integers(0, 10, n).astype(float),
    })


def _xy(h):
    rng = np.random.default_rng(4)
    return h.H2OFrame({"x": rng.normal(size=50).tolist(),
                       "y": rng.normal(size=50).tolist()})


def V(x):
    """A result as comparable values: a frame as its names and columns
    (categorical and string columns as their strings), a scalar as a
    float, a list element by element."""
    if hasattr(x, "frame") and hasattr(x, "names"):
        cols = []
        for v in x.frame.vecs:
            vals = v.to_numpy()
            if v.type == "enum":
                dom = v.levels()
                vals = np.array([None if np.isnan(c) else dom[int(c)]
                                 for c in vals], object)
            elif v.type in ("str", "uuid"):
                vals = np.asarray(vals, object)
            else:
                vals = np.asarray(vals, np.float64)
            cols.append((v.type, vals))
        return {"names": list(x.names), "shape": tuple(x.shape),
                "cols": cols}
    if isinstance(x, (list, tuple)):
        return [V(e) for e in x]
    if isinstance(x, dict):
        return {k: V(e) for k, e in x.items()}
    if isinstance(x, (str, bool)) or x is None:
        return x
    a = np.asarray(x)
    if a.dtype.kind in "OUS":
        return a.tolist()
    return a.astype(np.float64)


def same(got, want, where="result"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (where, got, want)
        for j, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{j}]")
    elif isinstance(want, np.ndarray) and want.dtype.kind == "O":
        assert got.dtype.kind == "O" and got.tolist() == want.tolist(), where
    elif isinstance(want, np.ndarray):
        got = np.asarray(got, np.float64)
        assert got.shape == want.shape, (where, got.shape, want.shape)
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan), where
        w, g = want[~nan], got[~nan]
        if np.all(w == np.round(w)) and np.all(g == np.round(g)):
            assert np.array_equal(g, w), where         # integral values
        elif w.size:
            tol = RTOL * max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= tol, \
                (where, float(np.abs(g - w).max()), tol)
    else:
        assert got == want, (where, got, want)


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# ---- test_pyunit_port.py -------------------------------------------------
@case
def munging_slice_and_filter(h, data):
    df = _df(h)
    sub = df[df["a"] > 0]
    return [V(sub), sub["a"].min(), df[["a", "b"]].names]


@case
def munging_arithmetic_and_assign(h, data):
    df = _df(h)
    df["c"] = df["a"] * 2 + df["b"]
    return [V(df["c"]), df["c"].mean(), df["a"].mean(), df["b"].mean()]


@case
def munging_group_by(h, data):
    return V(_df(h).group_by("g").mean("a").count().get_frame())


@case
def munging_merge(h, data):
    left = h.H2OFrame({"k": [1.0, 2.0, 3.0], "x": [10.0, 20.0, 30.0]})
    right = h.H2OFrame({"k": [2.0, 3.0, 4.0], "y": [200.0, 300.0, 400.0]})
    return V(left.merge(right))


@case
def munging_cbind_rbind(h, data):
    df = _df(h)
    return [V(df[["a"]].cbind(df[["b"]])), V(df[["a"]].rbind(df[["a"]]))]


@case
def munging_impute(h, data):
    f = h.H2OFrame({"x": np.array([1.0, np.nan, 3.0, np.nan, 5.0])})
    f.impute("x", method="mean")
    return V(h.get_frame(f.frame_id))


@case
def munging_sort_unique_table(h, data):
    df = _df(h)
    return [V(df.sort("a")), V(df[["g"]].unique()), V(df[["g"]].table())]


@case
def munging_ifelse_and_scale(h, data):
    df = _df(h)
    sc = df[["a", "b"]].scale()
    return [V(sc), abs(sc["a"].mean()) < 1e-5, abs(sc["b"].mean()) < 1e-5]


@case
def munging_asfactor_levels(h, data):
    f = _df(h)[["i"]].asfactor()
    return [f.levels(), V(f)]


@case
def munging_na_handling(h, data):
    f = h.H2OFrame({"x": [1.0, np.nan, 3.0], "y": [np.nan, 2.0, 3.0]})
    na = f.isna()
    return [V(na), na.sum()]


@case
def munging_split_frame(h, data):
    tr, te = _df(h).split_frame(ratios=[0.8], seed=42)
    return [V(tr), V(te)]


# ---- test_pyunit_port_munging.py (iris, wine through import_file) --------
@case
def iris_shape_types_and_values(h, data):
    iris = h.import_file(data["iris"])
    return [iris.shape, iris.types, V(iris)]


@case
def iris_reduce(h, data):
    iris = h.import_file(data["iris"])
    return [[getattr(iris[c], op)() for op in ("mean", "sum", "min", "max",
                                               "median")]
            for c in IRIS_COLS]


@case
def iris_math(h, data):
    iris = h.import_file(data["iris"])
    return [V(getattr(iris[c], fn)()) for c in ("sepal_len", "petal_wid")
            for fn in ("log", "exp", "sqrt", "abs", "floor", "ceil")]


@case
def iris_binops(h, data):
    iris = h.import_file(data["iris"])
    a, b = iris["sepal_len"], iris["petal_len"]
    return [V(a + b), V(a - b), V(a * b), V(a / b), V(a % b), V(a ** 2),
            V(2 - a), V(1 / b)]


@case
def iris_compare_and_filter(h, data):
    iris = h.import_file(data["iris"])
    a = iris["sepal_len"]
    out = [V(a > 5.8), V(a >= 5.8), V(a < 5.8), V(a <= 5.8), V(a == 5.8),
           V(a != 5.8), V((a > 5) & (a < 6)), V((a < 5) | (a > 6)), V(~(a
                                                                     > 5))]
    out += [iris[iris["sepal_len"] > t].nrows for t in (4.9, 5.8, 6.7)]
    return out


@case
def iris_select_and_factors(h, data):
    iris = h.import_file(data["iris"])
    return [iris[["sepal_len", "petal_wid"]].names, iris[IRIS_COLS].shape,
            V(iris["species"].table()), V(iris["species"].unique()),
            V(iris["species"].asnumeric()), V(iris[0]), V(iris[[1, 3]]),
            V(iris[2:7])]


@case
def iris_group_by(h, data):
    iris = h.import_file(data["iris"])
    g = iris.group_by("species")
    for agg in ("mean", "min", "max", "sum"):
        for col in ("sepal_len", "petal_len"):
            getattr(g, agg)(col)
    return [V(g.count().get_frame()),
            V(iris.group_by("species").median("petal_wid").get_frame())]


@case
def iris_sort_and_quantile(h, data):
    iris = h.import_file(data["iris"])
    out = [V(iris.sort(c)[c]) for c in ("sepal_len", "petal_wid")]
    out.append(V(iris.sort(["species", "sepal_len"], ascending=False)))
    for c in IRIS_COLS:
        q = iris[c]._x(f'(quantile {iris[c]._fr.key} [0.1 0.25 0.5 0.75 '
                       f'0.9] "interpolate")')
        out.append(V(q))
    return out


@case
def iris_scale_impute_cbind_merge(h, data):
    iris = h.import_file(data["iris"])
    out = [V(iris[IRIS_COLS].scale())]
    fr = h.import_file(data["iris_na"])
    out.append(V(fr.impute("sepal_len", method="mean")))
    a, b = iris[["sepal_len"]], iris[["petal_len"]]
    out += [V(a.cbind(b)), V(a.rbind(a))]
    gb = iris.group_by("species").mean("sepal_len").get_frame()
    out.append(V(iris.merge(gb)))
    return out


@case
def wine_stats_filter_table(h, data):
    wine = h.import_file(data["wine"])
    out = [wine.shape, [getattr(wine["alcohol"], op)()
                        for op in ("mean", "min", "max")]]
    sub = wine[wine["alcohol"] > 13.0]
    out += [sub.nrows, sub["malic_acid"].mean(), V(wine["klass"].table())]
    return out


# ---- test_client_frame_ext.py ---------------------------------------------
@case
def string_ops(h, data):
    f = h.H2OFrame({"s": [" Foo bar ", "BAZ foo", "foo"]})
    f2 = h.H2OFrame_from(f.frame)
    return [V(f.toupper()), V(f.tolower()), V(f.trim()), V(f.lstrip()),
            V(f.rstrip()), V(f.gsub("foo", "X")), V(f.sub("o", "0")),
            V(f.nchar()), V(f.countmatches("foo")), V(f.substring(0, 3)),
            V(f.strsplit(" ")), V(f2)]


@case
def stats_and_cumulative(h, data):
    fr = _xy(h)
    x = fr[["x"]]
    return [V(x.cumsum()), V(x.cumprod()), V(x.cummax()), V(x.cummin()),
            V(x.round(2)), V(x.signif(3)), x.cor(fr[["y"]]), V(fr.cor()),
            x.kurtosis(), x.skewness()]


@case
def time_accessors(h, data):
    import datetime as dt
    times = [dt.datetime(2023, 5, 17, 14, 30), dt.datetime(2024, 12, 1, 7,
                                                           5)]
    ms = np.array([int(t.replace(tzinfo=dt.timezone.utc).timestamp() * 1000)
                   for t in times], np.int64)
    pkg = sys.modules[h.__name__.rsplit(".", 1)[0]]
    f = h.H2OFrame_from(pkg.Frame.from_dict(
        {"t": ms.astype("datetime64[ms]")}))
    return [V(getattr(f, a)()) for a in ("year", "month", "day", "hour",
                                         "minute", "second", "week",
                                         "dayOfWeek")]


@case
def na_match_cut(h, data):
    f = h.H2OFrame({"v": [1.0, None, 3.0, None, 5.0]})
    g = h.H2OFrame({"g": ["a", "b", "c", "a"]})
    fr = _xy(h)
    return [f.any_na(), f.nacnt(), V(f.na_omit()), V(g.match(["a", "c"])),
            V(fr[["x"]].cut([-10, 0, 10])), V(fr[["x"]].which())]


@case
def hist_and_entropy(h, data):
    f = h.H2OFrame({"x": list(np.linspace(0, 1, 64))})
    s = h.H2OFrame({"s": ["aa", "ab", "ba"]})
    return [V(f.hist()), V(s.entropy()), V(f.hist(breaks=[0, 0.5, 1]))]


@case
def regex_escaping_and_labels(h, data):
    f = h.H2OFrame({"s": ["a1", "bb", "c22"]})
    v = h.H2OFrame({"x": [0.5, 1.5, 2.5]})
    return [V(f.grep(r"\d+", output_logical=True)), V(f.grep("b")),
            V(f.countmatches("2")),
            V(v.cut([0, 1, 2, 3], labels=["lo", "mid", "hi"])),
            V(v.hist(breaks=[0, 1, 2, 3])), V(v.rep_len(7)), V(v.t())]


@case
def topn_direction(h, data):
    f = h.H2OFrame({"x": list(np.arange(100.0))})
    return [V(f.topn("x", nPercent=10, grabTopN=-1)),
            V(f.topn("x", nPercent=10, grabTopN=1))]


# ---- test_psvm_client.py ---------------------------------------------------
@case
def client_frame_ops(h, data):
    fr = h.H2OFrame({"a": [1.0, 2.0, 3.0, 4.0],
                     "b": [10.0, 20.0, 30.0, 40.0]})
    c = fr["a"] + fr["b"] * 2
    sub = fr[fr["a"] > 2]
    mean = fr["a"].mean()
    fr["d"] = fr["a"].sqrt()
    return [fr.shape, V(c), V(sub), mean, V(fr), fr.names, len(fr)]


@case
def client_groupby_and_split(h, data):
    fr = h.H2OFrame({"g": np.array(["a", "b", "a", "b"], object),
                     "v": [1.0, 2.0, 3.0, 4.0]})
    tr, te = fr.split_frame(ratios=[0.5], seed=42)
    return [V(fr.group_by("g").sum("v").get_frame()), V(tr), V(te)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_client_twin(name, data):
    want = V(CASES[name](JC, data))
    got = V(CASES[name](TC, data))
    same(got, want, name)


@pytest.mark.parametrize("table,col", [("iris", "sepal_len"),
                                       ("iris", "petal_wid"),
                                       ("wine", "alcohol")])
def test_sd_and_var(data, table, col):
    """sd and var: the port's within 1e-6 of float64 numpy over the
    column's f32 values; the JAX package's rollups sum squares in f32
    (2.5e-6-5e-6 off here), so the two clients agree within 1e-5."""
    for h in (JC, TC):
        fr = h.import_file(data[table])[col]
        x = fr.frame.vecs[0].to_numpy().astype(np.float32).astype(np.float64)
        sd, var = fr.sd(), fr.var()
        if h is TC:
            assert abs(sd - x.std(ddof=1)) <= 1e-6 * x.std(ddof=1)
            assert abs(var - x.var(ddof=1)) <= 2e-6 * x.var(ddof=1)
            assert abs(sd - jsd) <= 1e-5 * jsd
            assert abs(var - jvar) <= 2e-5 * jvar
        else:
            jsd, jvar = sd, var


def test_rapids_text_is_the_jax_clients(data, monkeypatch):
    """Every case sends the JAX client's Rapids text, with frame keys
    masked (each store names its temporaries)."""
    import re
    sent = {"jax": [], "port": []}

    def recorder(tag, fn):
        def rec(expr, *a, **kw):
            sent[tag].append(expr)
            return fn(expr, *a, **kw)
        return rec
    monkeypatch.setattr(JC, "rapids_exec", recorder("jax", JC.rapids_exec))
    monkeypatch.setattr(TC, "rapids_exec", recorder("port", TC.rapids_exec))
    keys = re.compile(r"[A-Za-z_][\w.\-]*_[0-9a-f]{6,}|frame\w*|py_\w+")
    for name in ("munging_split_frame", "string_ops", "na_match_cut",
                 "client_frame_ops", "client_groupby_and_split"):
        sent["jax"].clear()
        sent["port"].clear()
        CASES[name](JC, data)
        CASES[name](TC, data)
        assert sent["jax"], name
        assert [keys.sub("K", e) for e in sent["port"]] == \
            [keys.sub("K", e) for e in sent["jax"]], name


@pytest.mark.parametrize("text", [
    "[1 2 3]", "[]", "[ 4.5  -2 +3 1e3 2.5E-2 ]", "[0 1:4 9]", "[1 NaN 2]",
    '["a" "b"]', "[- 1]", "[1e]", "[7 True]"])
def test_number_lists_parse_as_the_token_loop(text):
    """The Rapids parser's one-pass read of a [...] list of plain numbers
    (split_frame sends millions) gives what the token-by-token loop
    gives; lists with spans, names or strings take the loop."""
    from h2o3_tpu_torch.rapids import rapids as R
    got = R._Parser(text)._numlist()
    plain = R._PLAIN_NUMS
    try:
        R._PLAIN_NUMS = R.re.compile(r"(?!)")     # never the one-pass read
        want = R._Parser(text)._numlist()
    finally:
        R._PLAIN_NUMS = plain
    assert repr(got) == repr(want)


def test_as_data_frame_without_pandas_raises(monkeypatch):
    f = TC.H2OFrame({"a": [1.0, 2.0]})
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="needs pandas"):
        f.as_data_frame()
    with pytest.raises(ImportError, match="needs pandas"):
        f.as_data_frame(use_pandas=False)
