"""The port's sort, group-by and merge on the card (ops/device_sort.py)
against the JAX package's (XLA on the CPU), at about 5,000 rows of
chip_smoke.py's db-benchmark generators (`groupby_columns`,
`join_tables`), with NAs, signed zeros, duplicate keys and unmatched
levels put in.

Tolerances:
- sort: the same row order, every column bit for bit (f32 bits; the
  string column's strings and levels equal);
- group-by: keys, sizes, counts, minima and maxima equal; sums and means
  within 1e-6 relative (the port sums in exact fixed point, the JAX
  package in f32); var and sd within 1e-4 relative (both compute
  s2 - n·mean² in f32, which cancels);
- inner and left joins: the device paths of both packages give the same
  rows in the same order, every column bit for bit;
- right and outer joins (and a string key, an empty side): the port's own
  join against the JAX package's pandas path: names, types, levels and
  values equal, in pandas' row order (an outer join in sorted key order,
  a right join in right-row order); an inner join on string keys as the
  same rows (pandas 3 returns it in its hash table's order).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import h2o3_tpu_torch
from h2o3_tpu.core import frame as JF
from h2o3_tpu.ops import device_sort as JDS
from h2o3_tpu.rapids import rapids as JR
from h2o3_tpu_torch.core import frame as TF
from h2o3_tpu_torch.ops import device_sort as DS

ROOT = Path(__file__).resolve().parents[1]
N = 5000
_spec = importlib.util.spec_from_file_location("chip_smoke_gen",
                                               ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)


@pytest.fixture(scope="module", autouse=True)
def cpu_cloud():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def build(F, cols, strings=()):
    """A Frame of package F (the JAX package's frame module or the
    port's) from {name: (values, levels)}; the names in `strings` are
    object arrays made string columns."""
    vecs = []
    for name, (v, lv) in cols.items():
        if name in strings:
            vecs.append(F.Vec.from_numpy(np.asarray(v, object), type="str"))
            continue
        v = np.asarray(v, np.float64)
        m = np.isnan(v)
        vecs.append(F.Vec._from_floats(np.where(m, 0.0, v), m,
                                       F.T_CAT if lv is not None
                                       else F.T_NUM, lv))
    return F.Frame(list(cols), vecs)


def pair(cols, strings=()):
    return build(JF, cols, strings), build(TF, cols, strings)


def column(v, n):
    """A column's values: f32 bits as uint32, or the strings."""
    if v.type == "str":
        return list(v.to_numpy()[:n])
    x = v.as_f32()
    x = np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x,
                   np.float32)[:n]
    return x.view(np.uint32)


def same_frames(jf, tf, bits=True):
    """Names, types, levels and every value equal (bit for bit, or equal
    as numbers with NaN = NaN)."""
    assert list(jf.names) == list(tf.names)
    assert jf.nrows == tf.nrows
    n = tf.nrows
    for name, jv, tv in zip(tf.names, jf.vecs, tf.vecs):
        assert jv.type == tv.type, name
        assert jv.levels() == tv.levels(), name
        a, b = column(jv, n), column(tv, n)
        if tv.type == "str":
            assert a == b, name
            assert list(jv.levels_arr) == list(tv.levels_arr), name
        elif bits:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(a.view(np.float32),
                                          b.view(np.float32), err_msg=name)


def gb_cols(seed=20):
    cols = CS.groupby_columns(N, 10, seed)
    rng = np.random.default_rng(seed + 100)
    v3 = cols["v3"][0].copy()
    v3[rng.random(N) < 0.05] = np.nan
    cols["v3"] = (v3, None)
    k5 = cols["id5"][0].copy()
    k5[rng.random(N) < 0.03] = np.nan
    cols["id5"] = (k5, None)
    z = rng.integers(-2, 3, N).astype(np.float64)
    z[z == 0] = np.where(rng.random(int((z == 0).sum())) < 0.5, -0.0, 0.0)
    cols["z"] = (z, None)
    cols["s"] = (np.array([f"w{i}" for i in rng.integers(0, 40, N)],
                          object), None)
    return cols


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,by,asc", [
    ("ascending", ["id4"], [True]),
    ("descending", ["v2"], [False]),
    ("na_keys_ascending", ["v3"], [True]),
    ("na_keys_descending", ["id5"], [False]),
    ("signed_zeros_ascending", ["z"], [True]),
    ("signed_zeros_descending", ["z", "v1"], [False, True]),
    ("several_keys", ["id1", "v1", "v3"], [True, False, True]),
    ("categorical_key", ["id3", "id5"], [False, True]),
])
def test_sort_matches_jax(case, by, asc):
    cols = gb_cols()
    jf, tf = pair(cols, strings=("s",))
    idx = [tf.names.index(c) for c in by]
    same_frames(JDS.sort_frame(jf, idx, asc), DS.sort_frame(tf, idx, asc))


def test_lexsort_rows_ties_signed_zeros_in_row_order():
    K = torch.tensor([[0.0], [-0.0], [1.0], [-0.0], [0.0]])
    assert DS.lexsort_rows(K).tolist() == [0, 1, 3, 4, 2]
    assert DS.lexsort_rows(-K).tolist() == [2, 0, 1, 3, 4]


# ---------------------------------------------------------------------------
AGGS = ("sum", "mean", "min", "max", "var", "sd", "nrow", "count")
RTOL = {"sum": 1e-6, "mean": 1e-6}


def square_scale(key_cols, x):
    """Each group's sum of squares over (n - 1), groups in sorted key
    order (NA last): the size of the f32 rounding that s2 - n·mean²
    carries into var."""
    K = np.column_stack([np.where(np.isnan(k), 3e38, np.float32(k))
                         for k in key_cols])
    _, gid = np.unique(K, axis=0, return_inverse=True)
    gid = gid.reshape(-1)
    ok = ~np.isnan(x)
    x2 = np.where(ok, np.float32(x).astype(np.float64) ** 2, 0.0)
    cnt = np.bincount(gid, weights=ok)
    return np.bincount(gid, weights=x2) / np.maximum(cnt - 1, 1)


def check_groups(got_j, got_t, aggs, scales=None):
    """Keys and exact aggregates equal; sums and means within RTOL; var
    (and sd squared) within 1e-5 of the group's sum of squares over
    (n - 1) plus 1e-4 relative."""
    jn, jc, jd = got_j
    tn, tc, td = got_t
    assert jn == tn
    assert jd == td
    nk = len(jn) - len(aggs)
    for k, (name, a, b) in enumerate(zip(jn, jc, tc)):
        b = b.cpu().numpy().astype(np.float64)
        a = np.asarray(a, np.float64)
        fn, cj = aggs[k - nk] if k >= nk else (None, None)
        if fn in RTOL:
            np.testing.assert_allclose(b, a, rtol=RTOL[fn], atol=1e-9,
                                       err_msg=name)
        elif fn in ("var", "sd"):
            p = 2 if fn == "sd" else 1
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            ok = ~np.isnan(a)
            err = np.abs(b[ok] ** p - a[ok] ** p)
            assert np.all(err <= 1e-5 * scales[cj][ok]
                          + 1e-4 * a[ok] ** p), name
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("by", [["id1"], ["id4", "id5"], ["id3"],
                                ["id1", "id2", "id4", "id5"], ["z"]])
def test_group_by_every_aggregate_matches_jax(by):
    cols = gb_cols(7)
    jf, tf = pair(cols, strings=("s",))
    idx = [tf.names.index(c) for c in by]
    aggs = [(fn, tf.names.index(c)) for c in ("v1", "v3") for fn in AGGS]
    keys = [cols[c][0] for c in by]
    scales = {tf.names.index(c): square_scale(keys, cols[c][0])
              for c in ("v1", "v3")}
    check_groups(JDS.group_by_device(jf, idx, aggs),
                 DS.group_by_device(tf, idx, aggs), aggs, scales)


def test_group_by_empty_and_single_row_groups():
    key = np.array([1, 1, 2, 3, 3, 3, np.nan, np.nan])
    val = np.array([np.nan, np.nan, 4.0, 1.0, np.nan, 2.5, 7.0, 8.0])
    jf, tf = pair({"k": (key, None), "x": (val, None)})
    aggs = [(fn, 1) for fn in AGGS]
    got = DS.group_by_device(tf, [0], aggs)
    check_groups(JDS.group_by_device(jf, [0], aggs), got, aggs,
                 {1: square_scale([key], val)})
    mean = got[1][2].numpy()
    assert np.isnan(mean[0]) and mean[1] == 4.0    # all-NA, one row
    assert np.isnan(got[1][5][1].numpy())           # var of one value
    assert DS.group_by_device(tf, [0], [("median", 1)]) is None


def test_group_sums_keep_each_groups_precision_beside_an_outlier():
    """Each group sums at its own fixed-point scale: a row of 1e9 in one
    group leaves a group of 0.01s, and one of values in [0, 1), within
    1e-6 of float64 numpy (sums, means, sd) on the device path and on the
    host path a median sends the frame down, as the JAX package's f32
    sums are. One scale for the column would make each 0.01 a multiple
    of a quantum near 1e-6."""
    from h2o3_tpu_torch.rapids import rapids as TR
    rng = np.random.default_rng(3)
    key = np.r_[np.zeros(10), np.ones(N - 11), [2.0]]
    val = np.r_[np.full(10, 0.01), rng.uniform(0, 1, N - 11), [1e9]]
    perm = rng.permutation(N)
    key, val = key[perm], val[perm]
    jf, tf = pair({"k": (key, None), "x": (val, None)})
    aggs = [(fn, 1) for fn in AGGS]
    got = DS.group_by_device(tf, [0], aggs)
    check_groups(JDS.group_by_device(jf, [0], aggs), got, aggs,
                 {1: square_scale([key], val)})
    host = TR._groupby_sorted(tf, [0], [("sum", 1, "rm"), ("mean", 1, "rm"),
                                        ("sd", 1, "rm"),
                                        ("median", 1, "rm")])
    x32 = val.astype(np.float32).astype(np.float64)
    want = {"sum": [x32[key == g].sum() for g in range(3)],
            "mean": [x32[key == g].mean() for g in range(3)],
            "sd": [x32[key == g].std(ddof=1) for g in range(2)] + [np.nan]}
    for fn, cols in (("sum", (got[1][1], host.vecs[1])),
                     ("mean", (got[1][2], host.vecs[2])),
                     ("sd", (got[1][6], host.vecs[3]))):
        for c in cols:
            c = c.as_f32() if hasattr(c, "as_f32") else c
            np.testing.assert_allclose(c.cpu().numpy().astype(np.float64),
                                       want[fn], rtol=1e-6, atol=1e-12,
                                       err_msg=fn)


# ---------------------------------------------------------------------------
def join_pair(case):
    x, small, medium, big = CS.join_tables(N, 21, n1=10, n2=100)
    if case == "int_small":
        return x, small, ["id1"], ["id1"]
    if case == "int_medium":
        return x, medium, ["id2"], ["id2"]
    if case == "categorical_unmatched_levels":
        return x, medium, ["id5"], ["id5"]
    if case == "int_big":
        return x, big, ["id3"], ["id3"]
    rng = np.random.default_rng(3)
    if case == "float_duplicates_and_na":
        a = np.round(rng.normal(size=400), 1)
        a[::37] = np.nan
        b = np.round(rng.normal(size=150), 1)
        b[::23] = np.nan
        left = {"f": (a, None), "v": (rng.random(400), None)}
        right = {"w": (rng.random(150), None), "f": (b, None),
                 "v": (rng.random(150), None)}
        return left, right, ["f"], ["f"]
    if case == "two_keys_other_names":
        left = {"a": (rng.integers(0, 6, 300).astype(float), None),
                "b": (rng.integers(0, 3, 300).astype(float), ["p", "q", "r"]),
                "v": (rng.random(300), None)}
        right = {"c": (rng.integers(0, 8, 90).astype(float), None),
                 "d": (rng.integers(0, 3, 90).astype(float), ["q", "r", "s"]),
                 "v": (rng.random(90), None)}
        return left, right, ["a", "b"], ["c", "d"]
    raise KeyError(case)


JOINS = ["int_small", "int_medium", "categorical_unmatched_levels",
         "int_big", "float_duplicates_and_na", "two_keys_other_names"]


@pytest.mark.parametrize("all_l", [False, True])
@pytest.mark.parametrize("case", JOINS)
def test_merge_inner_left_match_jax(case, all_l):
    lc, rc, kl, kr = join_pair(case)
    jl, tl = pair(lc)
    jr, tr = pair(rc)
    bl = [tl.names.index(c) for c in kl]
    br = [tr.names.index(c) for c in kr]
    got = DS.merge_frames(tl, tr, bl, br, all_l=all_l)
    same_frames(JDS.merge_frames(jl, jr, bl, br, all_l=all_l), got)
    if case == "int_small":
        assert "id4_y" in got.names          # a clash takes _y


def jax_merge(jl, jr, bl, br, all_l, all_r):
    expr = (f"(merge {jl.key} {jr.key} {int(all_l)} {int(all_r)} "
            f"[{' '.join(map(str, bl))}] [{' '.join(map(str, br))}] "
            "\"auto\")")
    return JR.rapids_exec(expr)


@pytest.mark.parametrize("how", ["right", "outer"])
@pytest.mark.parametrize("case", ["int_medium", "categorical_unmatched_levels",
                                  "float_duplicates_and_na",
                                  "two_keys_other_names"])
def test_merge_right_outer_match_the_pandas_path(case, how):
    lc, rc, kl, kr = join_pair(case)
    jl, tl = pair(lc)
    jr, tr = pair(rc)
    bl = [tl.names.index(c) for c in kl]
    br = [tr.names.index(c) for c in kr]
    want = jax_merge(jl, jr, bl, br, how == "outer", True)
    same_frames(want, DS.merge_frames_pandas(tl, tr, bl, br, how),
                bits=False)


def rows_of(f):
    n = f.nrows
    cols = []
    for v in f.vecs:
        x = v.to_numpy()[:n]
        if v.type == "enum":
            dom = np.asarray(v.levels(), object)
            x = [None if c != c else dom[int(c)] for c in x]
        cols.append([None if (isinstance(c, float) and c != c) else c
                     for c in x])
    return sorted(zip(*cols), key=repr)


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_merge_on_string_keys_matches_the_pandas_path(how):
    rng = np.random.default_rng(5)
    lk = np.array([f"k{i}" for i in rng.integers(0, 12, 200)], object)
    rk = np.array([f"k{i}" for i in rng.integers(4, 16, 60)], object)
    lc = {"key": (lk, None), "v": (rng.random(200), None)}
    rc = {"key": (rk, None), "v": (rng.random(60), None),
          "t": (np.array([f"t{i % 7}" for i in range(60)], object), None)}
    jl, tl = pair(lc, strings=("key",))
    jr, tr = pair(rc, strings=("key", "t"))
    want = jax_merge(jl, jr, [0], [0], how in ("left", "outer"),
                     how in ("right", "outer"))
    got = h2o3_tpu_torch.rapids(
        f"(merge {tl.key} {tr.key} {int(how in ('left', 'outer'))} "
        f"{int(how in ('right', 'outer'))} [0] [0] \"auto\")")
    assert list(got.names) == list(want.names) == ["key", "v_x", "v_y", "t"]
    assert [v.type for v in got.vecs] == [v.type for v in want.vecs]
    if how == "inner":
        assert rows_of(got) == rows_of(want)
    else:
        same_frames(want, got, bits=False)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_merge_with_an_empty_side(how):
    lc = {"k": (np.array([1.0, 2.0, 2.0]), None),
          "v": (np.array([0.5, 1.5, 2.5]), None)}
    rc = {"k": (np.zeros(0), None), "w": (np.zeros(0), None)}
    jl, tl = pair(lc)
    jr, tr = pair(rc)
    assert DS.merge_frames(tl, tr, [0], [0], how == "left") is None
    want = jax_merge(jl, jr, [0], [0], how == "left", False)
    got = DS.merge_frames_pandas(tl, tr, [0], [0], how)
    same_frames(want, got, bits=False)
    assert got.nrows == (3 if how == "left" else 0)
