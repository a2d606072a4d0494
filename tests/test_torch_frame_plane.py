"""The port's frame data plane against the JAX package, on the CPU: the
codecs, StrVec, UuidVec, SparseVec, the Frame hooks and rebalance, and
ingest of SVMLight, ARFF, gzip and zip files.

Seeded numpy columns go to both packages at 512 rows, a row count the
JAX package's 8-shard CPU cloud does not pad (its planes are then the
port's, byte for byte). Tolerances:
- codecs: the same kind, bias and constant, the same packed bytes and NA
  plane, and `as_f32` bit for bit (the far-from-zero integer column
  included, whose f32 decode differs from its f32 value by an ulp);
- StrVec, UuidVec: codes, levels, words, NA lanes and the level ops
  equal; `eq` and `isna_f32` bit for bit;
- SparseVec: planes, `sparse_coo` and the densified column bit for bit;
  rollups equal within 1e-12 relative (both packages run the same numpy
  reductions over the host value plane);
- dense rollups within 1e-9 relative of float64 numpy over the decoded
  column, and within 1e-6 relative of the JAX package's f32 sums (not the
  sigma of the column near 1e8, which f32 cancellation ruins there);
  counts equal;
- parsed frames: names, types, domains equal; values bit for bit.
"""

import gzip
import math
import zipfile

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu.core import frame as JF
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu.io import parser as JP
from h2o3_tpu_torch.core import frame as TF
from h2o3_tpu_torch.core import scope as TS
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.core.memory import MANAGER
from h2o3_tpu_torch.io import parser as TP

N = 512


@pytest.fixture(scope="module", autouse=True)
def cpu_cloud():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _codec_cols():
    rng = np.random.default_rng(13)
    i = np.arange(N, dtype=np.float64)
    nan_every = np.where(i % 11 == 0, np.nan, 0.0)
    return {
        "i8": (i % 100) + nan_every,
        "i8_neg": -(i % 200) - 3.0,
        "i16": i % 30000 * 7.0,
        "i32": i * 70000.0,
        "i32_na": i * 70000.0 + np.where(i % 5 == 0, np.nan, 0.0),
        "f32": rng.normal(size=N) * 3.14159,
        "f32_na": rng.normal(size=N) + nan_every,
        "const": np.full(N, 7.0),
        "const_na": np.full(N, -2.5) + nan_every,
        "all_na": np.full(N, np.nan),
        "far_int": 1.0e8 + rng.integers(0, 60000, N),
        "far_int_na": 123456789.0 + rng.integers(0, 200, N) + nan_every,
        "bool": rng.random(N) < 0.3,
        "inf": np.where(i % 3 == 0, np.inf, rng.normal(size=N)),
    }


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.uint32)


def _same_codec(jc, tc):
    assert jc.kind == tc.kind
    assert jc.bias == tc.bias
    assert (jc.const_val == tc.const_val) or (
        math.isnan(jc.const_val) and math.isnan(tc.const_val))


@pytest.mark.parametrize("name", list(_codec_cols()))
def test_codec_packed_bytes_and_decode_match_jax(name):
    col = _codec_cols()[name]
    jv = JF.Vec.from_numpy(col)
    tv = TF.Vec.from_numpy(col)
    _same_codec(jv.codec, tv.codec)
    jd, jm = jv._chunk.staging_view()
    td, tm = tv._chunk.staging_view()
    assert jd.dtype == td.dtype and np.array_equal(jd, td)
    assert (jm is None) == (tm is None)
    if jm is not None:
        assert np.array_equal(jm, tm)
    assert np.array_equal(_bits(jv.as_f32()), _bits(tv.as_f32().numpy()))


def test_far_from_zero_decode_is_f32_not_float64():
    """The i16 codec of a column near 1e8 decodes as f32(stored) +
    f32(bias), as the JAX package does: some values land an ulp off
    their own f32, and the port keeps those bits."""
    col = _codec_cols()["far_int"]
    tv = TF.Vec.from_numpy(col)
    assert tv.codec.kind == "i16"
    got = tv.as_f32().numpy()
    assert np.any(got != col.astype(np.float32))
    assert np.array_equal(_bits(got), _bits(JF.Vec.from_numpy(col).as_f32()))


def test_f32_plane_without_na_is_returned_without_copy():
    import torch
    x = torch.arange(N, dtype=torch.float32) / 3
    v = TF.Vec.from_tensor(x)
    assert v.codec.kind == "f32" and v.mask is None
    assert v.as_f32().data_ptr() == v.as_f32().data_ptr() == x.data_ptr()
    w = TF.Vec.from_numpy(np.arange(N) / 3.0)
    assert w.as_f32().data_ptr() == w.data.data_ptr()
    y = x.clone()
    y[3] = float("nan")
    vn = TF.Vec.from_tensor(y)
    assert vn.mask is not None and vn.data[3] == 0
    assert np.array_equal(_bits(vn.as_f32().numpy()), _bits(y.numpy()))


@pytest.mark.parametrize("name", ["i8", "f32_na", "const_na", "far_int"])
def test_dense_rollups_match_float64_and_jax(name):
    col = _codec_cols()[name]
    tv = TF.Vec.from_numpy(col)
    t = tv.rollups()
    x = tv.as_f32().numpy().astype(np.float64)
    ok = x[~np.isnan(x)]
    want = {"min": ok.min(), "max": ok.max(), "mean": ok.mean(),
            "sigma": ok.std(ddof=1)}
    for k, a in want.items():
        assert abs(getattr(t, k) - a) <= 1e-9 * max(1.0, abs(a)), k
    j = JF.Vec.from_numpy(col).rollups()
    assert (t.nas, t.zeros, t.is_int) == (j.nas, j.zeros, j.is_int)
    # the JAX package's f32 sums: its sigma of a column near 1e8 is lost
    # to cancellation (s2/n - mean^2 in f32), so only the rest is held
    keys = ("min", "max", "mean") if name == "far_int" else \
        ("min", "max", "mean", "sigma")
    for k in keys:
        a, b = getattr(j, k), getattr(t, k)
        assert abs(a - b) <= 1e-6 * max(1.0, abs(a)), (k, a, b)


def test_categorical_and_time_columns_match_jax():
    rng = np.random.default_rng(5)
    cat = np.array(rng.choice(["b", "a", "c", ""], N), object)
    cat[::9] = None
    t = np.datetime64("2020-01-01") + rng.integers(0, 900, N).astype(
        "timedelta64[D]")
    t[::7] = np.datetime64("NaT")
    for col in (cat, t):
        jv, tv = JF.Vec.from_numpy(col), TF.Vec.from_numpy(col)
        assert jv.type == tv.type
        assert jv.levels() == tv.levels()
        _same_codec(jv.codec, tv.codec)
        assert np.array_equal(_bits(jv.as_f32()), _bits(tv.as_f32().numpy()))


# ---------------------------------------------------------------------------
def _strings():
    rng = np.random.default_rng(21)
    words = np.array(["apple", "Banana", " cherry ", "date", "", "fig"],
                     object)
    col = np.array(rng.choice(words, N), object)
    col[rng.random(N) < 0.1] = None
    return col


def test_strvec_codes_levels_and_level_ops_match_jax():
    col = _strings()
    jv = JF.Vec.from_numpy(col, type="str")
    tv = TF.Vec.from_numpy(col, type="str")
    assert isinstance(tv, TF.StrVec) and tv.type == jv.type == "str"
    assert list(tv.levels_arr) == list(jv.levels_arr)
    assert np.array_equal(np.asarray(jv.codes), tv.codes.numpy())
    assert list(tv.to_numpy()) == list(jv.to_numpy())
    assert tv.na_cnt() == jv.na_cnt()
    for fn in (str.upper, str.strip, lambda s: s[:1]):
        j2, t2 = jv.map_values(fn), tv.map_values(fn)
        assert list(t2.levels_arr) == list(j2.levels_arr)
        assert np.array_equal(np.asarray(j2.codes), t2.codes.numpy())
    opt = (lambda s: None if "a" in s else s.lower())
    j3, t3 = jv.map_values_opt(opt), tv.map_values_opt(opt)
    assert list(t3.levels_arr) == list(j3.levels_arr)
    assert np.array_equal(np.asarray(j3.codes), t3.codes.numpy())
    assert np.array_equal(_bits(jv.per_level_f32(len)),
                          _bits(tv.per_level_f32(len).numpy()))
    pred = (lambda s: s.startswith("d") or s == "")
    assert np.array_equal(_bits(jv.level_mask(pred)),
                          _bits(tv.level_mask(pred).numpy()))
    assert not tv.is_const()


def _uuids():
    rng = np.random.default_rng(8)
    import uuid
    vals = [str(uuid.UUID(int=int(rng.integers(0, 2**63)) << 64
                         | int(rng.integers(0, 2**63))))
            for _ in range(N)]
    col = np.array(vals, object)
    col[3] = col[10]                  # a repeat: eq must see it
    col[::13] = None
    col[5] = "not-a-uuid"
    col[6] = uuid.UUID(int=2**128 - 1)
    return col


def test_uuidvec_words_na_and_ops_match_jax():
    col = _uuids()
    jv, tv = JF.UuidVec.encode(col), TF.UuidVec.encode(col)
    assert np.array_equal(np.asarray(jv.words), tv.words.numpy())
    assert np.array_equal(np.asarray(jv.na), tv.na.numpy())
    assert list(tv.to_numpy()) == list(jv.to_numpy())
    assert tv.na_cnt() == jv.na_cnt()
    assert np.array_equal(_bits(jv.isna_f32()), _bits(tv.isna_f32().numpy()))
    sh = np.roll(col, 7)
    je = jv.eq(JF.UuidVec.encode(sh))
    te = tv.eq(TF.UuidVec.encode(sh))
    assert np.array_equal(_bits(je), _bits(te.numpy()))
    assert np.array_equal(_bits(jv.eq(jv)), _bits(tv.eq(tv).numpy()))
    with pytest.raises(TypeError):
        tv.as_f32()


def test_string_and_uuid_columns_load_through_from_dict():
    cols = {"s": _strings(), "u": _uuids(), "x": np.arange(N, dtype=float)}
    types = {"s": "str", "u": "uuid"}
    jf = JF.Frame.from_dict(cols, column_types=types)
    tf = TF.Frame.from_dict(cols, column_types=types)
    # the JAX package's from_numpy has no uuid branch and makes such a
    # column categorical; the port encodes it as its parser does
    assert jf.types == {"s": "str", "u": "enum", "x": "num"}
    assert tf.types == {"s": "str", "u": "uuid", "x": "num"}
    assert isinstance(tf.vec("s"), TF.StrVec)
    assert isinstance(tf.vec("u"), TF.UuidVec)
    ju = JF.UuidVec.encode(cols["u"])
    assert tf.summary()["u"]["missing"] == ju.na_cnt()
    JDKV.remove(jf.key)
    DKV.remove(tf.key)


# ---------------------------------------------------------------------------
def _sparse_cols(C=6, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(C):
        rows = np.sort(rng.choice(N, size=int(rng.integers(0, 60)),
                                  replace=False)).astype(np.int32)
        vals = rng.normal(0, 2, len(rows)).astype(np.float32)
        if j == 1 and len(vals) > 3:
            vals[2] = np.nan          # an explicit NA
            vals[3] = 0.0             # an explicit zero
        if j == 2:
            vals = np.round(vals)     # an integer column
        out.append((rows, vals))
    out.append((np.zeros(0, np.int32), np.zeros(0, np.float32)))  # empty
    out.append((np.arange(N, dtype=np.int32),                      # full
                np.full(N, 3.0, np.float32)))
    return out


def test_sparsevec_planes_densify_and_rollups_match_jax():
    for rows, vals in _sparse_cols():
        jv = JF.SparseVec(rows, vals, N)
        tv = TF.SparseVec(rows, vals, N)
        assert tv.nnz == jv.nnz
        assert np.array_equal(np.asarray(jv.nz_rows), tv.nz_rows.numpy())
        assert np.array_equal(_bits(jv.nz_vals), _bits(tv.nz_vals.numpy()))
        assert np.array_equal(_bits(jv.as_f32()), _bits(tv.as_f32().numpy()))
        j, t = jv.rollups(), tv.rollups()
        assert (t.nas, t.zeros, t.is_int) == (j.nas, j.zeros, j.is_int)
        for k in ("min", "max", "mean", "sigma"):
            a, b = getattr(j, k), getattr(t, k)
            assert abs(a - b) <= 1e-12 * max(1.0, abs(a)), (k, a, b)
        assert tv.is_const() == (jv.nnz == 0)


def test_sparse_coo_and_is_sparse_match_jax():
    cols = _sparse_cols()
    names = [f"C{j}" for j in range(len(cols))]
    jf = JF.Frame(names, [JF.SparseVec(r, v, N) for r, v in cols])
    tf = TF.Frame(names, [TF.SparseVec(r, v, N) for r, v in cols])
    assert tf.is_sparse() and jf.is_sparse()
    jr, jc, jv, jshape = jf.sparse_coo()
    tr, tc, tv, tshape = tf.sparse_coo()
    assert tshape == jshape
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(_bits(jv), _bits(tv.numpy()))
    tf["d"] = TF.Vec.from_numpy(np.arange(N, dtype=float))
    assert not tf.is_sparse() and tf.is_sparse(names)
    with pytest.raises(ValueError):
        tf.sparse_coo()
    JDKV.remove(jf.key)
    DKV.remove(tf.key)


def test_frame_summary_and_rebalance_match_jax():
    cols = {k: v for k, v in _codec_cols().items()
            if k in ("i8", "f32_na", "const", "far_int")}
    cols["cat"] = np.array(["x", "y"] * (N // 2), object)
    jf, tf = JF.Frame.from_dict(cols), TF.Frame.from_dict(cols)
    js, ts = jf.summary(), tf.summary()
    assert js.keys() == ts.keys()
    for c in js:
        for k in ("type", "missing", "zeros", "cardinality"):
            assert js[c][k] == ts[c][k], (c, k)
        for k in ("min", "max", "mean"):
            assert abs(js[c][k] - ts[c][k]) <= 1e-6 * max(1, abs(js[c][k]))
    jr, tr = JF.rebalance_frame(jf), TF.rebalance_frame(tf)
    assert tr.names == tf.names and tr.types == tf.types
    for a, b in zip(jr.vecs, tr.vecs):
        _same_codec(a.codec, b.codec)
        assert np.array_equal(_bits(a.as_f32()), _bits(b.as_f32().numpy()))
    for f in (jf, jr):
        JDKV.remove(f.key)
    for f in (tf, tr):
        DKV.remove(f.key)


def test_rebalance_keeps_string_uuid_and_sparse_layouts():
    rows, vals = _sparse_cols()[0]
    tf = TF.Frame(["s", "u", "z"], [
        TF.Vec.from_numpy(_strings(), type="str"),
        TF.UuidVec.encode(_uuids()), TF.SparseVec(rows, vals, N)])
    tr = TF.rebalance_frame(tf)
    assert [type(v) for v in tr.vecs] == [type(v) for v in tf.vecs]
    assert list(tr.vec("s").to_numpy()) == list(tf.vec("s").to_numpy())
    assert list(tr.vec("u").to_numpy()) == list(tf.vec("u").to_numpy())
    assert np.array_equal(tr.vec("z").to_numpy(), tf.vec("z").to_numpy())
    DKV.remove(tf.key)
    DKV.remove(tr.key)


# ---------------------------------------------------------------------------
def _same_frame(jf, tf):
    assert tf.names == jf.names
    assert tf.types == jf.types
    assert tf.shape == jf.shape
    for c in jf.names:
        jv, tv = jf.vec(c), tf.vec(c)
        assert type(tv).__name__ == type(jv).__name__, c
        assert jv.levels() == tv.levels()
        if jv.type in ("str", "uuid"):
            assert list(jv.to_numpy()) == list(tv.to_numpy())
        else:
            assert np.array_equal(_bits(jv.as_f32()[: jf.nrows]),
                                  _bits(tv.as_f32().numpy())), c


def _svm_text(n=300, C=40, seed=9):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        idx = np.sort(rng.choice(C, size=int(rng.integers(0, 8)),
                                 replace=False))
        vals = rng.normal(0, 1, len(idx)).astype(np.float32)
        lab = int(rng.random() < 0.4)
        body = " ".join(f"{j}:{v:.9g}" for j, v in zip(idx, vals))
        lines.append(f"{lab} {body}".rstrip() + (" # note" if i % 50 == 0
                                                  else ""))
    lines.insert(7, "")
    return "\n".join(lines) + "\n"


def _arff_text():
    rng = np.random.default_rng(12)
    head = ["@relation weather", "% a comment", "",
            "@attribute outlook {sunny, overcast, rainy}",
            "@attribute temperature numeric",
            "@attribute humidity real",
            "@attribute note string",
            "@attribute day date",
            "@attribute play {yes, no}", "", "@data"]
    rows = []
    for i in range(200):
        o = rng.choice(["sunny", "overcast", "rainy", "?"])
        t = f"{rng.normal(20, 5):.3f}" if i % 17 else "?"
        note = rng.choice(["calm", "windy", "'gusty'"])
        day = f"2021-0{1 + i % 9}-1{i % 10}"
        rows.append(f"{o},{t},{rng.integers(40, 99)},{note},{day},"
                    f"{rng.choice(['yes', 'no'])}")
        if i % 40 == 0:
            rows.append("% inline comment")
    return "\n".join(head + rows) + "\n"


def _csv_text():
    rng = np.random.default_rng(31)
    import uuid
    out = ["id,x,color,tag"]
    for i in range(250):
        u = str(uuid.UUID(bytes=rng.bytes(16)))
        out.append(f"{u if i % 23 else ''},{rng.normal():.6f},"
                   f"{rng.choice(['red', 'blue', 'NA'])},"
                   f"t{rng.integers(0, 1000)}")
    return "\n".join(out) + "\n"


def _write(path, text, kind):
    if kind == "plain":
        path.write_text(text)
    elif kind == "gz":
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    else:
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("inner.txt", text)


@pytest.mark.parametrize("fmt,kind", [
    ("svm", "plain"), ("svm", "gz"), ("svm", "zip"),
    ("arff", "plain"), ("arff", "gz"),
    ("csv", "gz"), ("csv", "zip")])
def test_import_file_matches_jax(tmp_path, fmt, kind):
    text = {"svm": _svm_text, "arff": _arff_text, "csv": _csv_text}[fmt]()
    suffix = {"plain": "", "gz": ".gz", "zip": ".zip"}[kind]
    path = tmp_path / f"data.{'svmlight' if fmt == 'svm' else fmt}{suffix}"
    _write(path, text, kind)
    jf = JP.import_file(str(path))
    tf = TP.import_file(str(path))
    _same_frame(jf, tf)
    if fmt == "svm":
        assert all(isinstance(tf.vec(c), TF.SparseVec)
                   for c in tf.names[1:])
    JDKV.remove(jf.key)
    DKV.remove(tf.key)


def test_csv_uuid_and_string_columns(tmp_path):
    path = tmp_path / "u.csv"
    path.write_text(_csv_text())
    jf = JP.parse(str(path), col_types={"tag": "str"})
    tf = TP.parse(str(path), col_types={"tag": "str"})
    _same_frame(jf, tf)
    assert isinstance(tf.vec("id"), TF.UuidVec)
    assert isinstance(tf.vec("tag"), TF.StrVec)
    JDKV.remove(jf.key)
    DKV.remove(tf.key)


def test_import_file_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError):
        TP.import_file(str(tmp_path))
    with pytest.raises(NotImplementedError):
        TP.import_file(str(tmp_path / "*.csv"))
    with pytest.raises(NotImplementedError):
        TP.import_file("http://example.invalid/x.csv")
    p = tmp_path / "x.parquet"
    p.write_bytes(b"PAR1")
    with pytest.raises(NotImplementedError):
        TP.import_file(str(p))
    bad = tmp_path / "bad.svm"
    bad.write_text("1 3:0.5 qid:2\n")
    with pytest.raises(ValueError):
        TP.import_file(str(bad))


def test_upload_frame_matches_jax():
    rng = np.random.default_rng(3)
    cols = {"a": rng.normal(size=N), "b": np.array(["u", "v"] * (N // 2),
                                                   object)}
    mat = rng.normal(size=(N, 3))
    for data in (cols, mat):
        jf, tf = JP.upload_frame(data), h2o3_tpu_torch.upload_frame(data)
        _same_frame(jf, tf)
        assert h2o3_tpu_torch.upload_frame(tf) is tf
        JDKV.remove(jf.key)
        DKV.remove(tf.key)
    with pytest.raises(TypeError):
        h2o3_tpu_torch.upload_frame(3)


# ---------------------------------------------------------------------------
def test_dkv_hooks_and_scope():
    f = TF.Frame.from_dict({"a": np.arange(N, dtype=float)})
    removed = []
    f._on_remove = lambda: removed.append(True)
    assert DKV.raw_get(f.key) is f and DKV.get(f.key) is f
    with TS.scope(keep=[f.key]):
        g = TF.Frame.from_dict({"b": np.ones(N)})
        h = TF.Frame.from_dict({"c": np.zeros(N)})
        TS.track("not-a-key")
    assert DKV.get(g.key) is None and DKV.get(h.key) is None
    assert DKV.get(f.key) is f
    DKV.remove(f.key)
    assert removed == [True]


def test_memory_manager_frame_bytes_and_pinning():
    f = TF.Frame.from_dict({"i8": _codec_cols()["i8"],
                            "f32": _codec_cols()["f32"]})
    # i8 plane + uint8 NA plane, then the f32 plane
    assert MANAGER.frame_bytes(f) == N * 2 + N * 4
    MANAGER.pin(f.key)
    assert all(v._chunk.pinned == 1 for v in f.vecs)
    MANAGER.unpin(f.key)
    MANAGER.unpin(f.key)
    assert all(v._chunk.pinned == 0 for v in f.vecs)
    assert MANAGER.is_hbm_resident(f.key) and not MANAGER.is_spilled(f.key)
    DKV.remove(f.key)
