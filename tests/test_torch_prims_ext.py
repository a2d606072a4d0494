"""The second tranche of the port's Rapids prims (rapids/prims_ext.py)
against the JAX package's, on the CPU: every prim, one parametrised test
over the prim names, on frames made from a numpy seed and registered
under the same keys in both stores; the PRIMS key sets; create_frame
bit for bit; the prims that raise; and ddply, which the JAX package
cannot run (it imports a name that does not exist), against a numpy
per-group computation.

Tolerances (`TOL`): exact where the port computes in host numpy over the
same f32 values (most of the tranche) or moves values on the card (cut,
fillna, rank, melt, pivot); 1e-6 relative for the last bits of torch's
transcendental functions against XLA's and for f32 sums and products on
the card (sumNA, prod.na, the matrix product); 1e-5 for digamma and
trigamma (torch's and XLA's series differ in their last bits) and for
scale_inplace (f32 sums of squares).
"""

import math
import types

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu.core import frame as JF
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu.models import segments as JSEG
from h2o3_tpu.rapids import rapids as JR
from h2o3_tpu.utils import config as JCFG
from h2o3_tpu.utils import create_frame as JCF
from h2o3_tpu_torch.core import frame as TF
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models import segments as TSEG
from h2o3_tpu_torch.rapids import rapids as TR
from h2o3_tpu_torch.utils import config as TCFG
from test_torch_rapids import N, both, build, frame_data, same

RAISES = {"PermutationVarImp"}
# each with a test of its own below
SPECIAL = {"ddply", "ls", "model.reset.threshold",
           "segment_models_as_frame", "num_valid_substrings"}


@pytest.fixture(scope="module", autouse=True)
def cpu_cloud():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def ext_data(seed=12):
    rng = np.random.default_rng(seed)
    na = np.array([1.0, np.nan, np.nan, np.nan, 4.0, np.nan, 6.0, np.nan,
                   np.nan, 2.0, np.nan, np.nan, np.nan, np.nan, 3.0])
    y = (rng.random(N) < 0.4).astype(np.float64)
    p = np.round(rng.random(N) * 0.6 + 0.3 * y, 2)
    i = np.repeat(np.arange(10.0), 4)
    words = np.array(["alp", "bet", "gam", "del"], object)
    doc = np.array(["the cat sat", "The dog", "cat and dog and cat",
                    None, "sat"], object)
    return {
        "fna": {"x": (na, "num", None), "y": (na[::-1].copy(), "num", None)},
        "fbin": {"y": (y, "num", None), "p": (p, "num", None)},
        "flong": {"i": (i, "num", None),
                  "c": (np.tile([1.5, 2.5, 3.5, 4.5], 10), "num", None),
                  "v": (np.round(rng.normal(size=40), 3), "num", None)},
        "flongcat": {"i": (i, "num", None),
                     "g": (np.tile([0.0, 1.0, 2.0, 3.0], 10), "enum",
                           ["w", "x", "y", "z"]),
                     "v": (np.round(rng.normal(size=40), 3), "num", None)},
        "flongstr": {"s": (np.repeat(words, 10), "str", None),
                     "c": (np.tile(np.arange(10.0), 4), "num", None),
                     "v": (np.round(rng.normal(size=40), 3), "num", None)},
        "fstrid": {"id": (words[rng.integers(0, 4, 12)], "str", None),
                   "a": (np.round(rng.normal(size=12), 2), "num", None),
                   "b": (np.round(rng.normal(size=12), 2), "num", None)},
        "fstr2": {"s": (np.array(["alpha", "beta", None, "gamma"],
                                 object)[rng.integers(0, 4, N)], "str",
                        None)},
        "fgp": {"g": (rng.integers(0, 2, 30).astype(float), "enum",
                      ["g0", "g1"]),
                "id": (rng.integers(0, 4, 30).astype(float), "enum",
                       ["a", "b", "c", "d"]),
                "t": (rng.integers(0, 2, 30).astype(float), "enum",
                      ["C", "D"]),
                "amt": (np.round(rng.uniform(1, 9, 30), 1), "num", None)},
        "fwide": {f"w{j}": (np.round(rng.normal(size=6), 3), "num", None)
                  for j in range(10)},
        "fdoc": {"d": (np.arange(5.0), "num", None),
                 "txt": (doc, "str", None)},
        "fyear": {"y": (np.array([2019.0, 2020.0, 2024.0]), "num", None)},
    }


@pytest.fixture()
def frames(tmp_path):
    data = {**frame_data(), **ext_data()}
    for key, cols in data.items():
        build(JF, key, cols)
        build(TF, key, cols)
    yield data
    for key in data:
        JDKV.remove(key)
        DKV.remove(key)


_TRIG = ("acosh", "asinh", "atanh", "cospi", "sinpi", "tanpi", "lgamma",
         "digamma", "trigamma")
_ARG = {"acosh": "fpos", "atanh": "funit", "lgamma": "fpos",
        "digamma": "fpos", "trigamma": "fpos"}
EXT_EXPRS = {
    **{m: [f"({m} {_ARG.get(m, 'fnum')})", f"({m} 1.5)"] for m in _TRIG},
    "cor": ["(cor fnum fnum \"complete.obs\" \"Pearson\")",
            "(cor (cols fnum [0]) (cols fnum [1]))"],
    "distance": ["(distance fsmall fsmall \"l2\")",
                 "(distance fpos fpos \"l1\")",
                 "(distance fpos fsmall \"cosine\")"],
    "skewness": ["(skewness fnum)"], "kurtosis": ["(kurtosis fnum)"],
    "h2o.mad": ["(h2o.mad fnum)"], "mode": ["(mode fint)"],
    "difflag1": ["(difflag1 fnum)"],
    "kfold_column": ["(kfold_column fnum 3 7)"],
    "modulo_kfold_column": ["(modulo_kfold_column fnum 4)"],
    "stratified_kfold_column": ["(stratified_kfold_column fint 3 5)"],
    "h2o.random_stratified_split":
        ["(h2o.random_stratified_split fint 0.3 5)"],
    "perfectAUC": ["(perfectAUC (cols fbin [1]) (cols fbin [0]))"],
    "cut": ["(cut fpos [0 2 4 6 10] [\"a\" \"b\" \"c\" \"d\"] 0 1 3)",
            "(cut fnum [-5 0 2.5 5])"],
    "h2o.fillna": ["(h2o.fillna fnum \"forward\" 0 1)",
                   "(h2o.fillna fna \"backward\" 0 2)",
                   "(h2o.fillna fna \"forward\" 0 3)",
                   "(h2o.fillna fcat \"forward\" 0 1)"],
    "append": ["(append fnum (cols fpos [0]) \"p\")",
               "(append fnum 3 \"k\")"],
    "columnsByType": ["(columnsByType fcat \"categorical\")",
                      "(columnsByType fcat \"numeric\")"],
    "filterNACols": ["(filterNACols fnum 0.04)"],
    "flatten": ["(flatten (rows (cols fcat [0]) 0))",
                "(flatten (rows (cols fnum [0]) 0))", "(flatten fnum)"],
    "naCnt": ["(naCnt fnum)"],
    "dropdup": ["(dropdup fint)"], "drop_duplicates": ["(drop_duplicates "
                                                       "fsmall)"],
    "topn": ["(topn fnum 1 10 0)", "(topn fnum 2 20 1)"],
    "relevel": ["(relevel (cols fcat [0]) \"hi\")"],
    "relevel.by.freq": ["(relevel.by.freq (cols fcat [0]))"],
    "rename": ["(rename fnum \"fnum_renamed\")"],
    "setDomain": ["(setDomain (cols fcat [0]) 0 [\"A\" \"B\" \"C\"])"],
    "setLevel": ["(setLevel (cols fcat [0]) \"mid\")"],
    "nlevels": ["(nlevels fcat)", "(nlevels fnum)"],
    "is.factor": ["(is.factor fcat)", "(is.factor fnum)"],
    "is.numeric": ["(is.numeric ftime)", "(is.numeric fstr)"],
    "is.character": ["(is.character fstr)", "(is.character fcat)"],
    "any.factor": ["(any.factor fcat)", "(any.factor fnum)"],
    "any.na": ["(any.na fnum)", "(any.na fpos)"],
    "seq": ["(seq 1 10 2.5)"], "seq_len": ["(seq_len 7)"],
    "rep_len": ["(rep_len fsmall 14)", "(rep_len 3 4)"],
    "which": ["(which (> fnum 0))"], "which.max": ["(which.max fpos)"],
    "which.min": ["(which.min fpos)"], "t": ["(t fsmall)"],
    "sumaxis": ["(sumaxis fnum 1 0)", "(sumaxis fnum 0 1)"],
    "melt": ["(melt fcat [0] [1] \"var\" \"val\" 0)",
             "(melt fstrid [0] [] \"variable\" \"value\" 0)",
             "(melt fnum [] [0 2] \"k\" \"v\" 0)"],
    "pivot": ["(pivot flong \"i\" \"c\" \"v\")",
              "(pivot flongcat \"i\" \"g\" \"v\")",
              "(pivot flongstr \"s\" \"c\" \"v\")"],
    "rank_within_groupby": [
        "(rank_within_groupby fcat [0] [1] [1] \"rank\" 0)",
        "(rank_within_groupby fnum [2] [0 1] [1 1] \"r\" 0)"],
    "lstrip": ["(lstrip fstr \" \")", "(lstrip fcat \"l\")"],
    "rstrip": ["(rstrip fstr \" a\")"], "entropy": ["(entropy fstr)"],
    "grep": ["(grep fstr \"a\" 0 0 0)", "(grep fstr \"A\" 1 1 1)"],
    "strDistance": ["(strDistance fstr fstr2 \"lv\" 0)",
                    "(strDistance fstr fstr2 \"jaccard\" 0)"],
    "tokenize": ["(tokenize fstr \" \")"],
    "mktime": ["(mktime 2020 0 14 10 30 15 250)",
               "(mktime fyear 1 2 3 4 5 6)"],
    "moment": ["(moment 2021 5 3 0 0 0 0)"],
    "millis": ["(millis ftime)"], "week": ["(week ftime)"],
    "as.Date": ["(as.Date fdate \"yyyy-MM-dd\")"],
    "getTimeZone": ["(getTimeZone)"], "setTimeZone": ["(setTimeZone "
                                                      "\"UTC\")"],
    "listTimeZones": ["(listTimeZones)"],
    "maxNA": ["(maxNA fpos)"], "minNA": ["(minNA fpos)"],
    "sumNA": ["(sumNA fpos)", "(sumNA fnum)"],
    "prod.na": ["(prod.na fsmall)"],
    "match": ["(match fcat [\"hi\" \"lo\"] -1 1)",
              "(match fint [2 5 -4] NA 0)"],
    "comma": ["(comma 1 (+ 1 1) 3)"], ",": ["(, 5 (nrow fnum))"],
    "%%": ["(%% fnum 3)"], "none": ["(none fnum)", "(none)"],
    "assign": ["(assign as_1 fcat)"],
    "x": ["(x fsmall (t fsmall))"],
    "scale_inplace": ["(scale_inplace fnum 1 1)"],
    "setproperty": ["(setproperty \"ai.h2o.rapids.test\" \"v1\")"],
    "grouped_permute": ["(grouped_permute fgp 1 [0] 2 3)"],
    "isax": ["(isax fwide 4 8 0)"],
    "tf-idf": ["(tf-idf fdoc 0 1 1 0)", "(tf-idf fdoc 0 1 0 1)"],
    "run_tool": ["(run_tool \"GarbageCollect\")"],
}
TOL = {**{m: 1e-6 for m in _TRIG}, "digamma": 1e-5, "trigamma": 1e-5,
       "lgamma": 1e-5,
       "sumNA": 1e-6, "prod.na": 1e-6, "x": 1e-6, "scale_inplace": 1e-5}


@pytest.mark.parametrize("name", sorted(EXT_EXPRS))
def test_prim_matches_jax(name, frames):
    for expr in EXT_EXPRS[name]:
        want, got = both(expr)
        same(want, got, TOL.get(name, 0.0), expr)
    if name == "rename":
        assert DKV.get("fnum_renamed") is DKV.get("fnum")
        DKV.remove("fnum_renamed")
        JDKV.remove("fnum_renamed")
    if name == "assign":
        assert DKV.get("as_1") is not None
        DKV.remove("as_1")
        JDKV.remove("as_1")
    if name == "setproperty":
        assert TCFG.get_property("rapids.test") == \
            JCFG.get_property("rapids.test") == "v1"


def test_prims_key_sets_equal():
    from test_torch_rapids import RAPIDS_EXPRS
    assert set(TR.PRIMS) == set(JR.PRIMS)
    assert set(RAPIDS_EXPRS) | set(EXT_EXPRS) | RAISES | SPECIAL \
        == set(TR.PRIMS)


def test_num_valid_substrings(frames, tmp_path):
    words = tmp_path / "words.txt"
    words.write_text("al\nalpha\nbet\na\nan\n")
    want, got = both(f"(num_valid_substrings fstr \"{words}\")")
    same(want, got)


def test_ls_lists_the_store(frames):
    """Each package lists its own store's keys (the stores differ)."""
    before = DKV.keys()
    got = TR.rapids_exec("(ls)")
    assert list(got.vecs[0].to_numpy()) == before
    assert set(frames) <= set(before)
    assert set(frames) <= set(JR.rapids_exec("(ls)").vecs[0].to_numpy())


def test_model_reset_threshold():
    for store, R in ((JDKV, JR), (DKV, TR)):
        m = types.SimpleNamespace(key="mdl_thr", _default_threshold=0.3)
        store.put("mdl_thr", m)
        assert R.rapids_exec("(model.reset.threshold mdl_thr 0.7)") == 0.3
        assert m._default_threshold == 0.7
        store.remove("mdl_thr")


def test_segment_models_as_frame():
    rows = [{"segment": {"area": 1.0}, "model": "m_1", "status": "SUCCEEDED",
             "error": None},
            {"segment": {"area": 2.0}, "model": None, "status": "FAILED",
             "error": "bad"}]
    JDKV.put("segm", JSEG.SegmentModels(rows))
    DKV.put("segm", TSEG.SegmentModels(rows))
    want, got = both("(segment_models_as_frame segm)")
    same(want, got)
    JDKV.remove("segm")
    DKV.remove("segm")


def test_max_min_na_propagate_na(frames):
    """maxNA and minNA of a frame with an NA are NA (H2O's AstMaxNa, and
    jnp.max); the JAX package's jitted reduction on XLA's CPU drops the
    NaN and gives the max of the rest."""
    a = frames["fnum"]
    for op, fn in (("maxNA", np.nanmax), ("minNA", np.nanmin)):
        assert math.isnan(TR.rapids_exec(f"({op} fnum)"))
        want = fn(np.concatenate([np.float32(v[0]) for v in a.values()]))
        assert JR.rapids_exec(f"({op} fnum)") == want


def test_prims_that_raise(frames):
    with pytest.raises(NotImplementedError, match="explain_data"):
        TR.rapids_exec("(PermutationVarImp mdl fnum \"AUTO\")")


def test_ddply_repaired_against_numpy(frames):
    """The JAX package's ddply raises ImportError; the port's gives each
    group's value of the lambda (1e-6 relative: an f32 sum on the card
    against float64 numpy)."""
    expr = "(ddply fcat [2] {x . (sum (cols x 1))})"
    with pytest.raises(ImportError):
        JR.rapids_exec(expr)
    got = TR.rapids_exec(expr)
    h = frames["fcat"]["h"][0]
    x = frames["fcat"]["x"][0].astype(np.float32).astype(np.float64)
    keys = np.unique(h)
    assert got.names == ["h", "ddply_C1"]
    np.testing.assert_array_equal(got.vecs[0].to_numpy(), keys)
    np.testing.assert_allclose(
        got.vecs[1].to_numpy(), [np.nansum(x[h == k]) for k in keys],
        rtol=1e-6)
    two = TR.rapids_exec("(ddply fcat [0 2] {x . (nrow x)})")
    g = frames["fcat"]["g"][0]
    pairs, counts = np.unique(np.stack([np.where(np.isnan(g), np.inf, g),
                                        h], 1), axis=0, return_counts=True)
    np.testing.assert_array_equal(two.vecs[2].to_numpy(), counts)
    with pytest.raises(ValueError, match="lambda"):
        TR.rapids_exec("(ddply fcat [0] 3)")


def test_create_frame_matches_jax_bit_for_bit():
    kw = dict(rows=500, cols=12, seed=42, categorical_fraction=0.25,
              time_fraction=0.1, string_fraction=0.1, has_response=True)
    want = JCF.create_frame(**kw)
    got = h2o3_tpu_torch.create_frame(**kw)
    assert [v.type for v in got.vecs] == [v.type for v in want.vecs]
    same(want, got)
    dflt = h2o3_tpu_torch.create_frame(rows=2000, seed=3)
    assert dflt.shape == (2000, 10)
    assert [v.type for v in dflt.vecs].count("enum") == 2
    na = np.mean([np.isnan(v.to_numpy()).mean() for v in dflt.vecs])
    assert 0.003 < na < 0.02
    same(JCF.create_frame(rows=2000, seed=3), dflt)


def test_time_parts_before_the_epoch():
    ms = np.array([-1.0, -86_400_001.0, 951_782_400_000.0,
                   -2_208_988_800_000.0], np.float32)
    from h2o3_tpu_torch.rapids.rapids import _time_parts
    import pandas as pd
    s = pd.Series(ms.astype("datetime64[ms]"))
    for part in ("year", "month", "day", "hour", "minute", "second",
                 "dayofweek"):
        np.testing.assert_array_equal(
            _time_parts(ms, part), getattr(s.dt, part).to_numpy()
            .astype(np.float64), err_msg=part)
    assert not math.isnan(_time_parts(ms, "year")[0])
