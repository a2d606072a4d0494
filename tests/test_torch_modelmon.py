"""The port's drift monitor (obs/modelmon.py) against the JAX package's,
on the CPU. Mirrors tests/test_modelmon.py where its cases need no REST
server or replay channel.

- `build_baseline`: on the same seeded raw matrix (numerics with NaN and
  inf, categoricals with NA and out-of-domain codes), class and
  regression predictions and responses, the port's profile equals the
  JAX function's EXACTLY — names, kinds, f64 edges bit for bit, the
  top-K codes and levels, every integer count, the NA counts, the
  prediction edges and counts, the response counts — whether the raw
  matrix and the response are numpy arrays or tensors (the path a frame
  in HBM takes on the card: `bucketize` + `bincount`);
- PSI and Jensen-Shannon divergence within 1e-12 of the JAX functions;
- the npz round trip; the merge is associative and commutative bit for
  bit over permutations and groupings;
- `train()` stamps the baseline before publish (DKV holds it beside the
  model), but not for a frame of sparse predictors; the tap folds,
  stride-samples and throttles; NA-rate drift;
- a covariate shift fires the drift SLO; a retrain under the key
  rotates the generation and the generation-skew gauge follows;
- `forget` removes every per-model series once and is idempotent;
  `reset` retires the evaluator thread.
"""

import itertools
import threading
import time
import types

import numpy as np
import pytest
import torch

import h2o3_tpu_torch
from h2o3_tpu.obs import modelmon as JMM
from h2o3_tpu_torch import serving
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.obs import metrics as TM
from h2o3_tpu_torch.obs import modelmon, slo, usage


@pytest.fixture(autouse=True)
def _fresh_modelmon(monkeypatch):
    # tests drive evaluate() themselves and fold every row
    monkeypatch.setenv("H2O3_MODELMON_EVAL_S", "0")
    monkeypatch.setenv("H2O3_MODELMON_TAP_PCT", "100")
    monkeypatch.setenv("H2O3_MODELMON_TAP_ROWS", "0")
    modelmon.reset()
    usage.reset()
    yield
    modelmon.reset()
    usage.reset()
    slo.ENGINE.configure([])


# ---------------------------------------------------------------------------
# build_baseline against the JAX function
def _dinfo(names, cats, resp_domain):
    return types.SimpleNamespace(
        raw_columns=lambda: list(names), cat_cols=[n for n in cats],
        cardinalities={n: len(d) for n, d in cats.items()},
        domains={n: list(d) for n, d in cats.items()},
        response_domain=resp_domain)


def _raw(n, seed):
    rng = np.random.default_rng(seed)
    num = np.column_stack([rng.normal(size=n), rng.exponential(2, n),
                           np.round(rng.normal(size=n), 1),   # many ties
                           np.full(n, 3.0)]).astype(np.float32)
    num[rng.random(n) < 0.05, 0] = np.nan
    num[rng.random(n) < 0.01, 1] = np.inf
    num[rng.random(n) < 0.01, 2] = -np.inf
    c1 = rng.choice(40, n, p=np.r_[np.full(10, 0.08),
                                   np.full(30, 0.2 / 30)]).astype(np.float32)
    c2 = rng.integers(0, 3, n).astype(np.float32)
    c1[rng.random(n) < 0.03] = np.nan
    c2[:5] = 3.0                       # out of the domain
    return np.column_stack([num[:, :2], c1, num[:, 2:], c2]) \
        .astype(np.float32)


NAMES = ["x0", "x1", "g40", "x2", "x3", "g3"]
CATS = {"g40": [f"l{i}" for i in range(40)], "g3": ["a", "b", "c"]}


def _profile_tuple(p):
    feats = []
    for f in p.features:
        d = dict(f)
        if "edges" in d:
            d["edges"] = np.asarray(d["edges"]).tobytes()
        feats.append(d)
    return (feats, [c.tolist() for c in p.counts], p.na.tolist(),
            p.pred_kind,
            None if p.pred_edges is None else p.pred_edges.tobytes(),
            p.pred_counts.tolist(),
            None if p.resp_counts is None else p.resp_counts.tolist(),
            p.n_rows)


@pytest.mark.parametrize("kind", ["class", "reg", "none"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_build_baseline_equals_jax_exactly(kind, as_tensor, monkeypatch):
    monkeypatch.setenv("H2O3_MODELMON_SAMPLE", "3000")   # edges from a head
    monkeypatch.setenv("H2O3_MODELMON_TOPK", "8")
    n = 20_000
    raw = _raw(n, 5)
    rng = np.random.default_rng(6)
    if kind == "class":
        preds = rng.dirichlet(np.ones(3), n).astype(np.float32)
        resp = rng.integers(0, 3, n).astype(np.float32)
        dom = ["p", "q", "r"]
    elif kind == "reg":
        preds = rng.normal(size=n).astype(np.float32)
        resp = (preds + rng.normal(0, 0.1, n)).astype(np.float32)
        resp[:7] = np.nan
        dom = None
    else:
        preds, resp, dom = None, None, None
    di = _dinfo(NAMES, CATS, dom)
    want = JMM.build_baseline(di, raw, preds, resp)
    got = modelmon.build_baseline(
        di, torch.from_numpy(raw) if as_tensor else raw, preds,
        torch.from_numpy(resp) if as_tensor and resp is not None else resp)
    assert _profile_tuple(got) == _profile_tuple(want)
    assert int(got.counts[0].sum()) + int(got.na[0]) == n


def test_device_binning_helpers_equal_numpy():
    rng = np.random.default_rng(8)
    col = rng.normal(size=5000).astype(np.float32)
    col[::17] = np.nan
    col[::101] = np.inf
    edges = np.quantile(col[np.isfinite(col)], np.arange(1, 10) / 10)
    edges[4] = edges[3]                 # a duplicate edge: an empty bin
    want = modelmon._bin_numeric(col, edges, 10)
    got = modelmon._bin_numeric(torch.from_numpy(col), edges, 10)
    assert got[0].tolist() == want[0].tolist() and got[1] == want[1]
    codes = rng.integers(-2, 9, 5000).astype(np.float32)
    codes[::13] = np.nan
    lut = modelmon._cat_slots(6, np.array([0, 2, 5]))
    want = modelmon._bin_categorical(codes, lut, 4)
    got = modelmon._bin_categorical(torch.from_numpy(codes), lut, 4)
    assert got[0].tolist() == want[0].tolist() and got[1] == want[1]


@pytest.mark.parametrize("seed", range(4))
def test_psi_and_js_match_jax(seed):
    rng = np.random.default_rng(seed)
    for k in (2, 10, 33):
        a = rng.integers(0, 1000, k)
        b = rng.integers(0, 1000, k)
        b[rng.random(k) < 0.3] = 0
        assert abs(modelmon.psi(a, b) - JMM.psi(a, b)) <= 1e-12
        assert abs(modelmon.js_divergence(a, b)
                   - JMM.js_divergence(a, b)) <= 1e-12
    assert modelmon.psi([5, 5], [0, 0]) == 0.0
    assert modelmon.js_divergence([0, 0], [1, 1]) == 0.0


def _synthetic_profile(nbins=8):
    edges = np.linspace(-2.0, 2.0, nbins - 1)
    feats = [{"name": "x", "kind": "numeric", "edges": edges},
             {"name": "g", "kind": "categorical",
              "codes": [0, 1, 2], "card": 5, "levels": ["a", "b", "c"]}]
    counts = [np.full(nbins, 50, np.int64),
              np.array([40, 30, 20, 10], np.int64)]
    return modelmon.BaselineProfile(
        feats, counts, np.array([0, 0], np.int64), "reg",
        np.linspace(0.0, 1.0, nbins - 1), np.full(nbins, 50, np.int64),
        None, nbins * 50)


def test_npz_round_trip_and_merge_algebra():
    prof = _synthetic_profile()
    clone = modelmon.BaselineProfile.from_npz_bytes(prof.to_npz_bytes())
    assert _profile_tuple(clone)[1:] == _profile_tuple(prof)[1:]
    rng = np.random.default_rng(99)
    hosts = []
    for _ in range(4):
        sk = modelmon.LiveSketch(prof)
        for _ in range(3):
            n = int(rng.integers(5, 60))
            raw = np.column_stack([
                rng.normal(0.5, 1.5, size=n),
                rng.integers(0, 5, size=n).astype(np.float64)])
            raw[rng.random(n) < 0.1, 0] = np.nan
            sk.fold(prof, raw.astype(np.float32), rng.random(n), n)
        hosts.append(sk.to_doc())

    def score(docs):
        merged = modelmon.LiveSketch(prof)
        for d in docs:
            merged.merge_doc(d)
        doc = modelmon.drift_from_sketches("m", prof, merged, None, 1)
        return (doc["drift"], doc["prediction_drift"], doc["rows"])

    ref = score(hosts)
    assert ref[2] > 0
    for perm in itertools.permutations(hosts):
        assert score(list(perm)) == ref
    for split in (1, 2, 3):
        a, b = modelmon.LiveSketch(prof), modelmon.LiveSketch(prof)
        for d in hosts[:split]:
            a.merge_doc(d)
        for d in hosts[split:]:
            b.merge_doc(d)
        assert score([a.to_doc(), b.to_doc()]) == ref


# ---------------------------------------------------------------------------
# the lifecycle on port models
def _train_frame(n=400, seed=7):
    rng = np.random.default_rng(seed)
    return Frame.from_dict(
        {"a": rng.normal(size=n), "b": rng.normal(2, 1, size=n),
         "c": rng.choice(["u", "v", "w"], size=n).tolist(),
         "resp": rng.choice(["no", "yes"], size=n).tolist()})


def _traffic(n=600, seed=11, shift=False):
    rng = np.random.default_rng(seed)
    if shift:
        return Frame.from_dict(
            {"a": rng.normal(6, 1, size=n), "b": rng.normal(-5, 1, size=n),
             "c": rng.choice(["w"], size=n).tolist()})
    return Frame.from_dict(
        {"a": rng.normal(size=n), "b": rng.normal(2, 1, size=n),
         "c": rng.choice(["u", "v", "w"], size=n).tolist()})


def _mk_gbm(model_id=None, seed=1, fr=None):
    fr = fr if fr is not None else _train_frame()
    m = h2o3_tpu_torch.H2OGradientBoostingEstimator(
        ntrees=3, max_depth=3, seed=seed, model_id=model_id)
    m.train(x=["a", "b", "c"], y="resp", training_frame=fr)
    return fr, m


_CACHE: dict = {}


@pytest.fixture()
def gbm():
    h2o3_tpu_torch.init(device="cpu")
    if "m" not in _CACHE:
        _CACHE["m"] = _mk_gbm()
    fr, m = _CACHE["m"]
    if not modelmon.monitored(m.key):
        modelmon.install_baseline(m, fr)
    return m


@pytest.fixture(scope="module", autouse=True)
def _module_cleanup():
    yield
    if "m" in _CACHE:
        fr, m = _CACHE.pop("m")
        DKV.remove(m.key)
        DKV.remove(fr.key)


def test_baseline_installed_on_train(gbm):
    assert modelmon.monitored(gbm.key)
    prof = DKV.get(modelmon.monitor_key(gbm.key))
    assert isinstance(prof, modelmon.BaselineProfile)
    assert [f["name"] for f in prof.features] == gbm._dinfo.raw_columns()
    kinds = {f["name"]: f["kind"] for f in prof.features}
    assert kinds["a"] == "numeric" and kinds["c"] == "categorical"
    assert prof.pred_kind == "class"
    assert int(prof.pred_counts.sum()) == prof.n_rows == 400
    assert int(prof.resp_counts.sum()) == prof.n_rows


def test_port_baseline_features_equal_the_jax_models(monkeypatch):
    """The same training frame in both packages: the feature edges and
    counts of the two models' baselines are equal exactly (predictions
    differ between the packages' fits, so they are not compared)."""
    from h2o3_tpu import models as JE
    from h2o3_tpu.core.frame import Frame as JFrame
    from h2o3_tpu.core.kvstore import DKV as JDKV
    monkeypatch.setenv("H2O3_MODELMON_SAMPLE", "256")
    h2o3_tpu_torch.init(device="cpu")
    rng = np.random.default_rng(12)
    cols = {"a": rng.normal(size=900), "b": rng.exponential(1, 900),
            "c": rng.choice(["u", "v", "w", "z"], size=900).tolist(),
            "resp": rng.choice(["no", "yes"], size=900).tolist()}
    cols["a"][::31] = np.nan
    JMM.reset()
    jm = JE.ESTIMATORS["glm"](family="binomial")
    jf = JFrame.from_dict(cols)
    jm.train(x=["a", "b", "c"], y="resp", training_frame=jf)
    tf = Frame.from_dict(cols)
    tm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="binomial")
    tm.train(x=["a", "b", "c"], y="resp", training_frame=tf)
    jp = JDKV.get(JMM.monitor_key(jm.key))
    tp = DKV.get(modelmon.monitor_key(tm.key))
    j, t = _profile_tuple(jp), _profile_tuple(tp)
    assert t[0] == j[0] and t[1] == j[1] and t[2] == j[2]
    assert t[6] == j[6] and t[7] == j[7] == 900
    JDKV.remove(jm.key)
    JDKV.remove(jf.key)
    JMM.reset()
    DKV.remove(tm.key)
    DKV.remove(tf.key)


def test_tap_folds_and_drift_separates(gbm):
    serving.score_frame(gbm, _traffic(600, seed=21))
    assert modelmon.SCORED.value(model=gbm.key) == 600.0
    doc = modelmon.evaluate()[gbm.key]
    assert doc["rows"] == 600
    assert doc["drift"]["numeric"] < 0.2 and doc["drift"]["categorical"] \
        < 0.2
    assert doc["prediction_drift"] < 0.05
    assert modelmon.DRIFT.value(model=gbm.key, feature_kind="numeric") \
        == doc["drift"]["numeric"]
    serving.score_frame(gbm, _traffic(600, seed=22, shift=True))
    doc = modelmon.evaluate()[gbm.key]
    assert doc["drift"]["numeric"] > 0.5 and doc["drift"]["categorical"] \
        > 0.2
    p, detail = modelmon.pressure()
    assert p == 1.0 and detail["worst_model"] == gbm.key
    assert usage.evaluate_pressure()["dimensions"]["drift"] == 1.0


def test_tap_stride_cap_and_throttle(monkeypatch, gbm):
    monkeypatch.setenv("H2O3_MODELMON_TAP_ROWS", "100")
    serving.score_frame(gbm, _traffic(600, seed=25))
    assert modelmon.SCORED.value(model=gbm.key) == 600.0
    assert modelmon.evaluate()[gbm.key]["rows"] == 100
    modelmon.reset()
    modelmon.install_baseline(gbm, _CACHE["m"][0])
    monkeypatch.setenv("H2O3_MODELMON_TAP_ROWS", "0")
    monkeypatch.setenv("H2O3_MODELMON_TAP_PCT", "0.001")
    serving.score_frame(gbm, _traffic(200, seed=26))
    serving.score_frame(gbm, _traffic(200, seed=27))
    assert modelmon.SCORED.value(model=gbm.key) == 400.0
    doc = modelmon.evaluate()[gbm.key]
    assert doc["rows"] == 200 and doc["batches"] == 1


def test_tap_of_rows_staged_as_a_tensor(gbm):
    """Rows staged on the device (a tensor) fold as the same rows staged
    on the host."""
    raw = serving.payload_to_raw(gbm, [{"a": 0.1 * i, "b": 2.0, "c": "u"}
                                       for i in range(50)])
    host = np.zeros((50, 2), np.float32)
    modelmon.observe(gbm, torch.from_numpy(raw), host, 50)
    a = modelmon.evaluate()[gbm.key]["features"]
    modelmon.reset()
    modelmon.install_baseline(gbm, _CACHE["m"][0])
    modelmon.observe(gbm, raw, host, 50)
    b = modelmon.evaluate()[gbm.key]["features"]
    assert a == b


def test_na_rate_drift_tracked(gbm):
    rng = np.random.default_rng(31)
    nas = Frame.from_dict({
        "a": np.where(np.arange(200) % 2 == 0, np.nan, rng.normal(size=200)),
        "b": rng.normal(2, 1, size=200),
        "c": rng.choice(["u", "v", "w"], size=200).tolist()})
    serving.score_frame(gbm, _traffic(200, seed=31))
    serving.score_frame(gbm, nas)
    doc = modelmon.evaluate()[gbm.key]
    fa = [x for x in doc["features"] if x["name"] == "a"][0]
    assert fa["na_rate_baseline"] == 0.0
    assert fa["na_rate_live"] == pytest.approx(0.25, abs=0.02)
    assert doc["drift"]["na"] == pytest.approx(0.25, abs=0.02)


def test_covariate_shift_fires_drift_slo_and_generation_skew():
    h2o3_tpu_torch.init(device="cpu")
    fr, m = _mk_gbm(model_id="drift_e2e_gbm")
    old_model = m
    try:
        serving.score_frame(m, _traffic(600, seed=71))
        modelmon.evaluate()
        assert modelmon.DRIFT.value(model=m.key,
                                    feature_kind="numeric") < 0.2
        serving.score_frame(m, _traffic(600, seed=72, shift=True))
        modelmon.evaluate()
        assert modelmon.DRIFT.value(model=m.key,
                                    feature_kind="numeric") > 0.5
        slo.ENGINE.configure([slo.SLOSpec(
            {"name": "model-drift", "kind": "drift", "objective": 0.9,
             "model": "^drift_e2e_gbm$", "threshold": 0.2,
             "windows": [[2, 4, 2.0]]})])
        now = time.time()
        for dt in (10, 8, 6, 4, 2):
            alerts = slo.ENGINE.evaluate(now=now - dt)
        firing = [a for a in alerts if a["slo"] == "model-drift"]
        assert firing and firing[0]["firing"], alerts
        assert firing[0]["trace"].startswith("slo-model-drift")
        # the retrain rotates generations: traffic still scoring the OLD
        # object shadow-folds into the retained sketch
        fr2, m2 = _mk_gbm(model_id="drift_e2e_gbm", seed=5)
        assert modelmon.monitored(m2.key)
        assert modelmon.DRIFT.value(model=m2.key,
                                    feature_kind="numeric") > 0.5
        serving.score_frame(m2, _traffic(400, seed=73))
        serving.score_frame(old_model, _traffic(400, seed=73))
        docs = modelmon.evaluate()
        skew = docs[m2.key]["generation_skew"]
        assert skew is not None and docs[m2.key]["generation"] == 2
        assert modelmon.GEN_SKEW.value(model=m2.key) == skew
        assert docs[m2.key]["rows"] == 400
        assert docs[m2.key]["prev_rows"] >= 400
        assert docs[m2.key]["drift"]["numeric"] < 0.2
        DKV.remove(fr2.key)
    finally:
        DKV.remove(m.key)
        DKV.remove(fr.key)


def _model_series(metric, key):
    return [e for e in metric._json()
            if (e["labels"] or {}).get("model") == key]


def test_series_hygiene_on_model_churn():
    h2o3_tpu_torch.init(device="cpu")
    deleted = []
    for i in range(3):
        fr, m = _mk_gbm(seed=50 + i)
        deleted.append(m.key)
        serving.score_frame(m, _traffic(128, seed=60 + i))
        modelmon.evaluate()
        assert _model_series(modelmon.DRIFT, m.key)
        assert _model_series(modelmon.SCORED, m.key)
        assert _model_series(usage.MODEL_DEVICE_SECONDS, m.key)
        DKV.remove(m.key)
        DKV.remove(fr.key)
        for metric in (modelmon.DRIFT, modelmon.PRED_DRIFT,
                       modelmon.GEN_SKEW, modelmon.SCORED,
                       usage.MODEL_DEVICE_SECONDS):
            assert not _model_series(metric, m.key), metric.name
        assert DKV.get(modelmon.monitor_key(m.key)) is None
        assert modelmon.forget(m.key) is False
    text = TM.REGISTRY.prometheus_text()
    for key in deleted:
        assert f'model="{key}"' not in text


def test_unmonitored_when_disabled_and_cardinality_cap(monkeypatch, gbm):
    monkeypatch.setenv("H2O3_MODELMON_MAX_MODELS", "1")
    s0 = modelmon.SKIPPED.value()
    fr, m = _mk_gbm(seed=4)                 # gbm holds the one slot
    assert not modelmon.monitored(m.key)
    assert modelmon.SKIPPED.value() == s0 + 1
    DKV.remove(m.key)
    monkeypatch.setenv("H2O3_MODELMON", "0")
    fr2, m2 = _mk_gbm(seed=3, fr=fr)
    assert not modelmon.monitored(m2.key)
    assert DKV.get(modelmon.monitor_key(m2.key)) is None
    DKV.remove(m2.key)
    DKV.remove(fr.key)


def test_reset_retires_the_evaluator(monkeypatch, gbm):
    monkeypatch.setenv("H2O3_MODELMON_EVAL_S", "0.05")
    modelmon._ensure_evaluator()
    t = modelmon._EVAL_THREAD[0]
    assert t is not None and t.daemon and t.is_alive()
    modelmon.reset()
    t.join(timeout=5)
    assert not t.is_alive()
    assert threading.active_count() >= 1


def test_sparse_predictors_are_not_profiled():
    """A frame of SparseVec predictors is scored sparsely and never
    staged dense: train() stamps no baseline for it."""
    from h2o3_tpu_torch.core.frame import SparseVec, Vec
    h2o3_tpu_torch.init(device="cpu")
    rng = np.random.default_rng(4)
    n = 256
    rows = [np.sort(rng.choice(n, 40, replace=False)) for _ in range(5)]
    vals = [rng.normal(size=40).astype(np.float32) for _ in range(5)]
    fr = Frame(["y"] + [f"x{j}" for j in range(5)],
               [Vec.from_numpy(rng.normal(size=n))]
               + [SparseVec(r, v, n) for r, v in zip(rows, vals)])
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="gaussian")
    m.train(y="y", training_frame=fr)
    assert m._sparse_fit and not modelmon.monitored(m.key)
    assert DKV.get(modelmon.monitor_key(m.key)) is None
    DKV.remove(m.key)
    DKV.remove(fr.key)


def test_frame_columns_bin_demoted_columns_without_faulting(tmp_path):
    """`FrameColumns` (the train-time staging) over a frame of every codec
    whose chunks sit in HBM, on the host and on disk gives the profile of
    the host-staged matrix exactly, and promotes no chunk into HBM."""
    from h2o3_tpu_torch.core import tiering as TT
    from h2o3_tpu_torch.core.memory import MANAGER
    from h2o3_tpu_torch.serving import scorer_cache as SC
    h2o3_tpu_torch.init(device="cpu")
    rng = np.random.default_rng(9)
    n = 3000
    a = rng.normal(size=n)
    a[::37] = np.nan
    cols = {"f32": a, "i8": rng.integers(-50, 50, n).astype(float),
            "i16": rng.integers(0, 3000, n).astype(float),
            "const": np.full(n, 2.5),
            "c": rng.choice(["u", "v", "w"], size=n).tolist(),
            "y": rng.choice(["no", "yes"], size=n).tolist()}
    fr = Frame.from_dict(cols)
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="binomial")
    m.train(y="y", training_frame=fr)
    di = m._dinfo
    want = modelmon.build_baseline(
        di, SC.stage_frame(di, di.adapt(fr), n), None)
    old_root = MANAGER.ice_root
    MANAGER.ice_root = str(tmp_path)
    try:
        vecs = [fr.vec(c) for c in di.raw_columns()]
        for v, to in zip(vecs, (TT.TIER_HOST, TT.TIER_DISK, TT.TIER_HOST)):
            TT.PAGER.demote(v._chunk, to)
            if to == TT.TIER_DISK:
                TT.PAGER.demote(v._chunk, TT.TIER_HOST)
                TT.PAGER.demote(v._chunk, TT.TIER_DISK)
        tiers = [v._chunk.tier for v in vecs]
        assert {"host", "disk", "hbm"} <= set(tiers)
        got = modelmon.build_baseline(
            di, modelmon.FrameColumns(fr, di.raw_columns(),
                                      torch.device("cpu")), None)
        # none promoted into HBM (the staging view reads a disk chunk
        # back into the host tier, as the host-staged matrix does)
        assert [v._chunk.tier == "hbm" for v in vecs] == \
            [t == "hbm" for t in tiers]
    finally:
        MANAGER.ice_root = old_root
    assert _profile_tuple(got) == _profile_tuple(want)
    DKV.remove(m.key)
    DKV.remove(fr.key)
