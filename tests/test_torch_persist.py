"""The port's persistence against the JAX package, on the CPU: `.hex`
frame snapshots (io/persist.py), binary model save and load
(genmodel/mojo.py) and a grid's recovery directory.

Tolerances:
- `.hex` round trips, in the port and between the packages: names, types,
  domains and codecs equal, every decoded value bit for bit; the port's
  export writes the JAX package's padded planes byte for byte;
- save_model/load_model: every estimator the port trains scores bit for
  bit after the round trip (predictions, or the estimator's own output:
  a transform, the aggregated frame, the infogram's table);
- a resumed grid: the same model keys as an uninterrupted grid and as the
  JAX package's resumed grid, each model's metrics equal bit for bit,
  and no model trained twice.
"""

import io
import json
import math
import zipfile

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu.core import frame as JF
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu.io import persist as JPERSIST
from h2o3_tpu_torch.core import frame as TF
from h2o3_tpu_torch.core import tiering
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.genmodel import mojo as TMOJO
from h2o3_tpu_torch.io import persist as TPERSIST

N = 300


@pytest.fixture(scope="module", autouse=True)
def cpu_cloud():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _cols(n=N, seed=5):
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.float64)
    x = rng.normal(size=(n, 4))
    logit = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    return {
        "x0": x[:, 0], "x1": x[:, 1], "x2": x[:, 2],
        "x3": np.where(i % 17 == 0, np.nan, x[:, 3]),
        "i8": i % 50, "const": np.full(n, 3.0),
        "far": 1.0e8 + rng.integers(0, 60000, n),
        "c": np.array([["a", "b", "c", None][k % 4] for k in range(n)],
                      object),
        "k": np.array([["p", "q", "r"][k % 3] for k in
                       rng.integers(0, 3, n)], object),
        "y": np.array(["no", "yes"], object)[y.astype(int)],
    }


def _bits32(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _same_values(tf, other, jax_side=False):
    """Names, types, domains and every value bit for bit."""
    assert list(tf.names) == list(other.names)
    assert tf.nrows == other.nrows
    for n in tf.names:
        a, b = tf.vec(n), other.vec(n)
        assert a.type == b.type, n
        assert a.levels() == b.levels(), n
        if a.type == "str":
            assert list(a.to_numpy()) == list(b.to_numpy()[:tf.nrows])
            continue
        if a.type == "uuid":
            assert list(a.to_numpy()) == list(b.to_numpy())
            continue
        if not jax_side:
            ca, cb = a.codec, b.codec
            assert (ca.kind, ca.bias) == (cb.kind, cb.bias), n
            assert ca.const_val == cb.const_val or (
                math.isnan(ca.const_val) and math.isnan(cb.const_val)), n
        av = a.as_f32().numpy()
        bv = np.asarray(b.to_numpy() if jax_side else b.as_f32().numpy())
        np.testing.assert_array_equal(_bits32(av), _bits32(bv[:tf.nrows]),
                                      err_msg=n)


def _frames(n=N, seed=5):
    cols = _cols(n, seed)
    tf = TF.Frame.from_dict(cols)
    jf = JF.Frame.from_dict(cols)
    return cols, tf, jf


@pytest.mark.parametrize("n", [N, 512])
def test_hex_round_trip_in_the_port(tmp_path, n):
    """Dense, categorical, constant, NA, string, uuid and sparse columns
    come back with the same codecs and bits; the NA plane is kept only
    where a value is NA."""
    _, tf, _ = _frames(n)
    import uuid
    u = np.array([str(uuid.UUID(int=k * 7919)) if k % 5 else None
                  for k in range(n)], object)
    tf["u"] = TF.UuidVec.encode(u)
    tf["s"] = TF.Vec.from_numpy(np.array([f"w{k % 9}" if k % 6 else None
                                          for k in range(n)], object),
                                type="str")
    rows = np.arange(0, n, 7, dtype=np.int32)
    tf["sp"] = TF.SparseVec(rows, np.linspace(-1, 1, len(rows)), n)
    p = str(tmp_path / "f.hex")
    h2o3_tpu_torch.export_file(tf, p)
    back = TPERSIST.import_frame(p, key="back")
    _same_values(tf, back)
    for n_, v in zip(tf.names, tf.vecs):
        if v.type in ("num", "enum", "time") and not isinstance(
                v, TF.SparseVec):
            bv = back.vec(n_)
            assert (v._chunk.host_view()[1] is None) == \
                (bv._chunk.host_view()[1] is None), n_
    sp = back.vec("sp")
    np.testing.assert_array_equal(sp.nz_rows.numpy(), rows)
    assert back.key == "back"


def test_port_export_is_the_jax_layout_and_imports_there(tmp_path):
    """At 300 rows the JAX package pads to 320: the port's export holds
    the same padded planes byte for byte, and each package imports the
    other's file to the same values."""
    cols, tf, jf = _frames()
    tp, jp = str(tmp_path / "t.hex"), str(tmp_path / "j.hex")
    TPERSIST.export_frame(tf, tp)
    JPERSIST.export_frame(jf, jp)
    with zipfile.ZipFile(tp) as a, zipfile.ZipFile(jp) as b:
        za = np.load(io.BytesIO(a.read("columns.npz")))
        zb = np.load(io.BytesIO(b.read("columns.npz")))
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
        ha = json.loads(a.read("header.json"))
        hb = json.loads(b.read("header.json"))
        assert ha["nrows"] == hb["nrows"] == N
        assert ha["cols"] == hb["cols"]
    # the JAX file into the port, the port's file into the JAX package
    from_jax = TPERSIST.import_frame(jp, key="from_jax")
    _same_values(tf, from_jax)
    to_jax = JPERSIST.import_frame(tp, key="to_jax")
    _same_values(tf, to_jax, jax_side=True)
    JDKV.remove(jf.key)
    JDKV.remove("to_jax")


def test_uuid_columns_are_one_way(tmp_path):
    """The JAX package cannot export a UUID column, and cannot import the
    port's (its words ride `u<j>`, which the JAX reader does not know)."""
    import uuid
    u = np.array([str(uuid.UUID(int=k + 1)) for k in range(64)], object)
    jf = JF.Frame(["u"], [JF.UuidVec.encode(u)])
    with pytest.raises(AttributeError):
        JPERSIST.export_frame(jf, str(tmp_path / "j.hex"))
    tf = TF.Frame(["u"], [TF.UuidVec.encode(u)])
    p = str(tmp_path / "t.hex")
    TPERSIST.export_frame(tf, p)
    with pytest.raises(KeyError):
        JPERSIST.import_frame(p)
    assert list(TPERSIST.import_frame(p).vec("u").to_numpy()) == \
        list(tf.vec("u").to_numpy())
    JDKV.remove(jf.key)


def test_demoted_frame_exports_without_a_fault(tmp_path, monkeypatch):
    """A frame demoted to the host and to disk exports from there: no
    chunk goes back to the device tier (a disk chunk is read into the
    host tier), and the file is the resident frame's."""
    _, tf, _ = _frames()
    p_hot = str(tmp_path / "hot.hex")
    TPERSIST.export_frame(tf, p_hot)
    chunks = [v._chunk for v in tf.vecs if v._chunk is not None]
    P = tiering.PAGER
    for c in chunks[: len(chunks) // 2]:
        P.demote(c, tiering.TIER_HOST)
    for c in chunks[len(chunks) // 2:]:
        P.demote(c, tiering.TIER_DISK)
    tiers = [c.tier for c in chunks]

    def no_fault(*a, **k):
        raise AssertionError("export faulted a chunk")
    monkeypatch.setattr(tiering.TierChunk, "device", no_fault)
    p_cold = str(tmp_path / "cold.hex")
    TPERSIST.export_frame(tf, p_cold)
    monkeypatch.undo()
    assert "disk" in tiers and all(c.tier == "host" for c in chunks)
    _same_values(TPERSIST.import_frame(p_hot), TPERSIST.import_frame(p_cold))


# ---------------------------------------------------------------------------
# binary models: every estimator the port trains
X4 = ["x0", "x1", "x2", "x3"]


def _sup(cls, y="y", x=None, **kw):
    def make(tf):
        m = getattr(h2o3_tpu_torch, cls)(**kw)
        m.train(x=x or X4 + ["c"], y=y, training_frame=tf)
        return m
    return make


def _unsup(cls, x=None, **kw):
    def make(tf):
        m = getattr(h2o3_tpu_torch, cls)(**kw)
        m.train(x=x or X4, training_frame=tf)
        return m
    return make


def _predict(m, tf):
    return m.predict(tf).to_numpy()


def _ensemble(tf):
    bases = []
    for cls, kw in (("H2OGradientBoostingEstimator",
                     dict(ntrees=3, max_depth=3, nbins=20)),
                    ("H2OGeneralizedLinearEstimator", dict(lambda_=0.0))):
        m = getattr(h2o3_tpu_torch, cls)(
            nfolds=3, seed=2, keep_cross_validation_predictions=True, **kw)
        m.train(x=X4, y="y", training_frame=tf)
        bases.append(m.key)
    m = h2o3_tpu_torch.H2OStackedEnsembleEstimator(base_models=bases)
    m.train(x=X4, y="y", training_frame=tf)
    return m


def _coxph(tf):
    rng = np.random.default_rng(4)
    f = TF.Frame.from_dict({
        "z0": tf.vec("x0").to_numpy(), "z1": tf.vec("x1").to_numpy(),
        "time": np.ceil(rng.exponential(10.0, tf.nrows)),
        "event": (rng.random(tf.nrows) < 0.7).astype(np.float64)})
    m = h2o3_tpu_torch.H2OCoxProportionalHazardsEstimator(stop_column="time")
    m.train(x=["z0", "z1"], y="event", training_frame=f)
    m._persist_frame = f
    return m


def _word2vec(tf):
    words = np.array([f"t{(k // 3) % 7}w{k % 5}" for k in range(600)],
                     object)
    f = TF.Frame(["w"], [TF.Vec.from_numpy(words, type="str")])
    m = h2o3_tpu_torch.H2OWord2vecEstimator(vec_size=8, epochs=1,
                                            min_word_freq=1, seed=3)
    m.train(training_frame=f)
    m._persist_frame = f
    return m


def _target_encoder(tf):
    m = h2o3_tpu_torch.H2OTargetEncoderEstimator()
    m.train(x=["c", "k"], y="y", training_frame=tf)
    return m


ESTIMATORS = {
    "gbm": (_sup("H2OGradientBoostingEstimator", ntrees=3, max_depth=3,
                 nbins=20, seed=1), _predict),
    "gbm_multinomial": (_sup("H2OGradientBoostingEstimator", y="k",
                             ntrees=2, max_depth=3, nbins=20), _predict),
    "gbm_adaptive": (_sup("H2OGradientBoostingEstimator", ntrees=3,
                          max_depth=3, histogram_type="UniformAdaptive"),
                     _predict),
    "drf": (_sup("H2ORandomForestEstimator", ntrees=3, max_depth=5, seed=1),
            _predict),
    "xgboost": (_sup("H2OXGBoostEstimator", ntrees=3, max_depth=3, seed=1),
                _predict),
    "isolation_forest": (_unsup("H2OIsolationForestEstimator", ntrees=5,
                                seed=1), _predict),
    "extended_isolation_forest": (
        _unsup("H2OExtendedIsolationForestEstimator", ntrees=5,
               sample_size=64, seed=1), _predict),
    "glm": (_sup("H2OGeneralizedLinearEstimator", lambda_=0.0), _predict),
    "gam": (_sup("H2OGeneralizedAdditiveEstimator", x=["x1", "x2"],
                 gam_columns=["x0"]), _predict),
    "rulefit": (_sup("H2ORuleFitEstimator", x=X4, max_rule_length=2,
                     seed=1),
                lambda m, tf: np.array([r["coefficient"] for r in
                                        m.rule_importance()] + [m.auc()])),
    "deeplearning": (_sup("H2ODeepLearningEstimator", x=X4, hidden=[6],
                          epochs=1, seed=1), _predict),
    "autoencoder": (_unsup("H2ODeepLearningEstimator", autoencoder=True,
                           hidden=[3], epochs=1, seed=1),
                    lambda m, tf: m.anomaly(tf).to_numpy()),
    "kmeans": (_unsup("H2OKMeansEstimator", k=3, seed=1), _predict),
    "pca": (_unsup("H2OPrincipalComponentAnalysisEstimator", k=2),
            _predict),
    "svd": (_unsup("H2OSingularValueDecompositionEstimator", nv=2),
            lambda m, tf: np.asarray(m._output.model_summary["d"])),
    "glrm": (_unsup("H2OGeneralizedLowRankEstimator", k=2, seed=1),
             lambda m, tf: m.reconstruct(tf).to_numpy()),
    "naive_bayes": (_sup("H2ONaiveBayesEstimator"), _predict),
    "coxph": (_coxph, lambda m, tf: m.predict(m._persist_frame).to_numpy()),
    "psvm": (_sup("H2OSupportVectorMachineEstimator", x=X4, seed=1),
             _predict),
    "ensemble": (_ensemble, _predict),
    "aggregator": (_unsup("H2OAggregatorEstimator",
                          target_num_exemplars=50),
                   lambda m, tf: m.aggregated_frame().to_numpy()),
    "target_encoder": (_target_encoder,
                       lambda m, tf: m.transform(tf).to_numpy()),
    "word2vec": (_word2vec, lambda m, tf: m.transform(
        m._persist_frame, aggregate_method="NONE").to_numpy()),
    "infogram": (lambda tf: h2o3_tpu_torch.H2OInfogram(
        ntrees=2, max_depth=3, nbins=20, seed=1).train(
            x=X4, y="y", training_frame=tf),
        lambda m, tf: np.array([[r["relevance_index"],
                                 r["total_information_index"]]
                                for r in m.result], np.float64)),
}


def _same_output(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype == object:
        assert [str(x) for x in a.ravel()] == [str(x) for x in b.ravel()]
        return
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    np.testing.assert_array_equal(a64.view(np.uint64), b64.view(np.uint64))


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_save_and_load_every_estimator(tmp_path, name):
    """Each estimator, saved and loaded (onto the CPU by the cloud, and by
    `device=`), scores bit for bit; the loaded model is in the store
    under its key."""
    make, score = ESTIMATORS[name]
    _, tf, _ = _frames()
    m = make(tf)
    want = score(m, tf)
    p = str(tmp_path / "m.bin")
    h2o3_tpu_torch.save_model(m, p)
    key = getattr(m, "key", None)
    if key is not None:
        DKV.remove(key)
    for dev in (None, "cpu"):
        back = h2o3_tpu_torch.load_model(p, device=dev)
        assert type(back) is type(m)
        if key is not None:
            assert DKV.get(key) is back
        _same_output(score(back, tf), want)


def test_saved_model_holds_no_device_state(tmp_path):
    """The file holds no torch storage (so it loads where no card is): a
    tensor, a generator and a frame on the model ride the port's own
    reducers, and come back."""
    import pickletools
    import torch
    _, tf, _ = _frames()
    m = ESTIMATORS["word2vec"][0](tf)
    m.gen_probe = torch.Generator()
    p = str(tmp_path / "m.bin")
    TMOJO.save_model(m, p)
    with open(p, "rb") as f:
        strings = {a for _op, a, _pos in pickletools.genops(f)
                   if isinstance(a, str)}
    assert not any("_rebuild" in a or "Storage" in a for a in strings)
    assert {"_restore_tensor", "_restore_generator",
            "_restore_frame"} <= strings
    back = TMOJO.load_model(p, device="cpu")
    assert isinstance(back.gen_probe, torch.Generator)
    assert back._persist_frame.names == ["w"]


# ---------------------------------------------------------------------------
def test_recovery_resume_reloads_frames_and_models(tmp_path):
    _, tf, _ = _frames()
    m = ESTIMATORS["gbm"][0](tf)
    rec = TPERSIST.Recovery(str(tmp_path / "rec"))
    rec.checkpoint_frame(tf)
    rec.checkpoint_model(m)
    rec.checkpoint_model(m)
    assert rec.recovered_model_keys() == [m.key]
    assert rec.resume() == {"frames": [], "models": []}
    fkey, mkey = tf.key, m.key
    want = m.predict(tf).to_numpy()
    DKV.remove(fkey)
    DKV.remove(mkey)
    out = rec.resume()
    assert [f.key for f in out["frames"]] == [fkey]
    assert [x.key for x in out["models"]] == [mkey]
    _same_values(tf, DKV.get(fkey))
    _same_output(DKV.get(mkey).predict(tf).to_numpy(), want)


class _Killed(BaseException):
    """Stops a grid as a killed process would: the grid's failure
    handling catches Exception only."""


def _count_trains(monkeypatch, cls, train, kill_after=None):
    """Patch estimator `cls` to record the model ids it trains (through
    its original `train`) and to raise _Killed at the train after
    `kill_after` of them."""
    trained = []

    def counting(self, *a, **k):
        if kill_after is not None and len(trained) >= kill_after:
            raise _Killed()
        trained.append(self.params.get("model_id"))
        return train(self, *a, **k)
    monkeypatch.setattr(cls, "train", counting)
    return trained


@pytest.mark.parametrize("strategy", ["Cartesian", "RandomDiscrete"])
def test_resumed_grid_is_the_uninterrupted_grid(tmp_path, monkeypatch,
                                                strategy):
    """A 4-model GBM grid stopped after 2 models and trained again with
    the same id and directory: 2 models reloaded, 2 trained, every model
    bit for bit the uninterrupted grid's, the same keys as the JAX
    package's resumed grid."""
    import h2o3_tpu
    from h2o3_tpu import models as JMODELS
    h2o3_tpu.init()
    cols, tf, jf = _frames()
    hyper = {"max_depth": [2, 3], "learn_rate": [0.1, 0.3]}
    crit = {"strategy": strategy}
    kw = dict(ntrees=3, nbins=20, seed=1, distribution="bernoulli")

    trains = {c: c.train for c in (
        h2o3_tpu_torch.H2OGradientBoostingEstimator,
        JMODELS.H2OGradientBoostingEstimator)}

    def run(pkg_grid, est, gid, rdir, kill_after=None, frame=tf):
        trained = _count_trains(monkeypatch, est, trains[est], kill_after)
        g = pkg_grid(est, hyper, grid_id=gid, search_criteria=crit,
                     recovery_dir=rdir)
        try:
            g.train(x=X4, y="y", training_frame=frame, **kw)
        except _Killed:
            pass
        return g, trained

    full, _ = run(h2o3_tpu_torch.H2OGridSearch,
                  h2o3_tpu_torch.H2OGradientBoostingEstimator, "gfull",
                  None)
    rdir = str(tmp_path / "rec")
    first, trained1 = run(h2o3_tpu_torch.H2OGridSearch,
                          h2o3_tpu_torch.H2OGradientBoostingEstimator,
                          "gres", rdir, kill_after=2)
    assert len(trained1) == 2 and len(first.models) == 2
    for mk in first.model_ids:
        DKV.remove(mk)                    # a restarted process's store
    DKV.remove(tf.key)
    second, trained2 = run(h2o3_tpu_torch.H2OGridSearch,
                           h2o3_tpu_torch.H2OGradientBoostingEstimator,
                           "gres", rdir, frame=TPERSIST.import_frame(
                               str(tmp_path / "rec" /
                                   f"frame_{tf.key}.hex")))
    assert len(trained2) == 2 and not set(trained1) & set(trained2)
    assert len(second.models) == 4
    def by_combo(g):
        return {(m.params["max_depth"], m.params["learn_rate"]): m
                for m in g.models}
    by_full, by_res = by_combo(full), by_combo(second)
    assert by_full.keys() == by_res.keys() and len(by_full) == 4
    for combo, m in by_full.items():
        r = by_res[combo]
        assert r.auc() == m.auc() and r.logloss() == m.logloss()
    # the JAX package's grid, killed and resumed the same way
    jdir = str(tmp_path / "jrec")
    jfirst, _ = run(JMODELS.H2OGridSearch,
                    JMODELS.H2OGradientBoostingEstimator, "gres", jdir,
                    kill_after=2, frame=jf)
    for mk in jfirst.model_ids:
        JDKV.remove(mk)
    jsecond, jtrained2 = run(JMODELS.H2OGridSearch,
                             JMODELS.H2OGradientBoostingEstimator, "gres",
                             jdir, frame=jf)
    assert sorted(jsecond.model_ids) == sorted(second.model_ids)
    assert sorted(jfirst.model_ids) == sorted(first.model_ids)
    assert sorted(jtrained2) == sorted(trained2)
    for g in (jfirst, jsecond):
        for mk in g.model_ids:
            JDKV.remove(mk)
    JDKV.remove(jf.key)
    assert not math.isnan(second.models[0].auc())
