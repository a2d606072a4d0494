"""The model framework of the port against the JAX package, on the CPU:
the Frame and Vec surface, metrics' and models' `to_dict`,
`model_performance`, the top-level registry functions, grid search,
stacked ensembles and segment models.

Seeded numpy frames go to both packages. Tolerances:
- Frame and Vec: shapes, names, types, values and summaries equal
  (rollups within 1e-6 relative: the port sums them in float64, the JAX
  package in f32);
- metrics `to_dict`: the same keys, values within 1e-6;
- a model's `to_dict` and `model_performance` (GBM, GLM, KMeans): the
  same key tree, values within 1e-6;
- grid: model ids, the order of the combinations (RandomDiscrete's
  numpy shuffle too) and the failures equal, each model's training AUC
  within 1e-6, and `parallelism` 2 the same models, bit for bit, as 1;
- ensemble: the level-one columns within 1e-5; binomial: the
  metalearner's coefficients and the predictions within 1e-4;
  multinomial: the predictions within 1e-3 (the metalearner's design is
  singular in both packages, so its coefficients are not identified and
  the JAX package's η holds 1e-3);
- segments: labels, row counts and statuses equal, with one segment made
  to fail in both packages.
"""

import json

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu.models import metrics as JM
from h2o3_tpu.models.ensemble import H2OStackedEnsembleEstimator as JSE
from h2o3_tpu.models.grid import H2OGridSearch as JGrid
from h2o3_tpu.models.segments import train_segments as jtrain_segments
from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models import metrics as TM

N = 900
X = ["a", "b", "c", "color"]
GBM = dict(ntrees=4, max_depth=3, nbins=20, min_rows=100, seed=3,
           distribution="bernoulli")


@pytest.fixture(scope="module")
def frames():
    h2o3_tpu_torch.init(device="cpu")
    rng = np.random.default_rng(17)
    a, b, c = rng.normal(size=(3, N))
    a[rng.random(N) < 0.05] = np.nan
    color = np.array(rng.choice(["red", "green", "blue"], N), object)
    color[rng.random(N) < 0.05] = None
    region = np.array(rng.choice(["east", "north", "west"], N), object)
    logit = 1.2 * np.nan_to_num(a) - 0.8 * b + 0.6 * (color == "blue")
    y = rng.random(N) < 1 / (1 + np.exp(-logit))
    k = np.clip(np.round(logit / 2 + rng.logistic(size=N)), 0, 2)
    cols = {"a": a, "b": b, "c": c, "color": color, "region": region,
            "n": rng.integers(0, 5, N).astype(float),
            "g": 2 * np.nan_to_num(a) - b + rng.normal(0, 0.3, N),
            "y": np.array(["n", "p"], object)[y.astype(int)],
            "k": np.array(["lo", "mid", "top"], object)[k.astype(int)]}
    yield JFrame.from_dict(cols), Frame.from_dict(cols), cols
    h2o3_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
def test_frame_and_vec_surface_matches_jax(frames):
    jf, tf, cols = frames
    assert tf.shape == jf.shape == (N, len(cols))
    assert tf.types == jf.types
    assert tf.col_idx("color") == jf.col_idx("color") == 3
    for sel in ("b", ["c", "a"], [0, 4]):
        j, t = jf[sel], tf[sel]
        assert t.names == j.names
        np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
    assert tf.drop(["a", "k"]).names == jf.drop(["a", "k"]).names
    assert tf.drop("g").names == jf.drop("g").names
    for name in ("a", "c", "n", "color"):
        tv, jv = tf.vec(name), jf.vec(name)
        assert tv.cardinality == jv.cardinality
        assert tv.na_cnt() == jv.na_cnt()
        assert tv.is_int() == jv.is_int()
        np.testing.assert_allclose([tv.min(), tv.max()],
                                   [jv.min(), jv.max()], rtol=1e-6)
        assert len(tv) == len(jv) == N
    ts, js = tf.summary(), jf.summary()
    assert list(ts) == list(js)
    for name in js:
        assert ts[name].keys() == js[name].keys()
        for key, v in js[name].items():
            if isinstance(v, float):
                np.testing.assert_allclose(ts[name][key], v, rtol=1e-6,
                                           err_msg=f"{name}.{key}")
            else:
                assert ts[name][key] == v, (name, key)
    # a column added from a Vec, a one-column Frame, and an array
    arr = np.arange(N, dtype=float)
    for f, vec in ((jf, h2o3_tpu.Vec), (tf, Vec)):
        f2 = f[["a", "b"]]
        f2["v"] = vec.from_numpy(arr)
        f2["w"] = f["c"]
        f2["a"] = arr * 2
        assert f2.names == ["a", "b", "v", "w"]
        np.testing.assert_array_equal(f2.to_numpy(["a", "v", "w"]),
                                      np.column_stack([arr * 2, arr,
                                                       cols["c"]]).astype(
                                                           np.float32))


def test_frame_pandas_round_trip_matches_jax(frames):
    pd = pytest.importorskip("pandas")
    jf, tf, _ = frames
    jd, td = jf.as_data_frame(), tf.as_data_frame()
    pd.testing.assert_frame_equal(td, jd)
    pd.testing.assert_frame_equal(tf.head(5), jf.head(5))
    back = Frame.from_pandas(td)
    assert back.names == tf.names and back.types == tf.types
    np.testing.assert_array_equal(back.to_numpy(), tf.to_numpy())


def test_frame_from_dict_column_types(frames):
    cols = {"x": np.array([1.0, 2.0, np.nan]),
            "s": np.array(["u", "v", "u"], object)}
    types = {"x": "enum", "s": "str"}
    j = JFrame.from_dict(cols, column_types=types)
    t = Frame.from_dict(cols, key="typed", column_types=types)
    assert t.key == "typed" and DKV.get("typed") is t
    assert t.types == j.types == {"x": "enum", "s": "str"}
    assert list(t.vec("s").to_numpy()) == list(j.vec("s").to_numpy())


@pytest.mark.parametrize("kind", ["regression", "binomial"])
def test_metrics_to_dict_matches_jax(kind):
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(5)
    y = (rng.random(2000) < 0.4).astype(np.float32)
    p = np.clip(y * 0.3 + rng.random(2000) * 0.7, 0, 1).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 2000).astype(np.float32)
    if kind == "regression":
        j = JM.regression_metrics(jnp.asarray(y), jnp.asarray(p),
                                  jnp.asarray(w)).to_dict()
        t = TM.regression_metrics(torch.tensor(y), torch.tensor(p),
                                  torch.tensor(w)).to_dict()
    else:
        j = JM.binomial_metrics(jnp.asarray(y), jnp.asarray(p),
                                jnp.asarray(w)).to_dict()
        t = TM.binomial_metrics(torch.tensor(y), torch.tensor(p),
                                torch.tensor(w)).to_dict()
    assert list(t) == list(j)
    for key in j:
        np.testing.assert_allclose(np.asarray(t[key], np.float64),
                                   np.asarray(j[key], np.float64),
                                   rtol=1e-6, atol=1e-9, err_msg=key)
    json.dumps(t)


# ---------------------------------------------------------------------------
def test_model_surface(frames):
    """model_performance on a frame equals the metrics train() computed on
    it; mse, model_id and to_dict (with GLM coefficients and KMeans
    centres), through json.dumps; the top-level registry."""
    _, tf, _ = frames
    gbm = h2o3_tpu_torch.H2OGradientBoostingEstimator(**GBM)
    gbm.train(x=X, y="y", training_frame=tf, validation_frame=tf)
    perf = gbm.model_performance(tf)
    assert perf.auc == gbm.auc(valid=True) and \
        perf.logloss == gbm.logloss(valid=True)
    assert gbm.model_performance() is gbm._output.training_metrics
    assert gbm.mse() == gbm._output.training_metrics.mse
    assert gbm.model_id == gbm.key
    d = json.loads(json.dumps(gbm.to_dict()))
    assert d["model_id"] == gbm.key and d["algo"] == "gbm"
    assert d["training_metrics"]["auc"] == gbm.auc()
    assert d["validation_metrics"]["logloss"] == gbm.logloss(valid=True)
    glm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(lambda_=0.0)
    glm.train(x=X, y="g", training_frame=tf)
    d = json.loads(json.dumps(glm.to_dict()))
    assert d["output"]["coefficients_table"] == glm.coef()
    assert d["training_metrics"]["RMSE"] == glm.rmse()
    km = h2o3_tpu_torch.H2OKMeansEstimator(k=3, seed=1)
    km.train(x=["a", "b", "c"], training_frame=tf)
    d = json.loads(json.dumps(km.to_dict()))
    np.testing.assert_array_equal(d["output"]["centers"],
                                  km._centroids.numpy())
    assert h2o3_tpu_torch.get_model(glm.model_id) is glm
    assert h2o3_tpu_torch.get_frame(tf.key) is tf
    assert glm.model_id in h2o3_tpu_torch.ls()
    h2o3_tpu_torch.remove(glm.model_id)
    assert h2o3_tpu_torch.get_model(glm.model_id) is None
    assert glm.model_id not in h2o3_tpu_torch.ls()


def _leaves(d, path=""):
    """A JSON tree's leaves by their path."""
    if isinstance(d, dict):
        items = d.items()
    elif isinstance(d, list):
        items = enumerate(d)
    else:
        return {path: d}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{path}/{k}"))
    return out


def _same_tree(j, t, differ=()):
    """The same key tree; numbers within 1e-6 relative (absolute near 0),
    anything else equal, but for the paths in `differ`."""
    j, t = _leaves(j), _leaves(t)
    assert sorted(t) == sorted(j)
    for k, jv in j.items():
        tv = t[k]
        if k in differ:
            continue
        if isinstance(jv, (int, float)) and not isinstance(jv, bool):
            np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6,
                                       equal_nan=True, err_msg=k)
        else:
            assert tv == jv, (k, tv, jv)


@pytest.mark.parametrize("algo", ["gbm", "glm", "kmeans"])
def test_model_dict_and_performance_match_jax(frames, algo):
    """The same GBM (depth 3, min_rows 100), GLM and KMeans in both
    packages: to_dict() has the JAX package's key tree with its values
    (metrics, coefficients, centres, scoring history) within 1e-6, but for
    the engine's name; model_performance(frame) scores the frame to the
    JAX package's metrics within 1e-6, and without a frame gives the
    training metrics (a KMeans has no response, so both raise on a
    frame)."""
    jf, tf, _ = frames
    cls, kw, fit = {
        "gbm": ("H2OGradientBoostingEstimator", GBM, dict(x=X, y="y")),
        "glm": ("H2OGeneralizedLinearEstimator", dict(lambda_=0.0),
                dict(x=X, y="g")),
        "kmeans": ("H2OKMeansEstimator", dict(k=3, seed=1),
                   dict(x=["a", "b", "c"])),
    }[algo]
    valid = algo == "gbm"
    jm = getattr(JMODELS, cls)(model_id=f"dict_{algo}", **kw)
    jm.train(training_frame=jf, validation_frame=jf if valid else None,
             **fit)
    tm = getattr(h2o3_tpu_torch, cls)(model_id=f"dict_{algo}", **kw)
    tm.train(training_frame=tf, validation_frame=tf if valid else None,
             **fit)
    _same_tree(json.loads(json.dumps(jm.to_dict())),
               json.loads(json.dumps(tm.to_dict())),
               differ=("/model_summary/engine",))
    assert tm.to_dict()["model_summary"].get("engine") in (None,
                                                           "binned_cuda")
    if algo == "kmeans":
        for m, f in ((jm, jf), (tm, tf)):
            with pytest.raises(ValueError):
                m.model_performance(f)
    else:
        _same_tree(jm.model_performance(jf).to_dict(),
                   tm.model_performance(tf).to_dict())
    _same_tree(jm.model_performance().to_dict(),
               tm.model_performance().to_dict())


# ---------------------------------------------------------------------------
def _grids(frames, cls, hyper, criteria=None, parallelism=1, gid="grid",
           **kw):
    jf, tf, _ = frames
    jg = JGrid(getattr(JMODELS, cls), hyper, grid_id=gid,
               search_criteria=criteria)
    jg.train(x=X, y="y", training_frame=jf, **kw)
    tg = h2o3_tpu_torch.H2OGridSearch(getattr(h2o3_tpu_torch, cls), hyper,
                                      grid_id=gid, search_criteria=criteria,
                                      parallelism=parallelism)
    tg.train(x=X, y="y", training_frame=tf, **kw)
    return jg, tg


def _by_id(grid):
    return {m.key: m for m in grid.models}


@pytest.mark.parametrize("seed", [42, 7])
def test_random_discrete_walk_matches_jax(seed):
    """RandomDiscrete draws the JAX package's combinations: numpy's
    default_rng(seed) shuffles the same Cartesian list."""
    hyper = {"max_depth": [2, 4, 6], "learn_rate": [0.05, 0.1, 0.3],
             "sample_rate": [0.8, 1.0]}
    crit = {"strategy": "RandomDiscrete", "max_models": 4, "seed": seed}
    j = JGrid(JMODELS.H2OGradientBoostingEstimator, hyper,
              search_criteria=crit)
    t = h2o3_tpu_torch.H2OGridSearch(
        h2o3_tpu_torch.H2OGradientBoostingEstimator, hyper,
        search_criteria=crit)
    assert t._combos() == j._combos() and len(t._combos()) == 4


def test_grid_matches_jax(frames):
    """A GLM grid with a failing family: the same ids, combinations and
    failures (recorded, not raised), the same models, and get_grid's
    order."""
    hyper = {"family": ["binomial", "bogus"], "alpha": [0.0, 0.5]}
    jg, tg = _grids(frames, "H2OGeneralizedLinearEstimator", hyper,
                    gid="glmgrid", lambda_=1e-3)
    assert tg._combos() == jg._combos()
    assert sorted(tg.model_ids) == sorted(jg.model_ids) == \
        ["glmgrid_model_0", "glmgrid_model_2"]
    assert tg.failures == jg.failures and len(tg.failures) == 2
    jm, tm = _by_id(jg), _by_id(tg)
    for key in jm:
        assert tm[key].params["alpha"] == jm[key].params["alpha"]
        assert abs(tm[key].auc() - jm[key].auc()) < 1e-6
    assert [m.key for m in tg.get_grid("auc")] == \
        [m.key for m in jg.get_grid("auc")]
    lls = [m.logloss() for m in tg.get_grid("logloss")]
    assert lls == sorted(lls)


def test_grid_parallelism_builds_the_same_models(frames, tmp_path):
    """`parallelism` 2 builds the same GBMs, bit for bit, as 1; with a
    `recovery_dir`, a grid trained again under the same id resumes: it
    loads the models the first run checkpointed and trains none."""
    _, tf, _ = frames
    grids = []
    for par in (1, 2):
        g = h2o3_tpu_torch.H2OGridSearch(
            h2o3_tpu_torch.H2OGradientBoostingEstimator,
            {"max_depth": [2, 3], "learn_rate": [0.1, 0.3]},
            grid_id=f"par{par}", parallelism=par)
        g.train(x=X, y="y", training_frame=tf, ntrees=3, nbins=20, seed=3,
                distribution="bernoulli")
        grids.append({k.split("_model_")[1]: m
                      for k, m in _by_id(g).items()})
    assert grids[0].keys() == grids[1].keys() and len(grids[0]) == 4
    for i, m in grids[0].items():
        other = grids[1][i]
        assert m.auc() == other.auc() and m.logloss() == other.logloss()
    aucs = [m.auc() for m in g.get_grid("auc")]
    assert aucs == sorted(aucs, reverse=True)
    rdir = str(tmp_path / "checkpoints")
    hyper = {"max_depth": [2, 3]}
    kw = dict(x=X, y="y", training_frame=tf, ntrees=3, nbins=20, seed=3,
              distribution="bernoulli")
    first = h2o3_tpu_torch.H2OGridSearch(
        h2o3_tpu_torch.H2OGradientBoostingEstimator, hyper,
        grid_id="recov", recovery_dir=rdir).train(**kw)
    for key in first.model_ids:
        DKV.remove(key)
    again = h2o3_tpu_torch.H2OGridSearch(
        h2o3_tpu_torch.H2OGradientBoostingEstimator, hyper,
        grid_id="recov", recovery_dir=rdir)
    again._cls = None                  # a train would fail: none may run
    again.train(**kw)
    assert again.failures == [] and len(again) == 2
    assert sorted(again.model_ids) == sorted(first.model_ids)
    for a, b in zip(sorted(again.models, key=lambda m: m.key),
                    sorted(first.models, key=lambda m: m.key)):
        assert a is not b and a.auc() == b.auc()


def test_grid_stops_at_its_runtime_budget(frames):
    _, tf, _ = frames
    g = h2o3_tpu_torch.H2OGridSearch(
        h2o3_tpu_torch.H2OGradientBoostingEstimator,
        {"max_depth": [2, 3, 4]},
        search_criteria={"strategy": "Cartesian", "max_runtime_secs": 1e-9})
    g.train(x=X, y="y", training_frame=tf, ntrees=2, nbins=20)
    assert len(g) == 0 and g.failures == []


# ---------------------------------------------------------------------------
GLMS = (("H2OGeneralizedLinearEstimator", {"lambda_": 0.0}),
        ("H2OGeneralizedLinearEstimator", {"lambda_": 0.01, "alpha": 0.0}))


@pytest.fixture(scope="module")
def bases(frames):
    """Base models cross-validated on the same 2 Modulo folds with their
    holdout predictions kept, in both packages: two GLMs, unpenalised and
    ridge (a GBM's holdout predictions are held against the JAX
    package's in test_torch_cv.py, and a GBM's cross-validation is slow
    in the JAX package on the CPU)."""
    jf, tf, _ = frames
    cv = dict(nfolds=2, fold_assignment="Modulo", seed=11,
              keep_cross_validation_predictions=True)
    out = {}
    for y, specs in (
            ("y", GLMS), ("k", GLMS)):
        pairs = []
        for cls, params in specs:
            pair = []
            for pkg, fr in ((JMODELS, jf), (h2o3_tpu_torch, tf)):
                m = getattr(pkg, cls)(**dict(params, **cv))
                m.train(x=X, y=y, training_frame=fr)
                pair.append(m)
            pairs.append(pair)
        out[y] = pairs
    return out


@pytest.mark.parametrize("y", ["y", "k"])
def test_stacked_ensemble_matches_jax(frames, bases, y):
    """The level-one columns, the AUTO metalearner (GLM, lambda 0) and the
    predictions. With a 3-class response each base model gives three
    probability columns that sum to one, so beside the intercept the
    multinomial metalearner's design is singular in both packages and
    its coefficients are not identified: there the probabilities are
    held, within the 1e-3 that the JAX package's η allows on a singular
    design (as for GLM's one-hot design), and not the coefficients."""
    jf, tf, _ = frames
    pairs = bases[y]
    for jm, tm in pairs:
        jp = JDKV.get(jm._output.cv_predictions_key).to_numpy()
        tp = DKV.get(tm._output.cv_predictions_key).to_numpy()
        np.testing.assert_allclose(tp, jp, atol=1e-5)
    je = JSE(base_models=[jm for jm, _ in pairs])
    je.train(x=X, y=y, training_frame=jf)
    te = h2o3_tpu_torch.H2OStackedEnsembleEstimator(
        base_models=[tm.key for _, tm in pairs])
    te.train(x=X, y=y, training_frame=tf)
    assert te._meta.algo == je._meta.algo == "glm"
    jp, tp = je.predict(jf).to_numpy(), te.predict(tf).to_numpy()
    np.testing.assert_allclose(tp[:, 1:], jp[:, 1:],
                               atol=1e-4 if y == "y" else 1e-3)
    if y == "y":
        jb = np.asarray(je._meta._state.beta, np.float64)
        tb = np.asarray(te._meta._state.beta, np.float64)
        assert np.abs(tb - jb).max() < 1e-4 * np.abs(jb).max()
        assert (tb[:-1] >= 0).all()
    jperf, tperf = je.model_performance(jf), te.model_performance(tf)
    assert abs(tperf.logloss - jperf.logloss) < 1e-4
    assert abs(tperf.logloss - te.logloss()) < 1e-12
    assert te.summary()["base_models"] == [tm.key for _, tm in pairs]


def test_ensemble_needs_kept_predictions_and_takes_a_gbm_metalearner(
        frames, bases):
    _, tf, _ = frames
    m = h2o3_tpu_torch.H2OGradientBoostingEstimator(**GBM)
    m.train(x=X, y="y", training_frame=tf)
    with pytest.raises(ValueError, match="keep_cross_validation"):
        h2o3_tpu_torch.H2OStackedEnsembleEstimator(
            base_models=[m]).train(x=X, y="y", training_frame=tf)
    base = [tm for _, tm in bases["y"]]
    te = h2o3_tpu_torch.H2OStackedEnsembleEstimator(
        base_models=base, metalearner_algorithm="gbm",
        metalearner_params={"ntrees": 3, "max_depth": 2, "nbins": 20})
    te.train(x=X, y="y", training_frame=tf)
    assert te._meta.algo == "gbm" and te.auc() > 0.7
    with pytest.raises(NotImplementedError, match="metalearner_nfolds"):
        h2o3_tpu_torch.H2OStackedEnsembleEstimator(
            base_models=base, metalearner_nfolds=3).train(
                x=X, y="y", training_frame=tf)


# ---------------------------------------------------------------------------
def test_segments_match_jax(frames):
    """One GLM a region; the "west" segment has only constant predictors
    (every predictor is dropped as constant) and fails in both."""
    _, _, cols = frames
    cols = dict(cols)
    west = cols["region"] == "west"
    for c in ("a", "b", "c"):
        cols[c] = np.where(west, 1.0, cols[c])
    cols["color"] = np.where(west, "red", cols["color"])
    jf, tf = JFrame.from_dict(cols), Frame.from_dict(cols)
    params = {"lambda_": 0.0}
    js = jtrain_segments(JMODELS.H2OGeneralizedLinearEstimator, params,
                         "region", x=X, y="y", training_frame=jf)
    ts = h2o3_tpu_torch.train_segments(
        h2o3_tpu_torch.H2OGeneralizedLinearEstimator, params, "region", x=X,
        y="y", training_frame=tf)
    jl, tl = js.as_list(), ts.as_list()
    assert len(tl) == len(jl) == 3
    for j, t in zip(jl, tl):
        assert t["segment"] == j["segment"]
        assert t["status"] == j["status"]
        assert t.get("nrows") == j.get("nrows")
    assert [t["status"] for t in tl] == ["SUCCEEDED", "SUCCEEDED", "FAILED"]
    assert sum(t["nrows"] for t in tl[:2]) == N - int(west.sum())
    for j, t in zip(jl[:2], tl[:2]):
        jm, tm = JDKV.get(j["model"]), DKV.get(t["model"])
        assert abs(tm.auc() - jm.auc()) < 1e-5
