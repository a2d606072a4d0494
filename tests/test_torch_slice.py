"""The port's main path as a whole against the JAX package's, on the CPU:
a seeded CSV (numeric columns with NA values, one categorical column, a
two-level response) goes through import_file, a bernoulli GBM, predict and
AUC in both packages: the port through its estimator, the JAX package
through its binned chunk trainer under the estimator's setup rules. Also:
the validation series of the scoring history and early stopping against
the JAX package's, a JAX-trained GBM (f32 and int8 histograms) carried
across as arrays, the device rule of `init()`, and the rule that the port
imports nothing of JAX or the JAX package.

Tolerances: parsed values equal (both store f32); predictions within 1e-4
and AUC within 1e-3 (f32 sums in another order, through 3 trees); the
validation series within 1e-3 (AUC) and 1e-4 (logloss) of the JAX trees
scored on the same rows; early-stopping decisions equal; a model carried
across scores within 1e-5 (the same trees walked by both).
"""

import ast
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import metrics as JM
from h2o3_tpu.models.model import DataInfo as JaxDataInfo
from h2o3_tpu.models.tree import binned as JB
from h2o3_tpu.models.tree import engine as JE
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.models import metrics as TM

ROOT = pathlib.Path(__file__).resolve().parents[1]
NTREES, DEPTH, NBINS, LR, N = 3, 3, 20, 0.2, 1500
GBM = dict(ntrees=NTREES, max_depth=DEPTH, nbins=NBINS, learn_rate=LR,
           distribution="bernoulli", seed=7)
GBM_NO_TREES = {k: v for k, v in GBM.items() if k != "ntrees"}


def _write_csv(path, n=N, seed=21):
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, 3)), 4)
    X[rng.random((n, 3)) < 0.05] = np.nan
    color = rng.choice(["red", "green", "blue", "teal"], n)
    logit = (1.4 * np.nan_to_num(X[:, 0]) - 0.9 * np.nan_to_num(X[:, 1])
             + np.where(color == "blue", 1.0, 0.0))
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    with open(path, "w") as f:
        f.write("a,b,c,color,label\n")
        for i in range(n):
            nums = ["NA" if np.isnan(v) else repr(float(v)) for v in X[i]]
            f.write(",".join(nums + [color[i], "yes" if y[i] else "no"])
                    + "\n")
    return path


def _jax_reference(jfr, int8=False):
    """The JAX package's bernoulli GBM on `jfr` through its binned engine,
    at the chunk-trainer level: the estimator's setup rules (label-mode
    DataInfo, b_val = max(nbins, cardinality), f0 = logit of the mean,
    F = 0 on padding rows) with one unsharded jitted trainer, because
    compiling the estimator's 8-shard program costs most of this file's
    time budget. Scored with its engine and metrics."""
    di = JaxDataInfo(jfr, [c for c in jfr.names if c != "label"], "label",
                     cat_mode="label")
    n = jfr.nrows
    X = np.asarray(di.matrix(jfr))[:n]
    y = np.asarray(di.response(jfr))[:n]
    is_cat = np.array([c in di.cat_cols for c in di.predictors])
    b_val = max(NBINS, max(di.cardinalities.values()))
    spec = JB.make_bins(X, is_cat, b_val)
    grower = JB.BinnedGrower(spec, max_depth=DEPTH, min_rows=10.0,
                             min_split_improvement=1e-5, axis_name=None,
                             int8_stats=int8, use_radix_shallow=False,
                             fused_level=False)
    n_pad = grower.layout(n)
    f0 = float(np.log(y.mean() / (1 - y.mean())))
    F = np.where(np.arange(n_pad) < n, f0, 0.0).astype(np.float32)
    y1 = np.zeros(n_pad, np.float32)
    y1[:n] = y
    w1 = (np.arange(n_pad) < n).astype(np.float32)
    _, trees = JB.gbm_chunk_trainer(
        grower, n, dist="bernoulli", eta=LR, sample_rate=1.0, mtries=0,
        k_trees=NTREES)(JB.quantize(jnp.asarray(X), spec, n_pad=n_pad),
                        jnp.asarray(y1), jnp.asarray(w1), jnp.asarray(F),
                        jax.random.PRNGKey(0))
    col, bins, nal, words, val, _, cover = (np.asarray(t) for t in trees)
    thr = spec.edges[np.clip(col, 0, X.shape[1] - 1),
                     np.clip(bins, 0, spec.edges.shape[1] - 1)]
    ta = JE.TreeArrays(col=col, thr=thr, na_left=nal, value=val,
                       depth=DEPTH, cover=cover, catbits=words,
                       col_is_cat=np.pad(is_cat, (0, spec.c_pad - len(is_cat))))
    p1 = np.asarray(jax.nn.sigmoid(
        f0 + LR * JE.predict_ensemble(jnp.asarray(X), ta)))
    auc = JM.binomial_metrics(jnp.asarray(y), jnp.asarray(p1)).auc
    return dict(di=di, spec=spec, trees=ta, f0=f0, p1=p1, auc=auc)


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory, port_cpu):
    csv = str(_write_csv(tmp_path_factory.mktemp("slice") / "train.csv"))
    jfr = h2o3_tpu.import_file(csv)
    tfr = h2o3_tpu_torch.import_file(csv)
    tm = h2o3_tpu_torch.H2OGradientBoostingEstimator(**GBM)
    tm.train(y="label", training_frame=tfr)
    return dict(jfr=jfr, tfr=tfr, tm=tm, ref=_jax_reference(jfr))


def test_import_file_matches_jax(slice_run):
    jfr, tfr = slice_run["jfr"], slice_run["tfr"]
    assert tfr.names == jfr.names
    assert tfr.types == jfr.types
    for c in tfr.names:
        assert tfr.vec(c).levels() == jfr.vec(c).levels(), c
    np.testing.assert_array_equal(tfr.to_numpy(), jfr.to_numpy())
    assert tfr.matrix().device.type == "cpu"
    r, rj = tfr.vec("a").rollups(), jfr.vec("a").rollups()
    assert r.nas == rj.nas and r.nas > 0
    np.testing.assert_allclose([r.mean, r.sigma, r.min, r.max],
                               [rj.mean, rj.sigma, rj.min, rj.max],
                               rtol=1e-5)


def test_gbm_predict_and_auc_match_jax(slice_run):
    tm, ref = slice_run["tm"], slice_run["ref"]
    tp = tm.predict(slice_run["tfr"]).to_numpy()
    assert tp.shape == (N, 3)
    np.testing.assert_allclose(tp[:, 2], ref["p1"], atol=1e-4)
    assert abs(tm.auc() - ref["auc"]) < 1e-3
    assert tm.auc() > 0.75
    np.testing.assert_array_equal(tm._trees.col.numpy(), ref["trees"].col)
    np.testing.assert_array_equal(tm._bin_spec.edges, ref["spec"].edges)
    assert abs(tm._f0 - ref["f0"]) < 1e-6
    hist = tm.scoring_history()
    assert hist[-1]["number_of_trees"] == NTREES
    assert abs(hist[-1]["training_auc"] - ref["auc"]) < 1e-3


def test_jax_gbm_carried_across_scores_the_same(slice_run):
    ref = slice_run["ref"]
    ta, di, spec = ref["trees"], ref["di"], ref["spec"]
    model = convert.gbm_from_arrays(
        col=ta.col, thr=ta.thr, na_left=ta.na_left, value=ta.value,
        cover=ta.cover, catbits=ta.catbits, col_is_cat=ta.col_is_cat,
        depth=ta.depth, f0=ref["f0"], distribution="bernoulli",
        learn_rate=LR, predictors=di.predictors, domains=di.domains,
        response_name=di.response_name, response_domain=di.response_domain,
        edges=spec.edges, is_cat=spec.is_cat, b_val=spec.b_val,
        n_bins=spec.n_bins, c_pad=spec.c_pad)
    tp = model.predict(slice_run["tfr"]).to_numpy()
    np.testing.assert_allclose(tp[:, 2], ref["p1"], atol=1e-5)
    np.testing.assert_array_equal(tp[:, 0], (tp[:, 2] > tp[:, 1]))
    assert model._bin_spec.b_val == spec.b_val


def test_jax_int8_gbm_carried_across_scores_the_same(slice_run):
    """A JAX GBM trained with int8_stats=True carried across scores the
    same; the port's own int8_hist=True model grows the same trees."""
    ref = _jax_reference(slice_run["jfr"], int8=True)
    ta, di, spec = ref["trees"], ref["di"], ref["spec"]
    model = convert.gbm_from_arrays(
        col=ta.col, thr=ta.thr, na_left=ta.na_left, value=ta.value,
        cover=ta.cover, catbits=ta.catbits, col_is_cat=ta.col_is_cat,
        depth=ta.depth, f0=ref["f0"], distribution="bernoulli",
        learn_rate=LR, predictors=di.predictors, domains=di.domains,
        response_name=di.response_name, response_domain=di.response_domain,
        edges=spec.edges, is_cat=spec.is_cat, b_val=spec.b_val,
        n_bins=spec.n_bins, c_pad=spec.c_pad)
    tp = model.predict(slice_run["tfr"]).to_numpy()
    np.testing.assert_allclose(tp[:, 2], ref["p1"], atol=1e-5)
    tm = h2o3_tpu_torch.H2OGradientBoostingEstimator(**GBM, int8_hist=True)
    tm.train(y="label", training_frame=slice_run["tfr"])
    np.testing.assert_array_equal(tm._trees.col.numpy(), ta.col)
    np.testing.assert_allclose(tm.predict(slice_run["tfr"]).to_numpy()[:, 2],
                               ref["p1"], atol=1e-4)
    assert abs(tm.auc() - ref["auc"]) < 1e-3


def test_validation_series_matches_jax(slice_run, tmp_path):
    """The port's validation_* entries, one per tree, against the JAX
    chunk trainer's trees scored on the validation rows."""
    csv = str(_write_csv(tmp_path / "valid.csv", n=700, seed=31))
    jvf = h2o3_tpu.import_file(csv)
    tvf = h2o3_tpu_torch.import_file(csv)
    tm = h2o3_tpu_torch.H2OGradientBoostingEstimator(
        **GBM, score_tree_interval=1)
    tm.train(y="label", training_frame=slice_run["tfr"],
             validation_frame=tvf)
    hist = tm.scoring_history()
    assert [h["number_of_trees"] for h in hist] == [1, 2, 3]
    ref = slice_run["ref"]
    ta, di = ref["trees"], ref["di"]
    Xv = jnp.asarray(np.asarray(di.matrix(jvf))[:jvf.nrows])
    yv = jnp.asarray(np.asarray(di.response(jvf))[:jvf.nrows])
    for t, h in enumerate(hist, start=1):
        part = JE.TreeArrays(col=ta.col[:t], thr=ta.thr[:t],
                             na_left=ta.na_left[:t], value=ta.value[:t],
                             depth=ta.depth, cover=ta.cover[:t],
                             catbits=ta.catbits[:t], col_is_cat=ta.col_is_cat)
        p1 = jax.nn.sigmoid(ref["f0"] + LR * JE.predict_ensemble(Xv, part))
        m = JM.binomial_metrics(yv, p1)
        assert abs(h["validation_auc"] - m.auc) < 1e-3, t
        assert abs(h["validation_logloss"] - m.logloss) < 1e-4, t
        assert abs(h["validation_pr_auc"] - m.pr_auc) < 1e-3, t
        assert abs(h["validation_rmse"] - m.rmse) < 1e-4, t
    # the last entry is the final model's validation metrics
    assert abs(hist[-1]["validation_auc"] - tm.auc(valid=True)) < 1e-6
    assert tm._vstate is None and tm._valid_for_scoring is None


def _histories(rng):
    """Seeded scoring histories: a classifier's with a validation series
    that improves then plateaus, and a regressor's training series."""
    n = 10
    trend = np.concatenate([np.linspace(0.69, 0.5, 6), np.full(4, 0.5)])
    cls = []
    for i in range(n):
        ll = float(trend[i] + rng.normal(0, 2e-4))
        cls.append({"number_of_trees": 5 * (i + 1),
                    "training_logloss": ll - 0.02,
                    "training_auc": 1.3 - ll, "training_pr_auc": 1.2 - ll,
                    "training_rmse": ll / 1.5,
                    "validation_logloss": ll, "validation_auc": 1.25 - ll,
                    "validation_pr_auc": 1.15 - ll,
                    "validation_rmse": ll / 1.4})
    plateau = [dict(h, validation_logloss=0.5, validation_auc=0.8)
               for h in cls]
    reg = [{"number_of_trees": 5 * (i + 1),
            "training_rmse": float(1.0 / (i + 1) + rng.normal(0, 1e-3)),
            "training_mae": float(0.8 / (i + 1)),
            "training_r2": float(-0.5 + 0.1 * min(i, 6))} for i in range(n)]
    return {"cls": cls, "plateau": plateau, "reg": reg}


@pytest.mark.parametrize("kind,metric,rounds,tol", [
    ("cls", "AUTO", 2, 1e-3),
    ("cls", "auc", 2, 1e-3),
    ("cls", "logloss", 3, 1e-3),
    ("cls", "AUCPR", 2, 1e-2),
    ("plateau", "logloss", 2, 0.0),
    ("plateau", "auc", 3, 0.0),
    ("cls", "mae", 2, 1e-3),
    ("cls", "classification_error", 2, 1e-3),
    ("reg", "auc", 2, 1e-3),
    ("reg", "AUTO", 2, 1e-3),
    ("reg", "r2", 2, 0.0),
    ("reg", "mae", 3, None),
])
def test_early_stopping_matches_jax(kind, metric, rounds, tol):
    """_validate_early_stopping and _should_stop of both packages on the
    same scoring histories, after every scoring event: the same decision,
    or the same error (a metric not recorded for the problem type, a
    classification metric on a numeric response)."""
    from h2o3_tpu.models.tree.shared_tree import \
        H2OGradientBoostingEstimator as JaxGBM
    hist = _histories(np.random.default_rng(25))[kind]
    domain = None if kind == "reg" else ["no", "yes"]
    params = dict(stopping_rounds=rounds, stopping_metric=metric,
                  stopping_tolerance=tol)

    def outcome(cls, n):
        m = cls(**params)
        m._dinfo = SimpleNamespace(response_domain=domain)
        m._output = SimpleNamespace(scoring_history=hist[:n])
        try:
            m._validate_early_stopping()
            return m._should_stop()
        except ValueError as e:
            return ("ValueError", str(e))

    got = [outcome(h2o3_tpu_torch.H2OGradientBoostingEstimator, n)
           for n in range(1, len(hist) + 1)]
    want = [outcome(JaxGBM, n) for n in range(1, len(hist) + 1)]
    assert got == want
    assert not any(g is True for g in got[: 2 * rounds - 1])
    if metric == "classification_error":      # known, but never recorded
        assert "not recorded" in got[-1][1]


def test_early_stopping_stops_training(port_cpu, slice_run):
    """stopping_rounds ends the chunk loop: a model that cannot improve
    (min_split_improvement too high to split, so every tree is a stump)
    stops after 2 * stopping_rounds scoring events."""
    m = h2o3_tpu_torch.H2OGradientBoostingEstimator(
        ntrees=40, max_depth=3, nbins=NBINS, learn_rate=0.2,
        score_tree_interval=2, stopping_rounds=2, stopping_tolerance=0.0,
        stopping_metric="auc", min_split_improvement=1e9, seed=7)
    m.train(y="label", training_frame=slice_run["tfr"])
    assert len(m.scoring_history()) == 4
    assert m.summary()["number_of_trees"] == 8
    bad = h2o3_tpu_torch.H2OGradientBoostingEstimator(
        **GBM, stopping_rounds=2, stopping_metric="r2")
    with pytest.raises(ValueError, match="regression metric"):
        bad.train(y="label", training_frame=slice_run["tfr"])


QUASI = dict(max_depth=DEPTH, nbins=NBINS, learn_rate=LR, seed=7,
             distribution="quasibinomial", score_tree_interval=5)


def _jax_estimator(jfr, **params):
    """The JAX package's own GBM estimator on `jfr` (its f0 rule, chunk
    loop and job deadline), as a user would call it."""
    from h2o3_tpu.models.tree.shared_tree import \
        H2OGradientBoostingEstimator as JaxGBM
    m = JaxGBM(**params)
    m.train(y="label", training_frame=jfr)
    return m


def test_quasibinomial_gbm_matches_jax(slice_run):
    """quasibinomial starts from the weighted mean of the response, not
    its logit (only bernoulli takes the logit), and links through the
    sigmoid: f0 within 1e-6, training logloss within 1e-4 and class-1
    probabilities within 1e-4 of the JAX estimator's (f32 sums in another
    order, through 5 trees)."""
    jm = _jax_estimator(slice_run["jfr"], ntrees=5, **QUASI)
    tm = h2o3_tpu_torch.H2OGradientBoostingEstimator(ntrees=5, **QUASI)
    tm.train(y="label", training_frame=slice_run["tfr"])
    assert tm.summary()["distribution"] == "quasibinomial"
    assert abs(tm._f0 - jm._f0) < 1e-6
    assert 0.0 < tm._f0 < 1.0                      # the mean, not a logit
    assert abs(tm.logloss() - jm.logloss()) < 1e-4
    assert abs(tm.scoring_history()[-1]["training_logloss"]
               - jm.scoring_history()[-1]["training_logloss"]) < 1e-4
    tp = tm.predict(slice_run["tfr"]).to_numpy()
    jp = jm.predict(slice_run["jfr"]).to_numpy()
    np.testing.assert_allclose(tp[:, 2], jp[:, 2], atol=1e-4)


def test_max_runtime_secs_stops_at_the_chunk_boundary(slice_run):
    """max_runtime_secs sets a deadline when train() starts; the chunk
    loop tests it after each chunk's history entry and stops there. With
    a deadline already past, 8 trees at score_tree_interval 5 build the
    first chunk only: 5 trees, as the JAX estimator builds."""
    kw = dict(ntrees=8, max_runtime_secs=1e-9, score_tree_interval=5,
              **GBM_NO_TREES)
    jm = _jax_estimator(slice_run["jfr"], **kw)
    tm = h2o3_tpu_torch.H2OGradientBoostingEstimator(**kw)
    tm.train(y="label", training_frame=slice_run["tfr"])
    want = int(jm.summary()["number_of_trees"])
    assert want == 5
    assert tm.summary()["number_of_trees"] == want
    assert [h["number_of_trees"] for h in tm.scoring_history()] == [5]
    # no deadline: all 8 trees
    full = h2o3_tpu_torch.H2OGradientBoostingEstimator(
        **dict(kw, max_runtime_secs=0.0))
    full.train(y="label", training_frame=slice_run["tfr"])
    assert full.summary()["number_of_trees"] == 8


def test_metrics_match_jax():
    rng = np.random.default_rng(22)
    y = (rng.random(3000) < 0.4).astype(np.float32)
    y[:20] = np.nan                              # missing responses
    p = np.clip(0.4 + 0.3 * (y - 0.4) + rng.normal(0, 0.2, 3000), 0, 1) \
        .astype(np.float32)
    w = rng.uniform(0.5, 2.0, 3000).astype(np.float32)
    ref = JM.binomial_metrics(jnp.asarray(y), jnp.asarray(p), jnp.asarray(w))
    got = TM.binomial_metrics(torch.from_numpy(y), torch.from_numpy(p),
                              torch.from_numpy(w))
    for k in ("auc", "pr_auc", "logloss", "rmse", "f1", "max_f1_threshold",
              "mean_per_class_error", "nobs"):
        np.testing.assert_allclose(getattr(got, k), getattr(ref, k),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.confusion_matrix, ref.confusion_matrix,
                               rtol=1e-5)
    yr = rng.gamma(2.0, 1.0, 3000).astype(np.float32)
    pr = (yr + rng.normal(0, 0.5, 3000)).astype(np.float32)
    ref = JM.regression_metrics(jnp.asarray(yr), jnp.asarray(pr))
    got = TM.regression_metrics(torch.from_numpy(yr), torch.from_numpy(pr))
    for k in ("mse", "rmse", "mae", "r2", "nobs"):
        np.testing.assert_allclose(getattr(got, k), getattr(ref, k),
                                   rtol=1e-5, err_msg=k)
    assert np.isnan(got.rmsle) and np.isnan(ref.rmsle)   # negative preds


def test_gaussian_gbm_trains(port_cpu):
    rng = np.random.default_rng(23)
    X = rng.normal(size=(2000, 3))
    y = 2.0 * X[:, 0] - X[:, 1] ** 2 + rng.normal(0, 0.1, 2000)
    fr = h2o3_tpu_torch.Frame.from_numpy(np.column_stack([X, y]),
                                         names=["a", "b", "c", "y"])
    m = h2o3_tpu_torch.H2OGradientBoostingEstimator(
        ntrees=10, max_depth=3, learn_rate=0.3, score_tree_interval=5)
    m.train(y="y", training_frame=fr)
    assert m.summary()["distribution"] == "gaussian"
    hist = [h["training_rmse"] for h in m.scoring_history()]
    assert len(hist) == 2 and hist[1] < hist[0] < float(np.std(y))
    pred = m.predict(fr).to_numpy()[:, 0]
    assert abs(np.sqrt(np.mean((pred - y) ** 2)) - m.rmse()) < 1e-4
    assert m.varimp()[0]["variable"] in ("a", "b")


def test_sampling_and_monotone_options(port_cpu):
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    rng = np.random.default_rng(24)
    X = rng.normal(size=(3000, 3))
    y = (rng.random(3000) < 1 / (1 + np.exp(-(2 * X[:, 0] - X[:, 1]))))
    fr = Frame(["a", "b", "c", "y"],
               [Vec.from_numpy(X[:, j]) for j in range(3)]
               + [Vec.from_numpy(y.astype(float), type=T_CAT,
                                 domain=["0", "1"])])
    kw = dict(ntrees=4, max_depth=3, sample_rate=0.7, col_sample_rate=0.7,
              col_sample_rate_per_tree=0.8, monotone_constraints={"a": 1},
              balance_classes=True)

    def fit(seed):
        m = h2o3_tpu_torch.H2OGradientBoostingEstimator(seed=seed, **kw)
        return m.train(y="y", training_frame=fr)

    m1, m2, m3 = fit(3), fit(3), fit(4)
    p1, p2, p3 = (m.predict(fr).to_numpy()[:, 2] for m in (m1, m2, m3))
    np.testing.assert_array_equal(p1, p2)      # one seed, one model
    assert not np.array_equal(p1, p3)          # the seed drives the draws
    assert m1.auc() > 0.75
    # monotone in a: sweep a with b and c held
    grid = np.linspace(-3, 3, 50)
    sweep = Frame(["a", "b", "c"],
                  [Vec.from_numpy(grid), Vec.from_numpy(np.full(50, 0.3)),
                   Vec.from_numpy(np.full(50, -0.2))])
    ps = m1.predict(sweep).to_numpy()[:, 2]
    assert (np.diff(ps) >= -1e-7).all() and ps[-1] > ps[0]
    # balance_classes: both classes carry the same total weight
    _, yz, w = m1._prep(fr)
    assert abs(w[yz == 1].sum().item() - w[yz == 0].sum().item()) < 1e-2


def test_unported_options_raise(port_cpu, slice_run):
    """What the JAX package accepts and ignores although it would change
    the result raises rather than being ignored: an offset column (no JAX
    model reads it), `export_checkpoints_dir` (it writes nothing),
    `calibrate_model` (it never calibrates) and a DRF checkpoint restart
    (the JAX package's DRF has none). Cross-validation and a custom
    distribution are ported: tests/test_torch_cv.py, test_torch_udf.py."""
    tm = slice_run["tm"]
    gbm = h2o3_tpu_torch.H2OGradientBoostingEstimator
    drf = h2o3_tpu_torch.H2ORandomForestEstimator
    cases = [(gbm, {**GBM, "offset_column": "a"}, "label"),
             (gbm, {**GBM, "export_checkpoints_dir": "ckpt"}, "label"),
             (gbm, {**GBM, "calibrate_model": True}, "label"),
             (drf, {"ntrees": 2, "max_depth": 4, "checkpoint": tm}, "label")]
    for cls, params, y in cases:
        m = cls(**params)
        with pytest.raises(NotImplementedError,
                           match="not ported yet|not supported"):
            m.train(y=y, training_frame=slice_run["tfr"])
    # a placement hint, meaningless on one card: taken
    gbm(**GBM, build_tree_one_node=True).train(
        y="label", training_frame=slice_run["tfr"])


def test_init_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        h2o3_tpu_torch.init()
    c = h2o3_tpu_torch.init(device="cpu")
    assert c.device == torch.device("cpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    pkg = ROOT / "h2o3_tpu_torch"
    # ops/build/ holds what the kernels' build writes, not the package
    files = sorted(f for f in pkg.rglob("*.py")
                   if "build" not in f.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    assert {pkg / "core" / "jobs.py", pkg / "udf.py",
            pkg / "models" / "glm.py"} <= set(files)
    assert {pkg / "models" / f"{m}.py" for m in (
        "deeplearning", "kmeans", "pca", "svd", "glrm", "grid", "ensemble",
        "segments", "naive_bayes", "quantile", "coxph", "psvm",
        "_lbfgs", "target_encoder", "gam", "extended_isofor", "aggregator",
        "rulefit", "infogram", "word2vec")} <= set(files)
    assert {pkg / "io" / f"{m}.py" for m in (
        "parser", "fastcsv", "dparse", "uri", "xlsx", "columnar",
        "persist", "spill")} <= set(files)
    assert {pkg / "genmodel" / "mojo.py",
            pkg / "utils" / "env.py"} <= set(files)
    assert {pkg / "genmodel" / "h2o_mojo.py", pkg / "genmodel" / "pojo.py",
            pkg / "models" / "generic.py", pkg / "explain_data.py",
            pkg / "explain_plots.py", pkg / "automl" / "automl.py",
            pkg / "automl" / "__init__.py"} <= set(files)
    assert {pkg / "ops" / "device_sort.py", pkg / "rapids" / "rapids.py",
            pkg / "rapids" / "prims_ext.py"} | {
        pkg / "utils" / f"{m}.py" for m in (
            "config", "tools", "stats", "create_frame")} <= set(files)
    assert {pkg / "analysis" / "lockdep.py", pkg / "utils" / "log.py",
            pkg / "utils" / "timeline.py"} | {
        pkg / "obs" / f"{m}.py" for m in (
            "__init__", "metrics", "tracing", "timeline", "segments",
            "recorder")} | {
        pkg / "serving" / f"{m}.py" for m in (
            "__init__", "params", "scorer_cache", "qos",
            "microbatch")} <= set(files)
    assert {pkg / "obs" / f"{m}.py" for m in (
        "usage", "modelmon", "slo", "watchdog")} | {
        pkg / "deploy" / f"{m}.py" for m in (
            "__init__", "chaos", "membership")} <= set(files)
    assert {pkg / "api" / f"{m}.py" for m in (
        "__init__", "server", "routes_ext", "routes_ext2", "routes_ext3",
        "routes_ext4", "flow")} | {
        pkg / "analysis" / f"{m}.py" for m in (
            "divergence", "leaktrack", "sanitizers")} | {
        pkg / "utils" / "auth.py", pkg / "obs" / "profiler.py",
        pkg / "models" / "param_docs.py", pkg / "ext.py",
        pkg / "__main__.py"} <= set(files)
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "h2o3_tpu"), \
                (f, mod)
