"""Cross-validation of the port against the JAX package, on the CPU.

One seeded frame goes to both packages; both cross-validate through their
estimators (`nfolds` or `fold_column`). Tolerances: fold ids equal (the
port draws them from the same numpy generator in the same order); on a
categorical with NAs, the holdout predictions of a GLM within 1e-5 and
its CV metrics within 1e-5 relative (the same f64 solves of f32 Grams
summed in another order); on one without NA, where the port's fold
models drop its first level (the reduced design) and the JAX package's
design is singular, each fold model's coefficients within 1e-4 of a
float64 numpy fit's, its holdout predictions within 1e-5 of that fit's,
and the JAX package's probabilities within 1e-3; the
CV metrics of a depth-4 binned GBM within 1e-5 relative (the same trees,
f32 sums in another order); the fold models' deadlines as the JAX
package's.
"""

import numpy as np
import pytest

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.kvstore import DKV

N = 1500
X = ["a", "b", "c", "color"]


def _cols(na):
    """The seeded frame's columns; with `na`, color gets an NA every 50th
    row after every draw (y unchanged), so that both packages' GLMs keep
    every level of it and fit one full-rank design."""
    rng = np.random.default_rng(4)
    a, b, c = rng.normal(size=(3, N))
    a[rng.random(N) < 0.04] = np.nan
    color = np.array(rng.choice(["red", "green", "blue"], N), object)
    logit = 1.2 * np.nan_to_num(a) - 0.8 * b + 0.7 * (color == "blue")
    y = rng.random(N) < 1 / (1 + np.exp(-logit))
    y[:5] = True                     # class sizes that do not divide by 3
    if na:
        color[::50] = None
    return {"a": a, "b": b, "c": c, "color": color,
            "g": 2 * np.nan_to_num(a) - b + rng.normal(0, 0.3, N),
            "fold": rng.integers(0, 4, N).astype(float),
            "y": np.array(["n", "p"], object)[y.astype(int)]}


def _pair(cols):
    return (JFrame.from_dict(cols),
            Frame(list(cols), [Vec.from_numpy(v) for v in cols.values()]))


@pytest.fixture(scope="module")
def frames():
    h2o3_tpu_torch.init(device="cpu")
    yield _pair(_cols(na=False))
    h2o3_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def frames_na(frames):
    return _pair(_cols(na=True))


def _both(frames, jcls, tcls, y, **params):
    jf, tf = frames
    jm = jcls(**params)
    jm.train(x=X, y=y, training_frame=jf)
    tm = tcls(**params)
    tm.train(x=X, y=y, training_frame=tf)
    return jm, tm


def _glms(frames, y="y", **params):
    return _both(frames, JMODELS.H2OGeneralizedLinearEstimator,
                 h2o3_tpu_torch.H2OGeneralizedLinearEstimator, y,
                 lambda_=0.0, **params)


@pytest.mark.parametrize("how", ["AUTO", "Random", "Modulo", "Stratified",
                                 "fold_column"])
def test_fold_ids_match_jax(frames, how):
    kw = ({"fold_column": "fold"} if how == "fold_column"
          else {"nfolds": 3, "fold_assignment": how, "seed": 42})
    jm, tm = _glms(frames, keep_cross_validation_fold_assignment=True, **kw)
    jfa = JDKV.get(jm._output.cv_fold_assignment_key).to_numpy()[:, 0]
    tfa = DKV.get(tm._output.cv_fold_assignment_key).to_numpy()[:, 0]
    np.testing.assert_array_equal(tfa, jfa)
    nf = 4 if how == "fold_column" else 3
    assert len(tm._cv_models) == len(jm._cv_models) == nf
    assert sorted(set(tfa.tolist())) == list(range(nf))
    if how == "Stratified":
        y = frames[1].vec("y").to_numpy()
        for cls in (0, 1):
            sizes = np.bincount(tfa[y == cls].astype(int), minlength=3)
            assert sizes.max() - sizes.min() <= 1


def _fold_design(cols, train):
    """The float64 reduced design of a fold model: color's green and red
    indicators (blue, the first level, dropped), a, b and c standardised
    by the fold's training rows' mean and sample sigma with NA as 0, and
    the intercept last."""
    nums = [(cols[c] - np.nanmean(cols[c][train]))
            / np.nanstd(cols[c][train], ddof=1) for c in ("a", "b", "c")]
    return np.column_stack(
        [cols["color"] == "green", cols["color"] == "red"]
        + [np.nan_to_num(v) for v in nums] + [np.ones(N)]).astype(np.float64)


def _numpy_fit(Z, y, binomial):
    """Float64 least squares, or IRLS for the logit link, to convergence."""
    if not binomial:
        return np.linalg.lstsq(Z, y, rcond=None)[0]
    beta = np.zeros(Z.shape[1])
    for _ in range(100):
        mu = 1 / (1 + np.exp(-Z @ beta))
        step = np.linalg.solve(Z.T @ ((mu * (1 - mu))[:, None] * Z),
                               Z.T @ (y - mu))
        beta += step
        if np.abs(step).max() < 1e-13:
            break
    return beta


def _hold_reduced_design(jm, tm, y):
    """Color has no NA: each fold model fits the reduced design, and its
    coefficients are a float64 numpy fit's on its training rows within
    1e-4 of the largest; the holdout predictions and the CV metrics are
    that fit's. The JAX package keeps every level of color beside its
    intercept, a singular design: its holdout probabilities agree within
    1e-3, and its CV metrics within 1e-3 relative."""
    cols = _cols(na=False)
    fa = DKV.get(tm._output.cv_fold_assignment_key).to_numpy()[:, 0]
    yv = (cols["y"] == "p").astype(np.float64) if y == "y" else cols["g"]
    want = np.zeros(N)
    for f, fm in enumerate(tm._cv_models):
        assert fm._dinfo.drop_first == ["color"]
        assert fm._dinfo.feature_names == ["color.green", "color.red", "a",
                                           "b", "c"]
        train = fa != f
        Z = _fold_design(cols, train)
        beta = _numpy_fit(Z[train], yv[train], y == "y")
        got = np.asarray(fm._state.beta, np.float64)
        assert np.abs(got - beta).max() < 1e-4 * np.abs(beta).max()
        eta = Z[~train] @ beta
        want[~train] = 1 / (1 + np.exp(-eta)) if y == "y" else eta
    tp = DKV.get(tm._output.cv_predictions_key).to_numpy()
    jp = JDKV.get(jm._output.cv_predictions_key).to_numpy()
    np.testing.assert_allclose(tp[:, -1], want, atol=1e-5)
    tcv = tm._output.cross_validation_metrics
    np.testing.assert_allclose(tcv.rmse, np.sqrt(np.mean((yv - want) ** 2)),
                               rtol=1e-5)
    if y == "y":
        np.testing.assert_allclose(tp, jp, atol=1e-3)
    jcv = jm._output.cross_validation_metrics
    for k in ("auc", "logloss", "rmse", "pr_auc") if y == "y" else ("rmse",):
        np.testing.assert_allclose(getattr(tcv, k), getattr(jcv, k),
                                   rtol=1e-3, err_msg=k)


_CV = dict(nfolds=3, seed=7, keep_cross_validation_predictions=True,
           keep_cross_validation_fold_assignment=True)


def test_glm_cv_metrics_and_kept_frames_match_jax(frames):
    """Color has no NA: the port's fold models fit the reduced design,
    held as in `_hold_reduced_design`."""
    jm, tm = _glms(frames, **_CV)
    tp = DKV.get(tm._output.cv_predictions_key).to_numpy()
    assert tp.shape == (N, 2)
    _hold_reduced_design(jm, tm, "y")
    # the holdout predictions are the fold models' own
    fa = np.asarray(tm._cv_models[0]._dinfo.predictors)
    assert list(fa) == X
    assert abs(tm._output.cross_validation_metrics.auc - tm.auc()) < 0.05
    # regression: one holdout column
    jm, tm = _glms(frames, y="g", **_CV)
    _hold_reduced_design(jm, tm, "g")
    assert DKV.get(tm._output.cv_predictions_key).names == ["C1"]


def test_glm_cv_full_rank_design_matches_jax(frames_na):
    """Color has NAs, so both packages fit every level of it: the CV
    metrics within 1e-5 relative, the holdout predictions within 1e-5."""
    jm, tm = _glms(frames_na, **_CV)
    assert tm._cv_models[0]._dinfo.drop_first == []
    jcv = jm._output.cross_validation_metrics
    tcv = tm._output.cross_validation_metrics
    for k in ("auc", "logloss", "rmse", "pr_auc"):
        np.testing.assert_allclose(getattr(tcv, k), getattr(jcv, k),
                                   rtol=1e-5, err_msg=k)
    jp = JDKV.get(jm._output.cv_predictions_key).to_numpy()
    tp = DKV.get(tm._output.cv_predictions_key).to_numpy()
    assert tp.shape == jp.shape == (N, 2)
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    jm, tm = _glms(frames_na, y="g", **_CV)
    np.testing.assert_allclose(tm._output.cross_validation_metrics.rmse,
                               jm._output.cross_validation_metrics.rmse,
                               rtol=1e-5)


def test_binned_gbm_cv_metrics_match_jax(frames):
    jm, tm = _both(frames, JMODELS.H2OGradientBoostingEstimator,
                   h2o3_tpu_torch.H2OGradientBoostingEstimator, "y",
                   ntrees=3, max_depth=4, nbins=20, learn_rate=0.2, seed=5,
                   distribution="bernoulli", nfolds=2,
                   fold_assignment="Modulo", radix_shallow=False,
                   fused_level=False)
    assert tm.summary()["engine"] == "binned_cuda"
    jcv = jm._output.cross_validation_metrics
    tcv = tm._output.cross_validation_metrics
    for k in ("auc", "logloss"):
        np.testing.assert_allclose(getattr(tcv, k), getattr(jcv, k),
                                   rtol=1e-5, err_msg=k)


def test_cv_temporary_frames_are_removed(frames):
    before = {k for k in DKV.keys() if k.startswith("frame")}
    h2o3_tpu_torch.H2OGeneralizedLinearEstimator(
        lambda_=0.0, nfolds=3, seed=3).train(x=X, y="y",
                                             training_frame=frames[1])
    after = {k for k in DKV.keys() if k.startswith("frame")}
    assert after == before


def test_fold_models_share_the_budget(frames):
    """Every fold model gets what remains of the job's deadline, at least
    one second, as in the JAX package; with the deadline already past the
    main model stops at its first chunk boundary (5 of 8 trees, the JAX
    estimator's count in test_torch_slice.py)."""
    jm, tm = _glms(frames, nfolds=3, seed=2, max_runtime_secs=1e-9)
    assert [m.params["max_runtime_secs"] for m in tm._cv_models] == \
        [m.params["max_runtime_secs"] for m in jm._cv_models] == [1.0] * 3
    kw = dict(ntrees=8, max_depth=3, nbins=20, seed=5, nfolds=2,
              score_tree_interval=5, distribution="bernoulli")
    gbm = h2o3_tpu_torch.H2OGradientBoostingEstimator
    tm = gbm(max_runtime_secs=1e-9, **kw).train(x=X, y="y",
                                                 training_frame=frames[1])
    assert [m.params["max_runtime_secs"] for m in tm._cv_models] == [1.0] * 2
    assert tm.summary()["number_of_trees"] == 5
    tm = gbm(max_runtime_secs=600.0, **kw).train(x=X, y="y",
                                                 training_frame=frames[1])
    budgets = [m.params["max_runtime_secs"] for m in tm._cv_models]
    assert 1.0 < budgets[1] <= budgets[0] < 600.0
    assert tm.summary()["number_of_trees"] == 8
