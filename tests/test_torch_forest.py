"""Multinomial GBM, binned checkpoint restart and binned DRF of the port
against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go to both packages: the port on
`init(device="cpu")` (every kernel wrapper runs its plain version), the
JAX package through its own estimators or its binned grower. Tolerances:
metrics of the same (y, probs, w) within 1e-6; f0 within 1e-6; trees
equal column for column and threshold for threshold (one bin spec, so one
threshold is one bin); leaf values, probabilities, predictions, OOB sums
and the scoring history within 1e-5 (f32 sums in another order, through
a few shallow trees); the in-bag share of a 100,000-row draw within 0.01
of the sample rate (about six standard deviations of a Bernoulli mean).
"""

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.models import metrics as JM
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
from h2o3_tpu_torch.models import metrics as TM
from h2o3_tpu_torch.models.tree import binned as BN

TOL = 1e-5


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _frames(kind, n=900, seed=2):
    """One seeded frame in both packages: four N(0,1) columns and a
    response, three classes (the frame of the JAX package's binned
    multinomial test), two, or numeric."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 4))
    names = [f"x{j}" for j in range(4)]
    if kind == "multinomial":
        yc = (X[:, 0] > 0.5).astype(int) + (X[:, 1] > 0).astype(int)
        dom = ["a", "b", "c"]
    elif kind == "binomial":
        yc = (X[:, 0] - X[:, 1] + rng.normal(0, 0.5, n) > 0).astype(int)
        dom = ["n", "p"]
    else:
        y = X[:, 0] * 2 + np.sin(X[:, 1] * 3) + rng.normal(0, 0.1, n)
        jf = JFrame.from_dict({**{c: X[:, j] for j, c in enumerate(names)},
                               "y": y})
        tf = Frame(names + ["y"], [Vec.from_numpy(X[:, j]) for j in range(4)]
                   + [Vec.from_numpy(y)])
        return jf, tf
    jf = JFrame.from_dict({**{c: X[:, j] for j, c in enumerate(names)},
                           "y": np.array(dom, object)[yc]})
    tf = Frame(names + ["y"], [Vec.from_numpy(X[:, j]) for j in range(4)]
               + [Vec.from_numpy(yc.astype(float), type=T_CAT, domain=dom)])
    assert jf.vec("y").levels() == dom
    return jf, tf


def _np(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


def _same_trees(tt, jt):
    """One ensemble of each package: the same splits, values within TOL."""
    np.testing.assert_array_equal(_np(tt.col), _np(jt.col))
    np.testing.assert_array_equal(_np(tt.thr), _np(jt.thr))
    np.testing.assert_array_equal(_np(tt.na_left), _np(jt.na_left))
    np.testing.assert_allclose(_np(tt.value), _np(jt.value), atol=TOL)


def _same_history(th, jh):
    assert [h["number_of_trees"] for h in th] == \
        [h["number_of_trees"] for h in jh]
    for a, b in zip(th, jh):
        assert sorted(a) == sorted(b)
        for k in a:
            assert abs(a[k] - b[k]) < TOL, (k, a[k], b[k])


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K", [3, 7, 12])
def test_multinomial_metrics_match_jax(K):
    """Every field of the multinomial metrics on the same (y, probs, w),
    missing responses and top-k hit ratios up to min(10, K) included."""
    rng = np.random.default_rng(40 + K)
    n = 2000
    y = rng.integers(0, K, n).astype(np.float32)
    y[:15] = np.nan
    logits = rng.normal(0, 1.5, (n, K)) + 2.0 * np.eye(K)[
        np.nan_to_num(y).astype(int)]
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    probs = probs.astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ref = JM.multinomial_metrics(*(map(np.asarray, (y, probs, w))),
                                 domain=[str(k) for k in range(K)])
    got = TM.multinomial_metrics(*(torch.from_numpy(a)
                                   for a in (y, probs, w)),
                                 domain=[str(k) for k in range(K)])
    for k in ("logloss", "mse", "rmse", "mean_per_class_error", "error",
              "nobs"):
        assert abs(getattr(got, k) - getattr(ref, k)) < 1e-6, k
    assert len(got.hit_ratios) == min(10, K)
    np.testing.assert_allclose(got.hit_ratios, ref.hit_ratios, atol=1e-6)
    np.testing.assert_allclose(got.confusion_matrix, ref.confusion_matrix,
                               rtol=1e-6)
    assert got.to_dict().keys() == ref.to_dict().keys()
    assert got.domain == ref.domain


MULTI = dict(ntrees=6, max_depth=3, min_rows=2, seed=1)


def _both(kind, jax_cls, port_cls, frames=None, **params):
    """Train one configuration in both packages on the frames of `kind`."""
    jf, tf = frames or _frames(kind)
    jm = jax_cls(**params)
    jm.train(y="y", training_frame=jf)
    tm = port_cls(**params)
    tm.train(y="y", training_frame=tf)
    return jf, tf, jm, tm


@pytest.fixture(scope="module")
def multi_run(port_cpu):
    return _both("multinomial", JMODELS.H2OGradientBoostingEstimator,
                 h2o3_tpu_torch.H2OGradientBoostingEstimator, **MULTI)


@pytest.mark.parametrize("int8", [False, True])
def test_multinomial_gbm_matches_jax(multi_run, int8):
    """A 3-class GBM through both estimators (distribution AUTO, 6
    iterations at score_tree_interval 5): f0 within 1e-6, every class's
    trees equal split for split with values within 1e-5, probabilities and
    the scoring history within 1e-5; with int8_hist=True as well."""
    if int8:
        jf, tf, jm, tm = _both(
            "multinomial", JMODELS.H2OGradientBoostingEstimator,
            h2o3_tpu_torch.H2OGradientBoostingEstimator,
            frames=multi_run[:2], int8_hist=True, **MULTI)
    else:
        jf, tf, jm, tm = multi_run
    assert tm.summary()["distribution"] == "multinomial"
    assert tm.summary()["number_of_trees"] == 18
    np.testing.assert_allclose(tm._f0, np.asarray(jm._f0), atol=1e-6)
    assert len(tm._trees_k) == len(jm._trees_k) == 3
    for tt, jt in zip(tm._trees_k, jm._trees_k):
        _same_trees(tt, jt)
    tp = tm.predict(tf).to_numpy()
    jp = jm.predict(jf).to_numpy()
    np.testing.assert_allclose(tp[:, 1:], jp[:, 1:], atol=TOL)
    np.testing.assert_allclose(tp[:, 1:].sum(1), 1.0, atol=1e-6)
    _same_history(tm.scoring_history(), jm.scoring_history())
    for k in ("logloss", "error", "mean_per_class_error", "rmse"):
        assert abs(getattr(tm._output.training_metrics, k)
                   - getattr(jm._output.training_metrics, k)) < TOL, k
    assert tm.scoring_history()[-1]["training_logloss"] == \
        pytest.approx(tm.logloss(), abs=TOL)


def test_jax_multinomial_gbm_carried_across_scores_the_same(multi_run):
    """The JAX multinomial GBM's K per-class ensembles and f0 vector,
    carried across as numpy arrays, score the frame within 1e-5."""
    jf, tf, jm, _ = multi_run
    model = _carried(jm, "multinomial")
    assert model.summary()["engine"] == "binned_pallas"
    assert model.summary()["number_of_trees"] == 18
    np.testing.assert_allclose(model.predict(tf).to_numpy()[:, 1:],
                               jm.predict(jf).to_numpy()[:, 1:], atol=TOL)


def _carried(jm, dist):
    """A JAX GBM carried across by convert.py as numpy arrays."""
    tk = jm._trees_k if dist == "multinomial" else jm._trees
    arrays = {k: ([_np(getattr(t, a)) for t in tk] if dist == "multinomial"
                  else _np(getattr(tk, a)))
              for k, a in (("col", "col"), ("thr", "thr"),
                           ("na_left", "na_left"), ("value", "value"),
                           ("cover", "cover"))}
    depth = (tk[0] if dist == "multinomial" else tk).depth
    return convert.gbm_from_arrays(
        **arrays, depth=depth, f0=np.asarray(jm._f0), distribution=dist,
        learn_rate=jm.params["learn_rate"], predictors=jm._dinfo.predictors,
        domains=jm._dinfo.domains, response_name="y",
        response_domain=jm._dinfo.response_domain,
        engine=jm._output.model_summary["engine"])


# ---------------------------------------------------------------------------
CKPT = dict(max_depth=3, min_rows=2, seed=1, score_tree_interval=5)


@pytest.mark.parametrize("kind,dist", [("regression", "gaussian"),
                                       ("binomial", "bernoulli"),
                                       ("multinomial", "multinomial")])
def test_checkpoint_restart_matches_jax(port_cpu, kind, dist):
    """5 trees, then a restart to 10 from them (by DKV key in the port, as
    the model itself in the JAX package) in both packages: predictions
    within 1e-5, the restart's scoring history (its validation series for
    the single-output distributions; the JAX package records none for
    multinomial) within 1e-5; a restart with ntrees not above the prior's
    raises ValueError and one at another max_depth the depth assertion,
    in both. The JAX prior carried across by convert.py restarts the same
    way in the port."""
    jf, tf = _frames(kind)
    valid = _frames(kind, n=400, seed=5)
    Jgbm = JMODELS.H2OGradientBoostingEstimator
    Tgbm = h2o3_tpu_torch.H2OGradientBoostingEstimator
    kw = dict(CKPT, distribution=dist)
    _, _, j1, t1 = _both(kind, Jgbm, Tgbm, frames=(jf, tf), ntrees=5,
                         model_id=f"ck_{dist}", **kw)
    j2 = Jgbm(ntrees=10, checkpoint=j1, **kw)
    j2.train(y="y", training_frame=jf, validation_frame=valid[0])
    t2 = Tgbm(ntrees=10, checkpoint=f"ck_{dist}", **kw)
    t2.train(y="y", training_frame=tf, validation_frame=valid[1])
    assert t2.summary()["number_of_trees"] == \
        j2._output.model_summary["number_of_trees"]
    np.testing.assert_allclose(t2.predict(tf).to_numpy(),
                               j2.predict(jf).to_numpy(), atol=TOL)
    np.testing.assert_allclose(t2.predict(valid[1]).to_numpy(),
                               j2.predict(valid[0]).to_numpy(), atol=TOL)
    th, jh = t2.scoring_history(), j2.scoring_history()
    _same_history(th, jh)
    assert [h["number_of_trees"] for h in th] == [10]
    assert ("validation_rmse" in th[-1]) == (dist != "multinomial")
    if dist != "multinomial":
        # the restart's validation margins include the prior's 5 trees
        assert th[-1]["validation_rmse"] == pytest.approx(
            t2.rmse(valid=True), abs=TOL)
    # the JAX prior carried across by convert.py is a binned prior too
    t3 = Tgbm(ntrees=10, checkpoint=_carried(j1, dist), **kw)
    t3.train(y="y", training_frame=tf)
    np.testing.assert_allclose(t3.predict(tf).to_numpy(),
                               j2.predict(jf).to_numpy(), atol=TOL)
    for model_cls, prior in ((Jgbm, j1), (Tgbm, t1)):
        with pytest.raises(ValueError, match="must exceed"):
            model_cls(ntrees=5, checkpoint=prior, **kw).train(
                y="y", training_frame=jf if model_cls is Jgbm else tf)
        with pytest.raises(AssertionError, match="identical max_depth"):
            model_cls(ntrees=10, checkpoint=prior,
                      **dict(kw, max_depth=4)).train(
                y="y", training_frame=jf if model_cls is Jgbm else tf)
    h2o3_tpu.remove(j1.key)


@pytest.mark.parametrize("kind,dist", [("regression", "gaussian"),
                                       ("binomial", "bernoulli"),
                                       ("multinomial", "multinomial")])
def test_checkpoint_restart_resumes_the_trained_state(port_cpu, monkeypatch,
                                                      kind, dist):
    """A restart from 5 trees picks up where a 10-tree run stood after its
    first 5: the margins the restart walks from the prior's trees within
    2e-6 of the ones the 10-tree run had routed (f32 sums of the same
    five leaf values in another order), and the restart's 5 trees split
    as that run's last 5, node for node, with leaf values within 1e-5."""
    name = ("gbm_multi_chunk_trainer" if dist == "multinomial"
            else "gbm_chunk_trainer")
    real, seen = getattr(BN, name), []

    def recording(*a, **k):
        trainer = real(*a, **k)

        def run(codes, y1, w1, F, gen):
            out = trainer(codes, y1, w1, F, gen)
            seen.append((F.clone(), out[0].clone()))
            return out
        return run
    monkeypatch.setattr(BN, name, recording)
    _, tf = _frames(kind)
    Tgbm = h2o3_tpu_torch.H2OGradientBoostingEstimator
    kw = dict(CKPT, distribution=dist)
    full = Tgbm(ntrees=10, **kw)
    full.train(y="y", training_frame=tf)
    trained_at_5 = seen[0][1]
    seen.clear()
    Tgbm(ntrees=5, model_id=f"resume_{dist}", **kw).train(
        y="y", training_frame=tf)
    seen.clear()
    rest = Tgbm(ntrees=10, checkpoint=f"resume_{dist}", **kw)
    rest.train(y="y", training_frame=tf)
    resumed = seen[0][0]
    n = tf.nrows
    np.testing.assert_allclose(_np(resumed[:n]), _np(trained_at_5[:n]),
                               rtol=0, atol=2e-6)
    pairs = (zip(rest._trees_k, full._trees_k) if dist == "multinomial"
             else [(rest._trees, full._trees)])
    for a, b in pairs:
        for f in ("col", "thr", "na_left"):
            np.testing.assert_array_equal(_np(getattr(a, f)),
                                          _np(getattr(b, f)))
        np.testing.assert_allclose(_np(a.value), _np(b.value), atol=TOL)


# ---------------------------------------------------------------------------
DRF = dict(ntrees=4, max_depth=5, sample_rate=1.0, mtries=-2, seed=1,
           score_tree_interval=2)


@pytest.fixture(scope="module")
def drf_binomial(port_cpu):
    return _both("binomial", JMODELS.H2ORandomForestEstimator,
                 h2o3_tpu_torch.H2ORandomForestEstimator, **DRF)


@pytest.mark.parametrize("kind", ["binomial", "regression"])
def test_drf_matches_jax(drf_binomial, kind):
    """A forest with every row in every bag (sample_rate=1) and every
    column at every node (mtries=-2), min_rows 1 and depth 5: the same
    trees (leaf values, the in-bag means, within 1e-5) and predictions
    within 1e-5. With no row out of any bag, the OOB metrics of both are
    NaN, and so is their history."""
    if kind == "binomial":
        jf, tf, jm, tm = drf_binomial
    else:
        jf, tf, jm, tm = _both(kind, JMODELS.H2ORandomForestEstimator,
                               h2o3_tpu_torch.H2ORandomForestEstimator, **DRF)
    assert tm.summary()["mtries"] == jm._output.model_summary["mtries"] == 4
    assert tm.summary()["oob_scored"] is True
    _same_trees(tm._trees, jm._trees)
    np.testing.assert_allclose(tm.predict(tf).to_numpy(),
                               jm.predict(jf).to_numpy(), atol=TOL)
    th, jh = tm.scoring_history(), jm.scoring_history()
    assert [h["number_of_trees"] for h in th] == [2, 4]
    assert [sorted(h) for h in th] == [sorted(h) for h in jh]
    for a, b in zip(th, jh):
        np.testing.assert_allclose([a[k] for k in sorted(a)],
                                   [b[k] for k in sorted(b)], atol=TOL)


def test_jax_drf_carried_across_scores_the_same(drf_binomial):
    jf, tf, jm, _ = drf_binomial
    t = jm._trees
    model = convert.drf_from_arrays(
        col=_np(t.col), thr=_np(t.thr), na_left=_np(t.na_left),
        value=_np(t.value), cover=_np(t.cover), depth=t.depth,
        predictors=jm._dinfo.predictors, domains=jm._dinfo.domains,
        response_name="y", response_domain=jm._dinfo.response_domain)
    np.testing.assert_allclose(model.predict(tf).to_numpy(),
                               jm.predict(jf).to_numpy(), atol=TOL)


def test_drf_oob_with_the_same_bags_matches_jax(port_cpu, monkeypatch):
    """The out-of-bag path with the same in-bag masks in both packages:
    the port's estimator draws them through `binned.draw_inbag`, replaced
    here; the JAX package's binned grower grows on the same masked stats
    (w, w*y, w) with F = 0, eta = 1 and no clipping, and its OOB sums,
    counts and metrics are accumulated as its DRF trainer does. Sums,
    counts, the OOB AUC and logloss within 1e-5."""
    import jax
    import jax.numpy as jnp
    from h2o3_tpu.models.model import DataInfo as JaxDataInfo
    from h2o3_tpu.models.tree import binned as JB
    ntrees, depth = 5, 4
    jf, tf = _frames("binomial")
    n = tf.nrows
    rng = np.random.default_rng(9)
    masks = rng.random((ntrees, n)) < 0.632
    # the port: its estimator, with the draw handing out the masks
    drawn, seen = iter(masks), []
    monkeypatch.setattr(BN, "draw_inbag", lambda w1, rate, gen=None:
                        torch.nn.functional.pad(torch.from_numpy(next(drawn)),
                                                (0, w1.shape[0] - n)))
    real = BN.drf_chunk_trainer

    def keep(*a, **k):
        run = real(*a, **k)

        def wrapped(*args):
            out = run(*args)
            seen.append(out[:2])
            return out
        return wrapped
    monkeypatch.setattr(BN, "drf_chunk_trainer", keep)
    tm = h2o3_tpu_torch.H2ORandomForestEstimator(
        ntrees=ntrees, max_depth=depth, mtries=-2, seed=1,
        score_tree_interval=ntrees)
    tm.train(y="y", training_frame=tf)
    t_sum, t_cnt = (_np(a)[:n] for a in seen[-1])
    # the JAX package: its binned grower on the same masked stats
    di = JaxDataInfo(jf, [f"x{j}" for j in range(4)], "y", cat_mode="label")
    X = np.asarray(di.matrix(jf))[:n]
    y = np.asarray(di.response(jf))[:n]
    spec = JB.make_bins(X, np.zeros(4, bool), 20)
    grower = JB.BinnedGrower(spec, max_depth=depth, min_rows=1.0,
                             min_split_improvement=1e-5, axis_name=None)
    n_pad = grower.layout(n)
    codes = JB.quantize(jnp.asarray(X), spec, n_pad=n_pad)
    y1 = jnp.asarray(np.pad(y, (0, n_pad - n)))
    j_sum = np.zeros(n_pad, np.float32)
    j_cnt = np.zeros(n_pad, np.float32)
    grow = jax.jit(lambda stats: grower.grow(
        codes, stats, jnp.zeros(n_pad, jnp.float32), eta=1.0, clip_val=0.0,
        key=jax.random.PRNGKey(0))["F"])
    w1 = (np.arange(n_pad) < n).astype(np.float32)
    for t in range(ntrees):
        inbag = np.pad(masks[t], (0, n_pad - n))
        wt = jnp.asarray(w1 * inbag)
        F = grow(jnp.stack([wt, wt * y1, wt, jnp.zeros_like(wt)]))
        oob = (~inbag) & (w1 > 0)
        j_sum += np.where(oob, np.asarray(F), 0.0)
        j_cnt += oob
    np.testing.assert_array_equal(t_cnt, j_cnt[:n])
    np.testing.assert_allclose(t_sum, j_sum[:n], atol=TOL)
    has = j_cnt[:n] > 0
    p = np.clip(j_sum[:n] / np.maximum(j_cnt[:n], 1.0), 1e-7, 1 - 1e-7)
    ref = JM.binomial_metrics(jnp.asarray(y), jnp.asarray(p),
                              jnp.asarray(has.astype(np.float32)))
    got = tm._output.training_metrics
    assert abs(got.auc - ref.auc) < TOL and abs(got.logloss - ref.logloss) \
        < TOL
    assert tm.scoring_history()[-1]["training_auc"] == pytest.approx(
        ref.auc, abs=TOL)


def test_inbag_share_of_a_draw():
    """One tree's bag over 100,000 rows holds sample_rate of them within
    0.01, and a seeded generator draws it again the same."""
    w1 = torch.ones(100_000)
    g = torch.Generator().manual_seed(3)
    bag = BN.draw_inbag(w1, 0.632, g)
    assert bag.dtype == torch.bool and bag.shape == w1.shape
    assert abs(bag.float().mean().item() - 0.632) < 0.01
    again = BN.draw_inbag(w1, 0.632, torch.Generator().manual_seed(3))
    assert torch.equal(bag, again)


@pytest.mark.parametrize("mtries", [-2, -1, 0, 3, 7])
def test_drf_mtries_rule_matches_jax(mtries):
    """The reference's mtries rule, quirks included (-2 and other values
    <= 0 but -1 take every column; 0 means -1): the same count in both
    packages for regression, binomial and multinomial responses."""
    for C in (4, 28, 54):
        for K in (1, 2, 7):
            jm = JMODELS.H2ORandomForestEstimator(mtries=mtries)
            tm = h2o3_tpu_torch.H2ORandomForestEstimator(mtries=mtries)
            assert tm._resolve_mtries(C, K) == jm._resolve_mtries(C, K)


@pytest.mark.parametrize("algo", ["gbm", "drf", "xgboost", "isolationforest",
                                  "glm", "deeplearning", "kmeans", "pca",
                                  "svd", "glrm"])
def test_estimator_parameters_match_jax(algo):
    """The parameters of each estimator and their defaults equal the JAX
    package's, the cross-validation, UDF and checkpoint-directory ones
    included; an unknown one is refused."""
    jcls, tcls = {
        "gbm": (JMODELS.H2OGradientBoostingEstimator,
                h2o3_tpu_torch.H2OGradientBoostingEstimator),
        "drf": (JMODELS.H2ORandomForestEstimator,
                h2o3_tpu_torch.H2ORandomForestEstimator),
        "xgboost": (JMODELS.H2OXGBoostEstimator,
                    h2o3_tpu_torch.H2OXGBoostEstimator),
        "isolationforest": (JMODELS.H2OIsolationForestEstimator,
                            h2o3_tpu_torch.H2OIsolationForestEstimator),
        "glm": (JMODELS.H2OGeneralizedLinearEstimator,
                h2o3_tpu_torch.H2OGeneralizedLinearEstimator),
        "deeplearning": (JMODELS.H2ODeepLearningEstimator,
                         h2o3_tpu_torch.H2ODeepLearningEstimator),
        "kmeans": (JMODELS.H2OKMeansEstimator,
                   h2o3_tpu_torch.H2OKMeansEstimator),
        "pca": (JMODELS.H2OPrincipalComponentAnalysisEstimator,
                h2o3_tpu_torch.H2OPrincipalComponentAnalysisEstimator),
        "svd": (JMODELS.H2OSingularValueDecompositionEstimator,
                h2o3_tpu_torch.H2OSingularValueDecompositionEstimator),
        "glrm": (JMODELS.H2OGeneralizedLowRankEstimator,
                 h2o3_tpu_torch.H2OGeneralizedLowRankEstimator),
    }[algo]
    jp, tp = jcls().params, tcls().params
    assert set(tp) == set(jp)
    assert tp == jp
    for name in ("keep_cross_validation_predictions",
                 "keep_cross_validation_fold_assignment",
                 "export_checkpoints_dir", "custom_metric_func",
                 "custom_distribution_func"):
        assert name in tp
    with pytest.raises(ValueError, match="unknown parameters"):
        tcls(no_such_parameter=1)
