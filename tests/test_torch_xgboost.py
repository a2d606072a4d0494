"""XGBoost of the port against the JAX package's, on the CPU (mirroring
tests/test_xgboost.py).

The same numpy frames, made from a seed, go to both packages. Where the
JAX package draws from a jax.random key the port gets the same draws
(`test_torch_draws.JaxDraws`); DART's drops come from numpy's
default_rng(seed) in both. Tolerances: trees node for node (col and
value at every node, thr and na_left at split nodes) with leaf values
within 1e-5 (real-valued g and h summed in another order; the JAX
package's sigmoid and exp differ from torch's in the last bit);
probabilities, predictions and the scoring history within 1e-5. A
multinomial booster's class trees can flip a near tie between columns
that part the rows alike, so those are compared by probabilities only,
and multinomial DART (whose drops make the margins of later trees
depend on every earlier one) at depth 3 with min_rows 20.
"""

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
from test_torch_adaptive import _np, frames, same_history, same_trees
from test_torch_draws import replay

TOL = 1e-5
JX = JMODELS.H2OXGBoostEstimator
TX = h2o3_tpu_torch.H2OXGBoostEstimator


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _cls_frames(n=600, c=6, seed=3):
    """tests/test_xgboost.py's binary frame in both packages."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, c))
    logit = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)
    names = [f"x{j}" for j in range(c)]
    jf = JFrame.from_dict({**{m: X[:, j] for j, m in enumerate(names)},
                           "y": np.array(["no", "yes"], object)[y]})
    tf = Frame(names + ["y"], [Vec.from_numpy(X[:, j]) for j in range(c)]
               + [Vec.from_numpy(y.astype(float), type=T_CAT,
                                 domain=["no", "yes"])])
    return jf, tf


def _train(cls, fr, scheme=None, pad=None, valid=None, **params):
    m = cls(**params)
    if scheme:
        replay(m, params["seed"], pad, scheme)
    m.train(y="y", training_frame=fr, validation_frame=valid)
    return m


def _pred(m, fr, cols=slice(1, None)):
    return np.asarray(m.predict(fr).to_numpy()[:, cols], np.float64)


@pytest.mark.parametrize("kind", ["binomial", "regression", "multinomial"])
def test_xgboost_booster_matches_jax(port_cpu, kind):
    """Binary (binary:logistic), regression (reg:squarederror, base score
    0.5) and 3-class softprob boosters, 6 trees of depth 4, min_rows 20:
    trees node for node (single-output), probabilities or predictions and
    the scoring history within 1e-5, the same objective in the
    summary."""
    jf, tf = frames(kind)
    kw = dict(ntrees=6, max_depth=4, min_rows=20, seed=5)
    jm, tm = _train(JX, jf, **kw), _train(TX, tf, **kw)
    cols = slice(0, 1) if kind == "regression" else slice(1, None)
    np.testing.assert_allclose(_pred(tm, tf, cols), _pred(jm, jf, cols),
                               atol=TOL)
    same_history(tm.scoring_history(), jm.scoring_history())
    assert tm.summary()["objective"] == jm._output.model_summary["objective"]
    if kind != "multinomial":
        same_trees(tm._trees, jm._trees)
        assert tm._f0 == jm._f0
    else:
        assert len(tm._trees_k) == 3 and tm._trees_k[0].ntrees == 6


def test_xgboost_aliases_resolve_as_in_jax(port_cpu):
    """The XGBoost-style aliases land on H2O's parameters as in the JAX
    package (every parameter equal), gamma is doubled onto the engine's
    gain, and a booster trained through them, with row sampling and a
    per-tree column sample (the same draws), matches the JAX one: trees
    node for node, probabilities within 1e-5."""
    aliases = dict(ntrees=4, eta=0.2, min_child_weight=2, subsample=0.9,
                   colsample_bytree=0.8, max_bins=64, gamma=0.01,
                   max_depth=3, seed=1)
    jm, tm = JX(**aliases), TX(**aliases)
    assert tm.params == {k: jm.params[k] for k in tm.params}
    assert tm.params["learn_rate"] == 0.2 and tm.params["nbins"] == 64
    assert tm._grower().msi == 0.02
    jf, tf = _cls_frames(n=400)
    jm.train(y="y", training_frame=jf)
    replay(tm, 1, jf.padded_len, "tree4")
    tm.train(y="y", training_frame=tf)
    same_trees(tm._trees, jm._trees)
    np.testing.assert_allclose(_pred(tm, tf), _pred(jm, jf), atol=TOL)
    with pytest.raises(AssertionError, match="tree_method"):
        TX(tree_method="gpu_exact")
    with pytest.raises(AssertionError, match="gblinear"):
        TX(booster="gblinear")


def test_xgboost_regularization_shrinks_leaves(port_cpu):
    """reg_lambda 1000 flattens the probabilities, as in the JAX package,
    and reg_alpha and per-level column sampling train the same trees in
    both packages (the same draws)."""
    jf, tf = _cls_frames(n=400)
    base = _train(TX, tf, ntrees=5, seed=1)
    strong = _train(TX, tf, ntrees=5, reg_lambda=1000.0, seed=1)
    pw = np.abs(_pred(base, tf)[:, 1] - 0.5).mean()
    ps = np.abs(_pred(strong, tf)[:, 1] - 0.5).mean()
    assert ps < pw
    kw = dict(ntrees=4, max_depth=3, reg_alpha=0.5, colsample_bylevel=0.5,
              seed=2)
    jm = _train(JX, jf, **kw)
    tm = _train(TX, tf, scheme="tree4", pad=jf.padded_len, **kw)
    same_trees(tm._trees, jm._trees)
    np.testing.assert_allclose(_pred(tm, tf), _pred(jm, jf), atol=TOL)


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_xgboost_dart_matches_jax(port_cpu, kind):
    """DART with rate_drop and one_drop: the same drops in both packages
    (numpy's default_rng(seed)), the folded tree weights, probabilities
    within 1e-5 (binomial trees node for node; multinomial at depth 3,
    min_rows 20); rate_drop 0 is gbtree exactly; DART changes the
    ensemble."""
    jf, tf = frames(kind)
    depth = dict(max_depth=3, min_rows=20) if kind == "multinomial" \
        else dict(max_depth=4)
    kw = dict(ntrees=8, seed=5, booster="dart", rate_drop=0.4,
              one_drop=True, **depth)
    jm, tm = _train(JX, jf, **kw), _train(TX, tf, **kw)
    np.testing.assert_allclose(_pred(tm, tf), _pred(jm, jf), atol=TOL)
    base = _train(TX, tf, ntrees=8, seed=5, **depth)
    zero = _train(TX, tf, **dict(kw, rate_drop=0.0))
    if kind == "binomial":
        same_trees(tm._trees, jm._trees)
        np.testing.assert_array_equal(_np(zero._trees.value),
                                      _np(base._trees.value))
        assert not np.allclose(_np(tm._trees.value), _np(base._trees.value))
    else:
        for a, b in zip(tm._trees_k, jm._trees_k):
            same_trees(a, b)
        assert not np.allclose(_np(tm._trees_k[0].value),
                               _np(base._trees_k[0].value))


def test_xgboost_checkpoint_with_a_new_learning_rate(port_cpu):
    """4 trees at eta 0.4, restarted to 6 at eta 0.2 (the prior's leaves
    rescaled by eta_prev/eta = 2) in both packages, the port's from its own
    prior by DKV key and from the JAX prior carried across by
    convert.xgboost_from_arrays: trees node for node, probabilities and
    the restart's history (a validation series in the port) within 1e-5;
    a restart to no more trees, another depth, other predictors and DART
    refused."""
    jf, tf = _cls_frames(n=300, seed=10)
    vj, vt = _cls_frames(n=200, seed=11)
    kw = dict(max_depth=2, seed=1, score_tree_interval=3)
    j1 = _train(JX, jf, ntrees=4, learn_rate=0.4, **kw)
    t1 = _train(TX, tf, ntrees=4, learn_rate=0.4, model_id="xgb_lr", **kw)
    j2 = JX(ntrees=6, learn_rate=0.2, checkpoint=j1, **kw)
    j2.train(y="y", training_frame=jf)
    ta = j1._trees
    carried = convert.xgboost_from_arrays(
        col=_np(ta.col), thr=_np(ta.thr), na_left=_np(ta.na_left),
        value=_np(ta.value), cover=_np(ta.cover), depth=ta.depth,
        f0=j1._f0, distribution="bernoulli", learn_rate=0.4,
        predictors=j1._dinfo.predictors, domains=j1._dinfo.domains,
        response_name="y", response_domain=j1._dinfo.response_domain)
    np.testing.assert_allclose(_pred(carried, tf), _pred(j1, jf), atol=TOL)
    for prior, pm in (("xgb_lr", t1), (carried, carried)):
        t2 = _train(TX, tf, valid=vt, ntrees=6, learn_rate=0.2,
                    checkpoint=prior, **kw)
        np.testing.assert_array_equal(_np(t2._trees.value)[:4],
                                      _np(pm._trees.value) * 2.0)
        same_trees(t2._trees, j2._trees)
        np.testing.assert_allclose(_pred(t2, tf), _pred(j2, jf), atol=TOL)
        th = t2.scoring_history()
        same_history([{k: v for k, v in h.items()
                       if not k.startswith("validation_")} for h in th],
                     j2.scoring_history())
        assert th[-1]["validation_auc"] == pytest.approx(t2.auc(valid=True),
                                                         abs=TOL)
    for bad, err in ((dict(ntrees=4), "must exceed"),
                     (dict(ntrees=6, max_depth=3), "identical max_depth")):
        with pytest.raises(AssertionError, match=err):
            _train(TX, tf, checkpoint="xgb_lr", **dict(kw, **bad))
    with pytest.raises(AssertionError, match="SAME predictor"):
        TX(ntrees=6, checkpoint="xgb_lr", **kw).train(
            x=["x0", "x1"], y="y", training_frame=tf)
    with pytest.raises(NotImplementedError, match="DART"):
        TX(checkpoint="xgb_lr", booster="dart")
    h2o3_tpu.remove(j1.key)


def test_xgboost_stump_closed_form(port_cpu):
    """tests/test_xgboost.py's hand-computed stump: 8 rows, one binary
    feature, lambda 1: leaves G/(H + lambda) = +-0.5."""
    x = np.array([0, 0, 0, 0, 1, 1, 1, 1], float)
    y = np.array([1, 1, 1, 0, 0, 0, 0, 1], float)
    fr = Frame(["x", "y"], [Vec.from_numpy(x),
                            Vec.from_numpy(y, type=T_CAT, domain=["n", "p"])])
    m = _train(TX, fr, ntrees=1, max_depth=1, learn_rate=1.0, reg_lambda=1.0,
               min_rows=0.0, min_split_improvement=0.0, seed=1)
    val = _np(m._trees.value[0])
    assert sorted(np.unique(np.round(val[1:3], 6))) == [-0.5, 0.5]


def test_xgboost_validation_series_and_shap(port_cpu):
    """A validation frame scores into the history (the last entry's
    validation AUC equals the final model's within 1e-5, for gbtree and for
    DART, whose tree weights change at every drop); the TreeSHAP
    contributions of a regression booster sum to its prediction within
    1e-4."""
    jf, tf = _cls_frames(n=400)
    vj, vt = _cls_frames(n=300, seed=4)
    for extra in ({}, dict(booster="dart", rate_drop=0.5)):
        m = _train(TX, tf, valid=vt, ntrees=6, max_depth=3, seed=1,
                   score_tree_interval=2, **extra)
        h = m.scoring_history()
        assert [e["number_of_trees"] for e in h] == [2, 4, 6]
        assert h[-1]["validation_auc"] == pytest.approx(m.auc(valid=True),
                                                        abs=TOL)
    _, rf = frames("regression")
    r = _train(TX, rf, ntrees=5, max_depth=4, seed=2)
    phi = r.predict_contributions(rf).to_numpy()
    np.testing.assert_allclose(phi.sum(1), _pred(r, rf, slice(0, 1))[:, 0],
                               atol=1e-4)
    assert TX.available()
