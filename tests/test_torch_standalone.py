"""Naive Bayes, quantiles, CoxPH and PSVM of the port against the JAX
package, on the CPU.

Seeded numpy frames go to both packages. Tolerances:
- Naive Bayes: priors, count tables, means and standard deviations within
  1e-6 relative (the port sums in float64, the JAX package in f32), the
  class probabilities within 1e-6;
- quantiles: within one f32 ulp of the JAX package's (the same order
  statistics, interpolated in float64) unweighted and with integer
  weights, and of a float64 numpy order statistic with any weights (the
  JAX package sums fractional weights in f32, which moves p·(W−1));
- CoxPH on numeric covariates (Efron, Breslow, strata): β within 1e-4 of
  the largest, standard errors within 1e-4 relative, the log-likelihood
  within 1e-6 relative, the same concordance;
- CoxPH on a categorical without NA (the reduced design): β within 1e-4
  of the largest of a float64 numpy Newton on the reduced design, finite
  non-zero standard errors;
- PSVM: the objective within 1e-5 relative for its first 10 iterations
  and at the end, β within 5e-3 of the largest (as with GLM's L-BFGS),
  the probabilities within 1e-4;
- a JAX model carried across by `*_from_arrays`: its scores within 1e-6.
"""

import math

import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.models import quantile as JQ
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models import quantile as TQ

N = 1200


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _pair(cols):
    return JFrame.from_dict(cols), Frame.from_dict(cols)


@pytest.fixture(scope="module")
def frames(port_cpu):
    rng = np.random.default_rng(21)
    X = rng.normal(size=(N, 4))
    X[:, 2] = 3 * X[:, 2] + 1
    X[rng.random((N, 4)) < 0.04] = np.nan
    col = np.array(rng.choice(["r", "g", "b"], N), object)
    col[rng.random(N) < 0.05] = None
    shade = np.array(rng.choice(["dark", "light"], N), object)
    logit = np.nan_to_num(1.2 * X[:, 0] - X[:, 1]) + (col == "b")
    y = (rng.random(N) < 1 / (1 + np.exp(-logit))).astype(int)
    k = np.clip(np.round(logit / 2 + rng.logistic(size=N)), 0, 2)
    cols = {f"x{j}": X[:, j] for j in range(4)}
    cols.update(col=col, shade=shade,
                y=np.array(["n", "p"], object)[y],
                k=np.array(["lo", "mid", "top"], object)[k.astype(int)],
                w=rng.uniform(0.5, 2.0, N),
                wi=rng.integers(1, 4, N).astype(float))
    return _pair(cols)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("y,extra", [("y", {}), ("k", {"laplace": 1.0}),
                                     ("y", {"weights_column": "w",
                                            "min_prob": 0.05})])
def test_naive_bayes_matches_jax(frames, y, extra):
    jf, tf = frames
    x = ["x0", "x1", "x2", "x3", "col", "shade"]
    jm = JMODELS.H2ONaiveBayesEstimator(**extra)
    jm.train(x=x, y=y, training_frame=jf)
    tm = h2o3_tpu_torch.H2ONaiveBayesEstimator(**extra)
    tm.train(x=x, y=y, training_frame=tf)
    assert _rel(tm._priors, jm._priors) < 1e-6
    for attr in ("_cat_probs", "_num_mean", "_num_sd"):
        for a, b in zip(getattr(tm, attr), getattr(jm, attr)):
            assert _rel(a, b) < 1e-6, attr
    tp = tm.predict(tf).to_numpy()
    jp = jm.predict(jf).to_numpy()
    np.testing.assert_array_equal(tp[:, 0], jp[:, 0])
    np.testing.assert_allclose(tp[:, 1:], jp[:, 1:], atol=1e-6)
    assert abs(tm.logloss() - jm.logloss()) < 1e-6
    carried = convert.naive_bayes_from_arrays(
        priors=jm._priors, cat_probs=jm._cat_probs, num_mean=jm._num_mean,
        num_sd=jm._num_sd, predictors=jm._dinfo.predictors,
        domains=jm._dinfo.domains, response_name=y,
        response_domain=jm._dinfo.response_domain,
        min_prob=jm.params["min_prob"])
    np.testing.assert_allclose(carried.predict(tf).to_numpy()[:, 1:],
                               jp[:, 1:], atol=1e-6)


# ---------------------------------------------------------------------------
def _ulp_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= ulp).all(), (got, want)


def _numpy_quantiles(x, w, probs):
    """Type 7 on cumulative-weight ranks, in float64: the k-th smallest
    value is the first, in sorted order, whose cumulative weight passes
    k."""
    ok = ~np.isnan(x) & (w > 0)
    order = np.argsort(x[ok], kind="stable")
    xs, cw = x[ok][order], np.cumsum(w[ok][order])
    h = np.asarray(probs) * (cw[-1] - 1.0)

    def kth(k):
        return xs[np.searchsorted(cw, k, side="right")]
    lo, hi = kth(np.floor(h)), kth(np.ceil(h))
    return lo + (h - np.floor(h)) * (hi - lo)


@pytest.mark.parametrize("method", ["interpolate", "low", "high", "average"])
def test_quantiles_match_jax(frames, method):
    """Unweighted and with integer weights, whose sums are exact in f32
    (the JAX package sums the weights in f32, the port in float64)."""
    jf, tf = frames
    for weights in (None, "wi"):
        _, jcols = JQ.frame_quantiles(jf, weights_column=weights,
                                      combine_method=method)
        probs, tcols = TQ.frame_quantiles(tf, weights_column=weights,
                                          combine_method=method)
        assert probs == list(JQ.DEFAULT_PROBS)
        assert list(tcols) == list(jcols)
        for c in jcols:
            _ulp_close(tcols[c], jcols[c])


@pytest.mark.parametrize("weights", [None, "wi", "w"])
def test_quantiles_are_float64_order_statistics(frames, weights):
    """Each quantile is the float64 order statistic of the f32 values by
    cumulative weight (numpy's Type 7 without weights), within one f32
    ulp; fractional weights too, which the port sums in float64."""
    _, tf = frames
    for c in ("x0", "x2"):
        x = tf.vec(c).as_f32()
        w = tf.vec(weights).as_f32() if weights else torch.ones_like(x)
        want = _numpy_quantiles(x.numpy().astype(np.float64),
                                w.numpy().astype(np.float64),
                                JQ.DEFAULT_PROBS)
        _ulp_close(TQ.quantile(x, JQ.DEFAULT_PROBS,
                               weights=w if weights else None), want)
        if weights is None:
            ok = x[~torch.isnan(x)].numpy().astype(np.float64)
            _ulp_close(want, np.quantile(ok, JQ.DEFAULT_PROBS))


def test_top_level_quantile_frame(frames):
    from h2o3_tpu import quantile as jquantile
    jf, tf = frames
    jq = jquantile(jf[["x0", "x3"]], prob=[0.1, 0.5, 0.9])
    tq = h2o3_tpu_torch.quantile(tf[["x0", "x3"]], prob=[0.1, 0.5, 0.9])
    assert tq.names == jq.names == ["Probs", "x0", "x3"]
    _ulp_close(tq.to_numpy(), jq.to_numpy())


# ---------------------------------------------------------------------------
def _survival(seed, n=600, cat=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    beta = np.array([0.8, -0.5, 0.3])
    eta = X @ beta
    cols = {f"z{j}": X[:, j] for j in range(3)}
    strat = np.array(rng.choice(["s0", "s1", "s2"], n), object)
    if cat:
        grp = np.array(rng.choice(["a", "b", "c"], n), object)
        eta = eta + 0.7 * (grp == "b") - 0.4 * (grp == "c")
        cols["grp"] = grp
    t = np.ceil(rng.exponential(20.0 / np.exp(eta)))   # whole days: ties
    ev = (rng.random(n) < 0.7).astype(float)
    cols.update(time=t, event=ev, strat=strat)
    return cols


def _coxph_pair(cols, x, **params):
    """Both packages' fits. The JAX package evaluates the partial
    likelihood in f32 and stops once a Newton step does not lower it by
    more than 1e-9, below f32's resolution of a sum of this size, so it
    may stop a step or two short; the port's sums are float64 and it runs
    to convergence. The port is held to the JAX fit after as many Newton
    steps as the JAX fit took, and its own fit must reach at least the
    JAX fit's log-likelihood."""
    jf, tf = _pair(cols)
    jm = JMODELS.H2OCoxProportionalHazardsEstimator(stop_column="time",
                                                    **params)
    jm.train(x=x, y="event", training_frame=jf)
    steps = jm._output.model_summary["iterations"]
    tm = h2o3_tpu_torch.H2OCoxProportionalHazardsEstimator(
        stop_column="time", max_iterations=steps, **params)
    tm.train(x=x, y="event", training_frame=tf)
    full = h2o3_tpu_torch.H2OCoxProportionalHazardsEstimator(
        stop_column="time", **params)
    full.train(x=x, y="event", training_frame=tf)
    fs = full._output.model_summary
    assert fs["iterations"] >= steps
    js = jm._output.model_summary
    assert fs["loglik"] >= js["loglik"] - 1e-6 * abs(js["loglik"])
    return jm, tm, tf


def _numpy_efron(X, t, ev, beta):
    """The negative Efron log partial likelihood, its gradient and its
    Hessian in float64, one tie group at a time."""
    eta = X @ beta
    r = np.exp(eta)
    p = X.shape[1]
    nll, g, H = 0.0, np.zeros(p), np.zeros((p, p))
    for tt in np.unique(t[ev > 0]):
        risk, evs = t >= tt, (t == tt) & (ev > 0)
        d = int(evs.sum())
        sums = []
        for m in (risk, evs):
            rx = r[m, None] * X[m]
            sums.append((r[m].sum(), rx.sum(0), rx.T @ X[m]))
        (R0, R1, R2), (T0, T1, T2) = sums
        nll -= eta[evs].sum()
        g -= X[evs].sum(0)
        for k in range(d):
            f = k / d
            D0, D1, D2 = R0 - f * T0, R1 - f * T1, R2 - f * T2
            nll += math.log(D0)
            g += D1 / D0
            H += D2 / D0 - np.outer(D1, D1) / D0 ** 2
    return nll, g, H


@pytest.mark.parametrize("ties,strata", [("efron", None),
                                         ("breslow", None),
                                         ("efron", "strat")])
def test_coxph_matches_jax(port_cpu, ties, strata):
    """Numeric covariates: the port after as many Newton steps as the JAX
    fit took holds its β, standard errors, log-likelihood and concordance;
    the JAX model carried by `coxph_from_arrays` scores its linear
    predictor."""
    cols = _survival(31)
    x = ["z0", "z1", "z2"]
    jm, tm, tf = _coxph_pair(cols, x, ties=ties, stratify_by=strata)
    js, ts = jm._output.model_summary, tm._output.model_summary
    assert ts["iterations"] == js["iterations"] > 0
    assert ts["n_strata"] == js["n_strata"] == (3 if strata else 1)
    assert tm._dinfo.feature_names == jm._dinfo.feature_names == x
    assert _rel(tm._beta, jm._beta) < 1e-4
    np.testing.assert_allclose(tm._se, jm._se, rtol=1e-4)
    assert abs(ts["loglik"] - js["loglik"]) < 1e-6 * abs(js["loglik"])
    assert ts["concordance"] == js["concordance"]
    jp = jm.predict(_pair(cols)[0]).to_numpy()
    np.testing.assert_allclose(tm.predict(tf).to_numpy(), jp, atol=1e-4)
    di = jm._dinfo
    carried = convert.coxph_from_arrays(
        beta=jm._beta, predictors=di.predictors, domains=di.domains,
        means=di.means, sigmas=di.sigmas)
    np.testing.assert_allclose(carried.predict(tf).to_numpy(), jp,
                               atol=1e-6)


def test_coxph_carried_keeps_every_level(port_cpu):
    """A JAX CoxPH on a categorical without NA keeps every level; carried
    by `coxph_from_arrays` it scores the JAX package's linear predictor."""
    cols = _survival(33, cat=True)
    jf, tf = _pair(cols)
    jm = JMODELS.H2OCoxProportionalHazardsEstimator(stop_column="time")
    jm.train(x=["z0", "z1", "grp"], y="event", training_frame=jf)
    di = jm._dinfo
    carried = convert.coxph_from_arrays(
        beta=jm._beta, predictors=di.predictors, domains=di.domains,
        means=di.means, sigmas=di.sigmas)
    assert carried._dinfo.feature_names == di.feature_names
    assert len(di.feature_names) == 5
    np.testing.assert_allclose(carried.predict(tf).to_numpy(),
                               jm.predict(jf).to_numpy(), atol=1e-6)


def test_coxph_reduced_design_matches_numpy_newton(port_cpu):
    """A categorical without NA loses its first level's column, so the
    levels are identified: Newton converges before max_iterations, the
    standard errors are finite and non-zero, and β is a float64 numpy
    Newton's on the same reduced design."""
    cols = _survival(32, n=800, cat=True)
    x = ["z0", "z1", "z2", "grp"]
    tf = Frame.from_dict(cols)
    tm = h2o3_tpu_torch.H2OCoxProportionalHazardsEstimator(
        stop_column="time")
    tm.train(x=x, y="event", training_frame=tf)
    assert tm._dinfo.feature_names == ["grp.b", "grp.c", "z0", "z1", "z2"]
    assert tm._output.model_summary["iterations"] < 20
    assert np.isfinite(tm._se).all() and (tm._se > 0).all()
    Z = np.column_stack([cols["grp"] == "b", cols["grp"] == "c"]
                        + [(cols[c] - cols[c].mean()) / cols[c].std(ddof=1)
                           for c in ("z0", "z1", "z2")]).astype(np.float64)
    beta = np.zeros(5)
    for _ in range(50):
        _, g, H = _numpy_efron(Z, cols["time"], cols["event"], beta)
        step = np.linalg.solve(H, g)
        beta -= step
        if np.abs(step).max() < 1e-12:
            break
    assert _rel(tm._beta, beta) < 1e-4
    se = np.sqrt(np.diag(np.linalg.inv(
        _numpy_efron(Z, cols["time"], cols["event"], beta)[2])))
    assert _rel(tm._se, se) < 1e-3


# ---------------------------------------------------------------------------
def _jax_psvm_objectives(jm, jf, iters):
    """The JAX PSVM's objective at each of its first `iters` iterations:
    its own loss and optax.lbfgs() loop on its feature map."""
    import jax
    import jax.numpy as jnp
    import optax
    di = jm._dinfo
    X, y = di.matrix(jf), di.response(jf)
    ysvm = jnp.where(y > 0.5, 1.0, -1.0)
    w = jnp.where(jnp.isnan(y), 0.0, di.weights(jf)) * jnp.where(
        ysvm > 0, float(jm.params["positive_weight"]),
        float(jm.params["negative_weight"]))
    Xz = jnp.where(jnp.isnan(X), 0.0, X)
    C = float(jm.params["hyper_param"])

    def loss(params):
        beta, b0 = params
        m = ysvm * (jm._features(Xz) @ beta + b0)
        hinge = jnp.maximum(0.0, 1.0 - m)
        return 0.5 * (beta @ beta) + \
            C * (w * hinge * hinge).sum() / jnp.maximum(w.sum(), 1.0)

    opt = optax.lbfgs()

    @jax.jit
    def step(params, state):
        val, g = jax.value_and_grad(loss)(params)
        upd, state = opt.update(g, state, params, value=val, grad=g,
                                value_fn=loss)
        return optax.apply_updates(params, upd), state, val

    params = (jnp.zeros(jm._params_svm[0].shape[0], jnp.float32),
              jnp.float32(0.0))
    state = opt.init(params)
    out = []
    for _ in range(iters):
        params, state, val = step(params, state)
        out.append(float(val))
    return out


@pytest.mark.parametrize("kernel", ["gaussian", "linear"])
def test_psvm_matches_jax(frames, kernel):
    jf, tf = frames
    x = ["x0", "x1", "x2", "x3", "col"]
    params = dict(kernel_type=kernel, max_iterations=40, seed=5,
                  feature_dim=64, positive_weight=1.5)
    jm = JMODELS.H2OSupportVectorMachineEstimator(**params)
    jm.train(x=x, y="y", training_frame=jf)
    tm = h2o3_tpu_torch.H2OSupportVectorMachineEstimator(**params)
    tm.train(x=x, y="y", training_frame=tf)
    if kernel == "gaussian":
        np.testing.assert_array_equal(tm._rff[0].numpy(),
                                      np.asarray(jm._rff[0]))
    first = _jax_psvm_objectives(jm, jf, 10)
    k = min(10, len(tm._objective))
    assert _rel(tm._objective[:k], first[:k]) < 1e-5
    js, ts = jm._output.model_summary, tm._output.model_summary
    assert abs(ts["final_objective"] - js["final_objective"]) \
        < 1e-5 * abs(js["final_objective"])
    jb = np.asarray(jm._params_svm[0])
    assert _rel(tm._beta.numpy(), jb) < 5e-3
    tp = tm.predict(tf).to_numpy()[:, 1:]
    jp = jm.predict(jf).to_numpy()[:, 1:]
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    di = jm._dinfo
    carried = convert.psvm_from_arrays(
        beta=jb, b0=float(jm._params_svm[1]),
        rff=None if jm._rff is None else tuple(np.asarray(a)
                                               for a in jm._rff),
        predictors=di.predictors, domains=di.domains, means=di.means,
        sigmas=di.sigmas, response_name="y",
        response_domain=di.response_domain)
    np.testing.assert_allclose(carried.predict(tf).to_numpy()[:, 1:], jp,
                               atol=1e-6)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cls,name,value", [
    ("H2ONaiveBayesEstimator", "eps_sdev", 0.01),
    ("H2ONaiveBayesEstimator", "eps_prob", 0.01),
    ("H2ONaiveBayesEstimator", "compute_metrics", False),
    ("H2OSupportVectorMachineEstimator", "rank_ratio", 0.1),
    ("H2OCoxProportionalHazardsEstimator", "start_column", "z0"),
    ("H2OCoxProportionalHazardsEstimator", "lre_min", 5.0),
    ("H2OCoxProportionalHazardsEstimator", "use_all_factor_levels", True),
])
def test_ignored_standalone_options_raise(frames, cls, name, value):
    """Options the JAX package accepts and never reads raise when set."""
    _, tf = frames
    extra = {"stop_column": "x3"} if "Cox" in cls else {}
    y = "x2" if "Cox" in cls else "y"
    m = getattr(h2o3_tpu_torch, cls)(**{name: value}, **extra)
    with pytest.raises(NotImplementedError, match=name):
        m.train(x=["x0", "x1"], y=y, training_frame=tf)
