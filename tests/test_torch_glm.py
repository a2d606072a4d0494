"""GLM and the one-hot design matrix of the port against the JAX package,
on the CPU.

One seeded frame (three numeric columns with NA values, two categorical
columns with NA values, responses for every family) goes to both
packages: the port on `init(device="cpu")`, the JAX package through its
own estimator and DataInfo. Tolerances:
- rollups: the port's mean and sample sigma within 1e-12 of numpy's
  float64 ones; the JAX package's within 1e-6 (it sums in f32);
- the design matrix within 1e-6 (f32 ops on statistics that agree to the
  JAX package's f32 sums), feature names equal;
- coefficients within 1e-4 of the largest coefficient (f32 Grams summed
  in another order, then the same float64 solve), the training metric
  within 1e-5 relative;
- L-BFGS fits (binomial, multinomial, ordinal): coefficients and
  thresholds within 5e-3 of the largest, logloss within 1e-5 relative,
  ordinal class probabilities within 1e-3: L-BFGS stops once the
  objective moves by less than 1e-7 of itself, its f32 resolution here,
  and the JAX package's own fits move by more than 1e-4 (and less than
  2.5e-3) from a start shifted by 1e-6, as a test here shows;
- p-values within 1e-5, z-values within 1e-4 relative;
- lambda search: the port repairs the JAX package's lambda_max (it
  leaves out Σw); on the port's lambdas both packages' warm-started
  paths within 1e-4 at every lambda;
- a JAX GLM carried across by `glm_from_arrays`: predictions within 1e-6.
"""

import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
from h2o3_tpu.models import glm as JGLM
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.models.model import DataInfo as JaxDataInfo
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.models.model import DataInfo

N = 2000
X = ["a", "b", "c", "color"]
COEF_TOL = 1e-4
# L-BFGS stops once the objective moves by less than 1e-7 of itself, the
# f32 resolution of a sum over 2000 rows: the JAX package's own fits move
# by more than 1e-4 of the largest coefficient from a start shifted by
# 1e-6 (test_lbfgs_tolerance_is_the_jax_fits_own_spread)
LBFGS_TOL = 5e-3


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _cols(n=N, seed=1, levels=("red", "green", "blue", "teal")):
    rng = np.random.default_rng(seed)
    a, b, c = rng.normal(size=(3, n))
    a[rng.random(n) < 0.05] = np.nan
    c[rng.random(n) < 0.03] = np.nan
    color = np.array(rng.choice(list(levels), n), object)
    color[rng.random(n) < 0.05] = None
    shade = np.array(rng.choice(["dark", "light", "mid"], n), object)
    shade[rng.random(n) < 0.04] = None
    eta = (0.3 + 0.4 * np.nan_to_num(a) - 0.3 * b
           + 0.3 * (color == "blue"))
    k = np.clip(np.round(eta + rng.logistic(size=n)).astype(int), 0, 2)
    return {
        "a": a, "b": b, "c": 3 * c + 1, "color": color, "shade": shade,
        "g": 1 + 2 * np.nan_to_num(a) - b + rng.normal(0, 0.5, n),
        "p": rng.poisson(np.exp(eta)).astype(float),
        # gamma with the inverse link's mean, bounded away from 1/0
        "gm": rng.gamma(2.0, 0.5 / (0.8 + 0.2 * np.tanh(eta))),
        "tw": np.where(rng.random(n) < 0.3, 0.0,
                       rng.gamma(2.0, np.exp(eta) / 2.0)),
        "y": np.array(["no", "yes"], object)[
            (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(int)],
        "k": np.array(["lo", "mid", "top"], object)[k],
    }


def _both(cols):
    jf = JFrame.from_dict(cols)
    tf = Frame(list(cols), [Vec.from_numpy(v) for v in cols.values()])
    return jf, tf


@pytest.fixture(scope="module")
def frames(port_cpu):
    return _both(_cols())


def _fit(frames, y, x=X, **params):
    jf, tf = frames
    jm = JMODELS.H2OGeneralizedLinearEstimator(**params)
    jm.train(x=x, y=y, training_frame=jf)
    tm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(**params)
    tm.train(x=x, y=y, training_frame=tf)
    return jm, tm


def _close_coefs(jb, tb, tol=COEF_TOL):
    jb, tb = np.asarray(jb, np.float64), np.asarray(tb, np.float64)
    assert jb.shape == tb.shape
    err = np.abs(jb - tb).max() / np.abs(jb).max()
    assert err < tol, (err, jb, tb)


def _metric(m):
    return m.logloss() if m._is_classifier else m.rmse()


# ---------------------------------------------------------------------------
def test_rollups_match_numpy_and_jax(frames):
    jf, tf = frames
    for c in ("a", "b", "c", "g"):
        x = tf.vec(c).to_numpy()
        ok = x[~np.isnan(x)]
        r = tf.vec(c).rollups()
        np.testing.assert_allclose(r.mean, ok.mean(), rtol=1e-12)
        np.testing.assert_allclose(r.sigma, ok.std(ddof=1), rtol=1e-12)
        np.testing.assert_allclose(r.mean, jf.vec(c).mean(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(r.sigma, jf.vec(c).sigma(), rtol=1e-6)


@pytest.mark.parametrize("standardize", [True, False])
def test_design_matrix_matches_jax(frames, standardize):
    """The one-hot matrix with NA values, standardised (or not) and
    imputed, with all three kinds of interaction, on the training frame
    and on a test frame with an unseen level and NAs in every column."""
    jf, tf = frames
    x = ["a", "b", "c", "color", "shade"]
    inter = ["a", "b", "color", "shade", "c"]
    jdi = JaxDataInfo(jf, x, "y", cat_mode="onehot",
                      standardize=standardize, interactions=inter)
    tdi = DataInfo.from_frame(tf, x, "y", cat_mode="onehot",
                              standardize=standardize, interactions=inter)
    assert tdi.feature_names == jdi.feature_names
    assert tdi.raw_columns() == jdi.raw_columns()
    assert [p[2] for p in tdi.inter_pairs] == ["a:b", "a:c", "b:c"]
    assert [p[2] for p in tdi.inter_catcat] == ["color_shade"]
    for name in jdi.means:
        np.testing.assert_allclose(tdi.means[name], jdi.means[name],
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(tdi.sigmas[name], jdi.sigmas[name],
                                   rtol=1e-6, err_msg=name)
    want = np.asarray(jdi.matrix(jf))[:N]
    got = tdi.matrix(tf).numpy()
    assert got.shape == want.shape == (N, len(jdi.feature_names))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # a test frame: an unseen level, NA in every column
    cols = _cols(n=300, seed=5, levels=("red", "blue", "purple"))
    for c in ("a", "b", "c"):
        cols[c][:7] = np.nan
    cols["shade"][3:9] = None
    jt, tt = _both(cols)
    want = np.asarray(jdi.matrix(jt))[:300]
    got = tdi.matrix(tt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    purple = np.asarray(cols["color"] == "purple", bool)
    blk = [i for i, f in enumerate(tdi.feature_names)
           if f.startswith("color.")]
    assert purple.any() and (got[purple][:, blk] == 0).all()


def test_interactions_are_validated(frames):
    _, tf = frames
    with pytest.raises(ValueError, match="unknown predictors"):
        DataInfo.from_frame(tf, X, "y", cat_mode="onehot",
                            interactions=["a", "zz"])
    with pytest.raises(ValueError, match="one-hot"):
        DataInfo.from_frame(tf, X, "y", cat_mode="label",
                            interactions=["a", "b"])


@pytest.mark.parametrize("family,y,extra", [
    ("gaussian", "g", {}), ("binomial", "y", {}),
    ("quasibinomial", "y", {}), ("poisson", "p", {}), ("gamma", "gm", {}),
    ("tweedie", "tw", {"tweedie_variance_power": 1.5}),
    ("negativebinomial", "p", {"theta": 0.5}), ("multinomial", "k", {})])
def test_irlsm_matches_jax(frames, family, y, extra):
    jm, tm = _fit(frames, y, family=family, lambda_=0.0, solver="IRLSM",
                  **extra)
    assert tm._solver == jm._solver == "IRLSM"
    _close_coefs(jm._state.beta, tm._state.beta)
    np.testing.assert_allclose(_metric(tm), _metric(jm), rtol=1e-5)
    if family != "multinomial":
        jc, tc = jm.coef(), tm.coef()
        assert list(tc) == list(jc)
        _close_coefs(list(jc.values()), list(tc.values()))


@pytest.mark.parametrize("family,y", [("binomial", "y"),
                                      ("multinomial", "k")])
def test_lbfgs_matches_jax(frames, family, y):
    jm, tm = _fit(frames, y, family=family, lambda_=1e-2, alpha=0.0,
                  solver="L_BFGS")
    assert tm._solver == "L_BFGS"
    _close_coefs(jm._state.beta, tm._state.beta, tol=LBFGS_TOL)
    np.testing.assert_allclose(tm.logloss(), jm.logloss(), rtol=1e-5)


def test_lbfgs_tolerance_is_the_jax_fits_own_spread(frames, monkeypatch):
    """Why L-BFGS fits are held at LBFGS_TOL and not 1e-4: the JAX
    package's own binomial fit, started 1e-6 away, ends more than 1e-4 of
    its largest coefficient away, and within LBFGS_TOL / 2, with the same
    logloss within 1e-5."""
    jf, _ = frames
    kw = dict(family="binomial", lambda_=1e-2, alpha=0.0, solver="L_BFGS")
    a = JMODELS.H2OGeneralizedLinearEstimator(**kw)
    a.train(x=X, y="y", training_frame=jf)
    start = JGLM._lbfgs
    monkeypatch.setattr(JGLM, "_lbfgs", lambda vg, x0, **k: start(
        vg, np.asarray(x0) + 1e-6, **k))
    b = JMODELS.H2OGeneralizedLinearEstimator(**kw)
    b.train(x=X, y="y", training_frame=jf)
    ab, bb = np.asarray(a._state.beta), np.asarray(b._state.beta)
    spread = np.abs(ab - bb).max() / np.abs(ab).max()
    assert COEF_TOL < spread < LBFGS_TOL / 2
    np.testing.assert_allclose(b.logloss(), a.logloss(), rtol=1e-5)


def test_ordinal_matches_jax(frames):
    jf, tf = frames
    jm, tm = _fit(frames, "k", family="ordinal", lambda_=0.0)
    assert tm._solver == "L_BFGS"
    _close_coefs(jm._state.beta, tm._state.beta, tol=LBFGS_TOL)
    _close_coefs(jm._ord_thr, tm._ord_thr, tol=LBFGS_TOL)
    jp = jm.predict(jf).to_numpy()[:, 1:]
    tp = tm.predict(tf).to_numpy()[:, 1:]
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    np.testing.assert_allclose(tm.logloss(), jm.logloss(), rtol=1e-5)


def test_lambda_search_path_matches_jax(frames, monkeypatch):
    """Elastic net down a 12-step lambda path (COD on the Gram, warm
    started from one lambda to the next). The port starts the path at the
    lambda where every penalised coefficient is 0 (the JAX package's start
    is Σw times higher: see the next test); handed the port's lambdas, the
    JAX package walks the same path, every coefficient vector within
    1e-4."""
    _, tf = frames
    tm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(
        family="binomial", alpha=0.5, lambda_search=True, nlambdas=12)
    tm.train(x=X, y="y", training_frame=tf)
    path = tm._lambda_path
    assert len(path) == 12
    active = [int((np.abs(b[:-1]) > 1e-10).sum()) for _, b in path]
    assert active[0] == 0 and active[1] > 0 and active[-1] == 7
    np.testing.assert_allclose(path[-1][0] / path[0][0], 1e-4, rtol=1e-9)
    lams = [lam for lam, _ in path]
    monkeypatch.setattr(JGLM.H2OGeneralizedLinearEstimator, "_alpha_lambda",
                        lambda self, G, q, p_pen: (0.5, lams))
    jm = JMODELS.H2OGeneralizedLinearEstimator(
        family="binomial", alpha=0.5, lambda_search=True, nlambdas=12)
    jm.train(x=X, y="y", training_frame=frames[0])
    assert [lam for lam, _ in jm._lambda_path] == lams
    for (_, jb), (_, tb) in zip(jm._lambda_path, path):
        if np.abs(jb[:-1]).max() > 0:
            _close_coefs(jb, tb)
        else:
            assert np.abs(tb[:-1]).max() == 0
    np.testing.assert_allclose(tm.logloss(), jm.logloss(), rtol=1e-5)


def test_lambda_search_repairs_the_empty_jax_path(port_cpu):
    """The JAX package's lambda_max leaves out Σw: at 20,000 rows its whole
    path is Σw times too high and holds no active predictor (AUC 0.5),
    where the port's path ends at nearly the unpenalised fit."""
    rng = np.random.default_rng(0)
    n = 20_000
    Xn = rng.normal(size=(n, 5))
    logit = 1.2 * Xn[:, 0] - 0.8 * Xn[:, 1] + 0.3 * Xn[:, 2]
    cols = {**{f"x{j}": Xn[:, j] for j in range(5)},
            "y": np.array(["0", "1"], object)[
                (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)]}
    xs = [f"x{j}" for j in range(5)]
    jm, tm = _fit(_both(cols), "y", x=xs, family="binomial", alpha=0.5,
                  lambda_search=True, nlambdas=10)
    assert all(np.abs(b[:-1]).max() == 0 for _, b in jm._lambda_path)
    assert jm.auc() == 0.5
    np.testing.assert_allclose(jm._lambda_path[0][0],
                               tm._lambda_path[0][0] * n, rtol=1e-5)
    assert (np.abs(tm._lambda_path[-1][1][:-1]) > 1e-10).sum() == 5
    assert tm.auc() > 0.75


@pytest.mark.parametrize("bounds", ["beta_constraints", "non_negative"])
def test_bounded_fit_matches_jax(frames, bounds):
    kw = ({"beta_constraints": {"a": (-0.1, 0.1), "b": (0.0, 1.0)}}
          if bounds == "beta_constraints" else {"non_negative": True})
    jm, tm = _fit(frames, "g", family="gaussian", lambda_=0.0, **kw)
    _close_coefs(jm._state.beta, tm._state.beta)
    beta = dict(zip(tm._dinfo.feature_names, tm._state.beta))
    if bounds == "beta_constraints":
        assert -0.1 - 1e-12 <= beta["a"] <= 0.1 + 1e-12
        assert beta["b"] >= -1e-12
    else:
        assert min(tm._state.beta[:-1]) >= -1e-12


def test_quadratic_penalty_matches_jax(frames):
    S = [[2.0, -1.0], [-1.0, 2.0]]
    jm, tm = _fit(frames, "g", family="gaussian", lambda_=0.0,
                  quadratic_penalty=[(["a", "b"], np.asarray(S) * 500.0)])
    _close_coefs(jm._state.beta, tm._state.beta)
    plain = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(
        family="gaussian", lambda_=0.0).train(x=X, y="g",
                                               training_frame=frames[1])
    assert np.abs(tm._state.beta - plain._state.beta).max() > 1e-3


def test_p_values_match_jax(frames):
    jm, tm = _fit(frames, "y", family="binomial", lambda_=0.0,
                  compute_p_values=True)
    np.testing.assert_allclose(tm._p_values, jm._p_values, atol=1e-5)
    np.testing.assert_allclose(tm._z_values, jm._z_values, rtol=1e-4)
    np.testing.assert_allclose(tm._std_errors, jm._std_errors, rtol=1e-4)


@pytest.mark.parametrize("family,y,extra", [
    ("binomial", "y", {"interactions": ["a", "color", "b"]}),
    ("multinomial", "k", {}), ("ordinal", "k", {}),
    ("gaussian", "g", {"standardize": False})])
def test_jax_glm_carried_across_predicts_the_same(frames, family, y, extra):
    jf, tf = frames
    jm = JMODELS.H2OGeneralizedLinearEstimator(family=family, lambda_=0.0,
                                               **extra)
    jm.train(x=X, y=y, training_frame=jf)
    di = jm._dinfo
    tm = convert.glm_from_arrays(
        beta=np.asarray(jm._state.beta), family=jm._state.family,
        link=jm._state.link, predictors=di.predictors, domains=di.domains,
        response_name=y, response_domain=di.response_domain,
        means=di.means, sigmas=di.sigmas, standardize=di.standardize,
        interactions=extra.get("interactions"),
        ord_beta=getattr(jm, "_ord_beta", None),
        ord_thr=getattr(jm, "_ord_thr", None))
    assert tm._dinfo.feature_names == di.feature_names
    np.testing.assert_allclose(tm.predict(tf).to_numpy(),
                               jm.predict(jf).to_numpy(), atol=1e-6)


def test_glm_surface(frames):
    """AUTO family from the response, summary, varimp, the prediction
    frame, and a CPU fit that stays on the CPU."""
    _, tf = frames
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(lambda_=0.0)
    m.train(x=X, y="y", training_frame=tf)
    assert m.summary()["family"] == "binomial"
    assert m.summary()["number_of_predictors_total"] == 7
    assert m.varimp()[0]["scaled_importance"] == 1.0
    p = m.predict(tf)
    assert p.names == ["predict", "pno", "pyes"]
    assert p.vec("pyes").data.device == torch.device("cpu")
    assert 0.6 < m.auc() < 1.0
    with pytest.raises(NotImplementedError, match="not implemented"):
        h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="hglm").train(
            x=X, y="g", training_frame=tf)


# ---------------------------------------------------------------------------
# The reduced design: with an intercept, a categorical without NA loses its
# first level's column (the JAX package keeps every level, and its design
# is singular). The frame is the re-anchor probe's: 1,500 rows, a, b and c
# N(0, 1) with 5% NA, color from three levels with no NA.
@pytest.fixture(scope="module")
def probe(port_cpu):
    n = 1500
    rng = np.random.default_rng(1)
    a, b, c = rng.normal(size=(3, n))
    for v in (a, b, c):
        v[rng.random(n) < 0.05] = np.nan
    color = np.array(rng.choice(["red", "green", "blue"], n), object)
    logit = 1.4 * np.nan_to_num(a) - 0.9 * np.nan_to_num(b) \
        + (color == "blue")
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    k = np.clip(np.round(logit / 2 + rng.logistic(size=n)), 0, 2)
    cols = {"a": a, "b": b, "c": c, "color": color,
            "y": np.array(["no", "yes"], object)[y.astype(int)],
            "k": np.array(["lo", "mid", "top"], object)[k.astype(int)]}
    return cols, _both(cols)


def _reduced_design(cols):
    """The float64 reduced design: color's green and red indicators (blue,
    the first level, dropped), a, b and c standardised by their mean and
    sample sigma with NA as 0, and the intercept last."""
    nums = [(cols[c] - np.nanmean(cols[c])) / np.nanstd(cols[c], ddof=1)
            for c in ("a", "b", "c")]
    return np.column_stack(
        [cols["color"] == "green", cols["color"] == "red"]
        + [np.nan_to_num(v) for v in nums] + [np.ones(len(cols["a"]))]
    ).astype(np.float64)


def _softmax(E):
    E = np.exp(E - E.max(axis=1, keepdims=True))
    return E / E.sum(axis=1, keepdims=True)


def test_reduced_design_binomial_glm_converges(probe):
    """At its defaults the binomial GLM meets beta_epsilon before
    max_iterations, its standard errors are finite and non-zero, its
    coefficients are a float64 numpy IRLS's on the reduced design, and
    its probabilities on the levels both packages know agree with the
    JAX package's within the 1e-3 that the JAX package's own η allows on
    its singular design. An NA or unseen level scores as the first."""
    cols, (jf, tf) = probe
    jm, tm = _fit((jf, tf), "y", compute_p_values=True)
    assert tm._dinfo.drop_first == ["color"]
    assert tm._dinfo.feature_names == ["color.green", "color.red", "a", "b",
                                       "c"]
    assert tm._iterations < tm.params["max_iterations"]
    assert np.isfinite(tm._std_errors).all() and (tm._std_errors > 0).all()
    Z = _reduced_design(cols)
    yv = (cols["y"] == "yes").astype(np.float64)
    beta = np.zeros(Z.shape[1])
    for _ in range(100):
        mu = 1 / (1 + np.exp(-Z @ beta))
        W = mu * (1 - mu)
        step = np.linalg.solve(Z.T @ (W[:, None] * Z), Z.T @ (yv - mu))
        beta += step
        if np.abs(step).max() < 1e-13:
            break
    _close_coefs(beta, tm._state.beta)
    mu = 1 / (1 + np.exp(-Z @ beta))
    se = np.sqrt(np.diag(np.linalg.inv(Z.T @ ((mu * (1 - mu))[:, None]
                                              * Z))))
    np.testing.assert_allclose(tm._std_errors, se, rtol=1e-3)
    np.testing.assert_allclose(tm.predict(tf).to_numpy()[:, 1:],
                               jm.predict(jf).to_numpy()[:, 1:], atol=1e-3)
    test = {c: cols[c][:3] for c in ("a", "b", "c")}
    test["color"] = np.array(["blue", "teal", None], object)
    p = tm.predict(Frame.from_dict(test)).to_numpy()[:, 2]
    q = tm.predict(Frame.from_dict(dict(test, color=np.array(
        ["blue"] * 3, object)))).to_numpy()[:, 2]
    np.testing.assert_array_equal(p, q)


def test_reduced_design_multinomial_glm_converges(probe):
    """The multinomial GLM at its defaults meets beta_epsilon before
    max_iterations; its coefficients are those of a float64 numpy twin of
    its block-coordinate IRLS on the reduced design; its probabilities
    agree with the JAX package's within 1e-3."""
    cols, (jf, tf) = probe
    jm, tm = _fit((jf, tf), "k", family="multinomial")
    assert tm._dinfo.drop_first == ["color"]
    assert tm._iterations < tm.params["max_iterations"]
    Z = _reduced_design(cols)
    yi = np.searchsorted(["lo", "mid", "top"], cols["k"])
    K, p1 = 3, Z.shape[1]
    B = np.zeros((K, p1))
    B[:, -1] = np.log(np.maximum(np.bincount(yi, minlength=K) / len(yi),
                                 1e-6))
    for _ in range(int(tm.params["max_iterations"])):
        dmax = 0.0
        for c in range(K):
            pc = np.clip(_softmax(Z @ B.T)[:, c], 1e-6, 1 - 1e-6)
            d = np.maximum(pc * (1 - pc), 1e-6)
            z = Z @ B[c] + ((yi == c) - pc) / d
            G = Z.T @ (d[:, None] * Z)
            nb = np.linalg.solve(G + 1e-8 * np.eye(p1), Z.T @ (d * z))
            dmax = max(dmax, np.abs(nb - B[c]).max())
            B[c] = nb
        if dmax < tm.params["beta_epsilon"]:
            break
    _close_coefs(B, tm._state.beta)
    np.testing.assert_allclose(tm.predict(tf).to_numpy()[:, 1:],
                               jm.predict(jf).to_numpy()[:, 1:], atol=1e-3)


def test_reduced_design_follows_the_training_frame(probe):
    """The choice is the training frame's: a categorical with an NA keeps
    every level; without an intercept nothing is dropped; PCA keeps every
    level; the codec lays a test frame out as the training frame."""
    cols, (_, tf) = probe
    na = dict(cols, color=np.where(np.arange(len(cols["a"])) == 0, None,
                                   cols["color"]))
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator()
    m.train(x=X, y="y", training_frame=Frame.from_dict(na))
    assert m._dinfo.drop_first == [] and "color.blue" in \
        m._dinfo.feature_names
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(intercept=False)
    m.train(x=X, y="y", training_frame=tf)
    assert m._dinfo.drop_first == []
    pca = h2o3_tpu_torch.H2OPrincipalComponentAnalysisEstimator(k=2)
    pca.train(x=X, training_frame=tf)
    assert "color.blue" in pca._dinfo.feature_names
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator()
    m.train(x=X, y="y", training_frame=tf)
    assert m._dinfo.matrix(Frame.from_dict(na)).shape[1] == 5
