"""GAM, RuleFit and the infogram of the port against the JAX package, on
the CPU.

Seeded numpy frames go to both packages. Tolerances:
- GAM, gaussian and binomial: the knots, centring transforms and
  penalties within 1e-12; the coefficients within 1e-4 of the largest,
  predictions within 1e-5; with knots at the data points, gaussian and
  scale λ, the fit is scipy's smoothing spline (2e-3, as the JAX
  package's own test holds it); a constant gam column, intercept=False
  and multinomial raise, as in the JAX package; a carried GAM
  (convert.gam_from_arrays) predicts within 1e-5;
- RuleFit on the JAX GBM's trees carried across (convert.gbm_from_arrays
  in place of the port's own fit), the JAX GLM on the port's lambda path
  (its lambda_max over Σw; the two paths within 1e-5): the same rules
  with the same supports, the same selected rules, and rule importances
  within 1e-4 of the largest. The JAX
  RuleFit runs with standardize=False there, so that it walks the trees
  over the raw rows as the port does (ROADMAP.md §3); and on a frame
  whose rows the JAX package pads, its supports count the padding rows
  and the port's do not;
- the infogram at depth 5 with min_rows 100 (the near-tie hazard of
  ROADMAP.md §3), core and fair: relevance and information indices within
  1e-3, the same admissible set.
"""

import numpy as np
import pytest

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.models import glm as JGLM
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models import infogram as TINFO
from h2o3_tpu_torch.models import rulefit as TRF


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _pair(cols):
    return JFrame.from_dict(cols), Frame.from_dict(cols)


def _close_rel(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), \
        (np.abs(a - b).max(), np.abs(b).max())


# ---------------------------------------------------------------------------
# GAM
def _gam_frames(n=600, seed=61):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, n)
    z = rng.normal(size=n)
    w = rng.uniform(0, 2, n)
    f = np.sin(2 * x) + 0.3 * w * w
    cols = dict(x=x, z=z, w=w,
                yg=f + 0.5 * z + rng.normal(0, 0.3, n),
                yb=np.array(["a", "b"], object)[
                    (rng.random(n) < 1 / (1 + np.exp(-f))).astype(int)])
    return _pair(cols)


@pytest.mark.parametrize("family,y", [("gaussian", "yg"),
                                      ("binomial", "yb")])
def test_gam_matches_jax(port_cpu, family, y):
    """Two gam columns (x with 8 knots, w with the default 6) beside a
    linear z: the same knots, Z and S, coefficients within 1e-4 of the
    largest, predictions within 1e-5; a carried GAM predicts the same."""
    jf, tf = _gam_frames()
    kw = dict(family=family, gam_columns=["x", "w"], num_knots=[8, 6],
              scale=[0.5, 2.0], lambda_=0.0)
    jm = JMODELS.H2OGeneralizedAdditiveEstimator(**kw)
    jm.train(x=["z", "x", "w"], y=y, training_frame=jf)
    tm = h2o3_tpu_torch.H2OGeneralizedAdditiveEstimator(**kw)
    tm.train(x=["z", "x", "w"], y=y, training_frame=tf)
    for c in ("x", "w"):
        for got, want in ((tm._knots[c], jm._knots[c]), (tm._Z[c], jm._Z[c]),
                          (tm._S[c], jm._S[c])):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-12 * max(1, np.abs(want).max()))
    jc, tc = jm.coef(), tm.coef()
    assert set(tc) == set(jc)
    keys = sorted(jc)
    _close_rel([tc[k] for k in keys], [jc[k] for k in keys], 1e-4)
    col = 0 if family == "gaussian" else 2
    tp = tm.predict(tf).to_numpy()[:, col]
    jp = jm.predict(jf).to_numpy()[: tf.nrows, col]
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    d = jm._glm._dinfo
    carried = convert.gam_from_arrays(
        knots=jm._knots, Z=jm._Z, S=jm._S, beta=jm._glm._state.beta,
        family=family, link=jm._glm._state.link, predictors=d.predictors,
        domains=d.domains, response_name=y,
        response_domain=d.response_domain, means=d.means, sigmas=d.sigmas,
        standardize=d.standardize)
    np.testing.assert_allclose(carried.predict(tf).to_numpy()[:, col], jp,
                               atol=1e-5)


def test_gam_is_the_smoothing_spline(port_cpu):
    """Knots at the 40 data points, gaussian, scale λ = 0.5 and lambda 0:
    the fit equals scipy's make_smoothing_spline (2e-3)."""
    from scipy.interpolate import make_smoothing_spline
    rng = np.random.default_rng(21)
    n = 40
    x = np.sort(rng.uniform(0, 6, n))
    y = np.sin(x) + rng.normal(0, 0.25, n)
    gam = h2o3_tpu_torch.H2OGeneralizedAdditiveEstimator(
        family="gaussian", gam_columns=["x"], num_knots=[n], scale=[0.5],
        lambda_=0.0)
    gam.train(x=[], y="y", training_frame=Frame.from_dict({"x": x, "y": y}))
    ours = gam.predict(Frame.from_dict({"x": x, "y": y})).to_numpy()[:, 0]
    want = make_smoothing_spline(x, y, lam=0.5)(x)
    np.testing.assert_allclose(ours, want, atol=2e-3)


def test_gam_refusals(port_cpu):
    """A constant gam column (fewer than 3 distinct knots), intercept=False
    and multinomial raise, as in the JAX package."""
    rng = np.random.default_rng(23)
    n = 60
    f = Frame.from_dict({"x": rng.normal(0, 1, n), "const": np.ones(n),
                         "y": rng.normal(0, 1, n)})
    G = h2o3_tpu_torch.H2OGeneralizedAdditiveEstimator
    with pytest.raises(ValueError, match="distinct"):
        G(family="gaussian", gam_columns=["const"]).train(
            x=[], y="y", training_frame=f)
    with pytest.raises(NotImplementedError, match="intercept"):
        G(family="gaussian", gam_columns=["x"], intercept=False).train(
            x=[], y="y", training_frame=f)
    yc = np.asarray(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    f3 = Frame.from_dict({"x": rng.normal(0, 1, n), "y": yc})
    with pytest.raises(NotImplementedError, match="family"):
        G(family="multinomial", gam_columns=["x"]).train(
            x=[], y="y", training_frame=f3)


# ---------------------------------------------------------------------------
# RuleFit
RF = dict(min_rule_length=2, max_rule_length=3, rule_generation_ntrees=5)


def _rule_frames(n, seed=71):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    logit = 1.5 * (X[:, 0] > 0.3) * (X[:, 1] < 0) + X[:, 2] - 0.5
    cols = {f"x{j}": X[:, j] for j in range(4)}
    cols["y"] = np.array(["n", "p"], object)[
        (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)]
    return _pair(cols)


def _jax_rulefit(jf, monkeypatch, **params):
    """The JAX RuleFit on the port's lambda path (its lambda_max over Σw,
    the rows here) with its GBMs kept, by rule length."""
    from h2o3_tpu.models.tree import gbm as JGBM
    kept = {}
    train = JGBM.H2OGradientBoostingEstimator.train

    def keep(self, *a, **kw):
        out = train(self, *a, **kw)
        kept[int(self.params["max_depth"])] = self
        return out

    def port_path(self, G, q, p_pen):
        lam_max = np.abs(q[:p_pen]).max() / jf.nrows
        return 1.0, list(np.geomspace(lam_max, lam_max * 1e-4, 15))
    monkeypatch.setattr(JGBM.H2OGradientBoostingEstimator, "train", keep)
    monkeypatch.setattr(JGLM.H2OGeneralizedLinearEstimator, "_alpha_lambda",
                        port_path)
    jm = JMODELS.H2ORuleFitEstimator(standardize=False, **params)
    jm.train(y="y", training_frame=jf)
    return jm, kept


def _port_rulefit(tf, kept, monkeypatch, **params):
    """The port's RuleFit on the JAX GBMs' trees, carried across."""
    def rule_gbm(self, depth, ntrees, frame):
        jg = kept[depth]
        t = jg._trees
        assert t.ntrees == ntrees
        return convert.gbm_from_arrays(
            col=np.asarray(t.col), thr=np.asarray(t.thr),
            na_left=np.asarray(t.na_left), value=np.asarray(t.value),
            depth=t.depth, f0=jg._f0, distribution="bernoulli",
            learn_rate=0.1, predictors=jg._dinfo.predictors, domains={},
            response_name="y", response_domain=["n", "p"])
    monkeypatch.setattr(TRF.H2ORuleFitEstimator, "_rule_gbm", rule_gbm)
    return h2o3_tpu_torch.H2ORuleFitEstimator(**params).train(
        y="y", training_frame=tf)


def test_rulefit_matches_jax(port_cpu, monkeypatch):
    """The same rules (names, supports), the same selected rules, and
    rule importances within 1e-4 of the largest, on 1,024 rows that the
    JAX package does not pad; both GLMs walk the port's lambda path."""
    jf, tf = _rule_frames(1024)
    assert jf.padded_len == 1024
    jm, kept = _jax_rulefit(jf, monkeypatch, **RF)
    assert sorted(kept) == [2, 3]
    tm = _port_rulefit(tf, kept, monkeypatch, **RF)
    lams = [lam for lam, _ in tm._glm._lambda_path]
    np.testing.assert_allclose([lam for lam, _ in jm._glm._lambda_path],
                               lams, rtol=1e-5)
    assert [r["name"] for r in tm._rules] == [r["name"] for r in jm._rules]
    np.testing.assert_allclose([r["support"] for r in tm._rules],
                               [r["support"] for r in jm._rules], rtol=1e-12)
    assert tm.summary() == jm._output.model_summary
    assert tm.summary()["rules_selected"] > 3
    ti, ji = tm.rule_importance(), jm.rule_importance()
    assert [r["rule"] for r in ti] == [r["rule"] for r in ji]
    _close_rel([r["coefficient"] for r in ti],
               [r["coefficient"] for r in ji], 1e-4)
    assert tm.auc() == pytest.approx(jm.auc(), abs=1e-4)
    with pytest.raises(NotImplementedError, match="RuleFit"):
        tm.predict(tf)


def test_rulefit_support_over_frame_rows(port_cpu, monkeypatch):
    """On 1,001 rows, which the JAX package pads, a rule's support is its
    rows over the frame's 1,001 in the port; the JAX package counts over
    its padded rows, NA padding routed down the trees."""
    jf, tf = _rule_frames(1001, seed=72)
    pad = jf.padded_len
    assert pad > 1001
    params = dict(RF, min_rule_length=2, max_rule_length=2)
    jm, kept = _jax_rulefit(jf, monkeypatch, **params)
    tm = _port_rulefit(tf, kept, monkeypatch, **params)
    tr = {r["name"]: r["support"] for r in tm._rules}
    jr = {r["name"]: r["support"] for r in jm._rules}
    shared = sorted(set(tr) & set(jr))
    assert len(shared) > 8
    counts = np.round(np.array([tr[k] for k in shared]) * 1001)
    np.testing.assert_allclose(counts / 1001, [tr[k] for k in shared],
                               rtol=1e-12)
    # the padded rows land in one leaf a tree: every other leaf's support
    # is its count over the padded rows there
    diff = [k for k in shared if abs(jr[k] - tr[k] * 1001 / pad) > 1e-12]
    assert 0 < len(diff) <= RF["rule_generation_ntrees"]


def test_rulefit_algorithm_is_refused(port_cpu):
    """algorithm other than AUTO/GBM raises: the JAX package always grows
    GBM rules."""
    _, tf = _rule_frames(200)
    with pytest.raises(NotImplementedError, match="algorithm"):
        h2o3_tpu_torch.H2ORuleFitEstimator(algorithm="DRF").train(
            y="y", training_frame=tf)


# ---------------------------------------------------------------------------
# Infogram
def _info_frames(n=1500, seed=81):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    logit = 1.5 * X[:, 0] - X[:, 1] + 0.4 * X[:, 2]
    cols = {f"x{j}": X[:, j] for j in range(3)}
    cols["y"] = np.array(["n", "p"], object)[
        (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)]
    return _pair(cols)


def _min_rows_100(module, name, monkeypatch):
    base = getattr(module, name)

    class GBM(base):
        def __init__(self, **kw):
            super().__init__(min_rows=100.0, **kw)
    monkeypatch.setattr(module, name, GBM)


@pytest.mark.parametrize("protected", [None, ["x2"]])
def test_infogram_matches_jax(port_cpu, monkeypatch, protected):
    """Depth 5, 20 bins, 3 trees and min_rows 100 in both packages: the
    relevance and information (or safety) indices within 1e-3, the same
    admissible columns, the fair variant on protected x2 too."""
    jf, tf = _info_frames()
    _min_rows_100(JMODELS, "H2OGradientBoostingEstimator", monkeypatch)
    _min_rows_100(TINFO, "H2OGradientBoostingEstimator", monkeypatch)
    kw = dict(protected_columns=protected, ntrees=3, max_depth=5, nbins=20,
              seed=3)
    ji = JMODELS.H2OInfogram(**kw).train(y="y", training_frame=jf)
    ti = h2o3_tpu_torch.H2OInfogram(**kw).train(y="y", training_frame=tf)
    ikey = "safety_index" if protected else "total_information_index"
    jr = {r["column"]: r for r in ji.result}
    tr = {r["column"]: r for r in ti.result}
    assert set(tr) == set(jr) and len(tr) == (2 if protected else 3)
    for c in tr:
        for k in ("relevance_index", ikey):
            assert tr[c][k] == pytest.approx(jr[c][k], abs=1e-3), (c, k)
    assert ti.get_admissible_features() == ji.get_admissible_features()
    assert {"x0", "x1"} <= set(ti.get_admissible_features())
    assert len(ti.gbm_seconds) == len(tr) + 1 + (1 if protected else 0)
    sf = ti.get_admissible_score_frame()
    assert sf.nrows == len(tr) and "admissible" in sf.names


def test_infogram_algorithm_is_refused():
    with pytest.raises(NotImplementedError, match="algorithm"):
        h2o3_tpu_torch.H2OInfogram(algorithm="drf")
