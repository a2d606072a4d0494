"""The port's explanation tables and figures against the JAX package's,
on the CPU, on a JAX GBM and GLM carried across (their varimp tables
carried with them): PDP (a numeric and a categorical column), ICE, the
varimp heatmap and model correlation within 1e-6; permutation importance
and the Rapids prim `PermutationVarImp` with the JAX package's
permutations replayed (`JaxPermutations`: PRNGKey(seed), one split a
shuffle, jax.random.permutation of the frame's rows) within 1e-6 (1e-5
by logloss: differences of f32 sums taken in another order). The
figures render under Agg and come back as matplotlib Figures; the package
and explain_data import and run without matplotlib.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu import explain_data as JEX
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.rapids.rapids import rapids_exec as jrapids
from h2o3_tpu_torch import explain_data as TEX
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.rapids.rapids import rapids_exec as trapids
from test_torch_genmodel import X, carry, columns

TOL = 1e-6


class JaxPermutations:
    """explain_data.Permutations with the JAX package's shuffles."""

    def __init__(self, seed, device=None):
        self.key = jax.random.PRNGKey(seed)

    def next(self, n):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.asarray(jax.random.permutation(k, n))
                                .astype(np.int64))


@pytest.fixture(scope="module")
def models():
    h2o3_tpu_torch.init(device="cpu")
    cols = columns(n=300, seed=41)
    jf, tf = JFrame.from_dict(cols), Frame.from_dict(cols)
    out = {}
    for name, cls, kw in (
            ("gbm", "H2OGradientBoostingEstimator",
             dict(ntrees=4, max_depth=3, nbins=20, seed=1)),
            ("glm", "H2OGeneralizedLinearEstimator",
             dict(family="binomial", lambda_=0.0))):
        jm = getattr(JMODELS, cls)(model_id=f"explain_{name}", **kw)
        jm.train(x=X, y="y", training_frame=jf)
        cm = carry(jm)
        cm._output.variable_importances = jm.varimp()
        out[name] = (jm, cm)
    yield jf, tf, out
    h2o3_tpu_torch.shutdown()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name,column", [("gbm", "x0"), ("gbm", "color"),
                                         ("glm", "x1"), ("glm", "color")])
def test_partial_dependence_and_ice_match_jax(models, name, column):
    jf, tf, ms = models
    jm, cm = ms[name]
    want = JEX.partial_dependence(jm, jf, column, nbins=7)
    got = TEX.partial_dependence(cm, tf, column, nbins=7)
    assert got["grid"] == want["grid"] and got["column"] == column
    _close(got["mean_response"], want["mean_response"])
    _close(got["stddev_response"], want["stddev_response"])
    jg, jc = JEX.ice(jm, jf, column, nbins=5, row_fraction=0.1)
    tg, tc = TEX.ice(cm, tf, column, nbins=5, row_fraction=0.1)
    assert tg == jg and tc.shape == jc.shape == (30, len(jg))
    _close(tc, jc)


def test_heatmap_and_correlation_match_jax(models):
    jf, tf, ms = models
    jms, cms = [m[0] for m in ms.values()], [m[1] for m in ms.values()]
    jfe, jn, jmat = JEX.varimp_heatmap(jms)
    tfe, tn, tmat = TEX.varimp_heatmap(cms)
    assert (tfe, tn) == (jfe, jn)
    np.testing.assert_allclose(tmat, jmat, rtol=TOL, atol=TOL,
                               equal_nan=True)
    jnames, jc = JEX.model_correlation(jms, jf)
    tnames, tc = TEX.model_correlation(cms, tf)
    assert tnames == jnames
    _close(tc, jc)


@pytest.mark.parametrize("name,metric,n_repeats", [("gbm", "AUTO", 1),
                                                   ("gbm", "logloss", 2),
                                                   ("glm", "auc", 1)])
def test_permutation_importance_matches_jax(models, name, metric,
                                            n_repeats, monkeypatch):
    jf, tf, ms = models
    jm, cm = ms[name]
    want = JEX.permutation_varimp(jm, jf, metric=metric,
                                  n_repeats=n_repeats, seed=7)
    monkeypatch.setattr(TEX, "Permutations", JaxPermutations)
    got = TEX.permutation_varimp(cm, tf, metric=metric, n_repeats=n_repeats,
                                 seed=7)
    assert [r["variable"] for r in got] == [r["variable"] for r in want]
    # logloss is an f32 sum in another order in each package, and the
    # importances are differences of it: 1e-5 there
    tol = 1e-5 if metric == "logloss" else TOL
    for g, w in zip(got, want):
        for k in ("relative_importance", "scaled_importance", "percentage"):
            _close(g[k], w[k], tol)


def test_permutation_varimp_prim_matches_jax(models, monkeypatch):
    jf, tf, ms = models
    jm, cm = ms["gbm"]
    monkeypatch.setattr(TEX, "Permutations", JaxPermutations)
    expr = '(PermutationVarImp {} {} "AUTO" -1 1 -1 5)'
    want = jrapids(expr.format(jm.key, jf.key))
    got = trapids(expr.format(cm.key, tf.key))
    assert got.names == want.names == ["Variable", "Relative Importance",
                                       "Scaled Importance", "Percentage"]
    assert list(got.vec("Variable").to_numpy()) \
        == list(want.vec("Variable").to_numpy())
    for c in got.names[1:]:
        _close(got.vec(c).to_numpy(), want.vec(c).to_numpy())
    # the port's own shuffles (a torch.Generator): the same table shape
    monkeypatch.undo()
    own = trapids(expr.format(cm.key, tf.key))
    assert own.nrows == got.nrows and own.names == got.names


def test_model_explain_surface_and_figures(models):
    from matplotlib.figure import Figure
    from h2o3_tpu_torch import explain_plots as EP
    _, tf, ms = models
    _, cm = ms["gbm"]
    m = h2o3_tpu_torch.H2OGradientBoostingEstimator(ntrees=3, max_depth=3,
                                                    nbins=20, seed=1)
    m.train(x=X, y="y", training_frame=tf)
    pdps = m.partial_plot(tf, cols=["x0", "color"], nbins=5)
    assert [p["column"] for p in pdps] == ["x0", "color"]
    assert m.permutation_importance(tf)[0]["variable"] == "x0"
    figs = [m.ice_plot(tf, "x0", nbins=5), m.pd_plot(tf, "color"),
            m.varimp_plot(), m.shap_summary_plot(tf),
            m.shap_explain_row_plot(tf, 3), m.learning_curve_plot(),
            EP.varimp_heatmap([m, cm]),
            EP.model_correlation_heatmap([m, cm], tf)]
    assert all(isinstance(f, Figure) for f in figs)
    bundle = h2o3_tpu_torch.explain(m, tf)
    assert {"varimp_plot", "shap_summary_plot", "pd_plots",
            "learning_curve_plot"} <= set(bundle)
    assert set(h2o3_tpu_torch.explain([m, cm], tf)) >= {
        "model_correlation_heatmap", "varimp_heatmap"}
    assert isinstance(h2o3_tpu_torch.explain_row(m, tf, 2)[
        "shap_explain_row_plot"], Figure)
    top = [r["variable"] for r in m.varimp()]
    assert set(m.explain(tf)["pd_plots"]) == set(top[:3])
    data = TEX.explain(m, tf, columns=2)
    assert list(data["partial_dependence"]) == top[:2]


def test_explain_data_without_matplotlib():
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "import numpy as np, h2o3_tpu_torch as h\n"
        "from h2o3_tpu_torch import explain_data as EX, explain_plots as EP\n"
        "h.init(device='cpu')\n"
        "f = h.Frame.from_dict({'a': np.arange(50.), "
        "'y': np.arange(50.) % 3})\n"
        "m = h.H2OGeneralizedLinearEstimator(lambda_=0.0)\n"
        "m.train(x=['a'], y='y', training_frame=f)\n"
        "assert len(EX.partial_dependence(m, f, 'a', 4)['grid']) == 4\n"
        "try:\n"
        "    EP.pd_plot(m, f, 'a')\n"
        "except ImportError:\n"
        "    print('no matplotlib: ImportError')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "no matplotlib: ImportError" in out.stdout
