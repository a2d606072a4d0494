"""AutoML of the port against the JAX package's, on the CPU.

- the step plan: names, estimator classes and parameters equal the JAX
  `_steps` for several seeds;
- a run (GLM and GBM, 4 models, 2 folds): the leaderboard is sorted by
  its metric, every base model equals, bit for bit (trees, coefficients),
  the same estimator trained alone in the port with the step's
  parameters and folds, and each stacked ensemble's metalearner fits the
  base models' holdout predictions;
- the deterministic steps (GLM_1, GBM_3: no row or column sampling) give
  the JAX package's CV AUC for the same step trained there, on the same
  folds (and GLM_1 on the port's lambda path, as test_torch_glm.py hands
  it), within 1e-4 (f32 sums in another order through 60 trees);
- a run with `recovery_dir` stopped after its first model and resumed
  (its models gone from the store, reloaded from the directory) ends with
  the leaderboard of an uninterrupted run;
- target encoding as preprocessing encodes the high-cardinality column.
"""

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu.models import glm as JGLM
from h2o3_tpu.automl import automl as JAML
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu_torch.automl import automl as TAML
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV
from test_torch_genmodel import X, columns

RUN = dict(include_algos=["GLM", "GBM"], max_models=4, nfolds=2, seed=1)


@pytest.fixture(scope="module")
def frames():
    h2o3_tpu_torch.init(device="cpu")
    cols = columns(n=300, seed=51)
    yield JFrame.from_dict(cols), Frame.from_dict(cols)
    h2o3_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def run(frames):
    _, tf = frames
    aml = h2o3_tpu_torch.automl(project_name="aml_run", **RUN)
    aml.train(x=X, y="y", training_frame=tf)
    return aml


@pytest.mark.parametrize("seed", [-1, 1, 7])
def test_step_plan_equals_jax(seed):
    got, want = TAML._steps(seed), JAML._steps(seed)
    assert [(n, c.__name__, c.algo, p) for n, c, p in got] \
        == [(n, c.__name__, c.algo, p) for n, c, p in want]


def _same_model(a, b):
    assert a.algo == b.algo
    if a.algo == "glm":
        np.testing.assert_array_equal(a._state.beta, b._state.beta)
        return
    for f in ("col", "thr", "na_left", "value"):
        assert np.array_equal(getattr(a._trees, f).numpy(),
                              getattr(b._trees, f).numpy()), f


def test_leaderboard_models_equal_their_estimators_alone(frames, run):
    _, tf = frames
    rows = run.leaderboard_obj.as_list()
    aucs = [r["auc"] for r in rows]
    assert aucs == sorted(aucs, reverse=True)
    steps = {n: (c, p) for n, c, p in TAML._steps(RUN["seed"])}
    base = [(r["step"], m) for r, m in run.leaderboard_obj.rows
            if r["step"] in steps]
    assert sorted(s for s, _ in base) == ["GBM_1", "GBM_2", "GBM_3",
                                          "GLM_1"]
    for step, m in base:
        cls, params = steps[step]
        params = {"seed": RUN["seed"], **params}    # GLM_1: the run's seed
        alone = cls(**params, nfolds=RUN["nfolds"],
                    keep_cross_validation_predictions=True,
                    model_id=f"alone_{step}")
        alone.train(x=X, y="y", training_frame=tf)
        _same_model(m, alone)
        assert m._output.cross_validation_metrics.auc \
            == alone._output.cross_validation_metrics.auc
    ses = [m for r, m in run.leaderboard_obj.rows
           if r["step"].startswith("StackedEnsemble")]
    assert len(ses) == 2
    best = max(m._output.cross_validation_metrics.auc for _, m in base)
    for se in ses:
        # the metalearner's fit is on the holdout predictions: the
        # ensemble's cross-validated AUC
        assert se._meta._output.training_metrics.auc >= best - 0.01
    assert run.leader is run.leaderboard_obj.rows[0][1]


def _jax_on_port_lambda_path(monkeypatch):
    """The JAX GLM's lambda search on the port's path: its lambda_max over
    the fit's Σw (the JAX package leaves the Σw out; ROADMAP §3)."""
    glm = JGLM.H2OGeneralizedLinearEstimator
    fit, path = glm._fit_irls, glm._alpha_lambda

    def fit_irls(self, Xi, y, w, job):
        self._wsum = float(np.asarray(w, np.float64).sum())
        return fit(self, Xi, y, w, job)

    def alpha_lambda(self, G, q, p_pen):
        alpha, lams = path(self, G, q, p_pen)
        if self.params.get("lambda_search"):
            lams = [lam / self._wsum for lam in lams]
        return alpha, lams
    monkeypatch.setattr(glm, "_fit_irls", fit_irls)
    monkeypatch.setattr(glm, "_alpha_lambda", alpha_lambda)


def test_deterministic_steps_match_jax_cv_metric(frames, run, monkeypatch):
    jf, _ = frames
    _jax_on_port_lambda_path(monkeypatch)
    steps = {n: (c, p) for n, c, p in JAML._steps(RUN["seed"])}
    ours = {r["step"]: r["auc"] for r in run.leaderboard_obj.as_list()}
    for step in ("GLM_1", "GBM_3"):
        cls, params = steps[step]
        # the JAX run leaves GLM_1 unseeded (random folds); the port's
        # gives it the run's seed, and so does this JAX fit
        params = {"seed": RUN["seed"], **params}
        jm = cls(**params, nfolds=RUN["nfolds"],
                 keep_cross_validation_predictions=True,
                 model_id=f"jax_{step}")
        jm.train(x=X, y="y", training_frame=jf)
        assert abs(ours[step] - jm._output.cross_validation_metrics.auc) \
            < 1e-4, step


def _rows(aml):
    return [{k: v for k, v in r.items() if k != "model_id"}
            for r in aml.leaderboard_obj.as_list()]


def test_recovery_resumes_to_the_same_leaderboard(frames, tmp_path):
    _, tf = frames
    kw = dict(include_algos=["GLM", "GBM"], nfolds=2, seed=3)
    rdir = str(tmp_path / "rec")
    first = h2o3_tpu_torch.automl(project_name="aml_rec", max_models=1,
                                  recovery_dir=rdir, **kw)
    first.train(x=X, y="y", training_frame=tf)
    done = [m.key for _, m in first.leaderboard_obj.rows]
    assert done == ["aml_rec_GLM_1"]
    for key in done:               # the killed process's store is gone
        DKV.remove(key)
    resumed = h2o3_tpu_torch.automl(project_name="aml_rec", max_models=2,
                                    recovery_dir=rdir, **kw)
    resumed.train(x=X, y="y", training_frame=tf)
    assert any(e["message"] == "recovered GLM_1" for e in resumed.event_log)
    whole = h2o3_tpu_torch.automl(project_name="aml_whole", max_models=2,
                                  **kw)
    whole.train(x=X, y="y", training_frame=tf)
    assert _rows(resumed) == _rows(whole)
    assert [r["step"] for r in _rows(whole)][-1] in ("GLM_1", "GBM_1")


def test_target_encoding_preprocessing(frames):
    rng = np.random.default_rng(52)
    cols = columns(n=300, seed=53)
    cols["zip"] = np.array([f"z{i}" for i in rng.integers(0, 40, 300)],
                           object)
    tf = Frame.from_dict(cols)
    aml = h2o3_tpu_torch.automl(project_name="aml_te", max_models=1,
                                nfolds=2, seed=5, include_algos=["GLM"],
                                preprocessing=["target_encoding"])
    aml.train(x=X + ["zip"], y="y", training_frame=tf)
    assert aml.te_model is not None
    assert "zip_te" in aml.leader._dinfo.predictors
    assert aml.leader._output.cross_validation_metrics.auc > 0.6
    assert aml.predict(tf).nrows == 300
