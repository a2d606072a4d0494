"""UDFs and jobs of the port against the JAX package, on the CPU.

A UDF exists twice here: in jax.numpy for the JAX package and in torch
for the port (each package calls its UDFs on its own arrays). Tolerances:
a custom metric within 1e-6 relative of the JAX package's value and of
the built-in logloss (the same per-row values folded in the same pairwise
order, through log functions that differ in the last bit); a custom
gaussian distribution's GBM on the adaptive engine node for node as the
JAX package's (`test_torch_adaptive.same_trees`: splits equal, values
within 1e-5) and predictions within 1e-5; against the port's own
`distribution="gaussian"` the same trees bit for bit where every leaf
lies on the last level.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu import udf as judf
from h2o3_tpu_torch import udf as tudf
from h2o3_tpu_torch.core import jobs
from h2o3_tpu_torch.core.kvstore import DKV
from test_torch_adaptive import frames as adaptive_frames
from test_torch_adaptive import same_trees
from test_torch_draws import replay


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


# ---- UDFs, twice --------------------------------------------------------
class JaxLogloss(judf.CustomMetric):
    name = "logloss"

    def map(self, pred, y, w):
        p = jnp.clip(pred[:, 1], 1e-15, 1 - 1e-15)
        return (-w * (y * jnp.log(p) + (1 - y) * jnp.log(1 - p)), w)

    def metric(self, agg):
        return float(agg[0] / agg[1])


class TorchLogloss(tudf.CustomMetric):
    name = "logloss"

    def map(self, pred, y, w):
        p = pred[:, 1].clamp(1e-15, 1 - 1e-15)
        return (-w * (y * torch.log(p) + (1 - y) * torch.log(1 - p)), w)

    def metric(self, agg):
        return float(agg[0] / agg[1])


class JaxLoglossSums(JaxLogloss):
    """Pre-aggregated: map returns the sums, reduce is skipped."""

    def map(self, pred, y, w):
        num, den = JaxLogloss.map(self, pred, y, w)
        return (num.sum(), den.sum())


class TorchLoglossSums(TorchLogloss):
    def map(self, pred, y, w):
        num, den = TorchLogloss.map(self, pred, y, w)
        return (num.sum(), den.sum())


class JaxGaussian(judf.CustomDistribution):
    def grad_hess(self, F, y):
        return y - F, jnp.ones_like(F)


class TorchGaussian(tudf.CustomDistribution):
    def grad_hess(self, F, y):
        return y - F, torch.ones_like(F)


@pytest.mark.parametrize("form", ["map_reduce", "pre_aggregated"])
def test_custom_metric_matches_jax(port_cpu, form):
    """A custom logloss on a binomial GLM's training metrics: the JAX
    value, and the built-in logloss of the port."""
    jf, tf = adaptive_frames("binomial", n=701)       # odd: a carried row
    jcls, tcls = ((JaxLogloss, TorchLogloss) if form == "map_reduce"
                  else (JaxLoglossSums, TorchLoglossSums))
    jref = judf.register_udf(f"ll_{form}", jcls())
    tref = tudf.register_udf(f"ll_{form}", tcls())
    assert tref == jref == f"python:ll_{form}"
    jm = JMODELS.H2OGeneralizedLinearEstimator(lambda_=0.0,
                                               custom_metric_func=jref)
    jm.train(y="y", training_frame=jf)
    tm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(
        lambda_=0.0, custom_metric_func=tref)
    tm.train(y="y", training_frame=tf)
    tc = tm._output.training_metrics.custom_metric
    jc = jm._output.training_metrics.custom_metric
    assert tc["name"] == jc["name"] == "logloss"
    np.testing.assert_allclose(tc["value"], jc["value"], rtol=1e-6)
    np.testing.assert_allclose(tc["value"], tm.logloss(), rtol=1e-6)


def test_custom_metric_folds_rows_pairwise():
    """The fold halves the rows pairwise, carrying an odd last row, and
    ends at one aggregate per component."""
    from h2o3_tpu_torch.models.model import _fold_custom_metric
    calls = []

    class Count(tudf.CustomMetric):
        def reduce(self, l, r):
            calls.append(l[0].shape[0])
            return tuple(a + b for a, b in zip(l, r))

    x = torch.arange(7, dtype=torch.float32)
    agg = _fold_custom_metric(Count(), (x, 2 * x))
    assert [float(a) for a in agg] == [21.0, 42.0]
    assert calls == [3, 2, 1]
    assert float(_fold_custom_metric(Count(), x)) == 21.0
    assert _fold_custom_metric(Count(), (torch.tensor(3.0),))[0] == 3.0


def test_register_and_resolve_udf(port_cpu):
    obj = TorchGaussian()
    ref = tudf.register_udf("dist_g", obj)
    assert ref == "python:dist_g"
    assert tudf.resolve_udf(ref) is obj
    assert tudf.resolve_udf("dist_g") is obj
    assert tudf.resolve_udf(obj) is obj
    with pytest.raises(KeyError, match="no UDF"):
        tudf.resolve_udf("python:missing")
    with pytest.raises(TypeError):
        tudf.resolve_udf(3)
    tudf.remove_udf("dist_g")
    with pytest.raises(KeyError):
        tudf.resolve_udf(ref)


def test_custom_distribution_gbm_matches_jax(port_cpu):
    """A gaussian UDF (y - F, ones, identity) at depth 4 on the adaptive
    engine (the binned gate turns a custom distribution away), with the
    JAX package's draws: trees node for node and predictions as the JAX
    package's; and the same trees bit for bit as the port's own
    distribution="gaussian" here, where every leaf lies on the last
    level (a leaf that stops above it takes the custom path's Newton
    refit from exact sums, and may differ in its last bits from the
    gaussian path's f32 sum of its histogram bins)."""
    jf, tf = adaptive_frames("regression")
    kw = dict(ntrees=4, max_depth=4, min_rows=5, seed=1, learn_rate=0.3,
              histogram_type="UniformAdaptive")
    jm = JMODELS.H2OGradientBoostingEstimator(
        distribution="custom",
        custom_distribution_func=judf.register_udf("g", JaxGaussian()), **kw)
    jm.train(y="y", training_frame=jf)
    models = {}
    for dist in ("custom", "gaussian"):
        tm = h2o3_tpu_torch.H2OGradientBoostingEstimator(
            distribution=dist,
            custom_distribution_func=tudf.register_udf("g", TorchGaussian()),
            **kw)
        replay(tm, 1, jf.padded_len, "tree4")
        models[dist] = tm.train(y="y", training_frame=tf)
    tm = models["custom"]
    assert tm.summary()["engine"] == "adaptive"
    assert tm.summary()["distribution"] == "custom"
    np.testing.assert_allclose(tm._f0, jm._f0, atol=1e-6)
    same_trees(tm._trees, jm._trees)
    np.testing.assert_allclose(tm.predict(tf).to_numpy()[:, 0],
                               jm.predict(jf).to_numpy()[:, 0], atol=1e-5)
    g = models["gaussian"]
    for f in ("col", "thr", "na_left", "value"):
        assert torch.equal(getattr(tm._trees, f), getattr(g._trees, f)), f
    assert torch.equal(tm._score_matrix(tm._dinfo.matrix(tf)),
                       g._score_matrix(g._dinfo.matrix(tf)))


# ---- jobs ---------------------------------------------------------------
def test_job_runs_in_the_background_and_publishes(port_cpu):
    started = threading.Event()

    def work(job):
        started.wait(5)
        job.update(0.5, "half")
        return "built"

    j = jobs.Job("bg", dest="built_result")
    assert j.status == jobs.CREATED
    j.start(work, background=True)
    assert j.status == jobs.RUNNING
    started.set()
    assert j.join(5) == "built"
    assert j.status == jobs.DONE and j.progress == 1.0
    assert j.progress_msg == "half" and DKV.get("built_result") == "built"
    d = j.to_dict()
    assert d["status"] == "DONE" and d["exception"] is None
    assert any(r["key"] == j.key for r in jobs.jobs_list())


def test_job_captures_a_failure(port_cpu):
    def work(job):
        raise ValueError("bad build")

    j = jobs.Job("fails").start(work, background=True)
    with pytest.raises(ValueError, match="bad build"):
        j.join(5)
    assert j.status == jobs.FAILED and "bad build" in j.traceback
    assert "ValueError" in j.to_dict()["exception"]


def test_job_cancel_and_deadline(port_cpu):
    go = threading.Event()

    def work(job):
        go.wait(5)
        for _ in range(1000):
            job.update(0.1)
            time.sleep(0.001)
        return "never"

    j = jobs.Job("cancel").start(work, background=True)
    j.stop()
    go.set()
    assert j.join(5) is None
    assert j.status == jobs.CANCELLED and j.stop_requested and j.is_done
    d = jobs.Job("deadline")
    d.deadline = time.time() - 1.0
    assert not d.budget_exhausted
    d.update(0.2)
    assert d.budget_exhausted
    with d.phase("grow"):
        pass
    assert "grow" in d.to_dict()["phases"]


def test_train_runs_through_a_job(port_cpu):
    """A model's train() runs its build as a job that ends DONE with the
    model in the DKV under the model's key."""
    _, tf = adaptive_frames("binomial", n=300)
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(lambda_=0.0)
    m.train(y="y", training_frame=tf)
    assert m._job.status == jobs.DONE and m._job.dest == m.key
    assert DKV.get(m.key) is m
