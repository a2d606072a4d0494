"""The isolation forest of the port against the JAX package's, on the CPU.

The same numpy frame, made from a seed, goes to both packages, and the
port gets the JAX package's draws (`test_torch_draws.JaxDraws`, scheme
tree3: each tree's row sample, and each level's column and threshold
draws). Tolerances: trees node for node (col and thr bit for bit: the
ranges are exact and the threshold is the same fused multiply-add), node
values (depth + c(n), through f32 log) within 1e-5, mean lengths and
scores within 1e-5.
"""

import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.models import metrics as TM
from test_torch_adaptive import _np, same_trees
from test_torch_draws import replay

TOL = 1e-5
PARAMS = dict(ntrees=8, max_depth=6, sample_size=64, seed=3)


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _frames(n=900, C=5, seed=2, n_out=30):
    """N(0,1) rows with 3% NA and `n_out` planted outliers (the last rows,
    shifted by 4 in two columns). Returns (jax frame, port frame, labels)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, C))
    X[n - n_out:, :2] += 4.0
    X[rng.random((n, C)) < 0.03] = np.nan
    names = [f"x{j}" for j in range(C)]
    jf = JFrame.from_dict({c: X[:, j] for j, c in enumerate(names)})
    tf = Frame(names, [Vec.from_numpy(X[:, j]) for j in range(C)])
    return jf, tf, (np.arange(n) >= n - n_out).astype(np.float32)


@pytest.fixture(scope="module")
def forests(port_cpu):
    jf, tf, lab = _frames()
    jm = JMODELS.H2OIsolationForestEstimator(**PARAMS)
    jm.train(training_frame=jf)
    tm = replay(h2o3_tpu_torch.H2OIsolationForestEstimator(**PARAMS),
                PARAMS["seed"], jf.padded_len, "tree3")
    tm.train(training_frame=tf)
    return jf, tf, lab, jm, tm


def test_isolation_trees_match_jax(forests):
    """Every tree node for node with the same draws, the sample size, and
    the observed range of mean path lengths within 1e-5."""
    jf, tf, _, jm, tm = forests
    same_trees(tm._trees, jm._trees)
    assert int((_np(tm._trees.col) >= 0).sum()) > 100
    assert tm._psi == jm._psi == 64
    assert tm._min_len == pytest.approx(jm._min_len, abs=TOL)
    assert tm._max_len == pytest.approx(jm._max_len, abs=TOL)
    assert tm.summary()["sample_size"] == 64


def test_isolation_scores_match_jax(forests):
    """predict's two columns (score, mean_length) within 1e-5 of the JAX
    package's; the planted outliers score high (the AUC of the score
    against the labels is 0.867 with these 8 trees: above 0.8); no
    training metrics (unsupervised)."""
    jf, tf, lab, jm, tm = forests
    tp, jp = tm.predict(tf), jm.predict(jf)
    assert tp.names == jp.names == ["predict", "mean_length"]
    np.testing.assert_allclose(tp.to_numpy(), jp.to_numpy()[: tf.nrows],
                               atol=TOL)
    auc = TM.binomial_metrics(torch.from_numpy(lab),
                              torch.from_numpy(tp.to_numpy()[:, 0])
                              .float()).auc
    assert auc > 0.8
    assert tm._output.training_metrics is None
    assert jm._output.training_metrics is None


def test_isolation_forest_carried_across_scores_the_same(forests):
    """convert.isofor_from_arrays with the JAX forest's trees, psi and
    min/max length: the same score and mean length within 1e-5."""
    jf, tf, _, jm, _ = forests
    t = jm._trees
    model = convert.isofor_from_arrays(
        col=_np(t.col), thr=_np(t.thr), na_left=_np(t.na_left),
        value=_np(t.value), depth=t.depth, psi=jm._psi,
        min_len=jm._min_len, max_len=jm._max_len,
        predictors=jm._dinfo.predictors, domains=jm._dinfo.domains)
    np.testing.assert_allclose(model.predict(tf).to_numpy(),
                               jm.predict(jf).to_numpy()[: tf.nrows],
                               atol=TOL)
    assert model.summary()["number_of_trees"] == PARAMS["ntrees"]


def test_isolation_forest_sample_rate_and_seed(port_cpu):
    """sample_rate sets psi = rate * rows as in the JAX package; one seed
    grows the same forest twice; another seed another forest."""
    _, tf, _ = _frames(n=400)
    kw = dict(ntrees=4, max_depth=5, sample_rate=0.25)
    a = h2o3_tpu_torch.H2OIsolationForestEstimator(seed=1, **kw)
    a.train(training_frame=tf)
    b = h2o3_tpu_torch.H2OIsolationForestEstimator(seed=1, **kw)
    b.train(training_frame=tf)
    c = h2o3_tpu_torch.H2OIsolationForestEstimator(seed=2, **kw)
    c.train(training_frame=tf)
    assert a._psi == 100
    np.testing.assert_array_equal(_np(a._trees.thr), _np(b._trees.thr))
    assert not np.array_equal(_np(a._trees.thr), _np(c._trees.thr))
