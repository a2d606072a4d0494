"""The extended isolation forest of the port against the JAX package's, on
the CPU.

The same numpy frame, made from a seed, goes to both packages, and the
port gets the JAX package's draws (`test_torch_draws.JaxDraws`, scheme
tree3: each tree's row sample; each level's normals, points and
dimension-mask uniforms). Tolerances: the hyperplane arrays (normals,
points) within 1e-6, the split flags equal, node values (depth + c(n),
through f32 log) within 1e-5; mean lengths and anomaly scores within
1e-5.
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
from test_torch_draws import replay

TOL = 1e-5
C = 5
PARAMS = dict(ntrees=6, sample_size=64, seed=3)


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _frames(n=700, seed=4, n_out=25):
    """N(0,1) rows with 3% NA and `n_out` planted outliers (the last rows,
    shifted by 4 in two columns). Returns (jax frame, port frame,
    labels)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, C))
    X[n - n_out:, :2] += 4.0
    X[rng.random((n, C)) < 0.03] = np.nan
    names = [f"x{j}" for j in range(C)]
    jf = JFrame.from_dict({c: X[:, j] for j, c in enumerate(names)})
    tf = Frame(names, [Vec.from_numpy(X[:, j]) for j in range(C)])
    return jf, tf, (np.arange(n) >= n - n_out).astype(np.float32)


@pytest.fixture(scope="module", params=[0, C - 1])
def forests(port_cpu, request):
    jf, tf, lab = _frames()
    p = dict(PARAMS, extension_level=request.param)
    jm = JMODELS.H2OExtendedIsolationForestEstimator(**p)
    jm.train(training_frame=jf)
    tm = replay(h2o3_tpu_torch.H2OExtendedIsolationForestEstimator(**p),
                p["seed"], jf.padded_len, "tree3")
    tm.train(training_frame=tf)
    return jf, tf, lab, jm, tm


def _np(a):
    return np.asarray(a.cpu().numpy() if torch.is_tensor(a) else a)


def test_eif_hyperplanes_match_jax(forests):
    """With the same draws: normals and points within 1e-6, the same
    split flags, node values within 1e-5; at extension_level 0 each
    split's normal has one nonzero entry, at C − 1 all C."""
    _, _, _, jm, tm = forests
    assert tm._D == jm._D == 6
    np.testing.assert_allclose(_np(tm._norms), _np(jm._norms), atol=1e-6)
    np.testing.assert_allclose(_np(tm._points), _np(jm._points), atol=1e-6)
    np.testing.assert_array_equal(_np(tm._dids), _np(jm._dids))
    np.testing.assert_allclose(_np(tm._vals), _np(jm._vals), atol=TOL)
    did = _np(tm._dids)
    assert did.sum() > 50
    nz = (_np(tm._norms)[did] != 0).sum(axis=1)
    ext = tm.summary()["extension_level"]
    assert set(nz.tolist()) == {ext + 1}
    assert tm._cn == pytest.approx(jm._cn, abs=1e-6)


def test_eif_scores_match_jax(forests):
    """predict's anomaly_score and mean_length within 1e-5 of the JAX
    package's; the planted outliers score high (AUC above 0.75 with
    these 6 trees)."""
    jf, tf, lab, jm, tm = forests
    tp, jp = tm.predict(tf), jm.predict(jf)
    assert tp.names == jp.names == ["anomaly_score", "mean_length"]
    np.testing.assert_allclose(tp.to_numpy(), jp.to_numpy()[: tf.nrows],
                               atol=TOL)
    auc = TM.binomial_metrics(torch.from_numpy(lab),
                              torch.from_numpy(tp.to_numpy()[:, 0])
                              .float()).auc
    assert auc > 0.75


def test_eif_carried_across_scores_the_same(forests):
    """convert.eif_from_arrays with the JAX forest's hyperplane trees and
    sample size: the same scores within 1e-5."""
    jf, tf, _, jm, _ = forests
    model = convert.eif_from_arrays(
        norms=_np(jm._norms), points=_np(jm._points), dids=_np(jm._dids),
        vals=_np(jm._vals), depth=jm._D, psi=64,
        predictors=jm._dinfo.predictors, domains=jm._dinfo.domains)
    np.testing.assert_allclose(model.predict(tf).to_numpy(),
                               jm.predict(jf).to_numpy()[: tf.nrows],
                               atol=TOL)
    assert model.summary()["number_of_trees"] == PARAMS["ntrees"]
