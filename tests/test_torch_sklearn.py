"""sklearn/ of the port against the JAX package's, on the CPU (the port's
cloud after `h2o3_tpu_torch.init(device="cpu")`): the same scikit-learn
calls on the same 600 seeded numpy rows through both packages' adapters.

- a `Pipeline` (StandardScaler, then the GLM classifier): probabilities
  within 1e-5 of the JAX adapter's, the classes the labels given;
- `GridSearchCV` (2 folds, 2 points of lambda) over the GLM regressor:
  the same best point, its CV scores and predictions within 1e-5;
- the KMeans transformer and the target-encoding transformer: labels
  equal, encodings within 1e-5;
- the sklearn protocol of every generated adapter: the same class names,
  `get_params` keys, `set_params` refusing an unknown name, `clone`.

GBM adapters are not refit here: one JAX GBM fit costs seconds on the
CPU; the binned GBM's twins are in the estimators' tests.
"""

import numpy as np
import pytest
from sklearn.base import clone
from sklearn.model_selection import GridSearchCV
from sklearn.pipeline import Pipeline
from sklearn.preprocessing import StandardScaler

import h2o3_tpu_torch
import h2o3_tpu.sklearn as JS
import h2o3_tpu_torch.sklearn as TS
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu_torch.core.kvstore import DKV as TDKV

TOL = 1e-5


@pytest.fixture(scope="module")
def xy():
    h2o3_tpu_torch.init(device="cpu")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=600) > 0)
    return X, np.where(y, "yes", "no")


@pytest.fixture(autouse=True)
def _clean_stores():
    j_before, t_before = set(JDKV.keys()), set(TDKV.keys())
    yield
    for k in set(JDKV.keys()) - j_before:
        JDKV.remove(k)
    for k in set(TDKV.keys()) - t_before:
        TDKV.remove(k)


def test_pipeline_glm_classifier(xy):
    X, y = xy
    out = {}
    for S in (JS, TS):
        p = Pipeline([("sc", StandardScaler()),
                      ("m", S.H2OGeneralizedLinearClassifier(
                          family="binomial", lambda_=0.0))]).fit(X, y)
        out[S] = (p.predict_proba(X), p.predict(X), p.classes_)
    (jp, jl, jc), (tp, tl, tc) = out[JS], out[TS]
    assert list(tc) == list(jc) == ["no", "yes"]
    assert np.abs(tp - jp).max() <= TOL
    assert np.array_equal(tl, jl)


def test_grid_search_glm_regressor(xy):
    X, y = xy
    target = X[:, 0] * 2.0 - X[:, 2] + 0.1 * np.arange(600) / 600
    out = {}
    for S in (JS, TS):
        g = GridSearchCV(S.H2OGeneralizedLinearRegressor(family="gaussian"),
                         {"lambda_": [0.0, 0.5]}, cv=2).fit(X, target)
        out[S] = (g.best_params_, g.cv_results_["mean_test_score"],
                  g.predict(X))
    (jb, js, jp), (tb, ts, tp) = out[JS], out[TS]
    assert tb == jb
    assert np.abs(ts - js).max() <= TOL
    assert np.abs(tp - jp).max() <= TOL * max(np.abs(jp).max(), 1.0)


def test_kmeans_and_target_encoder_transformers(xy):
    X, y = xy
    rng = np.random.default_rng(3)
    cats = rng.integers(0, 6, (600, 1)).astype(float)
    num = (cats[:, 0] * 0.3 + rng.normal(size=600) > 0.8).astype(float)
    out = {}
    for S in (JS, TS):
        km = S.H2OKMeansEstimator(k=3, seed=1, standardize=True)
        labels = km.fit(X[:, :2]).transform(X[:, :2])
        te = S.H2OTargetEncoderTransformer()
        enc = te.fit(cats, num).transform(cats)
        out[S] = (labels, enc)
    (jl, je), (tl, te_) = out[JS], out[TS]
    assert np.array_equal(tl, jl)
    assert tl.shape == (600, 1) and te_.shape == je.shape
    assert np.abs(te_ - je).max() <= TOL


def test_adapter_protocol():
    assert sorted(TS.__all__) == sorted(JS.__all__)
    for name in TS.__all__:
        tcls, jcls = getattr(TS, name), getattr(JS, name)
        if name.startswith("H2OAutoML"):
            assert set(tcls._known_params()) == set(jcls._known_params())
            continue
        t, j = tcls(), jcls()
        assert set(t.get_params()) == set(j.get_params()), name
        with pytest.raises(ValueError, match="unknown parameters"):
            t.set_params(bogus_param=1)
    g = TS.H2OGradientBoostingClassifier(ntrees=3, max_depth=2)
    c = clone(g)
    assert type(c) is type(g) and c.get_params() == g.get_params()
    assert c._h2o_class is h2o3_tpu_torch.H2OGradientBoostingEstimator
