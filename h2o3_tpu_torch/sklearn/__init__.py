"""sklearn-compatible estimator surface (h2o-py/h2o/sklearn/__init__.py).

The reference generates ~60 wrapper classes (one Classifier / Regressor /
Estimator triple per algo, plus AutoML and the TargetEncoder transformer)
so h2o models drop into sklearn ``Pipeline`` / ``GridSearchCV``. Same
surface here, generated over the native TPU estimators::

    from h2o3_tpu_torch.sklearn import H2OGradientBoostingClassifier
    clf = H2OGradientBoostingClassifier(ntrees=20)
    GridSearchCV(clf, {"max_depth": [3, 5]}).fit(X, y)
"""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch import models as _m
from h2o3_tpu_torch.sklearn.wrapper import (
    BaseH2OAdapter, H2OClassifierAdapter, H2ORegressorAdapter,
    H2OTransformerAdapter, _to_frame)

# (public stem, native class, supervised?) — mirrors the reference's
# gen_models table in h2o/sklearn/__init__.py
_SUPERVISED = [
    ("H2OGradientBoosting", _m.H2OGradientBoostingEstimator),
    ("H2ORandomForest", _m.H2ORandomForestEstimator),
    ("H2OGeneralizedLinear", _m.H2OGeneralizedLinearEstimator),
    ("H2ODeepLearning", _m.H2ODeepLearningEstimator),
    ("H2OXGBoost", _m.H2OXGBoostEstimator),
    ("H2ONaiveBayes", _m.H2ONaiveBayesEstimator),
    ("H2ORuleFit", _m.H2ORuleFitEstimator),
    ("H2OGeneralizedAdditive", _m.H2OGeneralizedAdditiveEstimator),
    ("H2OSupportVectorMachine", _m.H2OSupportVectorMachineEstimator),
    ("H2OStackedEnsemble", _m.H2OStackedEnsembleEstimator),
]
_UNSUPERVISED = [
    ("H2OKMeans", _m.H2OKMeansEstimator),
    ("H2OPrincipalComponentAnalysis", _m.H2OPrincipalComponentAnalysisEstimator),
    ("H2OSingularValueDecomposition", _m.H2OSingularValueDecompositionEstimator),
    ("H2OGeneralizedLowRank", _m.H2OGeneralizedLowRankEstimator),
    ("H2OIsolationForest", _m.H2OIsolationForestEstimator),
    ("H2OExtendedIsolationForest", _m.H2OExtendedIsolationForestEstimator),
    ("H2OAggregator", _m.H2OAggregatorEstimator),
]

__all__ = []


def _make(stem: str, base, native, classification):
    cls = type(stem, (base,), {
        "_h2o_class": native,
        "_classification": classification,
        "__doc__": (f"sklearn adapter over h2o3_tpu_torch.models."
                    f"{native.__name__} (algo '{native.algo}').\n\n"
                    f"Accepts every native parameter as a keyword; see "
                    f"``{native.__name__}`` for parameter docs."),
        "__module__": __name__,
    })
    globals()[stem] = cls
    __all__.append(stem)
    return cls


for _stem, _cls in _SUPERVISED:
    _make(_stem + "Classifier", H2OClassifierAdapter, _cls, True)
    _make(_stem + "Regressor", H2ORegressorAdapter, _cls, False)
    _make(_stem + "Estimator", H2ORegressorAdapter, _cls, False)

for _stem, _cls in _UNSUPERVISED:
    _make(_stem + "Estimator", H2OTransformerAdapter, _cls, None)

# NaiveBayes / SVM only classify in the reference; their Regressor shims
# are therefore withdrawn from the public list
for _name in ("H2ONaiveBayesRegressor", "H2ONaiveBayesEstimator",
              "H2OSupportVectorMachineRegressor"):
    globals().pop(_name, None)
    __all__.remove(_name)


class H2OTargetEncoderTransformer(H2OTransformerAdapter):
    """CV-safe categorical target encoding as a sklearn transformer
    (ai/h2o/targetencoding via h2o/sklearn H2OTargetEncoderEstimator)."""
    _h2o_class = _m.H2OTargetEncoderEstimator
    _classification = False

    def fit(self, X, y=None, **kw):
        frame, names = _to_frame(X)
        self._feature_names = names
        if y is not None:
            frame["__te_y__"] = np.asarray(y, np.float64)
        est = self._h2o_class(**self._params)
        est.train(x=names, y="__te_y__", training_frame=frame)
        self.estimator_ = est
        return self

    def transform(self, X):
        frame, _ = _to_frame(X, self._feature_names)
        out = self.estimator_.transform(frame)
        cols = [c for c in out.names if c != "__te_y__"]
        return np.column_stack([out.vec(c).to_numpy() for c in cols])


__all__.append("H2OTargetEncoderTransformer")


class H2OAutoMLClassifier(H2OClassifierAdapter):
    """AutoML leader as a sklearn classifier (h2o/sklearn H2OAutoML*)."""
    _classification = True

    @classmethod
    def _known_params(cls):
        from h2o3_tpu_torch.automl.automl import H2OAutoML
        import inspect
        sig = inspect.signature(H2OAutoML.__init__)
        return {k: p.default for k, p in sig.parameters.items()
                if k != "self" and p.default is not inspect.Parameter.empty}

    def fit(self, X, y=None, **fit_params):
        from h2o3_tpu_torch.automl.automl import H2OAutoML
        from h2o3_tpu_torch.core.frame import Vec
        from h2o3_tpu_torch.sklearn.wrapper import _RESPONSE
        frame, names = _to_frame(X)
        self._feature_names = names
        y = np.asarray(y).ravel()
        if self._classification:
            self.classes_ = np.unique(y)
            frame[_RESPONSE] = Vec.from_numpy(
                np.array([str(v) for v in y], object))
        else:
            frame[_RESPONSE] = np.asarray(y, np.float64)
        aml = H2OAutoML(**self._params)
        aml.train(x=names, y=_RESPONSE, training_frame=frame, **fit_params)
        self.automl_ = aml
        self.estimator_ = aml.leader
        return self


class H2OAutoMLRegressor(H2OAutoMLClassifier, H2ORegressorAdapter):
    _classification = False


__all__ += ["H2OAutoMLClassifier", "H2OAutoMLRegressor"]
