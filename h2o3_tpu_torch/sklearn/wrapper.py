"""scikit-learn adapter layer (h2o-py/h2o/sklearn/wrapper.py analog).

The reference wraps its REST estimators in sklearn-compatible shells so
they slot into ``Pipeline`` / ``GridSearchCV`` / ``cross_val_score``.
Here the native estimators already live in-process on the cloud's
device, so the adapter is thinner: convert ndarray/DataFrame inputs to
Frames, delegate to the native builder, and decode predictions back to
numpy.

Design notes vs sklearn's introspection contract:
- ``get_params``/``set_params`` are overridden (instead of relying on
  ``__init__``-signature inspection) because the wrapped parameter set
  is data-driven from each native estimator's ``_COMMON + _defaults``.
- ``clone()`` round-trips through ``type(self)(**params)``, which the
  kwargs ``__init__`` supports directly.
"""

from __future__ import annotations

import numpy as np
from sklearn.base import (BaseEstimator, ClassifierMixin, RegressorMixin,
                          TransformerMixin)

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.kvstore import DKV

_RESPONSE = "__sklearn_y__"


def _to_frame(X, feature_names=None) -> tuple:
    """ndarray / DataFrame / Frame -> (Frame, feature column names),
    the Frame on the cloud's device. pandas is only tried."""
    if isinstance(X, Frame):
        return X, list(X.names)
    try:
        import pandas as pd
        if isinstance(X, pd.DataFrame):
            cols = {str(c): X[c].to_numpy() for c in X.columns}
            f = Frame.from_dict(cols)
            return f, list(cols)
    except ImportError:
        pass
    X = np.asarray(X)
    if X.ndim == 1:
        X = X[:, None]
    names = feature_names or [f"x{i}" for i in range(X.shape[1])]
    f = Frame.from_dict({n: np.asarray(X[:, j], np.float64)
                         for j, n in enumerate(names)})
    return f, names


class BaseH2OAdapter(BaseEstimator):
    """Common fit/predict plumbing over a native h2o3_tpu_torch estimator."""

    _h2o_class = None          # native estimator class (set per subclass)
    _classification = None     # True / False / None (follow response type)

    def __init__(self, **params):
        self._params = dict(params)

    # ---- sklearn parameter protocol -------------------------------------
    @classmethod
    def _known_params(cls):
        c = cls._h2o_class
        return dict(getattr(c, "_COMMON", {}), **getattr(c, "_defaults", {}))

    def get_params(self, deep=True):
        out = self._known_params()
        out.update(self._params)
        return out

    def set_params(self, **params):
        unknown = set(params) - set(self._known_params())
        if unknown:
            raise ValueError(
                f"{type(self).__name__}: unknown parameters {sorted(unknown)}")
        self._params.update(params)
        return self

    # ---- fitting ---------------------------------------------------------
    def fit(self, X, y=None, **fit_params):
        frame, names = _to_frame(X)
        self._feature_names = names
        yname = None
        owns_frame = not isinstance(X, Frame)
        if not owns_frame and y is not None:
            # never mutate the caller's Frame: attach the response to a
            # fresh handle over the same vecs
            frame = Frame(list(frame.names), list(frame.vecs))
            owns_frame = True
        if y is not None and self._classification is not None:
            y = np.asarray(y).ravel()
            if self._classification:
                self.classes_ = np.unique(y)
                lbl = np.array([str(v) for v in y], object)
                frame[_RESPONSE] = Vec.from_numpy(lbl)
            else:
                frame[_RESPONSE] = np.asarray(y, np.float64)
            yname = _RESPONSE
        est = self._h2o_class(**self._params)
        est.train(x=names, y=yname, training_frame=frame, **fit_params)
        self.estimator_ = est
        if owns_frame:
            DKV.remove(frame.key)
        return self

    def _predict_frame(self, X) -> Frame:
        frame, _ = _to_frame(X, getattr(self, "_feature_names", None))
        out = self.estimator_.predict(frame)
        if not isinstance(X, Frame):
            DKV.remove(frame.key)
        return out

    def predict(self, X):
        out = self._predict_frame(X)
        v = out.vec("predict") if "predict" in out.names else out.vecs[0]
        vals = v.to_numpy()
        DKV.remove(out.key)
        if getattr(self, "classes_", None) is not None and v.levels():
            lut = {str(c): c for c in self.classes_}
            dom = v.levels()
            return np.array([lut[dom[int(i)]] for i in vals])
        return vals

    def __sklearn_is_fitted__(self):
        return hasattr(self, "estimator_")


class H2OClassifierAdapter(ClassifierMixin, BaseH2OAdapter):
    _classification = True

    def predict_proba(self, X):
        out = self._predict_frame(X)
        # prob columns follow the 'predict' column, one per domain level,
        # ordered by the model's response domain
        dom = self.estimator_._output.response_domain
        cols = [c for c in out.names if c != "predict"]
        probs = np.column_stack([out.vec(c).to_numpy() for c in cols])
        DKV.remove(out.key)
        # re-order to self.classes_ order
        order = [dom.index(str(c)) for c in self.classes_]
        return probs[:, order]

    def predict_log_proba(self, X):
        return np.log(self.predict_proba(X))


class H2ORegressorAdapter(RegressorMixin, BaseH2OAdapter):
    _classification = False


class H2OTransformerAdapter(TransformerMixin, BaseH2OAdapter):
    """Unsupervised estimators exposed as sklearn transformers: KMeans
    labels via predict, PCA/SVD/GLRM projections via transform."""
    _classification = None

    def transform(self, X):
        out = self._predict_frame(X)
        M = np.column_stack([v.to_numpy() for v in out.vecs])
        DKV.remove(out.key)
        return M

    def fit_transform(self, X, y=None, **kw):
        return self.fit(X, y, **kw).transform(X)
