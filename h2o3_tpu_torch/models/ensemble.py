"""Stacked ensemble of the port (h2o3_tpu/models/ensemble.py,
hex/ensemble/StackedEnsemble.java and Metalearners.java).

The base models must keep their cross-validation predictions
(`keep_cross_validation_predictions`); their holdout columns, bound side by
side, are the level-one frame: P(class 1) of a binomial model, every class
probability of a multinomial one, the prediction of a regression. The
level-one columns stay on the card: they are the CV frames' own Vecs, and
at scoring the base models' prediction columns. The metalearner trains on
that frame with the response: GLM at lambda 0 (non-negative for binomial
and regression) by default ("AUTO" or "glm"), or GBM, DRF or DeepLearning
as `metalearner_algorithm` says, each with `metalearner_params`.
"""

from __future__ import annotations

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models.model import ModelBase


class H2OStackedEnsembleEstimator(ModelBase):
    algo = "stackedensemble"
    _defaults = {
        "base_models": None, "metalearner_algorithm": "AUTO",
        "metalearner_nfolds": 0, "metalearner_params": None,
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + (
        ("metalearner_nfolds", 0,
         "the JAX ensemble never cross-validates its metalearner "
         "(h2o3_tpu/models/ensemble.py:23)"),)

    def _fit(self, frame: Frame):
        di = self._dinfo
        base = self.params.get("base_models") or []
        base = [DKV.get(b) if isinstance(b, str) else b for b in base]
        if not base:
            raise ValueError("stackedensemble requires base_models")
        self._base = base
        names, vecs = [], []
        for m in base:
            cvk = m._output.cv_predictions_key
            if cvk is None:
                raise ValueError(f"base model {m.key} lacks "
                                 "keep_cross_validation_predictions")
            self._add_columns(names, vecs, m, DKV.get(cvk).vecs)
        l1 = Frame(names + [di.response_name],
                   vecs + [frame.vec(di.response_name)])
        meta = self._metalearner()
        meta.train(y=di.response_name, training_frame=l1)
        self._meta = meta
        DKV.remove(l1.key)
        self._output.model_summary = {
            "base_models": [m.key for m in base], "metalearner": meta.algo}

    def _add_columns(self, names, vecs, m, cols):
        """One base model's level-one columns from its probability (or
        prediction) columns."""
        if self._is_classifier and self.nclasses == 2:
            names.append(m.key)
            vecs.append(cols[-1])
        elif self._is_classifier:
            names += [f"{m.key}_p{k}" for k in range(len(cols))]
            vecs += list(cols)
        else:
            names.append(m.key)
            vecs.append(cols[0])

    def _metalearner(self) -> ModelBase:
        algo = (self.params.get("metalearner_algorithm") or "AUTO").lower()
        mp = dict(self.params.get("metalearner_params") or {})
        if algo in ("auto", "glm"):
            from h2o3_tpu_torch.models.glm import \
                H2OGeneralizedLinearEstimator
            mp.setdefault("lambda_", 0.0)
            if not self._is_classifier or self.nclasses == 2:
                mp.setdefault("non_negative", True)
            return H2OGeneralizedLinearEstimator(**mp)
        if algo == "gbm":
            from h2o3_tpu_torch.models.tree.gbm import \
                H2OGradientBoostingEstimator
            return H2OGradientBoostingEstimator(**mp)
        if algo == "drf":
            from h2o3_tpu_torch.models.tree.drf import \
                H2ORandomForestEstimator
            return H2ORandomForestEstimator(**mp)
        if algo == "deeplearning":
            from h2o3_tpu_torch.models.deeplearning import \
                H2ODeepLearningEstimator
            return H2ODeepLearningEstimator(**mp)
        raise ValueError(f"metalearner {algo}")

    def _level_one(self, test: Frame, with_response: bool = False) -> Frame:
        names, vecs = [], []
        for m in self._base:
            p = m.predict(test)
            DKV.remove(p.key)
            # predict's columns: the label, then one per class
            self._add_columns(names, vecs, m, p.vecs[1:]
                              if m._is_classifier else p.vecs)
        if with_response:
            names.append(self._dinfo.response_name)
            vecs.append(test.vec(self._dinfo.response_name))
        return Frame(names, vecs)

    def predict(self, test_data: Frame) -> Frame:
        l1 = self._level_one(test_data)
        out = self._meta.predict(l1)
        DKV.remove(l1.key)
        return out

    def _compute_metrics(self, frame: Frame):
        l1 = self._level_one(frame, with_response=True)
        m = self._meta._compute_metrics(l1)
        DKV.remove(l1.key)
        return m

