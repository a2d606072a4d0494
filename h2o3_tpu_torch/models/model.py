"""Model framework of the port (h2o3_tpu/models/model.py): the design-matrix
codec `DataInfo` (label mode, as the tree models use it), `ModelOutput`,
and the estimator surface `ModelBase` (train, predict, metrics).

Training runs synchronously in the caller's thread. Cross-validation,
jobs, model monitoring and the serving cache are later slices; a parameter
that selects them raises NotImplementedError rather than being ignored.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, Vec, T_CAT
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models import metrics as M


# ===========================================================================
class DataInfo:
    """Design-matrix codec (hex/DataInfo.java) in "label" mode: categorical
    columns stay one numeric column of level ids, which the tree engine
    bins natively. The one-hot mode of the JAX package is a later slice."""

    def __init__(self, predictors: Sequence[str], cat_cols: Sequence[str],
                 domains: dict, response_name: Optional[str],
                 response_domain: Optional[list] = None,
                 weights_name: Optional[str] = None):
        self.cat_mode = "label"
        self.predictors = list(predictors)
        self.cat_cols = [c for c in self.predictors if c in set(cat_cols)]
        self.num_cols = [c for c in self.predictors if c not in self.cat_cols]
        self.domains = {c: list(domains[c]) for c in self.cat_cols}
        self.cardinalities = {c: len(self.domains[c]) for c in self.cat_cols}
        self.response_name = response_name
        self.response_domain = (list(response_domain)
                                if response_domain is not None else None)
        self.weights_name = weights_name
        self.feature_names = list(self.predictors)

    @staticmethod
    def from_frame(frame: Frame, x: Sequence[str], y: Optional[str],
                   weights: Optional[str] = None) -> "DataInfo":
        preds = [c for c in x if c != y and frame.vec(c).type != "str"]
        cats = [c for c in preds if frame.vec(c).type == T_CAT]
        rdom = None
        if y is not None and frame.vec(y).type == T_CAT:
            rdom = list(frame.vec(y).domain)
        return DataInfo(preds, cats, {c: frame.vec(c).domain for c in cats},
                        y, rdom, weights)

    def matrix(self, frame: Frame) -> torch.Tensor:
        """(nrows, n_features) f32 on the frame's device, NaN for NA."""
        return self.adapt(frame).matrix(self.predictors)

    def response(self, frame: Frame) -> torch.Tensor:
        """(nrows,) f32 response; class index for a categorical one."""
        return self.adapt(frame).matrix([self.response_name])[:, 0]

    def weights(self, frame: Frame) -> torch.Tensor:
        """(nrows,) f32 observation weights, 0 where the weight is NA."""
        if self.weights_name:
            w = frame.matrix([self.weights_name])[:, 0]
            return torch.where(torch.isnan(w), 0.0, w)
        return torch.ones(frame.nrows, dtype=torch.float32,
                          device=frame.vecs[0].device)

    def adapt(self, frame: Frame) -> Frame:
        """Model.adaptTestForTrain: remap categorical level ids to the
        training domains; a missing predictor becomes an all-NA column.
        Returns the frame itself when nothing needs adapting."""
        needed = list(self.predictors)
        if self.response_name and self.response_name in frame.names:
            needed.append(self.response_name)
        changed = False
        vecs = []
        dev = frame.vecs[0].device
        for c in needed:
            if c not in frame.names:
                v = Vec.from_numpy(np.full(frame.nrows, np.nan), device=dev)
                changed = True
            else:
                v = frame.vec(c)
                want = self.domains.get(c) or (
                    self.response_domain if c == self.response_name else None)
                if v.type == T_CAT and want is not None and v.levels() != want:
                    v = _remap_domain(v, want)
                    changed = True
                elif v.type == T_CAT and want is None and c in self.num_cols:
                    # numeric in training, categorical here: NA out
                    v = Vec.from_numpy(np.full(frame.nrows, np.nan),
                                       device=dev)
                    changed = True
            vecs.append(v)
        if not changed:
            return frame
        f = Frame(needed, vecs)
        DKV.remove(f.key)          # a transient product, not registered
        return f


def _remap_domain(v: Vec, want: list) -> Vec:
    lookup = {lvl: i for i, lvl in enumerate(want)}
    src = v.to_numpy()
    out = np.full(len(src), np.nan)
    for i, code in enumerate(src):
        if not math.isnan(code):
            out[i] = lookup.get(str(v.domain[int(code)]), np.nan)
    return Vec.from_numpy(out, type=T_CAT, domain=want, device=v.device)


# ===========================================================================
@dataclass
class ModelOutput:
    """hex/Model.Output: what the training run learned."""
    model_id: str = ""
    algo: str = ""
    names: list = field(default_factory=list)
    domains: dict = field(default_factory=dict)
    response_domain: Optional[list] = None
    training_metrics: Optional[object] = None
    validation_metrics: Optional[object] = None
    scoring_history: list = field(default_factory=list)
    model_summary: dict = field(default_factory=dict)
    variable_importances: Optional[list] = None
    run_time_ms: int = 0


class ModelBase:
    """Shared estimator/model surface (h2o-py H2OEstimator)."""

    algo = "base"
    supervised = True
    _defaults: dict = {}
    _COMMON = {
        "model_id": None, "seed": -1, "nfolds": 0, "weights_column": None,
        "offset_column": None, "fold_assignment": "AUTO", "fold_column": None,
        "ignored_columns": None, "ignore_const_cols": True,
        "max_runtime_secs": 0.0, "standardize": True,
        "categorical_encoding": "AUTO", "distribution": "AUTO",
        "checkpoint": None,
    }
    # parameters whose non-default values select code the port does not
    # have yet: (name, default, the JAX module that has it)
    _LATER = (("nfolds", 0, "model.py cross-validation"),
              ("fold_column", None, "model.py cross-validation"),
              ("offset_column", None, "model.py offsets"))

    def __init__(self, **params):
        self.params = dict(self._COMMON)
        self.params.update(self._defaults)
        unknown = set(params) - set(self.params)
        if unknown:
            raise ValueError(f"{self.algo}: unknown parameters "
                             f"{sorted(unknown)}")
        self.params.update(params)
        self._output: Optional[ModelOutput] = None
        self._dinfo: Optional[DataInfo] = None
        self.key: Optional[str] = None

    def _check_ported(self):
        for name, default, where in self._LATER:
            if (self.params.get(name) or default) != default:
                raise NotImplementedError(
                    f"{self.algo}: {name}={self.params[name]!r} is not "
                    f"ported yet (h2o3_tpu/models/{where})")

    # ---- public training entry point (H2OEstimator.train) ----------------
    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None, **overrides) -> "ModelBase":
        self.params.update(overrides)
        frame = training_frame
        if not isinstance(frame, Frame):
            raise TypeError("training_frame must be a Frame")
        if self.supervised and y is None:
            raise ValueError(f"{self.algo} requires a response column y")
        self._check_ported()
        x = self._resolve_predictors(frame, x, y)
        self._dinfo = DataInfo.from_frame(
            frame, x, y, weights=self.params.get("weights_column"))
        self.key = self.params.get("model_id") or DKV.make_key(self.algo)
        self._output = ModelOutput(model_id=self.key, algo=self.algo,
                                   names=list(x),
                                   domains=self._dinfo.domains,
                                   response_domain=self._dinfo.response_domain)
        t0 = time.time()
        # max_runtime_secs: a deadline that the trainers test at each chunk
        # boundary, after the chunk's history entry (Job.budget_exhausted)
        mrs = float(self.params.get("max_runtime_secs") or 0.0)
        self._deadline = t0 + mrs if mrs > 0 else None
        # the scoring history scores the validation frame when one is given
        # (ScoreKeeper and early stopping prefer its metrics)
        self._valid_for_scoring = validation_frame
        try:
            self._fit(frame)
            self._score_train_valid(frame, validation_frame)
        finally:
            # release the validation scoring state: its margins and matrix
            # would otherwise pin device memory for the model's lifetime
            self._vstate = None
            self._valid_for_scoring = None
        self._output.run_time_ms = int(1000 * (time.time() - t0))
        DKV.put(self.key, self)
        return self

    def _budget_exhausted(self) -> bool:
        """True once train()'s max_runtime_secs deadline has passed."""
        deadline = getattr(self, "_deadline", None)
        return deadline is not None and time.time() > deadline

    def _resolve_predictors(self, frame, x, y):
        if x is None:
            skip = {y, self.params.get("weights_column"),
                    self.params.get("offset_column"),
                    self.params.get("fold_column")}
            skip |= set(self.params.get("ignored_columns") or [])
            x = [c for c in frame.names if c not in skip]
        else:
            x = [frame.names[i] if isinstance(i, int) else i for i in x]
        if self.params.get("ignore_const_cols"):
            x = [c for c in x if not frame.vec(c).is_const()]
        return x

    # ---- algorithm hooks ---------------------------------------------------
    def _fit(self, frame: Frame):
        raise NotImplementedError

    def _score_matrix(self, X: torch.Tensor) -> torch.Tensor:
        """Batch score: regression predictions (n,) or class probs (n, K)."""
        raise NotImplementedError

    # ---- scoring / metrics -------------------------------------------------
    @property
    def _is_classifier(self) -> bool:
        return self.supervised and self._dinfo.response_domain is not None

    @property
    def nclasses(self) -> int:
        d = self._dinfo.response_domain if self._dinfo else None
        return len(d) if d else 1

    def predict(self, test_data: Frame) -> Frame:
        out = self._score_host(test_data)
        return self._prediction_frame(out, test_data.nrows)

    def _score_host(self, test_data: Frame) -> np.ndarray:
        """Score a frame on its device and fetch the result in one copy."""
        X = self._dinfo.matrix(test_data)
        return self._score_matrix(X).cpu().numpy()

    def _prediction_frame(self, out: np.ndarray, n: int) -> Frame:
        """predict + one p<level> column per class, or predict alone."""
        if self._is_classifier:
            probs = np.asarray(out, np.float64)[:n]
            dom = self._dinfo.response_domain
            names = ["predict"] + [f"p{lvl}" for lvl in dom]
            vecs = [Vec.from_numpy(probs.argmax(axis=1).astype(np.float64),
                                   type=T_CAT, domain=dom)]
            vecs += [Vec.from_numpy(probs[:, k]) for k in range(len(dom))]
            return Frame(names, vecs)
        return Frame(["predict"],
                     [Vec.from_numpy(np.asarray(out, np.float64)[:n])])

    def _compute_metrics(self, frame: Frame):
        di = self._dinfo
        y = di.response(frame)
        w = di.weights(frame)
        w = torch.where(torch.isnan(y), 0.0, w)
        out = self._score_matrix(di.matrix(frame))
        return self._metrics_from_preds(y, out, w)

    def _metrics_from_preds(self, y, out, w):
        if self._is_classifier and self.nclasses == 2:
            return M.binomial_metrics(y, out[:, 1], w,
                                      domain=self._dinfo.response_domain)
        if self._is_classifier:
            return M.multinomial_metrics(y, out, w,
                                         domain=self._dinfo.response_domain)
        return M.regression_metrics(y, out, w)

    def _score_train_valid(self, frame, valid):
        if not self.supervised:     # an unsupervised model has no metrics
            return
        self._output.training_metrics = self._compute_metrics(frame)
        if valid is not None:
            self._output.validation_metrics = self._compute_metrics(valid)

    # ---- introspection -------------------------------------------------------
    def _metric(self, name, valid):
        m = (self._output.validation_metrics if valid
             else self._output.training_metrics)
        return getattr(m, name, None)

    def auc(self, valid=False):
        return self._metric("auc", valid)

    def logloss(self, valid=False):
        return self._metric("logloss", valid)

    def rmse(self, valid=False):
        return self._metric("rmse", valid)

    def summary(self):
        return self._output.model_summary if self._output else {}

    def scoring_history(self):
        return self._output.scoring_history if self._output else []

    def varimp(self):
        return self._output.variable_importances if self._output else None
