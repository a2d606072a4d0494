"""Naive Bayes of the port (h2o3_tpu/models/naive_bayes.py,
hex/naivebayes/NaiveBayes.java): one pass of per-class tables.

The codec is the label-mode DataInfo (a categorical stays its level ids,
NaN an NA). One pass on the device sums, by class and in float64, the
class weights (the priors), each categorical's (class, level) counts, and
each numeric column's weighted sum, sum of squares and count over its
non-NA rows. On the host, `laplace` is added to the counts, and each
class's Gaussian takes the mean and the n-1 standard deviation, floored at
`min_sdev`. Scoring sums in log space: the log prior, each categorical's
log conditional (floored at `min_prob`) and each numeric column's Gaussian
log density, skipping NAs, and takes the softmax. The log tables are
staged on the host in float64 and cast to f32 once, as the JAX package
stages them (`_stage_score_tables`), so the card and the CPU read the
same numbers.

`eps_sdev`, `eps_prob` and `compute_metrics` are accepted and never read by
the JAX package; each would change H2O's result, so the port raises when
one is set to anything but its default.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import DataInfo, ModelBase, _dev_f32

_WHY = "the JAX Naive Bayes accepts it and never reads it " \
    "(h2o3_tpu/models/naive_bayes.py:29)"


def _class_sums(v, yi, K):
    """(K,) float64 sums of v by class."""
    return torch.zeros(K, dtype=torch.float64, device=v.device) \
        .index_add_(0, yi, v.to(torch.float64))


class H2ONaiveBayesEstimator(ModelBase):
    algo = "naivebayes"
    # the staged f32 scoring tables (not the raw counts) are the shared
    # params; staged on first export
    _serving_param_attrs = ("_score_tab",)
    _defaults = {
        "laplace": 0.0, "min_sdev": 0.001, "eps_sdev": 0.0,
        "min_prob": 0.001, "eps_prob": 0.0, "compute_metrics": True,
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + (
        ("eps_sdev", 0.0, _WHY), ("eps_prob", 0.0, _WHY),
        ("compute_metrics", True, _WHY))

    def _cat_mode(self):
        return "label"

    def _make_data_info(self, frame, x, y):
        return DataInfo.from_frame(
            frame, x, y, weights=self.params.get("weights_column"),
            cat_mode="label", standardize=False, impute_missing=False)

    def _fit(self, frame: Frame):
        self._score_tab = None
        di = self._dinfo
        X = di.matrix(frame)
        y = di.response(frame)
        w = torch.where(torch.isnan(y), 0.0, di.weights(frame))
        K = self.nclasses
        yi = torch.where(torch.isnan(y), 0.0, y).long()
        lap = float(self.params.get("laplace") or 0.0)
        self._cat_idx = [i for i, c in enumerate(di.predictors)
                         if c in di.cat_cols]
        self._num_idx = [i for i, c in enumerate(di.predictors)
                         if c not in di.cat_cols]
        prior = _class_sums(w, yi, K).cpu().numpy()
        self._priors = prior / prior.sum()
        self._cat_probs = []
        for j in self._cat_idx:
            card = di.cardinalities[di.predictors[j]]
            col = X[:, j]
            ok = ~torch.isnan(col)
            idx = yi * card + torch.where(ok, col, 0.0).long()
            cnt = _class_sums(torch.where(ok, w, 0.0), idx, K * card)
            c = cnt.reshape(K, card).cpu().numpy() + lap
            self._cat_probs.append(c / c.sum(axis=1, keepdims=True))
        min_sd = float(self.params.get("min_sdev") or 1e-3)
        self._num_mean, self._num_sd = [], []
        for j in self._num_idx:
            col = X[:, j].to(torch.float64)
            ok = ~torch.isnan(col)
            wv = torch.where(ok, w.to(torch.float64), 0.0)
            cv = torch.where(ok, col, 0.0)
            s, q, c = (t.cpu().numpy() for t in (
                _class_sums(wv * cv, yi, K),
                _class_sums(wv * cv * cv, yi, K), _class_sums(wv, yi, K)))
            m = s / np.maximum(c, 1e-30)
            var = q / np.maximum(c, 1e-30) - m * m
            self._num_mean.append(m)
            self._num_sd.append(np.sqrt(np.maximum(
                var * c / np.maximum(c - 1, 1), min_sd ** 2)))
        self._output.model_summary = {
            "nclasses": K, "priors": self._priors.tolist(), "laplace": lap}

    def _serving_params(self):
        if getattr(self, "_priors", None) is None:
            return None
        self._stage_score_tables()
        return super()._serving_params()

    def _stage_score_tables(self) -> dict:
        """The log tables of scoring, in float64 on the host and cast to
        f32 once (the JAX package's `_stage_score_tables`), cached."""
        tab = self.__dict__.get("_score_tab")
        if tab is not None:
            return tab
        min_prob = float(self.params.get("min_prob") or 1e-3)
        sds = [np.asarray(s, np.float32) for s in self._num_sd]
        tab = self._score_tab = {
            "log_prior": np.log(np.maximum(self._priors, 1e-300)
                                ).astype(np.float32),
            "log_cat": [np.log(np.maximum(p, min_prob)).astype(np.float32)
                        for p in self._cat_probs],
            "mean": [np.asarray(m, np.float32) for m in self._num_mean],
            "gauss_log": [np.float32(-0.5)
                          * np.log(np.float32(2 * np.pi) * s * s)
                          for s in sds],
            "inv_two_var": [np.float32(1.0) / (np.float32(2.0) * s * s)
                            for s in sds],
        }
        return tab

    def _score_matrix(self, X):
        tab = self._stage_score_tables()

        def t(a):
            return _dev_f32(a, X.device)
        parts = t(tab["log_prior"])[None, :].expand(X.shape[0], -1)
        for k, j in enumerate(self._cat_idx):
            col = X[:, j]
            ok = ~torch.isnan(col)
            contrib = t(tab["log_cat"][k]).T[torch.where(ok, col, 0.0)
                                             .long()]
            parts = parts + torch.where(ok[:, None], contrib, 0.0)
        for k, j in enumerate(self._num_idx):
            col = X[:, j]
            ll = (t(tab["gauss_log"][k])[None, :]
                  - (col[:, None] - t(tab["mean"][k])[None, :]) ** 2
                  * t(tab["inv_two_var"][k])[None, :])
            parts = parts + torch.where(~torch.isnan(col)[:, None], ll, 0.0)
        return torch.softmax(parts, dim=1)
