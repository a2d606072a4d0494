"""DRF of the port (h2o3_tpu/models/tree/drf.py): a random forest on the
binned tree engine.

Independent trees on rows drawn in-bag with probability `sample_rate`
(0.632 by default), `mtries` columns drawn per (level, leaf), leaves that
predict the in-bag response mean (the class frequency for a binomial
response); the ensemble predicts the mean of its trees. Out-of-bag scoring
is the reference default (DRF.java:78 doOOBScoring() = true): every tree
adds its leaf value to the rows it left out of its bag, and the model's
training metrics and scoring history come from those held-out rows.

Binomial and regression forests up to depth 10 run on the binned engine
(`binned.drf_chunk_trainer`), through the same CUDA kernels as GBM on a
card. The JAX package sends a multinomial forest, a deeper tree or an
adaptive histogram_type to its adaptive engine; the port raises there.
"""

from __future__ import annotations

import math

import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.tree import binned as BN
from h2o3_tpu_torch.models.tree import engine as E
from h2o3_tpu_torch.models.tree.shared_tree import (SharedTreeEstimator,
                                                    _generator)


class H2ORandomForestEstimator(SharedTreeEstimator):
    algo = "drf"
    _defaults = dict(SharedTreeEstimator._tree_defaults)
    _defaults.update({"sample_rate": 0.632, "max_depth": 20, "ntrees": 50,
                      "min_rows": 1.0, "binomial_double_trees": False})

    def _resolve_mtries(self, C, K):
        """Columns drawn per node. The reference's rules, quirks included:
        the default (-2) and any other value <= 0 but -1 take all C
        columns; -1 (or 0, which `or` turns into -1) takes sqrt(C) for a
        classifier and C/3 for a regression."""
        mtries = int(self.params.get("mtries") or -1)
        if mtries == -1:
            return max(1, int(math.sqrt(C))) if K > 1 else max(1, C // 3)
        if mtries <= 0:
            return C
        return mtries

    def _fit(self, frame: Frame):
        if self.params.get("checkpoint"):
            raise NotImplementedError(
                "drf: checkpoint restart is not ported (the JAX package's "
                "DRF has none: h2o3_tpu/models/tree/drf.py)")
        ht = str(self.params.get("histogram_type") or "AUTO").lower()
        if not (self.nclasses <= 2 and int(self.params["max_depth"]) <= 10
                and ht in ("auto", "quantilesglobal", "binned")):
            raise NotImplementedError(
                f"drf: {self.nclasses} classes, max_depth="
                f"{self.params['max_depth']}, histogram_type="
                f"{self.params.get('histogram_type')!r} needs the adaptive "
                "tree engine, which is not ported yet "
                "(h2o3_tpu/models/tree/engine.py TreeGrower)")
        return self._fit_binned_drf(frame)

    def _fit_binned_drf(self, frame: Frame):
        p = self.params
        ctx = self._binned_setup(frame)
        grower = ctx["grower"]
        y, w, y1, w1 = ctx["y"], ctx["w"], ctx["y1"], ctx["w1"]
        n, C, n_pad = ctx["n"], ctx["C"], ctx["n_pad"]
        dev = y.device
        gen = _generator(p, dev)
        mtries = self._resolve_mtries(C, self.nclasses)
        sample_rate = float(p["sample_rate"])
        oob_sum = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        oob_cnt = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        self._valid_setup(0.0)

        def step(k, done):
            nonlocal oob_sum, oob_cnt
            trainer = BN.drf_chunk_trainer(
                grower, n, sample_rate=sample_rate, mtries=mtries, k_trees=k,
                col_rate_tree=float(p.get("col_sample_rate_per_tree") or 1.0))
            oob_sum, oob_cnt, trees = trainer(ctx["codes"], y1, w1, oob_sum,
                                              oob_cnt, gen)
            if self._vstate is not None:
                self._valid_advance(self._binned_tree_arrays(ctx, [trees])[0],
                                    1.0)
            self._record_history_drf(done, oob_sum[:n], oob_cnt[:n], y, w)
            return trees
        chunks = self._train_chunks(0, step)

        self._trees, gainsT = self._binned_tree_arrays(ctx, chunks)
        self._bin_spec = ctx["spec"]
        self._oob_metrics = self._metrics_from_oob(oob_sum[:n], oob_cnt[:n],
                                                   y, w)
        self._varimp_from_gains(gainsT[:C].double().cpu().numpy())
        self._output.model_summary = {
            "number_of_trees": int(self._trees.ntrees),
            "max_depth": grower.D, "mtries": mtries,
            "sample_rate": sample_rate, "engine": "binned_cuda",
            "oob_scored": True,
        }

    # ---- scoring history / early stopping (OOB series) ---------------------
    # The history's training entries come from the OOB sums; the validation
    # entries from margins that add up the trees' votes chunk by chunk,
    # averaged at each scoring event (DRF predicts the ensemble mean).
    def _record_history_drf(self, done, oob_sum, oob_cnt, y, w):
        m = self._metrics_from_oob(oob_sum, oob_cnt, y, w)
        if self._is_classifier:
            h = {"number_of_trees": done, "training_logloss": m.logloss,
                 "training_auc": m.auc, "training_pr_auc": m.pr_auc,
                 "training_rmse": m.rmse}
        else:
            h = {"number_of_trees": done, "training_rmse": m.rmse,
                 "training_mae": m.mae, "training_r2": m.r2}
        h.update(self._valid_history_entry_drf(done))
        self._output.scoring_history.append(h)

    def _valid_history_entry_drf(self, done) -> dict:
        if getattr(self, "_vstate", None) is None:
            return {}
        vs = self._vstate
        mu = vs["F"] / max(done, 1)          # vote sum -> ensemble mean
        if self._is_classifier:
            mu = mu.clamp(1e-7, 1.0 - 1e-7)
            mu = torch.stack([1.0 - mu, mu], dim=1)
        vm = self._metrics_from_preds(vs["y"], mu, vs["w"])
        return {f"validation_{k}": getattr(vm, k)
                for k in ("logloss", "auc", "pr_auc", "rmse", "mae", "r2")
                if getattr(vm, k, None) is not None}

    def _metrics_from_oob(self, oob_sum, oob_cnt, y, w):
        """Metrics over the rows that were out of the bag of at least one
        tree, weighted as in training; with doOOBScoring() the reference
        reports these as the model's training metrics."""
        pred = oob_sum / oob_cnt.clamp(min=1.0)
        wm = w * (oob_cnt > 0)
        if self._is_classifier:
            # away from exact 0/1 votes, so that logloss stays finite
            return M.binomial_metrics(y, pred.clamp(1e-7, 1.0 - 1e-7), wm,
                                      domain=self._dinfo.response_domain)
        return M.regression_metrics(y, pred, wm)

    def _score_train_valid(self, frame, valid):
        super()._score_train_valid(frame, valid)
        if getattr(self, "_oob_metrics", None) is not None:
            # doOOBScoring() = true: the training metrics are the OOB ones
            self._output.training_metrics = self._oob_metrics

    def _score_matrix(self, X):
        mean = E.predict_ensemble(X, self._trees.to(X.device)) \
            / self._trees.ntrees
        if self._is_classifier:
            p = mean.clamp(0.0, 1.0)
            return torch.stack([1 - p, p], dim=1)
        return mean
