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
card. A deeper forest (DRF's default depth is 20), an adaptive
histogram_type and a multinomial response grow on the adaptive engine
(`engine.TreeGrower`), one tree at a time: a multinomial forest grows K
class trees an iteration on one-hot 0/1 targets, with no out-of-bag
series (as in the JAX package), and predicts each class's mean vote,
normalized to sum to 1.
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
                "drf: checkpoint restart is not ported yet (the JAX "
                "package's DRF has none: h2o3_tpu/models/tree/drf.py)")
        ht = str(self.params.get("histogram_type") or "AUTO").lower()
        if (self.nclasses <= 2 and int(self.params["max_depth"]) <= 10
                and ht in ("auto", "quantilesglobal", "binned")):
            return self._fit_binned_drf(frame)
        return self._fit_adaptive_drf(frame)

    def _fit_adaptive_drf(self, frame: Frame):
        p = self.params
        X, y, w = self._prep(frame)
        dev = X.device
        C = X.shape[1]
        K = self.nclasses
        ntrees = int(p["ntrees"])
        draws = self._draws(dev)
        grower = self._grower()
        mtries = self._resolve_mtries(C, K)
        sample_rate = float(p["sample_rate"])
        gains_tot = torch.zeros(C, dtype=torch.float32, device=dev)
        self._oob_metrics = None
        if K > 2:
            if int(p.get("stopping_rounds") or 0) > 0:
                raise NotImplementedError(
                    "stopping_rounds for multinomial DRF is not supported "
                    "yet (no per-class OOB vote series); set "
                    "stopping_rounds=0 or use binomial/regression DRF")
            self._vstate = None
            onehot = torch.nn.functional.one_hot(y.long(), K) \
                .to(torch.float32)
            trees_k = [[] for _ in range(K)]
            for t in range(ntrees):
                wt = self._sample_weights(w, draws, sample_rate)
                for c in range(K):
                    col, thr, nal, val, heap, g = grower.grow(
                        X, wt, onehot[:, c], draw=draws.levels(),
                        mtries=mtries)
                    gains_tot += g
                    trees_k[c].append((col, thr, nal, val,
                                       E.node_covers(heap, wt,
                                                     nodes=grower.nodes,
                                                     D=grower.D)))
                if self._budget_exhausted():
                    break
            self._trees_k = [E.stack_trees(tl, grower.D) for tl in trees_k]
            built = len(trees_k[0])
        else:
            interval = max(1, int(p.get("score_tree_interval") or 5))
            self._valid_setup(0.0)
            oob_sum = torch.zeros(X.shape[0], dtype=torch.float32,
                                  device=dev)
            oob_cnt = torch.zeros_like(oob_sum)
            trees, scored = [], 0
            for t in range(ntrees):
                inbag = draws.rows(X.shape[0]) < sample_rate
                wt = w * inbag
                col, thr, nal, val, heap, g = grower.grow(
                    X, wt, y, draw=draws.levels(), mtries=mtries)
                gains_tot += g
                # rows out of this tree's bag vote with its prediction
                oob = ~inbag & (w > 0)
                oob_sum = oob_sum + torch.where(oob, val[heap], 0.0)
                oob_cnt = oob_cnt + oob.to(torch.float32)
                trees.append((col, thr, nal, val,
                              E.node_covers(heap, wt, nodes=grower.nodes,
                                            D=grower.D)))
                if (t + 1) % interval == 0 or t + 1 == ntrees:
                    if self._vstate is not None:
                        self._valid_advance(
                            E.stack_trees(trees[scored:], grower.D), 1.0)
                    scored = len(trees)
                    self._record_history_drf(t + 1, oob_sum, oob_cnt, y, w)
                    if self._should_stop() or self._budget_exhausted():
                        break
            self._trees = E.stack_trees(trees, grower.D)
            self._oob_metrics = self._metrics_from_oob(oob_sum, oob_cnt,
                                                       y, w)
            built = self._trees.ntrees
        self._varimp_from_gains(gains_tot.double().cpu().numpy())
        self._output.model_summary = {
            "number_of_trees": built, "max_depth": grower.D,
            "mtries": mtries, "sample_rate": sample_rate,
            "engine": "adaptive", "oob_scored": K <= 2,
        }

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

    def _contrib_scale_bias(self):
        # the forest predicts the mean of its trees (a probability for a
        # binomial forest)
        return 1.0 / self._trees.ntrees, 0.0

    def _score_matrix(self, X):
        if self.nclasses > 2:
            P = torch.stack([E.predict_ensemble(X, ta.to(X.device))
                             / ta.ntrees for ta in self._trees_k],
                            dim=1).clamp(0.0, 1.0)
            return P / P.sum(dim=1, keepdim=True).clamp(min=1e-10)
        mean = E.predict_ensemble(X, self._trees.to(X.device)) \
            / self._trees.ntrees
        if self._is_classifier:
            p = mean.clamp(0.0, 1.0)
            return torch.stack([1 - p, p], dim=1)
        return mean
