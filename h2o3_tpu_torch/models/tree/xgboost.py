"""XGBoost of the port (h2o3_tpu/models/tree/xgboost.py): H2O's XGBoost
estimator on the adaptive tree engine.

There is no external booster: `tree_method=hist` is the adaptive engine
fed hessian-weighted stats (w = sum h, wy = sum g) with reg_lambda, so its
split search maximizes XGBoost's structure score sum G^2/(H+lambda), and
`engine.gamma_pass` gives the leaf weights sign(G)·max(|G|−alpha, 0)/
(H+lambda). The engine's gain is the un-halved SE reduction, twice
XGBoost's, so gamma (min_split_loss) is doubled. XGBoost-style aliases
(eta, min_child_weight, colsample_bytree, colsample_bylevel, subsample,
max_bins, min_split_loss, gamma) resolve onto H2O's names. DART drops
whole trees (whole iterations of K class trees for a multinomial
response) with draws from numpy's default_rng(seed), as the JAX package
does, and folds each tree's weight into its leaf values at the end.
A validation frame scores into the scoring history of a binomial or
regression booster.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.tree import engine as E
from h2o3_tpu_torch.models.tree.shared_tree import (
    H2OGradientBoostingEstimator, SharedTreeEstimator, _link_inv_dist)


def _objective_grad_hess(dist, F, y):
    """The second-order (g, h) of each objective, g = −gradient (the
    engine's descent direction)."""
    if dist == "gaussian":                       # reg:squarederror
        return y - F, torch.ones_like(F)
    if dist == "bernoulli":                      # binary:logistic
        p = torch.sigmoid(F)
        return y - p, torch.clamp(p * (1 - p), min=1e-6)
    if dist == "poisson":                        # count:poisson
        mu = torch.exp(F)
        return y - mu, torch.clamp(mu, min=1e-6)
    if dist == "gamma":                          # reg:gamma
        mu = torch.exp(F)
        return y / mu - 1.0, torch.clamp(y / mu, min=1e-6)
    if dist == "tweedie":
        mu = torch.exp(F)
        return (y * torch.pow(mu, -0.5) - torch.pow(mu, 0.5),
                torch.clamp(0.5 * (y * torch.pow(mu, -0.5)
                                   + torch.pow(mu, 0.5)), min=1e-6))
    raise NotImplementedError(f"XGBoost objective for {dist}")


_OBJECTIVE = {"gaussian": "reg:squarederror", "bernoulli": "binary:logistic",
              "poisson": "count:poisson", "gamma": "reg:gamma",
              "tweedie": "reg:tweedie"}


class _Dart:
    """DART's state (arXiv:1505.01866, normalize_type "tree"): the weight
    and training-row prediction of every tree (iteration), and the drops
    drawn from numpy's default_rng(seed)."""

    def __init__(self, params, seed):
        self.on = params.get("booster") == "dart"
        self.rate = float(params.get("rate_drop") or 0.0)
        self.one = bool(params.get("one_drop"))
        self.skip = float(params.get("skip_drop") or 0.0)
        self.rng = np.random.default_rng(seed)
        self.w, self.pred = [], []

    def drop(self, F):
        """The margins without this iteration's dropped trees."""
        self.dropped = []
        if self.on and self.pred and self.rate > 0 \
                and self.rng.random() >= self.skip:
            mask = self.rng.random(len(self.pred)) < self.rate
            if self.one and not mask.any():
                mask[self.rng.integers(len(self.pred))] = True
            self.dropped = list(np.nonzero(mask)[0])
        for i in self.dropped:
            F = F - self.w[i] * self.pred[i]
        return F

    def add(self, F, p_new, eta):
        """F advanced by the new tree; the dropped trees rescaled."""
        if not self.on:
            return F + eta * p_new
        k = len(self.dropped)
        new_w = eta
        if k:
            scale = k / (k + eta)
            new_w = eta / (k + eta)
            for i in self.dropped:
                F = F + (scale - 1.0) * self.w[i] * self.pred[i]
                self.w[i] *= scale
        self.w.append(new_w)
        self.pred.append(p_new)
        return F + new_w * p_new


class H2OXGBoostEstimator(H2OGradientBoostingEstimator):
    """The GBM driver's history and early stopping, with the boosting loop
    replaced by hessian-weighted hist updates."""
    algo = "xgboost"
    _defaults = dict(SharedTreeEstimator._tree_defaults)
    _defaults.update({
        # XGBoost's defaults (XGBoostModel.XGBoostParameters)
        "ntrees": 50, "max_depth": 6, "min_rows": 1.0, "learn_rate": 0.3,
        "sample_rate": 1.0, "col_sample_rate": 1.0,
        "col_sample_rate_per_tree": 1.0, "nbins": 256,
        "reg_lambda": 1.0, "reg_alpha": 0.0, "min_split_improvement": 0.0,
        "tree_method": "hist", "booster": "gbtree", "backend": "auto",
        "scale_pos_weight": 1.0,
        # XGBoost-style aliases, resolved in __init__
        "eta": None, "min_child_weight": None, "colsample_bytree": None,
        "colsample_bylevel": None, "subsample": None, "max_bins": None,
        "min_split_loss": None, "gamma": None, "max_leaves": 0,
        "grow_policy": "depthwise", "dmatrix_type": "auto",
        # DART (booster="dart"): tree dropout per iteration
        "rate_drop": 0.0, "skip_drop": 0.0, "one_drop": False,
    })
    _ALIASES = {
        "eta": "learn_rate", "min_child_weight": "min_rows",
        "colsample_bytree": "col_sample_rate_per_tree",
        "colsample_bylevel": "col_sample_rate",
        "subsample": "sample_rate", "max_bins": "nbins",
        "min_split_loss": "min_split_improvement",
        "gamma": "min_split_improvement",
    }

    def __init__(self, **params):
        super().__init__(**params)
        for alias, target in self._ALIASES.items():
            v = self.params.get(alias)
            if v is not None:
                self.params[target] = v
        tm = self.params.get("tree_method", "hist")
        # the reference asserts
        if tm not in ("auto", "hist", "approx", "exact"):
            raise AssertionError(
                f"tree_method must be auto/hist/approx/exact, got {tm!r}")
        if self.params.get("booster", "gbtree") not in ("gbtree", "dart"):
            raise AssertionError(
                "gblinear: use H2OGeneralizedLinearEstimator")
        if self.params.get("checkpoint") and \
                self.params.get("booster") == "dart":
            raise NotImplementedError(
                "checkpoint restart of a DART booster is not supported "
                "(per-tree weight state is folded into leaves at export)")

    def _grower(self):
        p = self.params
        return E.TreeGrower(
            nbins=int(p["nbins"]), max_depth=int(p["max_depth"]),
            min_rows=float(p["min_rows"]),     # on sum h = min_child_weight
            # the engine's gain is twice XGBoost's ½[G_L²/(H_L+λ) +
            # G_R²/(H_R+λ) − G_P²/(H_P+λ)], so γ doubles
            min_split_improvement=2.0 * float(p["min_split_improvement"]),
            reg_lambda=float(p["reg_lambda"]))

    def _seed(self):
        seed = int(self.params.get("seed") or -1)
        return seed if seed >= 0 else 42

    def _grow_one(self, grower, X, wt, g, h, cmask, draws, lam, alpha):
        """One booster tree on hessian-weighted stats: (tree, heap)."""
        col, thr, nal, val, heap, gn = grower.grow(
            X, wt * h, g / h, col_mask=cmask, draw=draws.levels(),
            mtries=self._per_level_mtries(X.shape[1]))
        val = E.gamma_pass(heap, wt, g, h, val, nodes=grower.nodes,
                           reg_lambda=lam, reg_alpha=alpha)
        cover = E.node_covers(heap, wt * h, nodes=grower.nodes, D=grower.D)
        return (col, thr, nal, val, cover), heap, gn

    # ---- the boosting driver (_resolve_dist inherited from GBM) -----------
    def _fit(self, frame: Frame):
        dist = self._resolve_dist()
        self._dist = dist
        X, y, w = self._prep(frame)
        if dist == "multinomial":
            return self._fit_multinomial(X, y, w)
        p = self.params
        dev = X.device
        ntrees = int(p["ntrees"])
        eta = float(p["learn_rate"])
        lam = float(p["reg_lambda"])
        alpha = float(p["reg_alpha"])
        spw = float(p.get("scale_pos_weight") or 1.0)
        draws = self._draws(dev)
        grower = self._grower()
        w_metric = w      # scale_pos_weight reweights the objective only
        if dist == "bernoulli" and spw != 1.0:
            w = w * torch.where(y > 0.5, spw, 1.0)
        # base_score 0.5: margin 0 for logistic; for reg:squarederror the
        # 0.5 is the raw prediction
        f0 = 0.5 if dist == "gaussian" else 0.0
        F = torch.full((X.shape[0],), f0, dtype=torch.float32, device=dev)
        sample_rate = float(p["sample_rate"])
        dart = _Dart(p, self._seed())
        trees = []
        gains_tot = torch.zeros(X.shape[1], dtype=torch.float32, device=dev)
        if p.get("checkpoint"):
            # resume from a prior booster's trees, its leaf values scaled
            # by eta_prev/eta so that lr · sum(trees) holds under the new
            # learning rate (ModelBuilder.java:1401)
            prev = self._resolve_checkpoint(p["checkpoint"])
            pt = prev._trees.to(dev)
            if pt.depth != grower.D:
                raise AssertionError(
                    "checkpoint restart requires identical max_depth")
            if prev._dinfo.predictors != self._dinfo.predictors:
                raise AssertionError(
                    "checkpoint restart requires the SAME predictor columns "
                    "in the same order (ModelBuilder.java checkpoint "
                    "training-frame validation)")
            if ntrees <= pt.ntrees:
                raise AssertionError(
                    f"checkpoint restart: ntrees ({ntrees}) must exceed the "
                    f"checkpoint's tree count ({pt.ntrees}) — ntrees is the "
                    "TOTAL (ModelBuilder.java checkpoint validation)")
            eta_prev = float(prev.params["learn_rate"])
            scale = eta_prev / eta
            cov = pt.cover if pt.cover is not None else \
                torch.zeros_like(pt.value)
            trees = [(pt.col[i], pt.thr[i], pt.na_left[i],
                      pt.value[i] * scale, cov[i])
                     for i in range(pt.ntrees)]
            f0 = prev._f0
            F = f0 + eta_prev * E.predict_ensemble(X, pt)
            # the prior's importances seed the continued model's
            fidx = {n: i for i, n in enumerate(self._dinfo.predictors)}
            for row in prev._output.variable_importances or []:
                if row["variable"] in fidx:
                    gains_tot[fidx[row["variable"]]] += \
                        float(np.float32(row["relative_importance"]))
        self._f0 = f0
        interval = max(1, int(p.get("score_tree_interval") or 5))
        self._valid_setup(f0)
        if trees and self._vstate is not None:
            self._valid_advance(E.stack_trees(trees, grower.D), eta)
        scored = len(trees)
        for t in range(len(trees), ntrees):
            g, h = _objective_grad_hess(dist, dart.drop(F), y)
            wt = self._sample_weights(w, draws, sample_rate)
            cmask = self._col_mask(X.shape[1], draws)
            tree, heap, gn = self._grow_one(grower, X, wt, g, h, cmask,
                                            draws, lam, alpha)
            gains_tot += gn
            trees.append(tree)
            F = dart.add(F, tree[3][heap], eta)
            if (t + 1) % interval == 0 or t == ntrees - 1:
                self._advance_valid(trees, scored, dart, grower, eta)
                scored = len(trees)
                self._record_history(t + 1, F, y, w_metric, dist)
                if self._should_stop() or self._budget_exhausted():
                    break
        if dart.on and dart.w:
            # fold the tree weights into the leaves: lr · sum matches F
            trees = [(c, th, na, v * (tw / eta), cv)
                     for (c, th, na, v, cv), tw in zip(trees, dart.w)]
        self._trees = E.stack_trees(trees, grower.D)
        self._varimp_from_gains(gains_tot.double().cpu().numpy())
        self._output.model_summary = {
            "number_of_trees": self._trees.ntrees, "max_depth": grower.D,
            "objective": _OBJECTIVE[dist], "tree_method": "hist",
            "eta": eta, "reg_lambda": lam, "engine": "adaptive",
        }

    def _advance_valid(self, trees, scored, dart, grower, eta):
        """The validation margins at a scoring event: the new trees added
        (for DART, every tree at its current weight)."""
        vs = self._vstate
        if vs is None:
            return
        if dart.on:
            ens = E.stack_trees(trees, grower.D)
            vs["F"] = self._f0 + E.predict_ensemble(vs["X"], ens,
                                                    weights=dart.w)
        elif len(trees) > scored:
            self._valid_advance(E.stack_trees(trees[scored:], grower.D),
                                eta)

    def _fit_multinomial(self, X, y, w):
        """K class trees an iteration on softmax gradients; no validation
        series, as in the JAX package."""
        self._vstate = None
        p = self.params
        if p.get("checkpoint"):
            raise NotImplementedError(
                "xgboost checkpoint restart covers binomial/regression "
                "boosters; multinomial restart is not wired")
        K = self.nclasses
        dev = X.device
        ntrees = int(p["ntrees"])
        eta = float(p["learn_rate"])
        lam = float(p["reg_lambda"])
        alpha = float(p["reg_alpha"])
        draws = self._draws(dev)
        grower = self._grower()
        onehot = torch.nn.functional.one_hot(y.long(), K).to(torch.float32)
        self._f0 = np.zeros(K, np.float32)
        F = torch.zeros((X.shape[0], K), dtype=torch.float32, device=dev)
        sample_rate = float(p["sample_rate"])
        trees_k = [[] for _ in range(K)]
        gains_tot = torch.zeros(X.shape[1], dtype=torch.float32, device=dev)
        interval = max(1, int(p.get("score_tree_interval") or 5))
        # an iteration's K class trees share one DART weight
        dart = _Dart(p, self._seed())
        for t in range(ntrees):
            P = torch.softmax(dart.drop(F), dim=1)
            wt = self._sample_weights(w, draws, sample_rate)
            cmask = self._col_mask(X.shape[1], draws)
            p_round = []
            for c in range(K):
                g = onehot[:, c] - P[:, c]
                h = torch.clamp(2.0 * P[:, c] * (1 - P[:, c]), min=1e-6)
                tree, heap, gn = self._grow_one(grower, X, wt, g, h, cmask,
                                                draws, lam, alpha)
                gains_tot += gn
                trees_k[c].append(tree)
                p_round.append(tree[3][heap])
            F = dart.add(F, torch.stack(p_round, dim=1), eta)
            if (t + 1) % interval == 0 or t == ntrees - 1:
                self._record_history_multi(t + 1, F, y, w)
                if self._should_stop() or self._budget_exhausted():
                    break
        if dart.on and dart.w:
            trees_k = [[(cl, th, na, v * (tw / eta), cv)
                        for (cl, th, na, v, cv), tw in zip(tl, dart.w)]
                       for tl in trees_k]
        self._trees_k = [E.stack_trees(tl, grower.D) for tl in trees_k]
        self._varimp_from_gains(gains_tot.double().cpu().numpy())
        self._output.model_summary = {
            "number_of_trees": sum(t.ntrees for t in self._trees_k),
            "max_depth": grower.D, "objective": "multi:softprob",
            "engine": "adaptive",
        }

    # ---- scoring ------------------------------------------------------------
    def _score_matrix(self, X):
        eta = float(self.params["learn_rate"])
        if self._dist == "multinomial":
            F = torch.stack([eta * E.predict_ensemble(X, ta.to(X.device))
                             for ta in self._trees_k], dim=1)
            return torch.softmax(F, dim=1)
        F = self._f0 + eta * E.predict_ensemble(X, self._trees.to(X.device))
        return _link_inv_dist(self._dist, F)

    @staticmethod
    def available() -> bool:
        """H2OXGBoostEstimator.available(): the booster is the port's own
        engine, so always True."""
        return True
