"""SharedTree driver of the port (h2o3_tpu/models/tree/shared_tree.py):
the GBM estimator on the binned tree engine.

The frame is quantized once into a uint8 code plane on its device; trees
grow in chunks of `score_tree_interval` through
`binned.gbm_chunk_trainer`, which runs the CUDA route and histogram
kernels for tensors on a card. After each chunk the training margins are
scored into the scoring history. The adaptive (UniformAdaptive) engine,
multinomial GBM, checkpoint restart, early stopping and the radix, fused
and int8 kernels are later slices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.model import ModelBase
from h2o3_tpu_torch.models.tree import binned as BN
from h2o3_tpu_torch.models.tree import engine as E

# Kernel families of the JAX engine that this port does not have yet, by
# estimator parameter; True asks for one and raises.
_LATER_KERNELS = {
    "int8_hist": "sbh_hist_pallas_i8",
    "radix_shallow": "sbh_hist_radix",
    "fused_level": "sbh_route_hist_fused_pallas",
}


class SharedTreeEstimator(ModelBase):
    """Common driver of the tree estimators."""

    _tree_defaults = {
        "ntrees": 50, "max_depth": 5, "min_rows": 10.0, "nbins": 20,
        "nbins_cats": 1024, "learn_rate": 0.1, "sample_rate": 1.0,
        "col_sample_rate": 1.0, "col_sample_rate_per_tree": 1.0,
        "min_split_improvement": 1e-5, "mtries": -2,
        "score_tree_interval": 5, "stopping_rounds": 0,
        "stopping_metric": "AUTO", "stopping_tolerance": 1e-3,
        "histogram_type": "AUTO", "balance_classes": False,
        "monotone_constraints": None, "nbins_top_level": None,
        # accepted for the JAX package's signature; only False/None run here
        "int8_hist": None, "radix_shallow": None, "fused_level": None,
    }

    def _check_ported(self):
        super()._check_ported()
        for name, kernel in _LATER_KERNELS.items():
            if self.params.get(name):
                raise NotImplementedError(
                    f"{name}=True needs the {kernel} kernel, which is not "
                    "ported yet (a later slice of the port)")
        if int(self.params.get("stopping_rounds") or 0) > 0:
            raise NotImplementedError(
                "early stopping is not ported yet "
                "(h2o3_tpu/models/tree/shared_tree.py _should_stop)")

    # ---- shared plumbing -----------------------------------------------------
    def _prep(self, frame: Frame):
        di = self._dinfo
        X = di.matrix(frame)
        y = di.response(frame)
        w = torch.where(torch.isnan(y), 0.0, di.weights(frame))
        yz = torch.where(torch.isnan(y), 0.0, y)
        if self.params.get("balance_classes") and self._is_classifier:
            # reweight so every class carries the same total weight
            K = self.nclasses
            yi = yz.long()
            totals = torch.zeros(K, dtype=w.dtype, device=w.device) \
                .index_add_(0, yi, w)
            factor = torch.where(totals > 0, totals.sum() / (K * totals), 1.0)
            w = w * factor[yi]
        return X, yz, w

    def _per_level_mtries(self, C) -> int:
        rate = float(self.params.get("col_sample_rate") or 1.0)
        if rate >= 1.0:
            return 0
        return max(1, int(round(rate * C)))

    def _binned_setup(self, frame: Frame):
        """Quantize the frame once and build the grower. Returns the context
        the binned driver uses."""
        p = self.params
        di = self._dinfo
        X, y, w = self._prep(frame)
        n = int(frame.nrows)
        C = X.shape[1]
        is_cat = np.array([c in di.cat_cols for c in di.predictors], bool)
        cards = [di.cardinalities[c] for c in di.cat_cols]
        nbins = int(p["nbins"])
        nbins_cats = int(p.get("nbins_cats") or 1024)
        nbins_top = int(p.get("nbins_top_level") or 0)
        b_val = max(nbins, nbins_top // 4,
                    min(nbins_cats, max(cards, default=0)))
        b_val = int(min(255, max(b_val, 4)))
        # bin edges from a strided row sample (a head slice would bias the
        # quantiles of ordered data)
        stride = max(1, n >> 18)
        Xs = X[::stride][: 1 << 18].cpu().numpy()
        spec = BN.make_bins(Xs, is_cat, b_val)
        mono = np.zeros(spec.c_pad, np.int32)
        mc = p.get("monotone_constraints") or {}
        for cname, v in mc.items():
            if cname in di.predictors:
                mono[di.predictors.index(cname)] = int(np.sign(v))
        grower = BN.BinnedGrower(
            spec, max_depth=int(p["max_depth"]), min_rows=float(p["min_rows"]),
            min_split_improvement=float(p["min_split_improvement"]),
            monotone=mono if mc else None, device=X.device)
        n_pad = grower.layout(n)
        codes = BN.quantize(X, spec, n_pad=n_pad)
        return dict(X=X, y=y, w=w, y1=BN.pad_rows(y, n_pad),
                    w1=BN.pad_rows(w, n_pad), codes=codes, n=n, C=C,
                    is_cat=is_cat, spec=spec, grower=grower, n_pad=n_pad)

    def _binned_tree_arrays(self, ctx, chunks):
        """TreeArrays from the trainer's chunk outputs, and the summed
        per-column gains."""
        spec, C = ctx["spec"], ctx["C"]
        colT = torch.cat([c[0] for c in chunks])
        binT = torch.cat([c[1] for c in chunks])
        nalT = torch.cat([c[2] for c in chunks])
        wordsT = torch.cat([c[3] for c in chunks])
        valT = torch.cat([c[4] for c in chunks])
        gainsT = torch.cat([c[5] for c in chunks]).sum(0)
        coverT = torch.cat([c[6] for c in chunks])
        edges = torch.as_tensor(spec.edges, device=colT.device)
        thrT = edges[colT.long().clamp(0, C - 1),
                     binT.long().clamp(0, spec.edges.shape[1] - 1)]
        any_cat = bool(ctx["is_cat"].any())
        ta = E.TreeArrays(
            col=colT, thr=thrT, na_left=nalT, value=valT,
            depth=ctx["grower"].D, cover=coverT,
            catbits=wordsT if any_cat else None,
            col_is_cat=(np.pad(ctx["is_cat"], (0, spec.c_pad - C))
                        if any_cat else None))
        return ta, gainsT

    def _record_history(self, ntrees, F, y, w, dist):
        mu = _link_inv_dist(dist, F)
        if self._is_classifier:
            m = M.binomial_metrics(y, mu[:, 1], w)
            h = {"number_of_trees": ntrees, "training_logloss": m.logloss,
                 "training_auc": m.auc, "training_pr_auc": m.pr_auc,
                 "training_rmse": m.rmse}
        else:
            m = M.regression_metrics(y, mu, w)
            h = {"number_of_trees": ntrees, "training_rmse": m.rmse,
                 "training_mae": m.mae, "training_r2": m.r2}
        self._output.scoring_history.append(h)

    def _varimp_from_gains(self, gains: np.ndarray):
        names = self._dinfo.feature_names
        tot = gains.sum() or 1.0
        order = np.argsort(-gains)
        self._output.variable_importances = [
            {"variable": names[i], "relative_importance": float(gains[i]),
             "scaled_importance": float(gains[i] / (gains[order[0]] or 1.0)),
             "percentage": float(gains[i] / tot)}
            for i in order]


# ===========================================================================
class H2OGradientBoostingEstimator(SharedTreeEstimator):
    algo = "gbm"
    _defaults = dict(SharedTreeEstimator._tree_defaults)

    def _resolve_dist(self) -> str:
        d = (self.params.get("distribution") or "AUTO").lower()
        if d != "auto":
            return d
        dom = self._dinfo.response_domain
        if dom is None:
            return "gaussian"
        return "bernoulli" if len(dom) == 2 else "multinomial"

    def _fit(self, frame: Frame):
        dist = self._resolve_dist()
        self._dist = dist
        if not self._binned_ok(dist):
            raise NotImplementedError(
                f"GBM distribution={dist!r}, histogram_type="
                f"{self.params.get('histogram_type')!r}, max_depth="
                f"{self.params['max_depth']} needs the adaptive tree engine "
                "or multinomial boosting, which are not ported yet "
                "(h2o3_tpu/models/tree/engine.py TreeGrower)")
        return self._fit_binned(frame, dist)

    def _binned_ok(self, dist) -> bool:
        ht = str(self.params.get("histogram_type") or "AUTO").lower()
        return (ht in ("auto", "quantilesglobal", "binned")
                and dist in ("gaussian", "bernoulli", "quasibinomial",
                             "poisson", "gamma", "tweedie", "laplace")
                and int(self.params["max_depth"]) <= 10)

    def _fit_binned(self, frame: Frame, dist: str):
        p = self.params
        ctx = self._binned_setup(frame)
        grower = ctx["grower"]
        y, w, y1, w1 = ctx["y"], ctx["w"], ctx["y1"], ctx["w1"]
        n, C, n_pad = ctx["n"], ctx["C"], ctx["n_pad"]
        dev = y.device
        ntrees = int(p["ntrees"])
        lr = float(p["learn_rate"])
        seed = int(p.get("seed") or -1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed if seed >= 0 else 42)
        wsum, wysum = torch.stack([w.sum(), (w * y).sum()]).cpu().tolist()
        ybar = wysum / max(wsum, 1e-30)
        if dist in ("bernoulli", "quasibinomial"):
            p0 = min(max(ybar, 1e-10), 1 - 1e-10)
            f0 = math.log(p0 / (1 - p0))
        elif dist in ("poisson", "gamma", "tweedie"):
            f0 = math.log(max(ybar, 1e-10))
        else:
            f0 = ybar
        self._f0 = f0
        # margins: f0 on the real rows, 0 on the padding rows
        F = torch.where(torch.arange(n_pad, device=dev) < n, f0, 0.0) \
            .to(torch.float32)
        interval = max(1, int(p.get("score_tree_interval") or 5))
        chunks = []
        done = 0
        while done < ntrees:
            k = min(interval, ntrees - done)
            trainer = BN.gbm_chunk_trainer(
                grower, n, dist=dist, eta=lr,
                sample_rate=float(p["sample_rate"]),
                mtries=self._per_level_mtries(C), k_trees=k,
                col_rate_tree=float(p.get("col_sample_rate_per_tree") or 1.0))
            F, trees = trainer(ctx["codes"], y1, w1, F, gen)
            chunks.append(trees)
            done += k
            self._record_history(done, F[:n], y, w, dist)

        self._trees, gainsT = self._binned_tree_arrays(ctx, chunks)
        self._bin_spec = ctx["spec"]
        self._varimp_from_gains(gainsT[:C].double().cpu().numpy())
        self._output.model_summary = {
            "number_of_trees": int(self._trees.ntrees),
            "max_depth": grower.D, "distribution": dist, "learn_rate": lr,
            "init_f": f0, "engine": "binned_cuda",
            "nbins_effective": ctx["spec"].b_val,
        }

    def _score_matrix(self, X):
        lr = float(self.params["learn_rate"])
        F = self._f0 + lr * E.predict_ensemble(X, self._trees.to(X.device))
        return _link_inv_dist(self._dist, F)


def _link_inv_dist(dist, F):
    if dist in ("bernoulli", "quasibinomial"):
        p = torch.sigmoid(F)
        return torch.stack([1 - p, p], dim=1)
    if dist in ("poisson", "gamma", "tweedie"):
        return torch.exp(F)
    return F
