"""SharedTree driver of the port (h2o3_tpu/models/tree/shared_tree.py):
GBM on the binned and on the adaptive tree engine.

On the binned engine the frame is quantized once into a uint8 code plane
on its device; trees grow in chunks of `score_tree_interval` through
`binned.gbm_chunk_trainer`, which runs the CUDA route and histogram
kernels for tensors on a card. After each chunk the training margins are
scored into the scoring history, and so is a validation frame when one is
given (its margins advance chunk by chunk); early stopping reads that
history (ScoreKeeper.stopEarly). The estimator's kernel flags mean what
they mean in the JAX package: `int8_hist` (off unless True) quantizes the
histogram stats to int8; `radix_shallow` and `fused_level` (on unless
False) take the shallow-window and level-fused kernels where a level
qualifies. A multinomial response grows K class trees an iteration
(`binned.gbm_multi_chunk_trainer`); `checkpoint=` resumes boosting from a
binned prior's trees, its margins rebuilt by walking the training rows
through them.

What the JAX package's gate (`_binned_ok`) turns away grows on the
adaptive engine (`engine.TreeGrower`), one tree at a time:
histogram_type other than AUTO, QuantilesGlobal or Binned, max_depth
above 10, and a checkpoint whose prior that engine grew. Its trees take
the Newton leaf refit (`engine.gamma_pass`) for every distribution but
gaussian, and record their node covers, from which
`predict_contributions` computes TreeSHAP.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.model import ModelBase
from h2o3_tpu_torch.models.tree import binned as BN
from h2o3_tpu_torch.models.tree import engine as E
from h2o3_tpu_torch.obs.timeline import span as _span
from h2o3_tpu_torch.udf import resolve_udf

class SharedTreeEstimator(ModelBase):
    """Common driver of the tree estimators."""

    # serving: the ensembles (`_trees` for the single-output
    # distributions, `_trees_k` per class for multinomial) are the shared
    # params; `_f0` stays the model's own (the scorer reads it as a
    # number). The JAX package shards the tree axis over a "model" mesh
    # axis; one card holds one copy.
    _serving_param_attrs = ("_trees", "_trees_k")
    _partition_rules = ((r"^_trees", ("model",)),)

    _tree_defaults = {
        "ntrees": 50, "max_depth": 5, "min_rows": 10.0, "nbins": 20,
        "nbins_cats": 1024, "learn_rate": 0.1, "sample_rate": 1.0,
        "col_sample_rate": 1.0, "col_sample_rate_per_tree": 1.0,
        "min_split_improvement": 1e-5, "mtries": -2,
        "score_tree_interval": 5, "stopping_rounds": 0,
        "stopping_metric": "AUTO", "stopping_tolerance": 1e-3,
        "build_tree_one_node": False, "histogram_type": "AUTO",
        "calibrate_model": False, "balance_classes": False,
        "monotone_constraints": None, "nbins_top_level": None,
        # kernel flags (None = the JAX package's default: int8 off, radix
        # and fused on wherever the level qualifies; False forces the dense
        # histogram / the sequential route-then-histogram pair)
        "int8_hist": None, "radix_shallow": None, "fused_level": None,
    }
    # build_tree_one_node is a placement hint, meaningless on one card, and
    # taken; calibrate_model would add calibrated columns, which the JAX
    # package never computes
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + (
        ("calibrate_model", False,
         "the JAX package accepts it and never calibrates "
         "(h2o3_tpu/models/tree/shared_tree.py:57)"),)

    # a custom distribution's UDF, resolved by GBM's _fit
    _udf_dist = None

    def _cat_mode(self) -> str:
        return "label"

    def _validate_early_stopping(self):
        """Fail fast on an unusable stopping_metric (H2O validates at
        build-parameter time, not 2*stopping_rounds scoring events in)."""
        if int(self.params.get("stopping_rounds") or 0) <= 0:
            return
        want = str(self.params.get("stopping_metric") or "AUTO").lower()
        want = {"aucpr": "pr_auc"}.get(want, want)
        if want in ("auto", ""):
            return
        known = {"auc", "pr_auc", "logloss", "rmse", "mae", "r2",
                 "classification_error"}
        cls_only = {"auc", "pr_auc", "logloss", "classification_error"}
        reg_only = {"mae", "r2"}
        if want not in known:
            raise ValueError(f"unknown stopping_metric {want!r}; "
                             f"supported: {sorted(known)}")
        if self._is_classifier and want in reg_only:
            raise ValueError(f"stopping_metric={want!r} is a regression "
                             "metric but the response is categorical")
        if not self._is_classifier and want in cls_only:
            raise ValueError(f"stopping_metric={want!r} is a "
                             "classification metric but the response is "
                             "numeric")

    # ---- shared plumbing -----------------------------------------------------
    def _prep(self, frame: Frame):
        self._validate_early_stopping()
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

    # ---- the adaptive engine's plumbing -------------------------------------
    def _grower(self):
        p = self.params
        return E.TreeGrower(nbins=int(p["nbins"]),
                            max_depth=int(p["max_depth"]),
                            min_rows=float(p["min_rows"]),
                            min_split_improvement=float(
                                p["min_split_improvement"]))

    def _draws(self, device):
        """The random draws of adaptive growth, from a torch.Generator on
        the rows' device seeded from `seed` (42 when unset)."""
        return E.Draws(_generator(self.params, device))

    def _sample_weights(self, w, draws, rate):
        """A tree's row sample: weights of the rows drawn in, 0 elsewhere."""
        if rate >= 1.0:
            return w
        return w * (draws.rows(w.shape[0]) < rate)

    def _col_mask(self, C, draws):
        """A tree's column sample (col_sample_rate_per_tree), or None."""
        rate = float(self.params.get("col_sample_rate_per_tree") or 1.0)
        if rate >= 1.0:
            return None
        k = max(1, int(round(rate * C)))
        r = draws.cols(C)
        return r <= torch.sort(r).values[k - 1]

    # ---- SHAP contributions (Model.PredictContributions) --------------------
    def predict_contributions(self, test_data: Frame) -> Frame:
        """Per-row TreeSHAP feature contributions and a BiasTerm, in margin
        space: each row sums to its margin prediction."""
        from h2o3_tpu_torch.models.tree import contrib
        if getattr(self, "_trees", None) is None:
            # the reference asserts
            raise AssertionError("contributions supported for "
                                 "regression/binomial tree models")
        X = self._dinfo.matrix(test_data).double().cpu().numpy()
        phi = contrib.ensemble_shap(self._trees, X)
        scale, bias0 = self._contrib_scale_bias()
        phi *= scale
        phi[:, -1] += bias0
        names = list(self._dinfo.feature_names) + ["BiasTerm"]
        return Frame(names, [Vec.from_numpy(phi[:, j])
                             for j in range(phi.shape[1])])

    def _contrib_scale_bias(self):
        return 1.0, 0.0

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
            monotone=mono if mc else None, device=X.device,
            int8_stats=p.get("int8_hist"),
            use_radix_shallow=p.get("radix_shallow"),
            fused_level=p.get("fused_level"))
        n_pad = grower.layout(n)
        codes = BN.quantize(X, spec, n_pad=n_pad)
        return dict(X=X, y=y, w=w, y1=BN.pad_rows(y, n_pad),
                    w1=BN.pad_rows(w, n_pad), codes=codes, n=n, C=C,
                    is_cat=is_cat, spec=spec, grower=grower, n_pad=n_pad)

    def _binned_tree_arrays(self, ctx, chunks, prev=None, lead=None):
        """TreeArrays from the trainer's chunk outputs, with a checkpoint
        prior's trees in front when `prev` is given, and the summed
        per-column gains of the new trees. `lead` picks one ensemble out of
        chunks with extra leading dims (class k of the multinomial
        trainer's (iters, K, ...) chunks)."""
        spec, C = ctx["spec"], ctx["C"]
        sel = (lambda a: a) if lead is None else lead  # noqa: E731

        def cat(i):
            return torch.cat([sel(c[i]) for c in chunks])
        colT, binT, nalT, wordsT, valT = (cat(i) for i in range(5))
        gainsT = cat(5).sum(0)
        coverT = cat(6)
        edges = torch.as_tensor(spec.edges, device=colT.device)
        thrT = edges[colT.long().clamp(0, C - 1),
                     binT.long().clamp(0, spec.edges.shape[1] - 1)]
        any_cat = bool(ctx["is_cat"].any())
        if prev is not None:
            prev = prev.to(colT.device)
            colT = torch.cat([prev.col, colT])
            thrT = torch.cat([prev.thr, thrT])
            nalT = torch.cat([prev.na_left, nalT])
            valT = torch.cat([prev.value, valT])
            coverT = torch.cat([prev.cover if prev.cover is not None
                                else torch.zeros_like(prev.value), coverT])
            if any_cat:
                pw = prev.catbits if prev.catbits is not None else \
                    torch.zeros((prev.ntrees,) + tuple(wordsT.shape[1:]),
                                dtype=wordsT.dtype, device=wordsT.device)
                wordsT = torch.cat([pw, wordsT])
        ta = E.TreeArrays(
            col=colT, thr=thrT, na_left=nalT, value=valT,
            depth=ctx["grower"].D, cover=coverT,
            catbits=wordsT if any_cat else None,
            col_is_cat=(np.pad(ctx["is_cat"], (0, spec.c_pad - C))
                        if any_cat else None))
        return ta, gainsT

    def _record_history(self, ntrees, F, y, w, dist):
        mu = _link_inv_dist(dist, F, udf=self._udf_dist)
        if self._is_classifier:
            m = M.binomial_metrics(y, mu[:, 1], w)
            h = {"number_of_trees": ntrees, "training_logloss": m.logloss,
                 "training_auc": m.auc, "training_pr_auc": m.pr_auc,
                 "training_rmse": m.rmse}
        else:
            m = M.regression_metrics(y, mu, w)
            h = {"number_of_trees": ntrees, "training_rmse": m.rmse,
                 "training_mae": m.mae, "training_r2": m.r2}
        h.update(self._valid_history_entry(dist))
        self._output.scoring_history.append(h)

    def _record_history_multi(self, ntrees, F, y, w):
        m = M.multinomial_metrics(y, torch.softmax(F, dim=1), w)
        h = {"number_of_trees": ntrees, "training_logloss": m.logloss,
             "training_classification_error": m.error}
        h.update(self._valid_history_entry())
        self._output.scoring_history.append(h)

    # ---- incremental validation scoring (ScoreKeeper valid series) ---------
    def _valid_setup(self, f0):
        """Validation margins for the scoring history: the model in progress
        scores the validation frame at every scoring event
        (SharedTree.doScoringAndSaveModel), so the margins advance chunk by
        chunk rather than being rebuilt from the final ensemble."""
        vf = getattr(self, "_valid_for_scoring", None)
        self._vstate = None
        if vf is None:
            return
        di = self._dinfo
        yv = di.response(vf)
        wv = torch.where(torch.isnan(yv), 0.0, di.weights(vf))
        yv = torch.where(torch.isnan(yv), 0.0, yv)
        Fv = torch.full((int(vf.nrows),), float(f0), dtype=torch.float32,
                        device=yv.device)
        self._vstate = {"X": di.matrix(vf), "y": yv, "w": wv, "F": Fv}

    def _valid_advance(self, new_trees, lr):
        """Add a just-trained chunk of trees to the validation margins (one
        batched walk over the validation rows)."""
        if self._vstate is None or new_trees.ntrees == 0:
            return
        self._vstate["F"] = self._vstate["F"] + \
            lr * E.predict_ensemble(self._vstate["X"], new_trees)

    def _valid_history_entry(self, dist="gaussian") -> dict:
        if getattr(self, "_vstate", None) is None:
            return {}
        vs = self._vstate
        mu = _link_inv_dist(dist, vs["F"],
                            udf=self._udf_dist)
        vm = self._metrics_from_preds(vs["y"], mu, vs["w"])
        out = {}
        for k in ("logloss", "auc", "pr_auc", "rmse", "mae", "r2"):
            v = getattr(vm, k, None)
            if v is not None:
                out[f"validation_{k}"] = v
        return out

    def _train_chunks(self, done, step):
        """The chunk loop of every binned path: `step(k, done)` grows k
        more trees (iterations of K class trees for multinomial), records
        the scoring history at `done` trees and returns the chunk's trees.
        The loop ends at ntrees, on early stopping or past the deadline."""
        ntrees = int(self.params["ntrees"])
        interval = max(1, int(self.params.get("score_tree_interval") or 5))
        chunks = []
        while done < ntrees:
            k = min(interval, ntrees - done)
            done += k
            chunks.append(step(k, done))
            if self._should_stop() or self._budget_exhausted():
                break
        return chunks

    def _should_stop(self) -> bool:
        """ScoreKeeper.stopEarly: stop when the chosen stopping_metric has
        not improved over the last `stopping_rounds` scoring events."""
        k = int(self.params.get("stopping_rounds") or 0)
        if k <= 0 or len(self._output.scoring_history) < 2 * k:
            return False
        hist = self._output.scoring_history
        want = str(self.params.get("stopping_metric") or "AUTO").lower()
        want = {"aucpr": "pr_auc"}.get(want, want)
        maximize = want in ("auc", "pr_auc", "r2")
        metric = None
        if want not in ("auto", ""):
            # the validation series wins when a validation frame was scored
            for prefix in ("validation_", "training_"):
                if prefix + want in hist[-1]:
                    metric = prefix + want
                    break
            if metric is None:
                metric = next((key for key in hist[-1]
                               if key.endswith("_" + want)), None)
            if metric is None:
                raise ValueError(
                    f"stopping_metric={want!r} is not recorded for this "
                    f"problem type (available: {sorted(hist[-1])})")
        else:
            maximize = False
            metric = next((c for c in ("validation_logloss",
                                       "validation_rmse", "training_logloss",
                                       "training_rmse") if c in hist[-1]),
                          None)
            if metric is None:
                return False
        vals = [h[metric] for h in hist]
        # a tolerance of 0 is valid (stop on any non-improvement); the
        # comparisons are inclusive, so an exact plateau stops; the
        # tolerance scales with |past|, so a negative metric (r2 < 0) keeps
        # its direction
        tol_raw = self.params.get("stopping_tolerance")
        tol = 1e-3 if tol_raw is None else float(tol_raw)
        if maximize:
            recent, past = max(vals[-k:]), max(vals[:-k])
            return recent <= past + tol * abs(past)
        recent, past = min(vals[-k:]), min(vals[:-k])
        return recent >= past - tol * abs(past)

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
        # a custom distribution UDF (water/udf CDistributionFunc); the
        # binned gate turns it away, so it grows on the adaptive engine
        self._udf_dist = None
        if dist == "custom":
            self._udf_dist = resolve_udf(
                self.params.get("custom_distribution_func"))
        if self._binned_ok(dist):
            if dist == "multinomial":
                return self._fit_binned_multinomial(frame)
            return self._fit_binned(frame, dist)
        X, y, w = self._prep(frame)
        if dist == "multinomial":
            return self._fit_multinomial(X, y, w)
        return self._fit_adaptive(X, y, w, dist)

    def _binned_ok(self, dist) -> bool:
        """The JAX package's gate of its binned engine; what fails it goes
        to the adaptive engine there. A checkpoint restart needs a binned
        prior (array-stacked trees)."""
        ht = str(self.params.get("histogram_type") or "AUTO").lower()
        if not (ht in ("auto", "quantilesglobal", "binned")
                and dist in ("gaussian", "bernoulli", "quasibinomial",
                             "poisson", "gamma", "tweedie", "laplace",
                             "multinomial")
                and int(self.params["max_depth"]) <= 10):
            return False
        ckpt = self.params.get("checkpoint")
        if ckpt:
            summary = self._resolve_checkpoint(ckpt).summary() or {}
            return summary.get("engine") in BINNED_ENGINES
        return True

    def _resolve_checkpoint(self, ckpt):
        """The prior model, by DKV key or as the model itself."""
        prev = DKV.get(ckpt) if isinstance(ckpt, str) else ckpt
        if prev is None or getattr(prev, "algo", None) != self.algo:
            # the reference asserts
            raise AssertionError(f"checkpoint {ckpt} not found or wrong algo")
        return prev

    def _restart_checks(self, prev_trees, ntrees, grower, per=""):
        """The reference's checks of a restart: the prior's depth, and
        more trees than it has."""
        done = prev_trees.ntrees
        if prev_trees.depth != grower.D:
            raise AssertionError(
                "checkpoint restart requires identical max_depth")
        if done >= ntrees:
            raise ValueError(
                f"checkpoint model already has {done} trees{per}; ntrees "
                f"({ntrees}) must exceed it to continue training "
                "(ModelBuilder checkpoint validation)")

    def _fit_binned(self, frame: Frame, dist: str):
        p = self.params
        ctx = self._binned_setup(frame)
        grower = ctx["grower"]
        y, w, y1, w1 = ctx["y"], ctx["w"], ctx["y1"], ctx["w1"]
        n, C, n_pad = ctx["n"], ctx["C"], ctx["n_pad"]
        dev = y.device
        ntrees = int(p["ntrees"])
        lr = float(p["learn_rate"])
        gen = _generator(p, dev)
        f0 = _initial_f0(dist, y, w)
        prev = None
        if p.get("checkpoint"):
            # binned restart (SharedTree.java:132): the prior's f0, and the
            # margins of its ensemble walked over the training rows
            prev_model = self._resolve_checkpoint(p["checkpoint"])
            prev = prev_model._trees.to(dev)
            self._restart_checks(prev, ntrees, grower)
            f0 = prev_model._f0
            F = BN.pad_rows(f0 + lr * E.predict_ensemble(ctx["X"], prev),
                            n_pad)
        else:
            # margins: f0 on the real rows, 0 on the padding rows
            F = torch.where(torch.arange(n_pad, device=dev) < n, f0, 0.0) \
                .to(torch.float32)
        self._f0 = f0
        self._valid_setup(f0)
        if prev is not None:
            # the validation margins include the prior's trees too
            self._valid_advance(prev, lr)

        def step(k, done):
            nonlocal F
            trainer = BN.gbm_chunk_trainer(
                grower, n, dist=dist, eta=lr,
                sample_rate=float(p["sample_rate"]),
                mtries=self._per_level_mtries(C), k_trees=k,
                col_rate_tree=float(p.get("col_sample_rate_per_tree") or 1.0))
            with _span("gbm.chunk", trees=k, rows=n, engine="binned"):
                F, trees = trainer(ctx["codes"], y1, w1, F, gen)
            E.ROW_TREES.inc(n * k, engine="binned")
            if self._vstate is not None:
                self._valid_advance(self._binned_tree_arrays(ctx, [trees])[0],
                                    lr)
            self._record_history(done, F[:n], y, w, dist)
            return trees
        chunks = self._train_chunks(prev.ntrees if prev is not None else 0,
                                    step)

        self._trees, gainsT = self._binned_tree_arrays(ctx, chunks, prev=prev)
        self._bin_spec = ctx["spec"]
        self._varimp_from_gains(gainsT[:C].double().cpu().numpy())
        self._output.model_summary = {
            "number_of_trees": int(self._trees.ntrees),
            "max_depth": grower.D, "distribution": dist, "learn_rate": lr,
            "init_f": f0, "engine": "binned_cuda",
            "nbins_effective": ctx["spec"].b_val,
        }

    def _fit_binned_multinomial(self, frame: Frame):
        """K class trees an iteration (the SharedTree.java:548-561 K-tree
        layer). As in the JAX package, no validation series is recorded;
        the validation metrics come at the end of train()."""
        self._vstate = None
        p = self.params
        ctx = self._binned_setup(frame)
        grower = ctx["grower"]
        y, w, y1, w1 = ctx["y"], ctx["w"], ctx["y1"], ctx["w1"]
        n, C, n_pad = ctx["n"], ctx["C"], ctx["n_pad"]
        dev = y.device
        K = self.nclasses
        ntrees = int(p["ntrees"])
        lr = float(p["learn_rate"])
        gen = _generator(p, dev)
        f0 = _class_prior_f0(y, w, K)
        prevs = None
        if p.get("checkpoint"):
            prev_model = self._resolve_checkpoint(p["checkpoint"])
            prevs = [t.to(dev) for t in prev_model._trees_k]
            self._restart_checks(prevs[0], ntrees, grower, per=" per class")
            f0 = np.asarray(prev_model._f0, np.float32)
            Fc = torch.stack(
                [float(f0[c]) + lr * E.predict_ensemble(ctx["X"], prevs[c])
                 for c in range(K)], dim=1)
            F = torch.zeros((n_pad, K), dtype=torch.float32, device=dev)
            F[:n] = Fc
        else:
            F = torch.where((torch.arange(n_pad, device=dev) < n)[:, None],
                            torch.as_tensor(f0, device=dev)[None, :], 0.0) \
                .to(torch.float32)
        self._f0 = f0

        def step(k, done):
            nonlocal F
            trainer = BN.gbm_multi_chunk_trainer(
                grower, n, n_classes=K, eta=lr,
                sample_rate=float(p["sample_rate"]),
                mtries=self._per_level_mtries(C), k_iters=k,
                col_rate_tree=float(p.get("col_sample_rate_per_tree") or 1.0))
            with _span("gbm.chunk", trees=k * K, rows=n,
                       engine="binned_multinomial"):
                F, trees = trainer(ctx["codes"], y1, w1, F, gen)
            E.ROW_TREES.inc(n * k * K, engine="binned")
            self._record_history_multi(done, F[:n], y, w)
            return trees
        chunks = self._train_chunks(
            prevs[0].ntrees if prevs is not None else 0, step)

        # chunks hold (iters, K, ...) tensors: one ensemble per class
        self._trees_k, gains = [], 0.0
        for c in range(K):
            ta, g = self._binned_tree_arrays(
                ctx, chunks, prev=prevs[c] if prevs is not None else None,
                lead=lambda a, c=c: a[:, c])
            self._trees_k.append(ta)
            gains = gains + g
        self._bin_spec = ctx["spec"]
        self._varimp_from_gains(gains[:C].double().cpu().numpy())
        self._output.model_summary = {
            "number_of_trees": sum(t.ntrees for t in self._trees_k),
            "max_depth": grower.D, "distribution": "multinomial",
            "learn_rate": lr, "engine": "binned_cuda",
            "nbins_effective": ctx["spec"].b_val,
        }

    # ---- the adaptive engine (UniformAdaptive, deep trees) -----------------
    def _fit_adaptive(self, X, y, w, dist):
        """One tree at a time on the adaptive engine: pseudo-residuals,
        a tree grown on them, the Newton leaf refit (not for gaussian), the
        margins advanced by lr · value[heap]. A checkpoint restart takes
        the prior's trees, f0 and covers (rebuilt from the training rows
        when the prior has none) and resumes from their margins."""
        p = self.params
        ntrees = int(p["ntrees"])
        lr = float(p["learn_rate"])
        dev = X.device
        draws = self._draws(dev)
        grower = self._grower()
        udf = self._udf_dist
        f0 = _initial_f0(dist, y, w, udf=udf)
        F = torch.full((X.shape[0],), f0, dtype=torch.float32, device=dev)
        sample_rate = float(p["sample_rate"])
        trees = []
        if p.get("checkpoint"):
            prev = self._resolve_checkpoint(p["checkpoint"])
            pt = prev._trees.to(dev)
            if pt.depth != grower.D:
                raise AssertionError(
                    "checkpoint restart requires identical max_depth")
            if pt.cover is not None:
                pcov = pt.cover
            else:
                # a prior without covers: route the training rows through
                # its trees (TreeSHAP then still sums to the margin)
                heaps, _ = E.predict_leaf_ids(X, pt)
                pcov = [E.node_covers(heaps[i], w, nodes=grower.nodes,
                                      D=grower.D) for i in range(pt.ntrees)]
            trees = [(pt.col[i], pt.thr[i], pt.na_left[i], pt.value[i],
                      pcov[i]) for i in range(pt.ntrees)]
            f0 = prev._f0
            F = f0 + lr * E.predict_ensemble(X, pt)
        self._f0 = f0
        gains_tot = torch.zeros(X.shape[1], dtype=torch.float32, device=dev)
        interval = max(1, int(p.get("score_tree_interval") or 5))
        mtries = self._per_level_mtries(X.shape[1])
        self._valid_setup(f0)
        if trees:   # the prior's trees score the validation frame too
            self._valid_advance(E.stack_trees(trees, grower.D), lr)
        scored = len(trees)
        for t in range(len(trees), ntrees):
            res, hess = _grad_hess(dist, F, y, udf=udf)
            wt = self._sample_weights(w, draws, sample_rate)
            cmask = self._col_mask(X.shape[1], draws)
            col, thr, nal, val, heap, g = grower.grow(
                X, wt, res, col_mask=cmask, draw=draws.levels(),
                mtries=mtries)
            gains_tot += g
            if dist != "gaussian":
                val = E.gamma_pass(heap, wt, res, hess, val,
                                   nodes=grower.nodes)
            trees.append((col, thr, nal, val,
                          E.node_covers(heap, wt, nodes=grower.nodes,
                                        D=grower.D)))
            F = F + lr * val[heap]
            if (t + 1) % interval == 0 or t == ntrees - 1:
                if self._vstate is not None and len(trees) > scored:
                    self._valid_advance(
                        E.stack_trees(trees[scored:], grower.D), lr)
                    scored = len(trees)
                self._record_history(t + 1, F, y, w, dist)
                if self._should_stop() or self._budget_exhausted():
                    break
        self._trees = E.stack_trees(trees, grower.D)
        self._varimp_from_gains(gains_tot.double().cpu().numpy())
        self._output.model_summary = {
            "number_of_trees": self._trees.ntrees, "max_depth": grower.D,
            "distribution": dist, "learn_rate": lr, "init_f": f0,
            "engine": "adaptive",
        }

    def _fit_multinomial(self, X, y, w):
        """K class trees an iteration on the adaptive engine, Newton leaves
        scaled by (K-1)/K; no validation series, as in the JAX package."""
        self._vstate = None
        p = self.params
        if p.get("checkpoint"):
            raise NotImplementedError(
                "gbm: a multinomial checkpoint restart from a prior the "
                "adaptive engine grew is not supported (the JAX package's "
                "adaptive multinomial path has no restart)")
        K = self.nclasses
        ntrees = int(p["ntrees"])
        lr = float(p["learn_rate"])
        dev = X.device
        draws = self._draws(dev)
        grower = self._grower()
        f0 = _class_prior_f0(y, w, K)
        self._f0 = f0
        F = torch.as_tensor(f0, device=dev)[None, :].repeat(X.shape[0], 1)
        trees_k = [[] for _ in range(K)]
        gains_tot = torch.zeros(X.shape[1], dtype=torch.float32, device=dev)
        interval = max(1, int(p.get("score_tree_interval") or 5))
        onehot = torch.nn.functional.one_hot(y.long(), K).to(torch.float32)
        sample_rate = float(p["sample_rate"])
        mtries = self._per_level_mtries(X.shape[1])
        for t in range(ntrees):
            R = onehot - torch.softmax(F, dim=1)
            wt = self._sample_weights(w, draws, sample_rate)
            cmask = self._col_mask(X.shape[1], draws)
            newF = []
            for c in range(K):
                res = R[:, c]
                col, thr, nal, val, heap, g = grower.grow(
                    X, wt, res, col_mask=cmask, draw=draws.levels(),
                    mtries=mtries)
                gains_tot += g
                absr = res.abs()
                val = E.gamma_pass(heap, wt, res, absr * (1 - absr), val,
                                   nodes=grower.nodes, scale=(K - 1) / K)
                trees_k[c].append((col, thr, nal, val,
                                   E.node_covers(heap, wt,
                                                 nodes=grower.nodes,
                                                 D=grower.D)))
                newF.append(F[:, c] + lr * val[heap])
            F = torch.stack(newF, dim=1)
            if (t + 1) % interval == 0 or t == ntrees - 1:
                self._record_history_multi(t + 1, F, y, w)
                if self._should_stop() or self._budget_exhausted():
                    break
        self._trees_k = [E.stack_trees(tl, grower.D) for tl in trees_k]
        self._varimp_from_gains(gains_tot.double().cpu().numpy())
        self._output.model_summary = {
            "number_of_trees": sum(t.ntrees for t in self._trees_k),
            "max_depth": grower.D, "distribution": "multinomial",
            "learn_rate": lr, "engine": "adaptive",
        }

    def _score_matrix(self, X):
        lr = float(self.params["learn_rate"])
        if self._dist == "multinomial":
            F = torch.stack(
                [float(self._f0[c])
                 + lr * E.predict_ensemble(X, ta.to(X.device))
                 for c, ta in enumerate(self._trees_k)], dim=1)
            return torch.softmax(F, dim=1)
        F = self._f0 + lr * E.predict_ensemble(X, self._trees.to(X.device))
        return _link_inv_dist(self._dist, F,
                              udf=self._udf_dist)

    def _contrib_scale_bias(self):
        return float(self.params["learn_rate"]), float(self._f0)


# Engines whose trees a binned checkpoint restart takes: the port's, and
# the JAX package's binned engine (a model carried across by convert.py).
BINNED_ENGINES = ("binned_cuda", "binned_pallas")


def _generator(params, device):
    """The trainers' random draws: a torch.Generator seeded from `seed`
    (42 when unset)."""
    seed = int(params.get("seed") or -1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed if seed >= 0 else 42)
    return gen


def _initial_f0(dist, y, w, udf=None) -> float:
    """The initial margin from the weighted response mean: a custom
    distribution's init_f0 of it, its logit for bernoulli, its log for
    poisson, gamma and tweedie, the mean itself otherwise (quasibinomial
    and laplace included, as in the reference)."""
    wsum, wysum = torch.stack([w.sum(), (w * y).sum()]).cpu().tolist()
    ybar = wysum / max(wsum, 1e-30)
    if udf is not None:
        return float(udf.init_f0(ybar))
    if dist == "bernoulli":
        p0 = min(max(ybar, 1e-10), 1 - 1e-10)
        return math.log(p0 / (1 - p0))
    if dist in ("poisson", "gamma", "tweedie"):
        return math.log(max(ybar, 1e-10))
    return ybar


def _class_prior_f0(y, w, K) -> np.ndarray:
    """f0[c] = log of the weighted class prior, summed in f64."""
    wn = w.double()
    prior = torch.zeros(K, dtype=torch.float64, device=w.device) \
        .index_add_(0, y.long(), wn) / wn.sum().clamp(min=1e-30)
    return np.log(np.maximum(prior.cpu().numpy(), 1e-10)).astype(np.float32)


def _grad_hess(dist, F, y, udf=None):
    """ComputePredAndRes (GBM.java:981): per-row pseudo-residual and
    hessian, a custom distribution's own when one is given. Huber and
    quantile are in no engine of the JAX package."""
    if udf is not None:
        return udf.grad_hess(F, y)
    if dist == "gaussian":
        return y - F, torch.ones_like(F)
    if dist in ("bernoulli", "quasibinomial"):
        p = torch.sigmoid(F)
        return y - p, p * (1 - p)
    if dist == "poisson":
        mu = torch.exp(F)
        return y - mu, mu
    if dist == "gamma":
        mu = torch.exp(F)
        return y / mu - 1.0, y / mu
    if dist == "tweedie":
        mu = torch.exp(F)
        return y * torch.pow(mu, -0.5) - torch.pow(mu, 0.5), \
            0.5 * (y * torch.pow(mu, -0.5) + torch.pow(mu, 0.5))
    if dist == "laplace":
        return torch.sign(y - F), torch.ones_like(F)
    raise NotImplementedError(f"GBM distribution {dist}")


def _link_inv_dist(dist, F, udf=None):
    if udf is not None:
        return udf.link_inv(F)
    if dist in ("bernoulli", "quasibinomial"):
        p = torch.sigmoid(F)
        return torch.stack([1 - p, p], dim=1)
    if dist in ("poisson", "gamma", "tweedie"):
        return torch.exp(F)
    return F
