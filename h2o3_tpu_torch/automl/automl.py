"""AutoML of the port (h2o3_tpu/automl/automl.py, ai/h2o/automl): the
staged model plan, the leaderboard and the stacked ensembles.

Reference: AutoML.java:40 (lifecycle; planWork :347, learn :612),
ModelingStep/ModelingStepsExecutor (step state machine), modeling/
*StepsProvider (per-algo step definitions: XGBoost x3, GLM, DRF, GBM x5,
DeepLearning x3, XRT, 2 grids, 2 stacked ensembles), leaderboard/
Leaderboard.java (ranked by CV metric), events/EventLog.

The plan is the JAX package's, step for step and parameter for parameter
(`_steps`), run on the port's estimators under the time and model
budgets: each step's work is its estimator's (the GBM steps train on the
binned engine and launch the CUDA kernels of ops/hist_cuda.py). A step is
the same model as its estimator trained alone with the step's parameters
and folds. A step without a seed of its own (GLM_1) takes the run's (1
when unset), so that its folds repeat from run to run; the JAX package
leaves it unseeded, and its folds are fresh each run. A killed run resumes from `recovery_dir` (io/persist.py
`Recovery`). `leaderboard` is a pandas DataFrame (pandas imported there);
`leaderboard_obj.as_list()` gives the rows without it.
"""

from __future__ import annotations

import time

import numpy as np

from h2o3_tpu_torch.core.frame import Frame, T_CAT
from h2o3_tpu_torch.core.kvstore import DKV


def _steps(seed: int):
    """The default modeling plan (modeling/*StepsProvider defaults)."""
    from h2o3_tpu_torch.models.deeplearning import \
        H2ODeepLearningEstimator as DL
    from h2o3_tpu_torch.models.glm import \
        H2OGeneralizedLinearEstimator as GLM
    from h2o3_tpu_torch.models.tree.drf import H2ORandomForestEstimator as DRF
    from h2o3_tpu_torch.models.tree.gbm import \
        H2OGradientBoostingEstimator as GBM
    from h2o3_tpu_torch.models.tree.xgboost import H2OXGBoostEstimator as XGB
    s = seed if seed and seed > 0 else 1
    return [
        # XGBoost steps (XGBoostStepsProvider defaults) on the native engine
        ("XGBoost_1", XGB, dict(ntrees=50, max_depth=10, min_rows=5, nbins=20,
                                learn_rate=0.3, sample_rate=0.8,
                                col_sample_rate_per_tree=0.8, seed=s)),
        ("XGBoost_2", XGB, dict(ntrees=50, max_depth=6, min_rows=10, nbins=20,
                                learn_rate=0.3, sample_rate=0.6,
                                col_sample_rate_per_tree=0.8, seed=s)),
        ("XGBoost_3", XGB, dict(ntrees=50, max_depth=15, min_rows=3, nbins=20,
                                learn_rate=0.3, sample_rate=0.8, seed=s)),
        ("GLM_1", GLM, dict(alpha=0.5, lambda_search=True, nlambdas=10,
                            max_iterations=20)),
        ("DRF_1", DRF, dict(ntrees=50, seed=s)),
        ("GBM_1", GBM, dict(ntrees=60, max_depth=6, min_rows=1,
                            learn_rate=0.1, sample_rate=0.8,
                            col_sample_rate_per_tree=0.8, seed=s)),
        ("GBM_2", GBM, dict(ntrees=60, max_depth=7, min_rows=10,
                            learn_rate=0.1, sample_rate=0.9, seed=s)),
        ("GBM_3", GBM, dict(ntrees=60, max_depth=8, min_rows=10,
                            learn_rate=0.1, seed=s)),
        ("GBM_4", GBM, dict(ntrees=60, max_depth=10, min_rows=10,
                            learn_rate=0.05, seed=s)),
        ("GBM_5", GBM, dict(ntrees=100, max_depth=15, min_rows=100,
                            learn_rate=0.05, sample_rate=0.6, seed=s)),
        ("DeepLearning_1", DL, dict(hidden=[64, 64], epochs=10, seed=s,
                                    mini_batch_size=128)),
        ("DeepLearning_2", DL, dict(hidden=[128], epochs=10, seed=s,
                                    mini_batch_size=128)),
        ("DeepLearning_3", DL, dict(hidden=[32, 32, 32], epochs=10, seed=s,
                                    mini_batch_size=128)),
        ("XRT_1", DRF, dict(ntrees=50, histogram_type="Random", seed=s)),
    ]


class Leaderboard:
    """leaderboard/Leaderboard.java: models ranked by CV metric — or by
    metrics on a held-out `leaderboard_frame` when one is supplied
    (Leaderboard.java scoring on the leaderboard frame)."""

    def __init__(self, sort_metric: str, decreasing: bool,
                 leaderboard_frame=None):
        self.sort_metric = sort_metric
        self.decreasing = decreasing
        self.leaderboard_frame = leaderboard_frame
        self.rows: list = []

    def add(self, name, model):
        if self.leaderboard_frame is not None:
            src = model._compute_metrics(self.leaderboard_frame)
        else:
            src = (model._output.cross_validation_metrics
                   or model._output.validation_metrics
                   or model._output.training_metrics)
        row = {"model_id": model.key, "step": name}
        for k in ("auc", "logloss", "mean_per_class_error", "rmse", "mse",
                  "pr_auc", "error", "mae"):
            v = getattr(src, k, None)
            if v is not None:
                row[k] = v
        self.rows.append((row, model))
        key = self.sort_metric
        self.rows.sort(key=lambda rm: rm[0].get(key, float("inf")),
                       reverse=self.decreasing)

    def as_list(self):
        return [r for r, _ in self.rows]

    @property
    def leader(self):
        return self.rows[0][1] if self.rows else None


class H2OAutoML:
    def __init__(self, max_models: int = 10, max_runtime_secs: float = 0.0,
                 seed: int = -1, nfolds: int = 5, sort_metric: str = "AUTO",
                 exclude_algos=None, include_algos=None, project_name=None,
                 balance_classes: bool = False,
                 keep_cross_validation_predictions: bool = True,
                 max_runtime_secs_per_model: float = 0.0,
                 recovery_dir: str | None = None,
                 preprocessing=None):
        self.max_models = max_models
        self.max_runtime_secs = max_runtime_secs
        self.max_runtime_secs_per_model = max_runtime_secs_per_model
        self.seed = seed
        self.nfolds = nfolds
        self.sort_metric = sort_metric
        self.exclude_algos = {a.lower() for a in (exclude_algos or [])}
        self.include_algos = ({a.lower() for a in include_algos}
                              if include_algos else None)
        self.project_name = project_name or DKV.make_key("automl")
        self.recovery_dir = recovery_dir
        # ai.h2o.automl.preprocessing.TargetEncoding: preprocessing=
        # ["target_encoding"] target-encodes high-cardinality categoricals
        # (cardinality >= 25, the reference's threshold) with CV-safe
        # kfold leakage handling before any model step runs
        self.preprocessing = [p.lower() for p in (preprocessing or [])]
        self.te_model = None
        DKV.put(self.project_name, self)
        self.leaderboard_obj = None
        self.event_log: list = []
        self.leader = None

    def _log(self, msg):
        self.event_log.append({"t": time.time(), "message": msg})

    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None, leaderboard_frame=None):
        assert y is not None and training_frame is not None
        is_cls = training_frame.vec(y).type == T_CAT
        ncls = training_frame.vec(y).cardinality if is_cls else 1
        metric = self.sort_metric
        if metric in ("AUTO", None):
            metric = ("auc" if ncls == 2 else
                      "mean_per_class_error" if is_cls else "rmse")
        decreasing = metric in ("auc", "pr_auc", "accuracy", "f1")

        # ---- preprocessing: CV-safe target encoding ----------------------
        # (TargetEncoding.java: kfold strategy on the training frame with
        # the SAME fold column the model CVs on; plain strategy elsewhere)
        te_fold_col = None
        if "target_encoding" in self.preprocessing:
            x = x or [c for c in training_frame.names if c != y]
            (x, training_frame, validation_frame, leaderboard_frame,
             te_fold_col) = self._apply_target_encoding(
                x, y, training_frame, validation_frame, leaderboard_frame)
        # reset per-train state: a second train() on a frame without
        # high-card categoricals must not inherit run 1's fold column
        self._te_fold_col = te_fold_col

        lb = Leaderboard(metric.lower(), decreasing,
                         leaderboard_frame=leaderboard_frame)
        self.leaderboard_obj = lb
        t0 = time.time()
        built = 0
        se_candidates = []

        # recovery (Recovery.java:55 + -auto_recovery_dir H2O.java:411):
        # reload finished models of a killed run, skip their steps
        recovery = None
        recovered = set()
        if self.recovery_dir:
            from h2o3_tpu_torch.io.persist import Recovery
            recovery = Recovery(self.recovery_dir)
            recovery.resume()
            recovered = set(recovery.recovered_model_keys())
            if training_frame is not None:
                recovery.checkpoint_frame(training_frame)

        def over_budget():
            return (self.max_runtime_secs
                    and time.time() - t0 > self.max_runtime_secs)

        def run_step(name, cls, params):
            nonlocal built
            p = dict(params)
            if te_fold_col is not None:
                # fold-consistent CV: models fold on the same assignment the
                # target encoder used for its out-of-fold encodings
                p["fold_column"] = te_fold_col
            else:
                p["nfolds"] = self.nfolds
            p["keep_cross_validation_predictions"] = True
            p["model_id"] = f"{self.project_name}_{name}"
            # a step without a seed of its own (GLM_1) takes the run's, so
            # that its folds are the same from run to run (the JAX package
            # leaves it unseeded: fresh random folds each time)
            p.setdefault("seed", self.seed if self.seed and self.seed > 0
                         else 1)
            # per-model budget (AutoML.java time allocation): the smaller of
            # the per-model cap and the remaining global budget
            caps = [c for c in (self.max_runtime_secs_per_model,
                                (self.max_runtime_secs
                                 - (time.time() - t0)
                                 if self.max_runtime_secs else 0.0))
                    if c and c > 0]
            if caps:
                p["max_runtime_secs"] = max(1.0, min(caps))
            if p["model_id"] in recovered:
                m = DKV.get(p["model_id"])
                if m is not None:
                    self._log(f"recovered {name}")
                    lb.add(name, m)
                    se_candidates.append(m)
                    built += 1
                    return m
            try:
                self._log(f"building {name}")
                m = cls(**p)
                m.train(x=x, y=y, training_frame=training_frame,
                        validation_frame=validation_frame)
                lb.add(name, m)
                se_candidates.append(m)
                built += 1
                if recovery is not None:
                    recovery.checkpoint_model(m)
                return m
            except Exception as ex:  # noqa: BLE001 — a failed step is logged
                self._log(f"step {name} failed: {ex!r}")
                return None

        for name, cls, params in _steps(self.seed):
            algo = cls.algo
            if self.include_algos is not None and algo not in self.include_algos:
                continue
            if algo in self.exclude_algos:
                continue
            if self.max_models and built >= self.max_models:
                break
            if over_budget():
                self._log("time budget exhausted")
                break
            run_step(name, cls, params)

        # ---- grid steps (the two default grids of AutoML.java planWork:
        # GBM + DeepLearning random-discrete grids) ------------------------
        gbm_allowed = ("gbm" not in self.exclude_algos
                       and (self.include_algos is None
                            or "gbm" in self.include_algos))
        if (not over_budget() and gbm_allowed
                and (self.max_models == 0 or built < self.max_models)):
            self._run_grid_steps(lb, se_candidates, x, y, training_frame,
                                 validation_frame, t0, recovery)
            built = len(se_candidates)

        # ---- exploitation phase (ModelingStep.DynamicStep "exploitation
        # ratio": fine-tune the current best GBM with more, slower trees) --
        if not over_budget() and lb.leader is not None:
            self._run_exploitation(lb, se_candidates, x, y, training_frame,
                                   validation_frame, recovery)
        # Stacked ensembles (best-of-family + all) when ≥2 base models
        if len(se_candidates) >= 2 and "stackedensemble" not in self.exclude_algos:
            from h2o3_tpu_torch.models.ensemble import \
                H2OStackedEnsembleEstimator
            # best-of-family over CV-capable candidates only (the ensemble
            # needs every base model's fold predictions)
            best_of_family = {}
            cand = {m.key for m in se_candidates}
            for (row, m) in lb.rows:
                if m.key in cand:
                    best_of_family.setdefault(m.algo, m)
            for se_name, base in (
                    ("StackedEnsemble_BestOfFamily",
                     list(best_of_family.values())),
                    ("StackedEnsemble_AllModels", se_candidates)):
                if len(base) < 2:
                    continue
                try:   # one failed ensemble must not kill the other
                    self._log(f"building {se_name}")
                    se = H2OStackedEnsembleEstimator(
                        base_models=base,
                        model_id=f"{self.project_name}_{se_name}")
                    se.train(y=y, training_frame=training_frame)
                    lb.add(se_name, se)
                except Exception as ex:  # noqa: BLE001
                    self._log(f"{se_name} failed: {ex!r}")
        self.leader = lb.leader
        self._log(f"done: {built} base models; leader={lb.leader.key if lb.leader else None}")
        return self

    # ------------------------------------------------------------------
    # TargetEncoding.java: DEFAULT_CARDINALITY_THRESHOLD — only columns at
    # or above this many levels are worth encoding (low-card categoricals
    # one-hot fine)
    TE_CARDINALITY_THRESHOLD = 25

    def _apply_target_encoding(self, x, y, training_frame,
                               validation_frame, leaderboard_frame):
        """ai/h2o/automl/preprocessing/TargetEncoding.java: encode
        high-cardinality categorical predictors out-of-fold on the training
        frame (kfold strategy over a dedicated fold column, blended, with
        noise) and with the plain global encodings on validation /
        leaderboard frames. Returns the rewritten
        (x, train, valid, lb_frame, fold_column)."""
        from h2o3_tpu_torch.core.frame import Vec
        from h2o3_tpu_torch.models.target_encoder import \
            H2OTargetEncoderEstimator
        te_cols = [c for c in x
                   if training_frame.vec(c).type == T_CAT
                   and training_frame.vec(c).cardinality
                   >= self.TE_CARDINALITY_THRESHOLD]
        if not te_cols:
            self._log("target_encoding: no high-cardinality columns; skipped")
            return x, training_frame, validation_frame, leaderboard_frame, None
        if self.nfolds and self.nfolds >= 2:
            fold_col = "__automl_te_fold__"
            n = training_frame.nrows
            rng = np.random.default_rng(self.seed if self.seed > 0 else 0)
            folds = rng.permutation(n) % self.nfolds
            train2 = Frame(list(training_frame.names),
                           list(training_frame.vecs),
                           key=DKV.make_key("te_train"))
            train2[fold_col] = Vec.from_numpy(folds.astype(np.float64))
            te = H2OTargetEncoderEstimator(
                data_leakage_handling="kfold", blending=True,
                inflection_point=10.0, smoothing=20.0, noise=0.01,
                seed=self.seed if self.seed > 0 else 1,
                fold_column=fold_col, columns_to_encode=te_cols)
        else:
            # nfolds=0 disables CV: a synthetic 2-fold column here would
            # force fold-based CV on every model the run builds. Fall back
            # to leave-one-out, the non-kfold leakage strategy
            # (TargetEncoding.java LeaveOneOut) — no fold column at all.
            fold_col = None
            train2 = training_frame
            te = H2OTargetEncoderEstimator(
                data_leakage_handling="loo", blending=True,
                inflection_point=10.0, smoothing=20.0, noise=0.01,
                seed=self.seed if self.seed > 0 else 1,
                columns_to_encode=te_cols)
        te.train(x=x, y=y, training_frame=train2)
        self.te_model = te
        train_enc = te.transform(train2, as_training=True)
        valid_enc = (te.transform(validation_frame)
                     if validation_frame is not None else None)
        lb_enc = (te.transform(leaderboard_frame)
                  if leaderboard_frame is not None else None)
        # models see the encodings INSTEAD of the raw high-card columns
        x_enc = [c for c in x if c not in te_cols] \
            + [f"{c}_te" for c in te_cols]
        self._log(f"target_encoding: encoded {te_cols} "
                  f"(cardinalities {[training_frame.vec(c).cardinality for c in te_cols]})")
        return x_enc, train_enc, valid_enc, lb_enc, fold_col

    def _run_grid_steps(self, lb, se_candidates, x, y, training_frame,
                        validation_frame, t0, recovery):
        """The AutoML plan's grid steps: a RandomDiscrete GBM grid under
        the remaining time/model budget (AutoML.java planWork grids)."""
        from h2o3_tpu_torch.models.grid import H2OGridSearch
        from h2o3_tpu_torch.models.tree.gbm import \
            H2OGradientBoostingEstimator
        budget_left = (self.max_runtime_secs - (time.time() - t0)
                       if self.max_runtime_secs else 0)
        if self.max_runtime_secs and budget_left < 5.0:
            return          # a sub-5s leftover cannot fit a model build
        room = (self.max_models - len(se_candidates)
                if self.max_models else 3)
        if room <= 0:
            return
        try:
            self._log("building GBM_grid_1")
            grid = H2OGridSearch(
                H2OGradientBoostingEstimator,
                hyper_params={"max_depth": [4, 7, 10],
                              "learn_rate": [0.05, 0.1],
                              "sample_rate": [0.6, 0.9]},
                grid_id=f"{self.project_name}_GBM_grid_1",
                search_criteria={"strategy": "RandomDiscrete",
                                 "max_models": min(room, 3),
                                 "max_runtime_secs": budget_left,
                                 "seed": self.seed},
                recovery_dir=self.recovery_dir)
            cv_kw = ({"fold_column": self._te_fold_col}
                     if getattr(self, "_te_fold_col", None)
                     else {"nfolds": self.nfolds})
            grid.train(x=x, y=y, training_frame=training_frame,
                       validation_frame=validation_frame,
                       keep_cross_validation_predictions=True,
                       ntrees=40, seed=self.seed if self.seed > 0 else 1,
                       **cv_kw)
            for i, m in enumerate(grid.models):
                lb.add(f"GBM_grid_1_model_{i}", m)
                se_candidates.append(m)
                if recovery is not None:
                    recovery.checkpoint_model(m)
        except Exception as ex:  # noqa: BLE001
            self._log(f"grid step failed: {ex!r}")

    def _run_exploitation(self, lb, se_candidates, x, y, training_frame,
                          validation_frame, recovery):
        """Exploitation: continue the best tree model with more trees via
        checkpoint restart (the learn-rate-annealing exploitation step of
        the reference plan).

        The continued model trains WITHOUT CV (a checkpoint restart cannot
        re-fold), so it only enters the leaderboard when ranking happens on
        a common held-out frame (leaderboard_frame / validation) — training
        metrics would compare optimistically against the others' CV
        metrics. It never joins se_candidates (no cv predictions)."""
        leader = lb.leader
        # gbm only: the xgboost estimator rejects `checkpoint` so its
        # continuation would fail on every run
        if getattr(leader, "algo", None) != "gbm":
            return
        holdout = (lb.leaderboard_frame is not None
                   or validation_frame is not None)
        if not holdout:
            self._log("exploitation skipped: no held-out frame to rank "
                      "a non-CV continuation fairly")
            return
        try:
            self._log("exploitation: continuing leader")
            cls = leader.__class__
            p = {k: v for k, v in leader.params.items() if v is not None}
            p["ntrees"] = int(p.get("ntrees") or 50) + 25
            p["checkpoint"] = leader.key
            p["model_id"] = f"{self.project_name}_{leader.algo}_exploit"
            p["nfolds"] = 0
            p.pop("keep_cross_validation_predictions", None)
            p.pop("keep_cross_validation_fold_assignment", None)
            m = cls(**p)
            m.train(x=x, y=y, training_frame=training_frame,
                    validation_frame=validation_frame)
            lb.add("exploitation", m)
            if recovery is not None:
                recovery.checkpoint_model(m)
        except Exception as ex:  # noqa: BLE001
            self._log(f"exploitation failed: {ex!r}")

    @property
    def leaderboard(self):
        import pandas as pd
        return pd.DataFrame(self.leaderboard_obj.as_list())

    def predict(self, test_data: Frame) -> Frame:
        if self.te_model is not None:
            # leader was trained on target-encoded columns: apply the same
            # (plain-strategy) encodings before scoring
            test_data = self.te_model.transform(test_data)
        return self.leader.predict(test_data)
