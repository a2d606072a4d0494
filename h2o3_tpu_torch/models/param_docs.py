"""Parameter documentation attached to every estimator class —
the h2o-py generated-docstring surface (h2o-bindings gen_python.py emits
one documented property per parameter; here one shared table renders a
parameter section into each estimator's __doc__ at import, so
``help(H2OGradientBoostingEstimator)`` reads like the reference's).

Descriptions are condensed from the reference schema help strings
(water/api/API.java help= annotations across */ModelParametersSchemaV3).
"""

from __future__ import annotations

PARAM_DOCS = {
    # shared ModelBuilder surface (ModelParametersSchemaV3)
    "model_id": "Destination key for the model (auto-generated when None).",
    "seed": "RNG seed for sampling/initialization; -1 = time-based.",
    "nfolds": "Number of cross-validation folds (0 = none).",
    "fold_assignment": "CV fold scheme: AUTO, Random, Modulo, Stratified.",
    "fold_column": "Column holding explicit fold indices for CV.",
    "keep_cross_validation_predictions":
        "Retain per-fold holdout predictions (needed for stacking).",
    "keep_cross_validation_fold_assignment":
        "Retain the fold-assignment frame.",
    "weights_column": "Observation weights column.",
    "offset_column": "Per-row model offset column (GLM/GBM margins).",
    "ignored_columns": "Columns excluded from training.",
    "ignore_const_cols": "Drop constant columns before training.",
    "max_runtime_secs": "Wall-clock budget for the build (0 = unlimited).",
    "standardize": "Standardize numeric columns to zero mean/unit variance.",
    "categorical_encoding": "Categorical handling (AUTO = algo default).",
    "distribution": "Loss family (AUTO resolves from the response type).",
    "checkpoint": "Model key to resume training from.",
    "export_checkpoints_dir": "Directory receiving per-iteration exports.",
    "custom_metric_func": "UDF computing an extra scoring metric.",
    "custom_distribution_func": "UDF loss (gradient/link) for boosting.",
    # tree family (SharedTreeV3 + GBMV3/DRFV3)
    "ntrees": "Number of trees (TOTAL, including a checkpoint's).",
    "max_depth": "Maximum tree depth.",
    "min_rows": "Minimum observation weight in a leaf.",
    "learn_rate": "Boosting shrinkage (GBM/XGBoost eta).",
    "sample_rate": "Row sample rate per tree.",
    "col_sample_rate": "Column sample rate per split level.",
    "col_sample_rate_per_tree": "Column sample rate per tree.",
    "nbins": "Histogram bins for numeric splits.",
    "nbins_cats": "Histogram bins for categorical splits.",
    "nbins_top_level": "Root-level bins (halve per level to nbins).",
    "min_split_improvement": "Minimum relative SE improvement to split.",
    "histogram_type": "Binning scheme (AUTO/UniformAdaptive/QuantilesGlobal).",
    "score_tree_interval": "Score every this-many trees.",
    "stopping_rounds": "Early-stop after this many non-improving scores.",
    "stopping_metric": "Metric driving early stopping.",
    "stopping_tolerance": "Relative improvement below which to stop.",
    "monotone_constraints": "Per-column {+1,-1} monotonicity constraints.",
    "calibrate_model": "Fit a Platt calibration model on holdout data.",
    "balance_classes": "Over/under-sample to balance class counts.",
    "mtries": "Columns tried per split (DRF; -1 = sqrt(p)).",
    "binomial_double_trees": "DRF: build one tree per class for binomial.",
    "reg_lambda": "L2 regularization on leaf weights (XGBoost lambda).",
    "reg_alpha": "L1 regularization on leaf weights (XGBoost alpha).",
    "booster": "gbtree or dart.",
    "rate_drop": "DART: per-iteration tree dropout rate.",
    "one_drop": "DART: always drop at least one tree.",
    "skip_drop": "DART: probability of skipping dropout entirely.",
    "tree_method": "hist (the TPU engine implements hist semantics).",
    "scale_pos_weight": "Positive-class gradient weight (imbalance).",
    # GLM family (GLMV3)
    "family": "Response family (gaussian, binomial, poisson, ...).",
    "link": "Link function (family_default resolves canonically).",
    "solver": "IRLSM, L_BFGS, COORDINATE_DESCENT or AUTO.",
    "alpha": "Elastic-net mixing (0 = ridge, 1 = lasso).",
    "lambda_": "Regularization strength (list = explicit path).",
    "lambda_search": "Fit a full regularization path.",
    "nlambdas": "Path length when lambda_search is on.",
    "lambda_min_ratio": "Smallest lambda as a ratio of lambda_max.",
    "beta_constraints": "Frame of per-coefficient bounds.",
    "compute_p_values": "Compute z/p-values (unpenalized fits).",
    "remove_collinear_columns": "Drop collinear columns before fitting.",
    "intercept": "Fit an intercept term.",
    "prior": "Prior probability of class 1 (binomial offset).",
    "tweedie_variance_power": "Tweedie variance power.",
    "tweedie_link_power": "Tweedie link power.",
    "interactions": "Columns whose pairwise interactions enter the design.",
    "max_iterations": "Solver iteration cap.",
    "objective_epsilon": "Relative objective convergence threshold.",
    "beta_epsilon": "Coefficient-change convergence threshold (IRLSM).",
    # DL family (DeepLearningV3)
    "hidden": "Hidden-layer sizes, e.g. [200, 200].",
    "epochs": "Passes over the training frame.",
    "activation": "Rectifier, Tanh, Maxout (+WithDropout variants).",
    "rho": "ADADELTA decay factor.",
    "epsilon": "ADADELTA smoothing constant.",
    "rate": "Learning rate (when adaptive_rate is off).",
    "momentum_start": "Initial momentum (plain SGD).",
    "input_dropout_ratio": "Dropout on the input layer.",
    "hidden_dropout_ratios": "Per-hidden-layer dropout.",
    "l1": "L1 weight penalty.",
    "l2": "L2 weight penalty.",
    "max_w2": "Squared-norm cap per neuron's incoming weights.",
    "autoencoder": "Train an autoencoder instead of a supervised net.",
    "mini_batch_size": "Rows per SGD minibatch.",
    "adaptive_rate": "Use ADADELTA instead of fixed-rate SGD.",
    # KMeans / PCA / dimensionality
    "k": "Number of clusters / components.",
    "init": "Initialization scheme (PlusPlus, Furthest, Random, User).",
    "estimate_k": "Find k up to the given maximum.",
    "user_points": "Frame of user-supplied initial centers.",
    "transform": "Column transform (NONE/STANDARDIZE/NORMALIZE/...).",
    "pca_method": "GramSVD / Power / Randomized.",
    # misc families
    "ntrees_isolation": "Isolation trees.",
    "sample_size": "Rows per isolation tree.",
    "laplace": "Naive Bayes Laplace smoothing.",
    "min_sdev": "Naive Bayes minimum per-feature std deviation.",
    "gamma": "Kernel width (PSVM) / min split loss (XGBoost alias).",
    "hyper_param": "SVM penalty C.",
    "kernel_type": "SVM kernel (gaussian via random Fourier features).",
    "rank_ratio": "ICF/feature-map rank as a fraction of n.",
    "min_word_freq": "Word2Vec vocabulary frequency floor.",
    "vec_size": "Word2Vec embedding width.",
    "window_size": "Word2Vec context window.",
    "sent_sample_rate": "Word2Vec frequent-word downsampling.",
    "epochs_w2v": "Word2Vec passes.",
    "stratify_by": "CoxPH strata columns.",
    "ties": "CoxPH tie handling (efron or breslow).",
    "num_knots": "GAM spline knots per column.",
    "gam_columns": "Columns receiving spline bases.",
    "scale": "GAM smoothing penalty scale.",
    "metalearner_algorithm": "Stacked-ensemble combiner algorithm.",
    "base_models": "Stacked-ensemble base model keys.",
    "data_leakage_handling": "Target encoding strategy (none/loo/kfold).",
    "blending": "Target encoding: shrink level means toward the prior.",
    "inflection_point": "TE blending inflection point (rows).",
    "smoothing": "TE blending smoothing.",
    "noise": "TE uniform noise half-width applied in training.",
}


def document(cls) -> None:
    """Append a generated parameter section to an estimator's __doc__."""
    params = dict(getattr(cls, "_COMMON", {}), **getattr(cls, "_defaults", {}))
    if not params:
        return
    lines = ["", "Parameters", "----------"]
    for name in sorted(params):
        desc = PARAM_DOCS.get(name)
        dflt = params[name]
        lines.append(f"{name} : default {dflt!r}")
        if desc:
            lines.append(f"    {desc}")
    cls.__doc__ = (cls.__doc__ or cls.__name__) + "\n" + "\n".join(lines)
