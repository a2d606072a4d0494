"""h2o3_tpu_torch: the PyTorch/CUDA port of h2o3_tpu for NVIDIA Hopper.

It imports torch and never jax, and nothing of h2o3_tpu. Entry points run
on the first CUDA card; `init(device="cpu")` is the only way onto the CPU,
where every kernel wrapper runs its plain PyTorch version.

    import h2o3_tpu_torch as h2o
    h2o.init()
    fr = h2o.import_file("train.csv")
    m = h2o.H2OGradientBoostingEstimator(ntrees=10, max_depth=8)
    m.train(y="label", training_frame=fr)
    m.predict(fr); m.auc()

GBM takes every single-output distribution of the binned engine and a
multinomial response, and `checkpoint=` restarts from a prior of either
engine; histogram_type="UniformAdaptive" or max_depth above 10 grows it on
the adaptive engine. `H2ORandomForestEstimator` trains a binomial,
regression or multinomial forest at any depth (20 by default),
`H2OXGBoostEstimator` XGBoost's hist booster (gbtree and DART) and
`H2OIsolationForestEstimator` an isolation forest. `predict_contributions`
gives TreeSHAP contributions of a single-output tree model.
`H2OGeneralizedLinearEstimator` fits a GLM of every family of the JAX
package (IRLSM with lambda search, elastic net and bounds, L-BFGS,
multinomial, ordinal) on the one-hot design matrix.
`H2ODeepLearningEstimator` trains a multilayer perceptron (classifier,
regression or autoencoder with `anomaly()`) by mini-batch ADADELTA or
SGD; the unsupervised family is `H2OKMeansEstimator`,
`H2OPrincipalComponentAnalysisEstimator`,
`H2OSingularValueDecompositionEstimator` and
`H2OGeneralizedLowRankEstimator` (train without `y`). Every estimator takes
`nfolds` or `fold_column` for cross-validation and `custom_metric_func`;
GBM takes `distribution="custom"` with `custom_distribution_func` (torch
UDFs registered by `h2o3_tpu_torch.udf.register_udf`).

Around the estimators: `H2OGridSearch` (Cartesian and RandomDiscrete),
`H2OStackedEnsembleEstimator` over cross-validated base models, and
`train_segments`, one model a segment. The standalone models are
`H2ONaiveBayesEstimator`, `H2OCoxProportionalHazardsEstimator` and
`H2OSupportVectorMachineEstimator`; `quantile` gives a frame's quantiles.
The models built on those estimators are `H2OTargetEncoderEstimator`,
`H2OGeneralizedAdditiveEstimator` (GLM on spline bases),
`H2OExtendedIsolationForestEstimator`, `H2OAggregatorEstimator`,
`H2ORuleFitEstimator` (GBM rules and an L1 GLM), `H2OInfogram` (GBMs) and
`H2OWord2vecEstimator`.
Every model has `model_performance`, `mse`, `model_id` and `to_dict`;
`get_frame`, `get_model`, `remove` and `ls` reach the key-value store.

`import_file` reads a local CSV, ARFF or SVMLight file, plain, gzip or
zip, and `upload_frame` takes in-memory data. A Frame's columns are packed
by the JAX package's codecs and paged between the card, host memory and
spill files (`core.tiering.PAGER`, `core.memory.MANAGER`); string, UUID
and sparse columns have their own layouts, and GLM on all-sparse
predictors fits without building the dense design.
"""

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.io.parser import import_file, parse_setup, upload_frame
from h2o3_tpu_torch.models import (
    H2OAggregatorEstimator, H2OCoxProportionalHazardsEstimator,
    H2ODeepLearningEstimator, H2OExtendedIsolationForestEstimator,
    H2OGeneralizedAdditiveEstimator, H2OGeneralizedLinearEstimator,
    H2OGeneralizedLowRankEstimator, H2OGradientBoostingEstimator,
    H2OGridSearch, H2OInfogram, H2OIsolationForestEstimator,
    H2OKMeansEstimator, H2ONaiveBayesEstimator,
    H2OPrincipalComponentAnalysisEstimator, H2ORandomForestEstimator,
    H2ORuleFitEstimator, H2OSingularValueDecompositionEstimator,
    H2OStackedEnsembleEstimator, H2OSupportVectorMachineEstimator,
    H2OTargetEncoderEstimator, H2OWord2vecEstimator, H2OXGBoostEstimator,
    SegmentModels, train_segments)
from h2o3_tpu_torch.parallel.mesh import cloud, init, shutdown


def get_frame(key):
    """A Frame by its key (h2o.get_frame)."""
    return DKV.get(key)


def get_model(key):
    """A model by its key (h2o.get_model)."""
    return DKV.get(key)


def remove(key):
    """Drop a key from the store (h2o.remove)."""
    DKV.remove(key)


def ls():
    """Every key in the store (h2o.ls)."""
    return DKV.keys()


def quantile(frame, prob=None, combine_method="interpolate",
             weights_column=None):
    """h2o.quantile: a Frame of a Probs column and one column of
    quantiles for each numeric column."""
    import numpy as np
    from h2o3_tpu_torch.models.quantile import frame_quantiles
    probs, cols = frame_quantiles(frame, prob, weights_column=weights_column,
                                  combine_method=combine_method)
    data = [np.asarray(probs, np.float64)] + [cols[c] for c in cols]
    return Frame(["Probs"] + list(cols),
                 [Vec.from_numpy(np.asarray(d, np.float64)) for d in data])


__all__ = ["DKV", "Frame", "H2OAggregatorEstimator",
           "H2OCoxProportionalHazardsEstimator", "H2ODeepLearningEstimator",
           "H2OExtendedIsolationForestEstimator",
           "H2OGeneralizedAdditiveEstimator", "H2OGeneralizedLinearEstimator",
           "H2OGeneralizedLowRankEstimator", "H2OGradientBoostingEstimator",
           "H2OGridSearch", "H2OInfogram", "H2OIsolationForestEstimator",
           "H2OKMeansEstimator", "H2ONaiveBayesEstimator",
           "H2OPrincipalComponentAnalysisEstimator",
           "H2ORandomForestEstimator", "H2ORuleFitEstimator",
           "H2OSingularValueDecompositionEstimator",
           "H2OStackedEnsembleEstimator", "H2OSupportVectorMachineEstimator",
           "H2OTargetEncoderEstimator", "H2OWord2vecEstimator",
           "H2OXGBoostEstimator", "SegmentModels", "Vec", "cloud", "get_frame",
           "get_model", "import_file", "init", "ls", "parse_setup",
           "quantile", "remove", "shutdown", "train_segments",
           "upload_frame"]
