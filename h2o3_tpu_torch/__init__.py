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

`import_file` reads CSV (through the native tokenizer), ARFF, SVMLight,
xlsx, Parquet, ORC, Feather and Avro files, plain, gzip or zip, from a
path, a directory, a glob, a list or an http(s) URI (the chunked parse
of `io/dparse.py`), and `upload_frame` takes in-memory data.
`export_file` writes a Frame as a `.hex` snapshot (read back by
`io.persist.import_frame`), `save_model` and `load_model` write and
read a binary model, and `H2OGridSearch(recovery_dir=...)` resumes an
interrupted grid. A Frame's columns are packed
by the JAX package's codecs and paged between the card, host memory and
spill files (`core.tiering.PAGER`, `core.memory.MANAGER`); string, UUID
and sparse columns have their own layouts, and GLM on all-sparse
predictors fits without building the dense design.

`rapids(expr)` evaluates a Rapids expression (the language H2O's clients
compile frame operations into) over the store's frames: arithmetic,
math, reducers, string and time prims, and the mungers (sort, group-by
and merge on the card, `ops/device_sort.py`); `create_frame` makes a
random frame of mixed types from a seed.

A model writes a scoring artifact (`download_mojo`: the native npz zip
or, with format="h2o3", a genuine H2O-3 MOJO; `download_pojo`, a Java
class) and `import_mojo` reads either family back as an
`H2OGenericEstimator`. `explain` and `explain_row` draw a model's
explanation figures (matplotlib, imported at the first figure), and
`explain_data` gives their tables; `automl` runs H2O's AutoML plan.
"""

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.io.parser import import_file, parse_setup, upload_frame
from h2o3_tpu_torch.models import (
    H2OAggregatorEstimator, H2OCoxProportionalHazardsEstimator,
    H2ODeepLearningEstimator, H2OExtendedIsolationForestEstimator,
    H2OGeneralizedAdditiveEstimator, H2OGeneralizedLinearEstimator,
    H2OGenericEstimator,
    H2OGeneralizedLowRankEstimator, H2OGradientBoostingEstimator,
    H2OGridSearch, H2OInfogram, H2OIsolationForestEstimator,
    H2OKMeansEstimator, H2ONaiveBayesEstimator,
    H2OPrincipalComponentAnalysisEstimator, H2ORandomForestEstimator,
    H2ORuleFitEstimator, H2OSingularValueDecompositionEstimator,
    H2OStackedEnsembleEstimator, H2OSupportVectorMachineEstimator,
    H2OTargetEncoderEstimator, H2OWord2vecEstimator, H2OXGBoostEstimator,
    SegmentModels, train_segments)
from h2o3_tpu_torch.core.jobs import Job
from h2o3_tpu_torch.parallel.mesh import cloud, cluster_info, init, shutdown

__version__ = "0.5.0"


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


def save_model(model, path):
    """Binary model export (h2o.save_model)."""
    from h2o3_tpu_torch.genmodel.mojo import save_model as _sm
    return _sm(model, path)


def load_model(path, device=None):
    """Binary model import (h2o.load_model); its tensors on `device`, by
    default the cloud's."""
    from h2o3_tpu_torch.genmodel.mojo import load_model as _lm
    return _lm(path, device)


def import_mojo(path):
    """h2o.import_mojo: a native or H2O-3 MOJO as a generic model. (The
    JAX package's returns the native artifact's MojoModel and reads no
    H2O-3 MOJO; h2o-py's returns the generic model, as here.)"""
    from h2o3_tpu_torch.models.generic import H2OGenericEstimator
    return H2OGenericEstimator(path)


def explain(models, frame, columns: int = 3, render: bool = False):
    """h2o.explain: the figures of a model (SHAP summary, varimp, PDPs,
    learning curve) or of a list of models (and their heatmaps)."""
    from h2o3_tpu_torch import explain_plots as EP
    return EP.explain(models, frame, columns=columns, render=render)


def explain_row(models, frame, row_index: int, columns: int = 3):
    """h2o.explain_row: a row's SHAP bars and ICE curves."""
    from h2o3_tpu_torch import explain_plots as EP
    return EP.explain_row(models, frame, row_index, columns=columns)


def export_file(frame, path):
    """Frame snapshot export (h2o.export_file; the .hex format)."""
    from h2o3_tpu_torch.io.persist import export_frame
    return export_frame(frame, path)


def create_frame(**kw):
    """A random frame of mixed column types (h2o.create_frame)."""
    from h2o3_tpu_torch.utils.create_frame import create_frame as _cf
    return _cf(**kw)


# the subpackage first: its first import binds the name `rapids` here to
# the module, so the function must be defined after it
from h2o3_tpu_torch.rapids import rapids_exec as _rapids_exec  # noqa: E402


def rapids(expr, session=None):
    """Evaluate a Rapids expression (h2o.rapids) over the store's frames."""
    return _rapids_exec(expr, session)


# the same for the automl subpackage and the function of its name
from h2o3_tpu_torch.automl import H2OAutoML as _H2OAutoML  # noqa: E402


def automl(**kw):
    """An H2OAutoML run's object (h2o.automl)."""
    return _H2OAutoML(**kw)


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
           "H2OGenericEstimator",
           "H2OGeneralizedLowRankEstimator", "H2OGradientBoostingEstimator",
           "H2OGridSearch", "H2OInfogram", "H2OIsolationForestEstimator",
           "H2OKMeansEstimator", "H2ONaiveBayesEstimator",
           "H2OPrincipalComponentAnalysisEstimator",
           "H2ORandomForestEstimator", "H2ORuleFitEstimator",
           "H2OSingularValueDecompositionEstimator",
           "H2OStackedEnsembleEstimator", "H2OSupportVectorMachineEstimator",
           "H2OTargetEncoderEstimator", "H2OWord2vecEstimator",
           "H2OXGBoostEstimator", "Job", "SegmentModels", "Vec", "cloud",
           "cluster_info",
           "automl", "create_frame", "explain", "explain_row", "export_file",
           "get_frame", "get_model", "import_file", "import_mojo", "init", "load_model", "ls", "parse_setup",
           "quantile", "rapids", "remove", "save_model", "shutdown",
           "train_segments", "upload_frame"]
