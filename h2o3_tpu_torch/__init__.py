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
"""

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.io.parser import import_file, parse_setup
from h2o3_tpu_torch.models.tree.drf import H2ORandomForestEstimator
from h2o3_tpu_torch.models.tree.gbm import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.tree.isofor import H2OIsolationForestEstimator
from h2o3_tpu_torch.models.tree.xgboost import H2OXGBoostEstimator
from h2o3_tpu_torch.parallel.mesh import cloud, init, shutdown

__all__ = ["DKV", "Frame", "H2OGradientBoostingEstimator",
           "H2OIsolationForestEstimator", "H2ORandomForestEstimator",
           "H2OXGBoostEstimator", "Vec", "cloud", "import_file", "init",
           "parse_setup", "shutdown"]
