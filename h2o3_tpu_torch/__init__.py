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
"""

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.io.parser import import_file, parse_setup
from h2o3_tpu_torch.models.tree.gbm import H2OGradientBoostingEstimator
from h2o3_tpu_torch.parallel.mesh import cloud, init, shutdown

__all__ = ["DKV", "Frame", "H2OGradientBoostingEstimator", "Vec", "cloud",
           "import_file", "init", "parse_setup", "shutdown"]
