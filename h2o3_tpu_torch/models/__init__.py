"""Models of the port (h2o3_tpu/models)."""

from h2o3_tpu_torch.models.tree.drf import H2ORandomForestEstimator
from h2o3_tpu_torch.models.tree.gbm import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.tree.isofor import H2OIsolationForestEstimator
from h2o3_tpu_torch.models.tree.xgboost import H2OXGBoostEstimator

__all__ = ["H2OGradientBoostingEstimator", "H2OIsolationForestEstimator",
           "H2ORandomForestEstimator", "H2OXGBoostEstimator"]
