"""Models of the port (h2o3_tpu/models)."""

from h2o3_tpu_torch.models.tree.gbm import H2OGradientBoostingEstimator

__all__ = ["H2OGradientBoostingEstimator"]
