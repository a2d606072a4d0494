"""GBM public module; the driver lives in shared_tree.py."""

from h2o3_tpu_torch.models.tree.shared_tree import H2OGradientBoostingEstimator

__all__ = ["H2OGradientBoostingEstimator"]
