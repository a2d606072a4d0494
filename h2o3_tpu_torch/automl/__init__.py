"""AutoML of the port (h2o3_tpu/automl)."""

from h2o3_tpu_torch.automl.automl import H2OAutoML, Leaderboard

__all__ = ["H2OAutoML", "Leaderboard"]
