"""Runtime analysis of the port (h2o3_tpu/analysis/): the lock-order
checker `lockdep`."""
