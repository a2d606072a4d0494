"""Model artifacts of the port (h2o3_tpu/genmodel)."""
