"""Rapids, the frame expression language of the port (h2o3_tpu/rapids/)."""

from h2o3_tpu_torch.rapids.rapids import rapids_exec, Session  # noqa: F401
