"""Client-bindings codegen — h2o-bindings analog (gen_python.py et al.)."""

from h2o3_tpu_torch.bindings.gen import gen_python  # noqa: F401
