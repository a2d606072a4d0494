"""User-defined functions of the port (h2o3_tpu/udf.py, water/udf): custom
GBM distributions and custom model metrics.

A UDF is a Python object registered in the DKV and named by a
"python:<key>" reference in `custom_distribution_func` or
`custom_metric_func`. Its array math is written in torch, where the JAX
package's is written in jax.numpy: the port calls it on the tensors it
trains and scores with, on their device. A UDF written for one package
does not run in the other.
"""

from __future__ import annotations

from h2o3_tpu_torch.core.kvstore import DKV

_PREFIX = "udf_"


class CustomDistribution:
    """Custom GBM distribution (water/udf/CDistributionFunc). Subclass and
    override, in torch:
      link_inv(F)      the inverse link: margin to prediction
      grad_hess(F, y)  the pseudo-residual and the hessian of each row
      init_f0(ybar)    the initial margin from the weighted response mean
    """

    def link_inv(self, F):
        return F

    def grad_hess(self, F, y):
        raise NotImplementedError

    def init_f0(self, ybar: float) -> float:
        return float(ybar)


class CustomMetric:
    """Custom model metric (water/udf/CMetricFunc): map, reduce and metric,
    the reference's three phases."""

    name = "custom"

    def map(self, pred, y, w):
        """Phase 1: takes the whole columns (pred, y, w) as tensors and
        returns a tuple of components, either per-row tensors (length n)
        or scalars already reduced. Per-row components are folded pairwise
        with reduce(); scalars go straight to metric()."""
        raise NotImplementedError

    def reduce(self, l, r):
        return tuple(a + b for a, b in zip(l, r))

    def metric(self, agg) -> float:
        raise NotImplementedError


def register_udf(key: str, obj) -> str:
    """Register a UDF; returns its "python:<key>" reference."""
    DKV.put(_PREFIX + key, obj)
    return f"python:{key}"


def resolve_udf(ref):
    """A UDF object, a "python:key" reference or a bare key, to the UDF."""
    if isinstance(ref, (CustomDistribution, CustomMetric)):
        return ref
    if not isinstance(ref, str):
        raise TypeError(f"not a UDF reference: {ref!r}")
    key = ref.split(":", 1)[1] if ":" in ref else ref
    obj = DKV.get(_PREFIX + key)
    if obj is None:
        raise KeyError(f"no UDF registered under {key!r}")
    return obj


def remove_udf(key: str):
    DKV.remove(_PREFIX + key)
