"""Carry a trained GBM across from the JAX package as plain arrays.

`gbm_from_arrays` takes a binned-engine GBM's state as numpy arrays (the
TreeArrays fields, the initial margin, the distribution, the learning rate,
the predictors and their domains, and the bin spec) and returns a port
model that scores the same rows to the same values. Nothing here imports
the JAX package: the caller pulls the arrays out of its model.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models.model import DataInfo, ModelOutput
from h2o3_tpu_torch.models.tree import binned as BN
from h2o3_tpu_torch.models.tree import engine as E
from h2o3_tpu_torch.models.tree.shared_tree import H2OGradientBoostingEstimator
from h2o3_tpu_torch.parallel import mesh as _mesh


def gbm_from_arrays(*, col, thr, na_left, value, depth: int, f0: float,
                    distribution: str, learn_rate: float,
                    predictors: Sequence[str], domains: dict,
                    response_name: str,
                    response_domain: Optional[Sequence[str]] = None,
                    cover=None, catbits=None, col_is_cat=None,
                    edges=None, is_cat=None, b_val: Optional[int] = None,
                    n_bins: Optional[int] = None, c_pad: Optional[int] = None,
                    model_id: Optional[str] = None,
                    device=None) -> H2OGradientBoostingEstimator:
    """A port GBM from a JAX model's arrays.

    col (T, nodes) int, -1 = leaf; thr (T, nodes) f32; na_left (T, nodes)
    bool; value (T, nodes) f32; cover (T, nodes) f32 or None; catbits
    (T, nodes, W) uint32 go-right words or None; col_is_cat (C_pad,) bool
    or None. `domains` maps each categorical predictor to its levels. The
    bin spec (edges, is_cat, b_val, n_bins, c_pad) is kept on the model
    when given. Tensors land on `device`, by default the cloud's."""
    dev = torch.device(device) if device is not None else _mesh.cloud().device

    def t(a, dtype):
        return None if a is None else torch.tensor(np.asarray(a),
                                                   device=dev).to(dtype)

    trees = E.TreeArrays(
        col=t(col, torch.int32), thr=t(thr, torch.float32),
        na_left=t(na_left, torch.bool), value=t(value, torch.float32),
        depth=int(depth), cover=t(cover, torch.float32),
        # uint32 words held in int64 (torch's uint32 support is thin)
        catbits=(None if catbits is None else
                 t(np.asarray(catbits).astype(np.int64), torch.int64)),
        col_is_cat=None if col_is_cat is None else np.asarray(col_is_cat,
                                                               bool))
    model = H2OGradientBoostingEstimator(
        distribution=distribution, learn_rate=float(learn_rate),
        max_depth=int(depth), ntrees=trees.ntrees, model_id=model_id)
    cats = [c for c in predictors if c in domains]
    model._dinfo = DataInfo(predictors, cats, domains, response_name,
                            response_domain)
    model._dist = distribution.lower()
    model._f0 = float(f0)
    model._trees = trees
    if edges is not None:
        model._bin_spec = BN.BinSpec(
            edges=np.asarray(edges, np.float32),
            is_cat=np.asarray(is_cat, bool), b_val=int(b_val),
            n_bins=int(n_bins), c_pad=int(c_pad))
    model.key = model_id or DKV.make_key("gbm")
    model._output = ModelOutput(
        model_id=model.key, algo="gbm", names=list(predictors),
        domains=model._dinfo.domains,
        response_domain=model._dinfo.response_domain,
        model_summary={"number_of_trees": trees.ntrees,
                       "max_depth": int(depth), "distribution": distribution,
                       "learn_rate": float(learn_rate), "init_f": float(f0),
                       "engine": "converted"})
    DKV.put(model.key, model)
    return model
