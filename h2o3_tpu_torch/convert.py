"""Carry a trained tree model across from the JAX package as plain arrays.

`gbm_from_arrays` takes a binned-engine GBM's state as numpy arrays (the
TreeArrays fields, one set per class for a multinomial model, the initial
margin or margins, the distribution, the learning rate, the predictors and
their domains, and the bin spec) and `drf_from_arrays` a forest's; each
returns a port model that scores the same rows to the same values. A
carried GBM is a binned prior for a checkpoint restart only when the
caller names the JAX model's binned engine. Nothing here imports the JAX
package: the caller pulls the arrays out of its model.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models.model import DataInfo, ModelOutput
from h2o3_tpu_torch.models.tree import binned as BN
from h2o3_tpu_torch.models.tree import engine as E
from h2o3_tpu_torch.models.tree.drf import H2ORandomForestEstimator
from h2o3_tpu_torch.models.tree.shared_tree import H2OGradientBoostingEstimator
from h2o3_tpu_torch.parallel import mesh as _mesh


def _tree_arrays(dev, col, thr, na_left, value, depth, cover, catbits,
                 col_is_cat) -> E.TreeArrays:
    def t(a, dtype):
        return None if a is None else torch.tensor(np.asarray(a),
                                                   device=dev).to(dtype)

    return E.TreeArrays(
        col=t(col, torch.int32), thr=t(thr, torch.float32),
        na_left=t(na_left, torch.bool), value=t(value, torch.float32),
        depth=int(depth), cover=t(cover, torch.float32),
        # uint32 words held in int64 (torch's uint32 support is thin)
        catbits=(None if catbits is None else
                 t(np.asarray(catbits).astype(np.int64), torch.int64)),
        col_is_cat=None if col_is_cat is None else np.asarray(col_is_cat,
                                                               bool))


def _finish(model, *, algo, predictors, domains, response_name,
            response_domain, edges, is_cat, b_val, n_bins, c_pad, model_id,
            summary):
    """The data codec, the bin spec, the output and the DKV entry of a
    carried model."""
    cats = [c for c in predictors if c in domains]
    model._dinfo = DataInfo(predictors, cats, domains, response_name,
                            response_domain)
    if edges is not None:
        model._bin_spec = BN.BinSpec(
            edges=np.asarray(edges, np.float32),
            is_cat=np.asarray(is_cat, bool), b_val=int(b_val),
            n_bins=int(n_bins), c_pad=int(c_pad))
    model.key = model_id or DKV.make_key(algo)
    model._output = ModelOutput(
        model_id=model.key, algo=algo, names=list(predictors),
        domains=model._dinfo.domains,
        response_domain=model._dinfo.response_domain,
        model_summary=dict(summary, converted=True))
    DKV.put(model.key, model)
    return model


def gbm_from_arrays(*, col, thr, na_left, value, depth: int, f0,
                    distribution: str, learn_rate: float,
                    predictors: Sequence[str], domains: dict,
                    response_name: str,
                    response_domain: Optional[Sequence[str]] = None,
                    cover=None, catbits=None, col_is_cat=None,
                    edges=None, is_cat=None, b_val: Optional[int] = None,
                    n_bins: Optional[int] = None, c_pad: Optional[int] = None,
                    engine: Optional[str] = None,
                    model_id: Optional[str] = None,
                    device=None) -> H2OGradientBoostingEstimator:
    """A port GBM from a JAX model's arrays.

    col (T, nodes) int, -1 = leaf; thr (T, nodes) f32; na_left (T, nodes)
    bool; value (T, nodes) f32; cover (T, nodes) f32 or None; catbits
    (T, nodes, W) uint32 go-right words or None; col_is_cat (C_pad,) bool
    or None. For distribution "multinomial" each of col, thr, na_left,
    value, cover and catbits holds the K classes' arrays (a sequence of K,
    or a leading class axis; the JAX model's `_trees_k`) and f0 is the
    (K,) vector of initial margins. `domains` maps each categorical
    predictor to its levels. The bin spec (edges, is_cat, b_val, n_bins,
    c_pad) is kept on the model when given. `engine` is the JAX model's
    `model_summary["engine"]`: the arrays do not tell which engine grew
    them, so only a caller that passes "binned_pallas" (its binned engine)
    makes the model a prior that a binned checkpoint restart takes; with
    none given, a restart from it is refused as one from the adaptive
    engine. Tensors land on `device`, by default the cloud's."""
    dev = torch.device(device) if device is not None else _mesh.cloud().device
    dist = distribution.lower()
    model = H2OGradientBoostingEstimator(
        distribution=distribution, learn_rate=float(learn_rate),
        max_depth=int(depth), model_id=model_id)
    model._dist = dist
    if dist == "multinomial":
        pick = (lambda a, k: None if a is None else a[k])  # noqa: E731
        model._trees_k = [
            _tree_arrays(dev, col[k], thr[k], na_left[k], value[k], depth,
                         pick(cover, k), pick(catbits, k), col_is_cat)
            for k in range(len(col))]
        model._f0 = np.asarray(f0, np.float32)
        ntrees = sum(t.ntrees for t in model._trees_k)
        init_f = model._f0.tolist()
    else:
        model._trees = _tree_arrays(dev, col, thr, na_left, value, depth,
                                    cover, catbits, col_is_cat)
        model._f0 = float(f0)
        ntrees = model._trees.ntrees
        init_f = model._f0
    model.params["ntrees"] = ntrees
    return _finish(model, algo="gbm", predictors=predictors, domains=domains,
                   response_name=response_name,
                   response_domain=response_domain, edges=edges,
                   is_cat=is_cat, b_val=b_val, n_bins=n_bins, c_pad=c_pad,
                   model_id=model_id, summary={
                       "number_of_trees": ntrees, "max_depth": int(depth),
                       "distribution": distribution,
                       "learn_rate": float(learn_rate), "init_f": init_f,
                       "engine": engine})


def drf_from_arrays(*, col, thr, na_left, value, depth: int,
                    predictors: Sequence[str], domains: dict,
                    response_name: str,
                    response_domain: Optional[Sequence[str]] = None,
                    cover=None, catbits=None, col_is_cat=None,
                    edges=None, is_cat=None, b_val: Optional[int] = None,
                    n_bins: Optional[int] = None, c_pad: Optional[int] = None,
                    model_id: Optional[str] = None,
                    device=None) -> H2ORandomForestEstimator:
    """A port DRF (binomial or regression) from a JAX forest's arrays, as
    gbm_from_arrays takes them; the model predicts the mean of its trees'
    leaf values (the class-1 probability of a binomial forest)."""
    dev = torch.device(device) if device is not None else _mesh.cloud().device
    model = H2ORandomForestEstimator(max_depth=int(depth),
                                     model_id=model_id)
    model._trees = _tree_arrays(dev, col, thr, na_left, value, depth, cover,
                                catbits, col_is_cat)
    ntrees = model._trees.ntrees
    model.params["ntrees"] = ntrees
    return _finish(model, algo="drf", predictors=predictors, domains=domains,
                   response_name=response_name,
                   response_domain=response_domain, edges=edges,
                   is_cat=is_cat, b_val=b_val, n_bins=n_bins, c_pad=c_pad,
                   model_id=model_id, summary={
                       "number_of_trees": ntrees, "max_depth": int(depth),
                       "oob_scored": False})
