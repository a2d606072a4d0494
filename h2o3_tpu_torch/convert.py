"""Carry a trained tree model across from the JAX package as plain arrays.

`gbm_from_arrays` takes a GBM's state as numpy arrays (the TreeArrays
fields, one set per class for a multinomial model, the initial margin or
margins, the distribution, the learning rate, the predictors and their
domains, and the bin spec of a binned-engine model), `drf_from_arrays` a
forest's (one set per class for a multinomial forest),
`xgboost_from_arrays` a booster's and `isofor_from_arrays` an isolation
forest's (with its sample size and its observed path-length range); each
returns a port model that scores the same rows to the same values. A
carried GBM is a binned prior for a checkpoint restart only when the
caller names the JAX model's binned engine; any other is a prior of the
adaptive engine. Nothing here imports the JAX package: the caller pulls
the arrays out of its model.
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
from h2o3_tpu_torch.models.tree.isofor import H2OIsolationForestEstimator
from h2o3_tpu_torch.models.tree.shared_tree import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.tree.xgboost import H2OXGBoostEstimator
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
    any other (none included) a restart from it runs on the adaptive
    engine. Tensors land on `device`, by default the cloud's."""
    dev = _device(device)
    dist = distribution.lower()
    model = H2OGradientBoostingEstimator(
        distribution=distribution, learn_rate=float(learn_rate),
        max_depth=int(depth), model_id=model_id)
    model._dist = dist
    ntrees, init_f = _set_trees(model, dev, dist == "multinomial", f0, col,
                                thr, na_left, value, depth, cover, catbits,
                                col_is_cat)
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
    """A port DRF from a JAX forest's arrays, as gbm_from_arrays takes them;
    with more than two response levels each array holds the K classes'
    (the JAX model's `_trees_k`). The model predicts the mean of its
    trees' leaf values (the class-1 probability of a binomial forest, each
    class's normalized vote of a multinomial one)."""
    dev = _device(device)
    model = H2ORandomForestEstimator(max_depth=int(depth),
                                     model_id=model_id)
    multi = response_domain is not None and len(response_domain) > 2
    ntrees, _ = _set_trees(model, dev, multi, None, col, thr, na_left,
                           value, depth, cover, catbits, col_is_cat)
    model.params["ntrees"] = ntrees // len(col) if multi else ntrees
    return _finish(model, algo="drf", predictors=predictors, domains=domains,
                   response_name=response_name,
                   response_domain=response_domain, edges=edges,
                   is_cat=is_cat, b_val=b_val, n_bins=n_bins, c_pad=c_pad,
                   model_id=model_id, summary={
                       "number_of_trees": model.params["ntrees"],
                       "max_depth": int(depth), "oob_scored": False})


def xgboost_from_arrays(*, col, thr, na_left, value, depth: int, f0,
                        distribution: str, learn_rate: float,
                        predictors: Sequence[str], domains: dict,
                        response_name: str,
                        response_domain: Optional[Sequence[str]] = None,
                        cover=None, model_id: Optional[str] = None,
                        device=None) -> H2OXGBoostEstimator:
    """A port XGBoost booster from a JAX booster's arrays, as
    gbm_from_arrays takes them (f0: the base margin, (K,) zeros for a
    multinomial booster)."""
    dev = _device(device)
    dist = distribution.lower()
    model = H2OXGBoostEstimator(learn_rate=float(learn_rate),
                                max_depth=int(depth), model_id=model_id)
    model._dist = dist
    ntrees, _ = _set_trees(model, dev, dist == "multinomial", f0, col, thr,
                           na_left, value, depth, cover, None, None)
    model.params["ntrees"] = ntrees
    return _finish(model, algo="xgboost", predictors=predictors,
                   domains=domains, response_name=response_name,
                   response_domain=response_domain, edges=None, is_cat=None,
                   b_val=None, n_bins=None, c_pad=None, model_id=model_id,
                   summary={"number_of_trees": ntrees,
                            "max_depth": int(depth), "eta": float(learn_rate),
                            "engine": "adaptive"})


def isofor_from_arrays(*, col, thr, na_left, value, depth: int, psi: int,
                       min_len: float, max_len: float,
                       predictors: Sequence[str], domains: dict,
                       model_id: Optional[str] = None,
                       device=None) -> H2OIsolationForestEstimator:
    """A port isolation forest from a JAX one's arrays: its trees (values
    are path lengths), its sample size psi and the observed range
    [min_len, max_len] of the training rows' mean path length."""
    dev = _device(device)
    model = H2OIsolationForestEstimator(max_depth=int(depth),
                                        model_id=model_id)
    ntrees, _ = _set_trees(model, dev, False, None, col, thr, na_left, value,
                           depth, None, None, None)
    model.params["ntrees"] = ntrees
    model._psi = int(psi)
    model._min_len, model._max_len = float(min_len), float(max_len)
    return _finish(model, algo="isolationforest", predictors=predictors,
                   domains=domains, response_name=None, response_domain=None,
                   edges=None, is_cat=None, b_val=None, n_bins=None,
                   c_pad=None, model_id=model_id,
                   summary={"number_of_trees": ntrees,
                            "max_depth": int(depth), "sample_size": int(psi)})


def _device(device):
    return torch.device(device) if device is not None \
        else _mesh.cloud().device


def _set_trees(model, dev, multi, f0, col, thr, na_left, value, depth,
               cover, catbits, col_is_cat):
    """The carried trees on the model (`_trees_k` per class when `multi`)
    and its f0. Returns (trees in all, f0 as the summary reports it)."""
    if multi:
        pick = (lambda a, k: None if a is None else a[k])  # noqa: E731
        model._trees_k = [
            _tree_arrays(dev, col[k], thr[k], na_left[k], value[k], depth,
                         pick(cover, k), pick(catbits, k), col_is_cat)
            for k in range(len(col))]
        if f0 is not None:
            model._f0 = np.asarray(f0, np.float32)
        return (sum(t.ntrees for t in model._trees_k),
                None if f0 is None else model._f0.tolist())
    model._trees = _tree_arrays(dev, col, thr, na_left, value, depth, cover,
                                catbits, col_is_cat)
    if f0 is not None:
        model._f0 = float(f0)
    return model._trees.ntrees, None if f0 is None else model._f0
