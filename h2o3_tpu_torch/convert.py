"""Carry a trained tree model across from the JAX package as plain arrays.

`gbm_from_arrays` takes a GBM's state as numpy arrays (the TreeArrays
fields, one set per class for a multinomial model, the initial margin or
margins, the distribution, the learning rate, the predictors and their
domains, and the bin spec of a binned-engine model), `drf_from_arrays` a
forest's (one set per class for a multinomial forest),
`xgboost_from_arrays` a booster's, `isofor_from_arrays` an isolation
forest's (with its sample size and its observed path-length range) and
`glm_from_arrays` a GLM's (its coefficients and its one-hot codec's
statistics), `deeplearning_from_arrays` a net's ((W, b) a layer and its
activation), `kmeans_from_arrays` the centroids, `pca_from_arrays` the
rotation and the transform's statistics, `svd_from_arrays` V, d and
theirs, `glrm_from_arrays` the archetypes, `coxph_from_arrays` β and
`psvm_from_arrays` β, b0 and the random Fourier features (each of these
with its one-hot codec's statistics), and `naive_bayes_from_arrays` the
priors and tables; `eif_from_arrays` an extended isolation forest's
hyperplane trees, `gam_from_arrays` a GAM's knots, centring transforms
and penalties with its inner GLM's arrays, `target_encoder_from_arrays`
the per-level (and per-fold) sums and counts and the prior, and
`word2vec_from_arrays` the word vectors; each returns a port model that
scores the same rows to the same values. A
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
from h2o3_tpu_torch.models.deeplearning import MLP, H2ODeepLearningEstimator
from h2o3_tpu_torch.models.coxph import H2OCoxProportionalHazardsEstimator
from h2o3_tpu_torch.models.extended_isofor import \
    H2OExtendedIsolationForestEstimator
from h2o3_tpu_torch.models.gam import H2OGeneralizedAdditiveEstimator
from h2o3_tpu_torch.models.glm import H2OGeneralizedLinearEstimator, _GLMState
from h2o3_tpu_torch.models.glrm import H2OGeneralizedLowRankEstimator
from h2o3_tpu_torch.models.kmeans import H2OKMeansEstimator
from h2o3_tpu_torch.models.model import DataInfo, ModelOutput
from h2o3_tpu_torch.models.naive_bayes import H2ONaiveBayesEstimator
from h2o3_tpu_torch.models.pca import H2OPrincipalComponentAnalysisEstimator
from h2o3_tpu_torch.models.psvm import H2OSupportVectorMachineEstimator
from h2o3_tpu_torch.models.svd import H2OSingularValueDecompositionEstimator
from h2o3_tpu_torch.models.target_encoder import H2OTargetEncoderEstimator
from h2o3_tpu_torch.models.tree import binned as BN
from h2o3_tpu_torch.models.tree import engine as E
from h2o3_tpu_torch.models.tree.drf import H2ORandomForestEstimator
from h2o3_tpu_torch.models.tree.isofor import (
    H2OIsolationForestEstimator, _avg_path)
from h2o3_tpu_torch.models.tree.shared_tree import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.tree.xgboost import H2OXGBoostEstimator
from h2o3_tpu_torch.models.word2vec import H2OWord2vecEstimator
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
            response_domain, model_id, summary, edges=None, is_cat=None,
            b_val=None, n_bins=None, c_pad=None, dinfo=None):
    """The data codec (label mode unless `dinfo` is given), the bin spec,
    the output and the DKV entry of a carried model."""
    cats = [c for c in predictors if c in domains]
    model._dinfo = dinfo or DataInfo(predictors, cats, domains,
                                     response_name, response_domain)
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


def glm_from_arrays(*, beta, family: str, link: str,
                    predictors: Sequence[str], domains: dict,
                    response_name: str,
                    response_domain: Optional[Sequence[str]] = None,
                    means: dict, sigmas: dict, standardize: bool,
                    interactions: Optional[Sequence[str]] = None,
                    ord_beta=None, ord_thr=None,
                    tweedie_link_power: float = 1.0,
                    model_id: Optional[str] = None
                    ) -> H2OGeneralizedLinearEstimator:
    """A port GLM from a JAX GLM's arrays: `beta` its `_state.beta` ((p+1,)
    with the intercept last, (K, p+1) for multinomial), its family and
    link, the ordinal `_ord_beta` and `_ord_thr`, and its one-hot
    `DataInfo`'s predictors, domains, means, sigmas (numeric and
    interaction columns), standardize flag and interactions."""
    model = H2OGeneralizedLinearEstimator(
        family=family, link=link, standardize=bool(standardize),
        interactions=list(interactions) if interactions else None,
        tweedie_link_power=float(tweedie_link_power), model_id=model_id)
    cats = [c for c in predictors if c in domains]
    dinfo = DataInfo(predictors, cats, domains, response_name,
                     response_domain, cat_mode="onehot",
                     standardize=bool(standardize), means=means,
                     sigmas=sigmas, interactions=interactions)
    model._family, model._link = family, link
    model._state = _GLMState(beta=np.asarray(beta, np.float64), link=link,
                             family=family)
    if ord_beta is not None:
        model._ord_beta = np.asarray(ord_beta, np.float64)
        model._ord_thr = np.asarray(ord_thr, np.float64)
    return _finish(model, algo="glm", predictors=predictors, domains=domains,
                   response_name=response_name,
                   response_domain=response_domain, edges=None, is_cat=None,
                   b_val=None, n_bins=None, c_pad=None, model_id=model_id,
                   summary={"family": family, "link": link}, dinfo=dinfo)


def _onehot_info(predictors, domains, means, sigmas, *, standardize,
                 impute_missing=True, response_name=None,
                 response_domain=None) -> DataInfo:
    """The one-hot codec of a carried model, from its JAX DataInfo's
    predictors, domains, means and sigmas."""
    cats = [c for c in predictors if c in domains]
    return DataInfo(predictors, cats, domains, response_name,
                    response_domain, cat_mode="onehot",
                    standardize=bool(standardize),
                    impute_missing=impute_missing, means=means,
                    sigmas=sigmas)


def _f32(a, dev):
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def deeplearning_from_arrays(*, weights, activation: str,
                             predictors: Sequence[str], domains: dict,
                             means: dict, sigmas: dict,
                             standardize: bool = True,
                             response_name: Optional[str] = None,
                             response_domain: Optional[Sequence[str]] = None,
                             autoencoder: bool = False,
                             model_id: Optional[str] = None,
                             device=None) -> H2ODeepLearningEstimator:
    """A port net from a JAX DeepLearning model's `_params_net` ((W, b) a
    layer, W of shape (fan_in, fan_out)), its activation, and its one-hot
    DataInfo's statistics (`response_name` None for an autoencoder)."""
    dev = _device(device)
    model = H2ODeepLearningEstimator(
        activation=activation, autoencoder=bool(autoencoder),
        standardize=bool(standardize), model_id=model_id,
        hidden=[int(np.asarray(b).shape[0]) for _, b in weights[:-1]])
    model.supervised = not autoencoder
    layers = [(_f32(W, dev), _f32(b, dev)) for W, b in weights]
    model._net = MLP(layers, activation).requires_grad_(False)
    dinfo = _onehot_info(predictors, domains, means, sigmas,
                         standardize=standardize,
                         response_name=None if autoencoder else response_name,
                         response_domain=response_domain)
    return _finish(model, algo="deeplearning", predictors=predictors,
                   domains=domains, response_name=dinfo.response_name,
                   response_domain=dinfo.response_domain, model_id=model_id,
                   summary={"activation": activation,
                            "weights": [list(W.shape) for W, _ in layers]},
                   dinfo=dinfo)


def kmeans_from_arrays(*, centroids, predictors: Sequence[str],
                       domains: dict, means: dict, sigmas: dict,
                       standardize: bool = True,
                       model_id: Optional[str] = None,
                       device=None) -> H2OKMeansEstimator:
    """A port KMeans from a JAX model's `_centroids` (in its model space)
    and its one-hot DataInfo's statistics."""
    C = _f32(centroids, _device(device))
    model = H2OKMeansEstimator(k=int(C.shape[0]),
                               standardize=bool(standardize),
                               model_id=model_id)
    model._centroids = C
    return _finish(model, algo="kmeans", predictors=predictors,
                   domains=domains, response_name=None, response_domain=None,
                   model_id=model_id, summary={"k": int(C.shape[0])},
                   dinfo=_onehot_info(predictors, domains, means, sigmas,
                                      standardize=standardize))


def pca_from_arrays(*, rotation, mean, sd, transform: str,
                    predictors: Sequence[str], domains: dict, means: dict,
                    sigmas: dict, model_id: Optional[str] = None
                    ) -> H2OPrincipalComponentAnalysisEstimator:
    """A port PCA from a JAX model's `_rotation`, `_mean`, `_sd` and
    `_transform`, and its (raw, mean-imputing) DataInfo's statistics."""
    rotation = np.asarray(rotation, np.float64)
    model = H2OPrincipalComponentAnalysisEstimator(
        k=int(rotation.shape[1]), transform=transform, model_id=model_id)
    model._rotation = rotation
    model._mean = np.asarray(mean, np.float32)
    model._sd = np.asarray(sd, np.float32)
    model._transform = transform.upper()
    return _finish(model, algo="pca", predictors=predictors, domains=domains,
                   response_name=None, response_domain=None,
                   model_id=model_id, summary={"k": int(rotation.shape[1])},
                   dinfo=_onehot_info(predictors, domains, means, sigmas,
                                      standardize=False))


def svd_from_arrays(*, v, d, mean, sd, transform: str,
                    predictors: Sequence[str], domains: dict, means: dict,
                    sigmas: dict, model_id: Optional[str] = None
                    ) -> H2OSingularValueDecompositionEstimator:
    """A port SVD from a JAX model's `_v`, `_d`, `_mean`, `_sd` and
    `_transform` (no U: `u()` is the trained model's), and its DataInfo's
    statistics."""
    v = np.asarray(v, np.float64)
    model = H2OSingularValueDecompositionEstimator(
        nv=int(v.shape[1]), transform=transform, keep_u=False,
        model_id=model_id)
    model._v, model._d = v, np.asarray(d, np.float64)
    model._mean = np.asarray(mean, np.float32)
    model._sd = np.asarray(sd, np.float32)
    model._transform = transform.upper()
    return _finish(model, algo="svd", predictors=predictors, domains=domains,
                   response_name=None, response_domain=None,
                   model_id=model_id,
                   summary={"nv": int(v.shape[1]), "d": model._d.tolist()},
                   dinfo=_onehot_info(predictors, domains, means, sigmas,
                                      standardize=False))


def glrm_from_arrays(*, archetypes, predictors: Sequence[str], domains: dict,
                     means: dict, sigmas: dict, gamma_x: float = 0.0,
                     model_id: Optional[str] = None
                     ) -> H2OGeneralizedLowRankEstimator:
    """A port GLRM from a JAX model's archetypes (`_B`, (k, p)) and
    gamma_x, which scores rows by the same masked ridge, and its
    DataInfo's statistics (its design imputes nothing)."""
    B = np.array(archetypes, np.float32)
    model = H2OGeneralizedLowRankEstimator(
        k=int(B.shape[0]), gamma_x=float(gamma_x), model_id=model_id)
    model._B = B
    return _finish(model, algo="glrm", predictors=predictors, domains=domains,
                   response_name=None, response_domain=None,
                   model_id=model_id, summary={"k": int(B.shape[0])},
                   dinfo=_onehot_info(predictors, domains, means, sigmas,
                                      standardize=False,
                                      impute_missing=False))


def naive_bayes_from_arrays(*, priors, cat_probs, num_mean, num_sd,
                            predictors: Sequence[str], domains: dict,
                            response_name: str,
                            response_domain: Sequence[str],
                            min_prob: float = 1e-3,
                            model_id: Optional[str] = None
                            ) -> H2ONaiveBayesEstimator:
    """A port Naive Bayes from a JAX model's `_priors`, `_cat_probs`,
    `_num_mean` and `_num_sd` (in the order of its categorical and of its
    numeric predictors) and its label-mode codec's predictors and
    domains; it stages the same log tables."""
    model = H2ONaiveBayesEstimator(min_prob=float(min_prob),
                                   model_id=model_id)
    model._priors = np.asarray(priors, np.float64)
    model._cat_probs = [np.asarray(p, np.float64) for p in cat_probs]
    model._num_mean = [np.asarray(m, np.float64) for m in num_mean]
    model._num_sd = [np.asarray(s, np.float64) for s in num_sd]
    model._cat_idx = [i for i, c in enumerate(predictors) if c in domains]
    model._num_idx = [i for i, c in enumerate(predictors)
                      if c not in domains]
    model._score_tab = None
    return _finish(model, algo="naivebayes", predictors=predictors,
                   domains=domains, response_name=response_name,
                   response_domain=response_domain, model_id=model_id,
                   summary={"nclasses": len(response_domain)},
                   dinfo=DataInfo(predictors,
                                  [c for c in predictors if c in domains],
                                  domains, response_name, response_domain,
                                  impute_missing=False))


def coxph_from_arrays(*, beta, predictors: Sequence[str], domains: dict,
                      means: dict, sigmas: dict, standardize: bool = True,
                      model_id: Optional[str] = None
                      ) -> H2OCoxProportionalHazardsEstimator:
    """A port CoxPH from a JAX model's `_beta` and its one-hot DataInfo's
    predictors, domains and statistics (the JAX design keeps every
    level); it scores the same linear predictor."""
    model = H2OCoxProportionalHazardsEstimator(standardize=bool(standardize),
                                               model_id=model_id)
    model._beta = np.asarray(beta, np.float64)
    return _finish(model, algo="coxph", predictors=predictors,
                   domains=domains, response_name=None, response_domain=None,
                   model_id=model_id, summary={},
                   dinfo=_onehot_info(predictors, domains, means, sigmas,
                                      standardize=standardize))


def psvm_from_arrays(*, beta, b0, rff, predictors: Sequence[str],
                     domains: dict, means: dict, sigmas: dict,
                     response_name: str, response_domain: Sequence[str],
                     model_id: Optional[str] = None, device=None
                     ) -> H2OSupportVectorMachineEstimator:
    """A port PSVM from a JAX model's `_params_svm` (β, b0), its random
    Fourier features `_rff` (W, b; None for the linear kernel) and its
    one-hot standardising DataInfo's statistics."""
    dev = _device(device)
    model = H2OSupportVectorMachineEstimator(model_id=model_id)
    model._beta, model._b0 = _f32(beta, dev), _f32(b0, dev)
    model._rff = None if rff is None else (_f32(rff[0], dev),
                                           _f32(rff[1], dev))
    return _finish(model, algo="psvm", predictors=predictors,
                   domains=domains, response_name=response_name,
                   response_domain=response_domain, model_id=model_id,
                   summary={},
                   dinfo=_onehot_info(predictors, domains, means, sigmas,
                                      standardize=True,
                                      response_name=response_name,
                                      response_domain=response_domain))


def eif_from_arrays(*, norms, points, dids, vals, depth: int, psi: int,
                    predictors: Sequence[str], domains: dict,
                    extension_level: int = 0,
                    model_id: Optional[str] = None,
                    device=None) -> H2OExtendedIsolationForestEstimator:
    """A port extended isolation forest from a JAX one's hyperplane trees:
    `_norms` and `_points` (T, nodes, C) f32, `_dids` (T, nodes) bool,
    `_vals` (T, nodes) f32, its depth `_D` and its sample size psi (which
    gives c(ψ) of the score)."""
    dev = _device(device)
    model = H2OExtendedIsolationForestEstimator(
        sample_size=int(psi), extension_level=int(extension_level),
        model_id=model_id)
    model._norms, model._points = _f32(norms, dev), _f32(points, dev)
    model._dids = torch.tensor(np.asarray(dids, bool), device=dev)
    model._vals = _f32(vals, dev)
    model._D = int(depth)
    model._cn = float(_avg_path(torch.tensor(float(psi))))
    ntrees = int(model._norms.shape[0])
    model.params["ntrees"] = ntrees
    return _finish(model, algo="extendedisolationforest",
                   predictors=predictors, domains=domains,
                   response_name=None, response_domain=None,
                   model_id=model_id,
                   summary={"number_of_trees": ntrees, "sample_size": int(psi),
                            "extension_level": int(extension_level)})


def gam_from_arrays(*, knots: dict, Z: dict, S: dict, beta, family: str,
                    link: str, predictors: Sequence[str], domains: dict,
                    response_name: str,
                    response_domain: Optional[Sequence[str]] = None,
                    means: dict, sigmas: dict, standardize: bool,
                    model_id: Optional[str] = None
                    ) -> H2OGeneralizedAdditiveEstimator:
    """A port GAM from a JAX one's state: by gam column (in the order of
    `knots`), its knots, centring transform Z (K, K-1) and penalty S
    (K, K); and its inner GLM's arrays as `glm_from_arrays` takes them
    (the predictors include the basis columns `<column>_gam<j>`), which
    keep the JAX package's all-levels one-hot layout."""
    model = H2OGeneralizedAdditiveEstimator(family=family,
                                            gam_columns=list(knots),
                                            model_id=model_id)
    model._gam_cols = list(knots)
    t64 = (lambda a: torch.tensor(np.asarray(a, np.float64)))  # noqa: E731
    model._knots = {c: t64(k) for c, k in knots.items()}
    model._Z = {c: t64(z) for c, z in Z.items()}
    model._S = {c: t64(s) for c, s in S.items()}
    model._basis_names = {c: [f"{c}_gam{j}" for j in range(z.shape[1])]
                          for c, z in model._Z.items()}
    model._glm = glm_from_arrays(beta=beta, family=family, link=link,
                                 predictors=predictors, domains=domains,
                                 response_name=response_name,
                                 response_domain=response_domain,
                                 means=means, sigmas=sigmas,
                                 standardize=standardize)
    model.key = model_id or model._glm.key + "_gam"
    model._output = model._glm._output
    model._dinfo = model._glm._dinfo
    DKV.put(model.key, model)
    return model


def target_encoder_from_arrays(*, encodings: dict, prior: float,
                               response_name: str, params: dict,
                               nfolds: Optional[int] = None,
                               device=None) -> H2OTargetEncoderEstimator:
    """A port target encoder from a JAX one's `_encodings` (by column: its
    domain, sums and counts, and fold_sums and fold_counts under kfold),
    `_prior`, `_y`, its params and `_nfolds`."""
    dev = _device(device)
    model = H2OTargetEncoderEstimator(**params)
    t64 = (lambda a: torch.tensor(np.asarray(a, np.float64),  # noqa: E731
                                  device=dev))
    model._encodings = {
        c: {k: (list(v) if k == "domain" else t64(v)) for k, v in e.items()}
        for c, e in encodings.items()}
    model._cols = list(encodings)
    model._prior = float(prior)
    model._y = response_name
    if nfolds is not None:
        model._nfolds = int(nfolds)
    return model


def word2vec_from_arrays(*, vectors, vocab: Sequence[str],
                         model_id: Optional[str] = None,
                         device=None) -> H2OWord2vecEstimator:
    """A port Word2Vec from a JAX one's `_vectors` (V, d) and
    `_vocab_list`."""
    dev = _device(device)
    model = H2OWord2vecEstimator(vec_size=int(np.asarray(vectors).shape[1]),
                                 model_id=model_id)
    model._vectors = _f32(vectors, dev)
    model._vocab_list = list(vocab)
    model._vocab = {w: i for i, w in enumerate(model._vocab_list)}
    model.key = model_id or DKV.make_key("word2vec")
    DKV.put(model.key, model)
    return model
