"""Model framework of the port (h2o3_tpu/models/model.py): the design-matrix
codec `DataInfo` (label mode for the trees, one-hot mode for GLM),
`ModelOutput`, and the estimator surface `ModelBase`: train through a
`Job`, cross-validation, predict, metrics and the custom-metric hook. An
unsupervised model (`supervised = False`: KMeans, PCA, SVD, GLRM, the
DeepLearning autoencoder) trains without a response and computes no
supervised metrics; it builds its own output frames (`_matrix_frame`).

Each model also has the explanation surface (explain_data.py,
explain_plots.py) and the export surface (`download_mojo`, `save_mojo`,
`download_pojo`, `save_model_details`; genmodel/). `predict` and
`model_performance` score through the serving cache (serving/: a CUDA
graph a row bucket on the card, the model's params placed once), as the
JAX package's do through its compiled programs; each family names the
attributes that enter the scorer as shared params
(`_serving_param_attrs`). `train()` stamps the drift baseline of those
families (obs/modelmon.py) before it publishes the model; a DELETE drops
the model's drift and usage series, a retrain over its key keeps them
(the previous generation's sketch is the shadow-compare). A parameter
the JAX package accepts and ignores although it would change the result
(`offset_column`, `export_checkpoints_dir`) raises NotImplementedError
here rather than being ignored.
"""

from __future__ import annotations

import copy
import itertools
import math
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import (Frame, StrVec, T_CAT,
                                       UuidVec, Vec)
from h2o3_tpu_torch.core.jobs import Job
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.parallel import mrtask as _mr
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.udf import resolve_udf


# ===========================================================================
class DataInfo:
    """Design-matrix codec (hex/DataInfo.java).

    cat_mode:
      * "label": a categorical column stays one numeric column of level
        ids, which the tree engines bin natively;
      * "onehot": each categorical column expands to one indicator column
        a level (GLM), numeric columns are standardised with the training
        frame's mean and sample sigma and NAs imputed, and `interactions`
        add pairwise columns: num x num their product (standardised with
        its own training statistics), cat x cat an indicator block over
        the cross of the levels (at most 10,000 columns), cat x num one
        column a level holding the number in the row's level slot.

    The statistics come in as `means` and `sigmas` (by column or
    interaction name); `from_frame` computes them from the training frame.

    The reduced design (for a model with an intercept or its like): each
    categorical predictor in `drop_first` loses its first
    level's column, as H2O drops it beside an intercept. `from_frame`
    puts there the categoricals with no NA in the training frame (one
    with NAs keeps every level: its all-zero NA rows keep the design of
    full rank), so the choice is the training frame's and a test frame
    is laid out alike; an NA or unseen level scores as the first level.
    The JAX package keeps every level (its design is singular beside the
    intercept); a carried JAX model keeps them too.
    """

    def __init__(self, predictors: Sequence[str], cat_cols: Sequence[str],
                 domains: dict, response_name: Optional[str],
                 response_domain: Optional[list] = None,
                 weights_name: Optional[str] = None, *,
                 cat_mode: str = "label", standardize: bool = False,
                 impute_missing: bool = True,
                 offset_name: Optional[str] = None,
                 means: Optional[dict] = None,
                 sigmas: Optional[dict] = None,
                 interactions: Optional[Sequence[str]] = None,
                 drop_first: Sequence[str] = ()):
        self.cat_mode = cat_mode
        self.standardize = standardize
        self.impute_missing = impute_missing
        self.predictors = list(predictors)
        self.cat_cols = [c for c in self.predictors if c in set(cat_cols)]
        self.num_cols = [c for c in self.predictors if c not in self.cat_cols]
        self.domains = {c: list(domains[c]) for c in self.cat_cols}
        self.cardinalities = {c: len(self.domains[c]) for c in self.cat_cols}
        self.drop_first = [c for c in self.cat_cols if c in set(drop_first)]
        if self.drop_first and cat_mode != "onehot":
            raise ValueError("drop_first needs the one-hot design matrix")
        self.response_name = response_name
        self.response_domain = (list(response_domain)
                                if response_domain is not None else None)
        self.weights_name = weights_name
        self.offset_name = offset_name
        self.means = dict(means or {})
        self.sigmas = dict(sigmas or {})
        self.inter_pairs: list = []      # (num_a, num_b, name)
        self.inter_catcat: list = []     # (cat_a, cat_b, name)
        self.inter_catnum: list = []     # (cat_a, num_b, name)
        if interactions:
            self._set_interactions(interactions)
        # expanded feature names, categoricals first as in H2O
        self.feature_names: list[str] = []
        if cat_mode == "onehot":
            for c in self.cat_cols:
                levels = self.domains[c][self._first(c):]
                self.feature_names += [f"{c}.{lvl}" for lvl in levels]
            self.feature_names += self.num_cols
            self.feature_names += [n for _, _, n in self.inter_pairs]
            for a, b, name in self.inter_catcat:
                self.feature_names += [
                    f"{name}.{la}_{lb}" for la in self.domains[a]
                    for lb in self.domains[b]]
            for a, b, name in self.inter_catnum:
                self.feature_names += [f"{a}.{la}:{b}"
                                       for la in self.domains[a]]
        else:
            self.feature_names = list(self.predictors)

    def _first(self, c) -> int:
        """The first level of column c that has a design column."""
        return 1 if c in self.drop_first else 0

    def _set_interactions(self, interactions):
        if self.cat_mode != "onehot":
            raise ValueError(
                "interactions are only supported with the one-hot "
                "design matrix (GLM-family models)")
        # dedupe, keeping order: a repeated entry would pair with itself
        interactions = list(dict.fromkeys(interactions))
        unknown = [c for c in interactions if c not in self.predictors]
        if unknown:
            raise ValueError(
                f"interactions reference unknown predictors: {unknown} "
                "(GLM interaction-column validation)")
        for a, b in itertools.combinations(interactions, 2):
            a_cat, b_cat = a in self.cat_cols, b in self.cat_cols
            if a_cat and b_cat:
                cross = self.cardinalities[a] * self.cardinalities[b]
                if cross > 10_000:
                    raise ValueError(
                        f"categorical interaction {a}x{b} expands to "
                        f"{cross} indicator columns (cap 10000)")
                self.inter_catcat.append((a, b, f"{a}_{b}"))
            elif a_cat or b_cat:
                ca, nb = (a, b) if a_cat else (b, a)
                self.inter_catnum.append((ca, nb, f"{ca}:{nb}"))
            else:
                self.inter_pairs.append((a, b, f"{a}:{b}"))

    @staticmethod
    def from_frame(frame: Frame, x: Sequence[str], y: Optional[str],
                   weights: Optional[str] = None, *, cat_mode: str = "label",
                   standardize: bool = False, impute_missing: bool = True,
                   offset: Optional[str] = None,
                   interactions: Optional[Sequence[str]] = None,
                   reduced: bool = False) -> "DataInfo":
        """The codec of a training frame: its domains, and the mean and
        sample sigma (n-1) of each numeric column from its rollups, summed
        in float64 (0 sigma taken as 1); with `reduced`, the categoricals
        without NA lose their first level."""
        preds = [c for c in x if c != y and frame.vec(c).type != "str"]
        cats = [c for c in preds if frame.vec(c).type == T_CAT]
        nums = [c for c in preds if c not in cats]
        rdom = None
        if y is not None and frame.vec(y).type == T_CAT:
            rdom = list(frame.vec(y).domain)
        means = {c: frame.vec(c).mean() for c in nums}
        sigmas = {c: frame.vec(c).sigma() or 1.0 for c in nums}
        di = DataInfo(preds, cats, {c: frame.vec(c).domain for c in cats},
                      y, rdom, weights, cat_mode=cat_mode,
                      standardize=standardize, impute_missing=impute_missing,
                      offset_name=offset,
                      means=means, sigmas=sigmas, interactions=interactions,
                      drop_first=[c for c in cats
                                  if frame.vec(c).na_cnt() == 0]
                      if reduced else ())
        for a, b, name in di.inter_pairs:
            # the statistics of the f32 product, in float64
            prod = (frame.vec(a).as_f32() * frame.vec(b).as_f32()).double()
            ok = prod[~torch.isnan(prod)]
            k = int(ok.numel())
            di.means[name] = float(ok.mean()) if k else 0.0
            di.sigmas[name] = (float(ok.std(correction=1)) or 1.0) \
                if k > 1 else 1.0
        return di

    @property
    def n_features(self) -> int:
        return len(self.feature_names)

    # ---- the design matrix ----------------------------------------------
    def raw_columns(self) -> list:
        """The columns of the raw matrix `assemble_design` takes: the
        predictors in label mode; categorical codes first, then the
        numeric columns, in one-hot mode."""
        if self.cat_mode == "label":
            return list(self.predictors)
        return self.cat_cols + self.num_cols

    def _assemble(self, raw_cat, raw_num):
        """Raw columns (f32, NaN for NA) into the one-hot design matrix:
        indicators (without the first level's column where it is dropped),
        standardisation, imputation and interactions. An NA or unseen level
        gives an all-zero indicator row, and so does an NA in either factor
        of a cat x cat interaction."""
        ref = raw_cat if raw_cat is not None else raw_num
        dev = ref.device

        def f32(vals):
            return _dev_const(self, dev, vals)

        def sig(name):
            return max(self.sigmas[name], 1e-10)

        def fix(x, mean, sigma):
            if self.standardize:
                x = (x - mean) / sigma
            if self.impute_missing:
                x = torch.where(torch.isnan(x),
                                torch.zeros_like(mean)
                                if self.standardize else mean, x)
            return x

        parts = []
        for j, c in enumerate(self.cat_cols):
            parts.append(_one_hot(raw_cat[:, j],
                                  self.cardinalities[c])[:, self._first(c):])
        if self.num_cols:
            parts.append(fix(raw_num,
                             f32([self.means[c] for c in self.num_cols]),
                             f32([sig(c) for c in self.num_cols])))
        for a, b, name in self.inter_pairs:
            p = raw_num[:, self.num_cols.index(a)] \
                * raw_num[:, self.num_cols.index(b)]          # raw product
            parts.append(fix(p, f32(self.means[name]),
                             f32(sig(name)))[:, None])
        for a, b, _ in self.inter_catcat:
            ca = raw_cat[:, self.cat_cols.index(a)]
            cb = raw_cat[:, self.cat_cols.index(b)]
            kb = self.cardinalities[b]
            code = torch.where(torch.isnan(ca) | torch.isnan(cb),
                               torch.full_like(ca, -1.0),
                               torch.nan_to_num(ca) * kb
                               + torch.nan_to_num(cb))
            parts.append(_one_hot(code, self.cardinalities[a] * kb))
        for a, b, _ in self.inter_catnum:
            x = fix(raw_num[:, self.num_cols.index(b)], f32(self.means[b]),
                    f32(sig(b)))
            parts.append(_one_hot(raw_cat[:, self.cat_cols.index(a)],
                                  self.cardinalities[a]) * x[:, None])
        return torch.cat(parts, dim=1)

    def assemble_design(self, raw: torch.Tensor) -> torch.Tensor:
        """raw (rows, len(raw_columns())) f32, NaN for NA, to the design
        matrix."""
        if self.cat_mode == "label":
            return raw
        ncat = len(self.cat_cols)
        return self._assemble(raw[:, :ncat] if ncat else None,
                              raw[:, ncat:] if self.num_cols else None)

    def matrix(self, frame: Frame) -> torch.Tensor:
        """(nrows, n_features) f32 on the frame's device: in label mode NaN
        for NA, in one-hot mode imputed."""
        frame = self.adapt(frame)
        if self.cat_mode == "label":
            return frame.matrix(self.predictors)
        return self._assemble(
            frame.matrix(self.cat_cols) if self.cat_cols else None,
            frame.matrix(self.num_cols) if self.num_cols else None)

    def response(self, frame: Frame) -> torch.Tensor:
        """(nrows,) f32 response; class index for a categorical one."""
        return self.adapt(frame).matrix([self.response_name])[:, 0]

    def weights(self, frame: Frame) -> torch.Tensor:
        """(nrows,) f32 observation weights, 0 where the weight is NA."""
        if self.weights_name:
            w = frame.matrix([self.weights_name])[:, 0]
            return torch.where(torch.isnan(w), 0.0, w)
        return torch.ones(frame.nrows, dtype=torch.float32,
                          device=frame.vecs[0].device)

    def offset(self, frame: Frame) -> Optional[torch.Tensor]:
        """(nrows,) f32 offsets, 0 where NA; None without an offset column
        (no model of either package reads it yet)."""
        if not self.offset_name:
            return None
        o = frame.matrix([self.offset_name])[:, 0]
        return torch.where(torch.isnan(o), 0.0, o)

    def adapt(self, frame: Frame) -> Frame:
        """Model.adaptTestForTrain: remap categorical level ids to the
        training domains; a missing predictor becomes an all-NA column.
        Returns the frame itself when nothing needs adapting."""
        needed = list(self.predictors)
        if self.response_name and self.response_name in frame.names:
            needed.append(self.response_name)
        changed = False
        vecs = []
        dev = frame.vecs[0].device
        have = set(frame.names)
        for c in needed:
            if c not in have:
                v = Vec.from_numpy(np.full(frame.nrows, np.nan), device=dev)
                changed = True
            else:
                v = frame.vec(c)
                want = self.domains.get(c) or (
                    self.response_domain if c == self.response_name else None)
                if v.type == T_CAT and want is not None and v.levels() != want:
                    v = _remap_domain(v, want)
                    changed = True
                elif v.type == T_CAT and want is None and c in self.num_cols:
                    # numeric in training, categorical here: NA out
                    v = Vec.from_numpy(np.full(frame.nrows, np.nan),
                                       device=dev)
                    changed = True
            vecs.append(v)
        if not changed:
            return frame
        f = Frame(needed, vecs)
        DKV.remove(f.key)          # a transient product, not registered
        return f


# DataInfo → {(device, values): f32 tensor}: the standardisation and
# imputation constants of `_assemble`, copied to a device once. A scorer
# captured into a CUDA graph must not copy from pageable host memory, so
# the serving cache's warm-up runs fill this before a capture; the eager
# path reads the same tensors.
_DEV_CONSTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_DEV_CONSTS_LOCK = threading.Lock()


def _dev_const(di, dev, vals) -> torch.Tensor:
    arr = np.asarray(vals, np.float32)
    key = (str(dev), arr.shape, arr.tobytes())
    with _DEV_CONSTS_LOCK:
        per = _DEV_CONSTS.setdefault(di, {})
        t = per.get(key)
    if t is None:
        t = torch.tensor(arr, device=dev)
        with _DEV_CONSTS_LOCK:
            t = per.setdefault(key, t)
    return t


def _dev_f32(a, device) -> torch.Tensor:
    """`a` as f32 on `device`: a host array is copied (as every scorer
    did), a placed tensor is cast on its device (the same rounding)."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _one_hot(code: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) f32 indicators of f32 level ids; a NaN, negative or
    out-of-range id gives a row of zeros (as jax.nn.one_hot does;
    torch.nn.functional.one_hot raises on them)."""
    valid = ~torch.isnan(code) & (code >= 0) & (code < k)
    idx = torch.where(valid, code, 0.0).long()
    out = torch.zeros((code.shape[0], k), dtype=torch.float32,
                      device=code.device)
    return out.scatter_(1, idx[:, None], valid.to(torch.float32)[:, None])


def _fold_custom_metric(udf, mapped):
    """The CMetricFunc contract (water/udf): `map` gave per-row components,
    folded down pairwise with the associative `reduce` (the JAX package's
    order of halving); scalars already reduced pass through."""
    tup = mapped if isinstance(mapped, tuple) else (mapped,)
    if torch.as_tensor(tup[0]).dim() == 0:
        return mapped
    comps = tuple(torch.atleast_1d(torch.as_tensor(c)) for c in tup)
    while comps[0].shape[0] > 1:
        n = comps[0].shape[0]
        even = n - (n % 2)
        red = udf.reduce(tuple(c[0:even:2] for c in comps),
                         tuple(c[1:even:2] for c in comps))
        red = tuple(torch.atleast_1d(torch.as_tensor(a)) for a in red)
        if n % 2:
            red = tuple(torch.cat([a, c[-1:]]) for a, c in zip(red, comps))
        comps = red
    agg = tuple(c[0] for c in comps)
    return agg if isinstance(mapped, tuple) else agg[0]


def _remap_domain(v: Vec, want: list) -> Vec:
    lookup = {lvl: i for i, lvl in enumerate(want)}
    src = v.to_numpy()
    out = np.full(len(src), np.nan)
    for i, code in enumerate(src):
        if not math.isnan(code):
            out[i] = lookup.get(str(v.domain[int(code)]), np.nan)
    return Vec.from_numpy(out, type=T_CAT, domain=want, device=v.device)


# ===========================================================================
@dataclass
class ModelOutput:
    """hex/Model.Output: what the training run learned."""
    model_id: str = ""
    algo: str = ""
    names: list = field(default_factory=list)
    domains: dict = field(default_factory=dict)
    response_domain: Optional[list] = None
    training_metrics: Optional[object] = None
    validation_metrics: Optional[object] = None
    cross_validation_metrics: Optional[object] = None
    scoring_history: list = field(default_factory=list)
    model_summary: dict = field(default_factory=dict)
    variable_importances: Optional[list] = None
    run_time_ms: int = 0
    cv_predictions_key: Optional[str] = None
    cv_fold_assignment_key: Optional[str] = None


class ModelBase:
    """Shared estimator/model surface (h2o-py H2OEstimator)."""

    algo = "base"
    supervised = True
    _defaults: dict = {}
    _COMMON = {
        "model_id": None, "seed": -1, "nfolds": 0, "weights_column": None,
        "offset_column": None, "fold_assignment": "AUTO", "fold_column": None,
        "keep_cross_validation_predictions": False,
        "keep_cross_validation_fold_assignment": False,
        "ignored_columns": None, "ignore_const_cols": True,
        "max_runtime_secs": 0.0, "standardize": True,
        "categorical_encoding": "AUTO", "distribution": "AUTO",
        "checkpoint": None, "export_checkpoints_dir": None,
        "custom_metric_func": None, "custom_distribution_func": None,
    }
    # parameters the JAX package accepts and never reads, although a set
    # value would change the result: the port takes them at their default
    # (or at any value of a tuple of values that give the JAX package's
    # result) and raises when another is set, (name, default, why)
    _IGNORED_IN_JAX = (
        ("offset_column", None,
         "no model of the JAX package reads its offset "
         "(h2o3_tpu/models/model.py:273, DataInfo.offset has no caller)"),
        ("export_checkpoints_dir", None,
         "the JAX package accepts it and writes no checkpoint "
         "(h2o3_tpu/models/model.py:394)"))

    def __init__(self, **params):
        self.params = dict(self._COMMON)
        self.params.update(self._defaults)
        unknown = set(params) - set(self.params)
        if unknown:
            raise ValueError(f"{self.algo}: unknown parameters "
                             f"{sorted(unknown)}")
        self.params.update(params)
        self._output: Optional[ModelOutput] = None
        self._dinfo: Optional[DataInfo] = None
        self._job: Optional[Job] = None
        self.key: Optional[str] = None

    def _check_ported(self):
        for name, default, why in self._IGNORED_IN_JAX:
            value = self.params.get(name)
            taken = default if isinstance(default, tuple) else (default,)
            if value is not None and value not in taken:
                raise NotImplementedError(
                    f"{self.algo}: {name}={self.params[name]!r} is not "
                    f"supported: {why}")

    # ---- public training entry point (H2OEstimator.train) ----------------
    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None, **overrides) -> "ModelBase":
        self.params.update(overrides)
        frame = training_frame
        if not isinstance(frame, Frame):
            raise TypeError("training_frame must be a Frame")
        if self.supervised and y is None:
            raise ValueError(f"{self.algo} requires a response column y")
        self._check_ported()
        if _mr.sharded(frame):
            if not getattr(self, "_shard_ok", False):
                raise NotImplementedError(
                    f"{self.algo} trains on one rank's rows; a frame of a "
                    "cloud of several ranks trains the binned tree models "
                    "only")
            if int(self.params.get("nfolds") or 0) > 1 \
                    or self.params.get("fold_column"):
                raise NotImplementedError(
                    f"{self.algo}: cross-validation of a frame of a cloud "
                    "of several ranks is not ported")
        x = self._resolve_predictors(frame, x, y)
        self._dinfo = self._make_data_info(frame, x, y)
        self.key = self.params.get("model_id") or DKV.make_key(self.algo)
        self._output = ModelOutput(model_id=self.key, algo=self.algo,
                                   names=list(x),
                                   domains=self._dinfo.domains,
                                   response_domain=self._dinfo.response_domain)
        job = Job(description=f"{self.algo} on {frame.key}", dest=self.key)
        t0 = time.time()
        # max_runtime_secs: the job's deadline, which the trainers test at
        # each chunk boundary, after the chunk's history entry
        mrs = float(self.params.get("max_runtime_secs") or 0.0)
        if mrs > 0:
            job.deadline = t0 + mrs
        self._job = job
        # the scoring history scores the validation frame when one is given
        # (ScoreKeeper and early stopping prefer its metrics)
        self._valid_for_scoring = validation_frame

        def work(job: Job):
            try:
                if int(self.params["nfolds"] or 0) > 1 \
                        or self.params.get("fold_column"):
                    self._run_cross_validation(frame, x, y, job)
                self._fit(frame)
                self._score_train_valid(frame, validation_frame)
            finally:
                # release the validation scoring state: its margins and
                # matrix would otherwise pin device memory for the model's
                # lifetime
                self._vstate = None
                self._valid_for_scoring = None
            self._output.run_time_ms = int(1000 * (time.time() - t0))
            return self

        job.start(work, background=False)
        job.join()
        # drift baseline: profile the training distribution (features +
        # predictions) and register the model for live monitoring BEFORE
        # publish, so a retrain rotates generations before any request
        # can score the new one (modelmon owns the try/except — a failed
        # profile must never fail the train)
        from h2o3_tpu_torch.obs import modelmon as _modelmon
        _modelmon.install_baseline(self, frame)
        DKV.put(self.key, self)
        return self

    def _budget_exhausted(self) -> bool:
        """The job's budget_exhausted, tested now: True once train()'s
        max_runtime_secs deadline has passed (a stop asked of the job
        raises JobCancelled here)."""
        job = self._job
        if job is None:
            return False
        job.update(job.progress)
        return job.budget_exhausted

    def _resolve_predictors(self, frame, x, y):
        if x is None:
            skip = {y, self.params.get("weights_column"),
                    self.params.get("offset_column"),
                    self.params.get("fold_column")}
            skip |= set(self.params.get("ignored_columns") or [])
            x = [c for c in frame.names if c not in skip]
        else:
            x = [frame.names[i] if isinstance(i, int) else i for i in x]
        if self.params.get("ignore_const_cols"):
            x = [c for c in x if not frame.vec(c).is_const()]
        return x

    def _make_data_info(self, frame, x, y) -> DataInfo:
        return DataInfo.from_frame(
            frame, x, y, weights=self.params.get("weights_column"),
            cat_mode=self._cat_mode(),
            standardize=bool(self.params.get("standardize")),
            offset=self.params.get("offset_column"),
            interactions=self.params.get("interactions"),
            reduced=self._reduced_design())

    def _cat_mode(self) -> str:
        return "onehot"

    def _reduced_design(self) -> bool:
        """Whether the one-hot design drops each NA-free categorical's
        first level (DataInfo): off here, on for a model whose intercept
        (or its like) would make every level's column singular."""
        return False

    # ---- algorithm hooks ---------------------------------------------------
    def _fit(self, frame: Frame):
        raise NotImplementedError

    def _score_matrix(self, X: torch.Tensor) -> torch.Tensor:
        """Batch score: regression predictions (n,) or class probs (n, K)."""
        raise NotImplementedError

    # ---- serving params ------------------------------------------------------
    # The instance attributes whose values (tensors, arrays, dataclasses
    # and lists of them) enter the serving scorer as SHARED params: the
    # param store places them once per model generation and every
    # row-bucket program reads that copy. Missing or None attributes are
    # skipped. Anything the scorer reads as a Python number stays out.
    _serving_param_attrs: tuple = ()
    # ((regex, spec), ...) of the JAX package's sharding; declared for the
    # multi-device item (ROADMAP.md §1), unread on one card.
    _partition_rules: tuple = ()

    def _serving_params(self):
        """Param pytree for the serving fast path, or None when this
        family's scorer reads its own state."""
        attrs = self._serving_param_attrs
        if not attrs:
            return None
        p = {a: getattr(self, a, None) for a in attrs}
        p = {a: v for a, v in p.items() if v is not None}
        return p or None

    def _score_with_params(self, params, X):
        """_score_matrix with `params` (a `_serving_params()`-shaped
        pytree of placed tensors) standing in for the exported attributes:
        the params are grafted onto a SHALLOW COPY of the model and the
        family's own `_score_matrix` runs, so fast-path and eager
        predictions come from the same code."""
        clone = copy.copy(self)
        for a, v in params.items():
            setattr(clone, a, v)
        return type(self)._score_matrix(clone, X)

    # ---- DKV lifecycle hooks -------------------------------------------------
    def _on_remove(self):
        """DKV.remove(model key): drop the model's serving residency —
        its programs and graphs, and its param placements on every tier —
        exactly once, and its per-model observability series. Runs
        outside the `dkv` lock."""
        if not self.key:
            return
        self._on_replace()
        # per-model observability series leave /metrics exactly once:
        # drift sketches + gauges (modelmon) and the usage ledger's
        # attribution rows/counters. Both are idempotent no-ops when the
        # model was never monitored/charged.
        try:
            from h2o3_tpu_torch.obs import modelmon as _mm
            _mm.forget(self.key)
        except Exception:   # noqa: BLE001
            pass
        try:
            from h2o3_tpu_torch.obs import usage as _usage
            _usage.forget_model(self.key)
        except Exception:   # noqa: BLE001
            pass

    def _on_replace(self):
        """A retrain overwriting this key frees the old generation's
        serving residency like a remove — but KEEPS the monitoring series:
        modelmon retains the outgoing generation's live sketch for the
        shadow-compare (rotation happened in install_baseline), and the
        usage ledger keeps attributing to the key across generations."""
        if not self.key:
            return
        try:
            from h2o3_tpu_torch import serving
            serving.CACHE.invalidate_key(self.key)
        except Exception:   # noqa: BLE001 — removal must not fail the DKV op
            pass

    # ---- scoring / metrics -------------------------------------------------
    @property
    def _is_classifier(self) -> bool:
        return self.supervised and self._dinfo.response_domain is not None

    @property
    def nclasses(self) -> int:
        d = self._dinfo.response_domain if self._dinfo else None
        return len(d) if d else 1

    def predict(self, test_data: Frame) -> Frame:
        out = self._score_host(test_data)
        pred = self._prediction_frame(out, test_data.nrows)
        pred.shard = test_data.shard     # scoring is local to each rank
        return pred

    def _score_host(self, test_data: Frame) -> np.ndarray:
        """Score a frame and fetch the result in one copy. Serving-sized
        frames go through the scorer cache (a graph a row bucket; the
        result at bucket length, trimmed by the callers); larger ones, and
        any the fast path refuses, run the scorer eagerly."""
        from h2o3_tpu_torch import serving
        out = serving.score_frame(self, test_data)
        if out is None:
            X = self._dinfo.matrix(test_data)
            out = self._score_matrix(X).cpu().numpy()
        return out

    def _prediction_columns(self, out: np.ndarray, n: int) -> list:
        """The ONE map from raw scores to (name, float64 values,
        domain-or-None) columns: predict and one p<level> column per class,
        or predict alone."""
        if self._is_classifier:
            probs = np.asarray(out, np.float64)[:n]
            dom = self._dinfo.response_domain
            cols = [("predict", probs.argmax(axis=1).astype(np.float64),
                     dom)]
            cols += [(f"p{lvl}", probs[:, k], None)
                     for k, lvl in enumerate(dom)]
            return cols
        return [("predict", np.asarray(out, np.float64)[:n], None)]

    def _prediction_frame(self, out: np.ndarray, n: int) -> Frame:
        """The predictions Frame from host scores, its columns born in
        the host tier: the scores are on the host already, and reach the
        card only when a reader faults them in."""
        names, vecs = [], []
        for name, vals, dom in self._prediction_columns(out, n):
            vecs.append(Vec.from_host_floats(vals, domain=dom))
            names.append(name)
        return Frame(names, vecs)

    def model_performance(self, test_data: Optional[Frame] = None):
        """The metrics of a frame scored now; the training metrics without
        one."""
        if test_data is None:
            return self._output.training_metrics
        return self._compute_metrics(test_data)

    def _compute_metrics(self, frame: Frame):
        di = self._dinfo
        from h2o3_tpu_torch import serving
        if _mr.sharded(frame):
            # its all-reduces as one region of the collective guard
            from h2o3_tpu_torch.parallel import compat as _compat
            return _compat.run_host_serialized(
                lambda: self._sharded_metrics(frame))
        fast = serving.score_frame_with_response(self, frame)
        if fast is not None:
            # bucketed fast path: (bucket,)-long y and w with w = 0 on
            # the padding and missing-response rows, so padded rows never
            # reach an aggregate
            dev = frame.vecs[0].device
            out, y, w = (torch.from_numpy(a).to(dev) for a in fast)
        else:
            y = di.response(frame)
            w = di.weights(frame)
            w = torch.where(torch.isnan(y), 0.0, w)
            out = self._score_matrix(di.matrix(frame))
        m = self._metrics_from_preds(y, out, w)
        cmf = self.params.get("custom_metric_func")
        if cmf and m is not None:
            # the CMetricFunc contract on the card: rows with w = 0 (a
            # missing response) must not poison the aggregate, so their
            # y is neutralised (0 * NaN would propagate)
            udf = resolve_udf(cmf)
            ysafe = torch.where(w > 0, torch.nan_to_num(y), 0.0)
            agg = _fold_custom_metric(udf, udf.map(torch.nan_to_num(out),
                                                   ysafe, w))
            m.custom_metric = {"name": udf.name,
                               "value": float(udf.metric(agg))}
        return m

    def _sharded_metrics(self, frame: Frame):
        """The metrics of a frame that holds one row block on each rank of
        a cloud: each rank scores its rows, and the metric passes' states
        are summed over the world (models/metrics.py `sharded`): the AUC
        and the counts are the one-process ones, the float sums equal to
        within the order of their f32 partials."""
        if self.params.get("custom_metric_func"):
            raise NotImplementedError(
                "custom metrics of a frame of a cloud of several ranks are "
                "not ported")
        di = self._dinfo
        y = di.response(frame)
        w = torch.where(torch.isnan(y), 0.0, di.weights(frame))
        out = self._score_matrix(di.matrix(frame))
        return self._metrics_from_preds(y, out, w, sharded=True)

    def _metrics_from_preds(self, y, out, w, sharded=False):
        """The metrics of scores `out`; `sharded`: of this rank's rows of
        a frame of a cloud of several ranks (summed over the world)."""
        if not self.supervised:
            return None
        if self._is_classifier and self.nclasses == 2:
            return M.binomial_metrics(y, out[:, 1], w,
                                      domain=self._dinfo.response_domain,
                                      sharded=sharded)
        if self._is_classifier:
            return M.multinomial_metrics(y, out, w,
                                         domain=self._dinfo.response_domain,
                                         sharded=sharded)
        return M.regression_metrics(y, out, w, sharded=sharded)

    def _score_train_valid(self, frame, valid):
        if not self.supervised:     # an unsupervised model has no metrics
            return
        self._output.training_metrics = self._compute_metrics(frame)
        if valid is not None:
            self._output.validation_metrics = self._compute_metrics(valid)

    # ---- cross-validation (ModelBuilder.computeCrossValidation) -----------
    def _fold_ids(self, frame: Frame, y) -> tuple[np.ndarray, list]:
        """Each row's fold, and the folds, as the JAX package assigns them.
        The draws come from numpy's default_rng(seed) on the host, in the
        JAX package's order of calls, and not from a torch generator: the
        folds must be that package's folds row for row."""
        nfolds = int(self.params["nfolds"] or 0)
        fold_col = self.params.get("fold_column")
        n = frame.nrows
        if fold_col:
            fa = frame.vec(fold_col).to_numpy().astype(int)
            return fa, sorted(set(fa.tolist()))
        seed = int(self.params.get("seed") or -1)
        rng = np.random.default_rng(seed if seed > 0 else None)
        how = self.params.get("fold_assignment") or "AUTO"
        if how in ("AUTO", "Random"):
            fa = rng.integers(0, nfolds, size=n)
        elif how == "Modulo":
            fa = np.arange(n) % nfolds
        else:       # Stratified: per-class modulo over a shuffled order
            yv = frame.vec(y).to_numpy()
            fa = np.zeros(n, int)
            for cls in np.unique(yv[~np.isnan(yv)]):
                idx = np.where(yv == cls)[0]
                rng.shuffle(idx)
                fa[idx] = np.arange(len(idx)) % nfolds
        return fa, list(range(nfolds))

    def _run_cross_validation(self, frame: Frame, x, y, job: Job):
        """One model a fold on the other folds' rows (row subsets taken on
        the frame's device), scored on its fold; the holdout predictions of
        all folds make `cross_validation_metrics`. Every fold model gets
        what remains of the job's deadline."""
        fa, folds = self._fold_ids(frame, y)
        n = frame.nrows
        dev = frame.vecs[0].device
        holdout = None
        cv_models = []
        for fi, f in enumerate(folds):
            te_np = fa == f
            tr = _subframe(frame, torch.from_numpy(
                np.flatnonzero(~te_np)).to(dev))
            te_idx = torch.from_numpy(np.flatnonzero(te_np)).to(dev)
            te = _subframe(frame, te_idx)
            mb = self.__class__(**{k: v for k, v in self.params.items()
                                   if k not in ("nfolds", "model_id",
                                                "fold_column")})
            mb.params["nfolds"] = 0
            if job.deadline is not None:
                mb.params["max_runtime_secs"] = max(
                    1.0, job.deadline - time.time())
            mb.train(x=x, y=y, training_frame=tr)
            cv_models.append(mb)
            out = mb._score_matrix(mb._dinfo.matrix(te)).to(torch.float32)
            if holdout is None:
                holdout = torch.full((n,) + tuple(out.shape[1:]), math.nan,
                                     dtype=torch.float32, device=dev)
            holdout[te_idx] = out
            for k in (tr.key, te.key):
                DKV.remove(k)
            job.update(0.5 * (fi + 1) / len(folds), f"CV fold {fi + 1}")
        di = self._dinfo
        self._output.cross_validation_metrics = self._metrics_from_preds(
            di.response(frame), holdout, di.weights(frame))
        self._cv_models = cv_models
        if self.params.get("keep_cross_validation_predictions"):
            cols = holdout if holdout.dim() == 2 else holdout[:, None]
            cvp = Frame([f"C{j + 1}" for j in range(cols.shape[1])],
                        [Vec.from_tensor(cols[:, j])
                         for j in range(cols.shape[1])])
            self._output.cv_predictions_key = cvp.key
        if self.params.get("keep_cross_validation_fold_assignment"):
            cvf = Frame(["C1"], [Vec.from_tensor(
                torch.from_numpy(fa.astype(np.float32)).to(dev))])
            self._output.cv_fold_assignment_key = cvf.key

    # ---- introspection -------------------------------------------------------
    def _metric(self, name, valid):
        m = (self._output.validation_metrics if valid
             else self._output.training_metrics)
        return getattr(m, name, None)

    def auc(self, valid=False):
        return self._metric("auc", valid)

    def logloss(self, valid=False):
        return self._metric("logloss", valid)

    def mse(self, valid=False):
        return self._metric("mse", valid)

    def rmse(self, valid=False):
        return self._metric("rmse", valid)

    @property
    def model_id(self):
        return self.key

    def summary(self):
        return self._output.model_summary if self._output else {}

    def scoring_history(self):
        return self._output.scoring_history if self._output else []

    def varimp(self):
        return self._output.variable_importances if self._output else None

    # ---- explanation surface (h2o-py explain module) ---------------------
    def partial_plot(self, frame, cols=None, nbins: int = 20, plot=False):
        """h2o model.partial_plot: PDP tables of `cols` (by default the
        two most important predictors)."""
        from h2o3_tpu_torch import explain_data as EX
        cols = cols or [r["variable"] for r in (self.varimp() or [])[:2]] \
            or self._dinfo.predictors[:2]
        return [EX.partial_dependence(self, frame, c, nbins=nbins)
                for c in cols]

    def permutation_importance(self, frame, metric="AUTO", n_repeats=1,
                               seed=42):
        """h2o model.permutation_importance (PermutationVarImp.java)."""
        from h2o3_tpu_torch import explain_data as EX
        return EX.permutation_varimp(self, frame, metric=metric,
                                     n_repeats=n_repeats, seed=seed)

    def ice_plot(self, frame, column, nbins: int = 20):
        from h2o3_tpu_torch import explain_plots as EP
        return EP.ice_plot(self, frame, column, nbins=nbins)

    def pd_plot(self, frame, column, nbins: int = 20):
        from h2o3_tpu_torch import explain_plots as EP
        return EP.pd_plot(self, frame, column, nbins=nbins)

    def varimp_plot(self, num_of_features: int = 10):
        from h2o3_tpu_torch import explain_plots as EP
        return EP.varimp_plot(self, num_of_features=num_of_features)

    def shap_summary_plot(self, frame, top_n: int = 20):
        from h2o3_tpu_torch import explain_plots as EP
        return EP.shap_summary_plot(self, frame, top_n=top_n)

    def shap_explain_row_plot(self, frame, row_index: int, top_n: int = 10):
        from h2o3_tpu_torch import explain_plots as EP
        return EP.shap_explain_row_plot(self, frame, row_index, top_n=top_n)

    def learning_curve_plot(self):
        from h2o3_tpu_torch import explain_plots as EP
        return EP.learning_curve_plot(self)

    def explain(self, frame, columns: int = 3):
        from h2o3_tpu_torch import explain_plots as EP
        return EP.explain(self, frame, columns=columns)

    # ---- export (h2o-genmodel surface) -----------------------------------
    def download_mojo(self, path: str, format: str = "native") -> str:
        """format="native": the npz-zip artifact (genmodel/mojo.py);
        format="h2o3": a genuine H2O-3 MOJO zip (genmodel/h2o_mojo.py: GBM,
        DRF, GLM, KMeans, DL)."""
        if format == "h2o3":
            from h2o3_tpu_torch.genmodel.h2o_mojo import export_h2o_mojo
            return export_h2o_mojo(self, path)
        from h2o3_tpu_torch.genmodel.mojo import export_mojo
        return export_mojo(self, path)

    save_mojo = download_mojo

    def download_pojo(self, path: str) -> str:
        """A dependency-free Java scoring class (water/util/JCodeGen.java)
        at `path` (a directory: <ClassName>.java in it)."""
        from h2o3_tpu_torch.genmodel.pojo import export_pojo
        return export_pojo(self, path)

    def save_model_details(self, path: str) -> str:
        """to_dict() as JSON at `path`."""
        import json
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, default=str)
        return path

    def to_dict(self) -> dict:
        """The model's JSON (ModelOutputSchemaV3's keys): its parameters,
        metrics and summary, with the variable importances, the scoring
        history, the coefficients and the centres where it has them."""
        o = self._output

        def metrics(m):
            return m.to_dict() if m is not None else None
        d = {"model_id": self.key, "algo": self.algo,
             "params": {k: v for k, v in self.params.items()
                        if v is not None},
             "training_metrics": metrics(o.training_metrics) if o else None,
             "validation_metrics": (metrics(o.validation_metrics)
                                    if o else None),
             "model_summary": o.model_summary if o else {}}
        if o and o.variable_importances:
            d["variable_importances"] = o.variable_importances
        if o and o.scoring_history:
            d["scoring_history"] = o.scoring_history
        out = {}
        if getattr(self, "_coefficients", None):
            out["coefficients_table"] = self._coefficients
            out["coefficients_std"] = getattr(self, "_coefficients_std",
                                              None)
        centres = getattr(self, "_centroids", None)
        if centres is not None:
            out["centers"] = np.asarray(
                centres.cpu() if torch.is_tensor(centres) else centres,
                np.float64).tolist()
        if out:
            d["output"] = out
        return d


def _matrix_frame(names: Sequence[str], M: torch.Tensor) -> Frame:
    """A frame of the columns of an (n, len(names)) device tensor, left on
    its device (the unsupervised models' projections, assignments and
    reconstructions; the JAX package builds them on the host)."""
    return Frame(list(names), [Vec.from_tensor(M[:, j])
                               for j in range(M.shape[1])])


def _subframe(frame: Frame, idx: torch.Tensor) -> Frame:
    """Rows `idx` (int64, on the frame's device) of every column, in that
    order, with the columns' types and domains (CV fold splitting; the JAX
    package takes the rows on the host)."""
    vecs = []
    for c in frame.names:
        v = frame.vec(c)
        if isinstance(v, StrVec):
            vecs.append(StrVec(v.codes.index_select(0, idx), v.levels_arr,
                               idx.numel()))
        elif isinstance(v, UuidVec):
            words, na = v._uuid_chunk.staging_view()
            rows = idx.cpu().numpy()
            vecs.append(UuidVec(words[rows], na[rows], len(rows),
                                device=v.device))
        else:       # a sparse column is taken dense
            vecs.append(Vec.from_tensor(v.as_f32().index_select(0, idx),
                                        v.type, v.domain))
    return Frame(list(frame.names), vecs)
