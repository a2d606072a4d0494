"""Binary model save and load of the port (h2o3_tpu/genmodel/mojo.py
`save_model`/`load_model`; water/api/ModelsHandler exportBinaryModel).

`save_model` pickles the whole model, as the JAX package does, with what
lives on a device reduced to host form, so a model saved on the card
loads on a machine without one:
  * a tensor (and an nn.Parameter) as its bytes, dtype and shape;
  * a torch.device as the load's device;
  * a torch.Generator as its device type and state;
  * a Frame as its `.hex` bytes (io/persist.py), its key kept.
`load_model(path, device=None)` puts every tensor, Frame and generator on
`device`, by default the cloud's (the card unless `init(device="cpu")`);
a generator saved on another device type restarts from its initial seed.
A model with a key (every estimator but the target encoder, which has
none) is put in the store under it.

`export_mojo` writes the scoring artifact (hex/genmodel MojoModel and
the per-algorithm *MojoWriter): a zip of `model.json` (the metadata and
the row codec) and `payload.npz` (the learned arrays), the JAX package's
layout under the same MAGIC, so that an artifact of either package loads
in the other's `MojoModel`. `MojoModel` scores it with numpy alone, no
torch and no cloud: `predict` takes dict rows (EasyPredictModelWrapper's
row API), `predict_matrix` a model-space matrix, and `columns_to_matrix`
builds that matrix a column at a time (the generic estimator's path; the
same matrix as the rows give). A tree model with categorical set splits
also writes its go-right words (`cb_<c>`, `cic`), which the port's
`MojoModel` walks and the JAX package's ignores.

The port's GLM drops the first level of each categorical without NAs
(DataInfo's reduced design); its artifacts take the JAX package's layout
with every level, the dropped level's coefficient exactly 0
(`all_levels`, `full_beta`), which scores what the port scores: an NA or
unseen level and the dropped level each contribute 0.
"""

from __future__ import annotations

import io
import json
import pickle
import threading
import zipfile

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV

_TARGET = threading.local()
MAGIC = "h2o3_tpu_mojo/1"


def _target():
    dev = getattr(_TARGET, "device", None)
    if dev is None:
        from h2o3_tpu_torch.parallel.mesh import cloud
        dev = cloud().device
    return dev


def _restore_tensor(raw: np.ndarray, dtype: str, shape: tuple,
                    parameter: bool, requires_grad: bool):
    t = torch.from_numpy(raw.copy()).view(getattr(torch, dtype))
    t = t.reshape(shape).to(_target())
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _restore_generator(kind: str, state: np.ndarray, seed: int):
    dev = _target()
    g = torch.Generator(device=dev)
    if dev.type == kind:
        g.set_state(torch.from_numpy(state.copy()))
    else:
        g.manual_seed(seed)
    return g


def _restore_frame(hex_bytes: bytes, key: str):
    from h2o3_tpu_torch.io.persist import _read_hex
    return _read_hex(io.BytesIO(hex_bytes), key, device=_target())


class _ModelPickler(pickle.Pickler):
    """Device state reduced to host form (the JAX package's
    `_ModelPickler` does this for jax.Array)."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous()
            raw = t.reshape(-1).view(torch.uint8).numpy().copy()
            return _restore_tensor, (
                raw, str(t.dtype).split(".")[1], tuple(t.shape),
                isinstance(obj, torch.nn.Parameter), obj.requires_grad)
        if isinstance(obj, torch.device):
            # a model keeps the device it trained on to make its tensors
            # there: it becomes the load's device
            return _target, ()
        if isinstance(obj, torch.Generator):
            return _restore_generator, (obj.device.type,
                                        obj.get_state().numpy().copy(),
                                        obj.initial_seed())
        if isinstance(obj, Frame):
            from h2o3_tpu_torch.io.persist import _write_hex
            buf = io.BytesIO()
            _write_hex(obj, buf)
            return _restore_frame, (buf.getvalue(), obj.key)
        return NotImplemented


def save_model(model, path: str) -> str:
    """h2o.save_model: the model as one binary file at `path` (by the
    coordinator of a cloud: a worker replaying the request writes
    nothing)."""
    from h2o3_tpu_torch.deploy import multihost as _mh
    if not _mh.writes_artifacts():
        return path
    with open(path, "wb") as f:
        _ModelPickler(f, protocol=5).dump(model)
    return path


def load_model(path: str, device=None):
    """h2o.load_model: a saved model, its tensors on `device` (by default
    the cloud's), put in the store."""
    _TARGET.device = torch.device(device) if device is not None else None
    try:
        with open(path, "rb") as f:
            m = pickle.load(f)
    finally:
        _TARGET.device = None
    if getattr(m, "key", None):
        DKV.put(m.key, m)
    return m


# ===========================================================================
# The scoring artifact
def _np(x):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _AllLevels:
    """A one-hot DataInfo seen with every level of each categorical (the
    JAX package's layout): `feature_names` in full, `index` the position
    in it of each of the model's own design columns; every other
    attribute is the DataInfo's."""

    def __init__(self, di):
        self._di = di
        names, idx = [], []
        for c in di.cat_cols:
            levels = [f"{c}.{lvl}" for lvl in di.domains[c]]
            idx += range(len(names) + di._first(c), len(names) + len(levels))
            names += levels
        rest = di.feature_names[len(idx):]      # numeric and interactions
        idx += range(len(names), len(names) + len(rest))
        self.feature_names = names + list(rest)
        self.index = np.asarray(idx, np.int64)
        self.drop_first = []

    def __getattr__(self, name):
        return getattr(self._di, name)


def all_levels(di):
    """The DataInfo itself in label mode or with every level; else its
    all-levels view."""
    if di is None or di.cat_mode != "onehot" or not di.drop_first:
        return di
    return _AllLevels(di)


def full_beta(model) -> np.ndarray:
    """The GLM's coefficients in the all-levels layout ((p+1,), or (K,
    p+1) for multinomial, intercept last): 0 at each dropped level."""
    beta = np.asarray(model._state.beta, np.float64)
    view = all_levels(model._dinfo)
    if view is model._dinfo:
        return beta
    out = np.zeros(beta.shape[:-1] + (len(view.feature_names) + 1,))
    out[..., view.index] = beta[..., :-1]
    out[..., -1] = beta[..., -1]
    return out


def full_coefficients(coefs: dict, names) -> dict:
    """A coefficient table over `names` (+ Intercept), 0 (K zeros for
    multinomial) where the model has no column."""
    zero = [0.0] * len(coefs["Intercept"]) \
        if isinstance(coefs["Intercept"], list) else 0.0
    return {n: coefs.get(n, zero) for n in list(names) + ["Intercept"]}


def _trees_payload(meta, arrays, tlist):
    for c, ta in enumerate(tlist):
        arrays[f"col_{c}"] = _np(ta.col)
        arrays[f"thr_{c}"] = _np(ta.thr)
        arrays[f"nal_{c}"] = _np(ta.na_left)
        arrays[f"val_{c}"] = _np(ta.value)
        if ta.catbits is not None and ta.col_is_cat is not None \
                and bool(np.any(ta.col_is_cat)):
            arrays[f"cb_{c}"] = _np(ta.catbits).astype(np.uint32)
            arrays["cic"] = np.asarray(ta.col_is_cat, bool)
    meta["depth"] = tlist[0].depth


def export_mojo(model, path: str) -> str:
    """Model.getMojo(): the learned state and the scoring metadata as a
    zip at `path`."""
    algo = model.algo
    di = all_levels(model._dinfo)
    meta = {
        "magic": MAGIC, "algo": algo, "model_id": model.key,
        "params": {k: v for k, v in model.params.items()
                   if isinstance(v, (int, float, str, bool, list,
                                     type(None)))},
        "predictors": di.predictors if di else [],
        "feature_names": di.feature_names if di else [],
        "cat_cols": di.cat_cols if di else [],
        "num_cols": di.num_cols if di else [],
        "domains": ({k: list(v) for k, v in (di.domains or {}).items()}
                    if di else {}),
        "response_domain": di.response_domain if di else None,
        "means": di.means if di else {},
        "sigmas": di.sigmas if di else {},
        "standardize": di.standardize if di else False,
        "cat_mode": di.cat_mode if di else "onehot",
    }
    if di is not None and di.cat_mode == "onehot" and (
            di.inter_pairs or di.inter_catcat or di.inter_catnum):
        raise NotImplementedError(
            "MOJO export: the artifact's row codec has no interaction "
            "columns")
    arrays = {}
    if algo in ("gbm", "xgboost", "drf", "isolationforest"):
        if getattr(model, "_trees_k", None) is not None:
            meta["nclass_trees"] = len(model._trees_k)
            _trees_payload(meta, arrays, model._trees_k)
            meta["f0"] = np.asarray(model._f0, np.float64).tolist() \
                if getattr(model, "_f0", None) is not None else None
        else:
            _trees_payload(meta, arrays, [model._trees])
            if algo in ("gbm", "xgboost"):
                meta["f0"] = float(model._f0)
            if algo == "isolationforest":
                meta["min_len"] = model._min_len
                meta["max_len"] = model._max_len
        if algo in ("gbm", "xgboost"):
            meta["dist"] = model._dist
            meta["learn_rate"] = float(model.params["learn_rate"])
        if algo == "drf":
            meta["nclasses"] = model.nclasses
    elif algo == "glm":
        if model._state.family == "ordinal":
            raise NotImplementedError("MOJO export: the artifact's GLM "
                                      "scorer has no ordinal family")
        arrays["beta"] = full_beta(model)
        meta["family"] = model._state.family
        meta["link"] = model._state.link
    elif algo == "kmeans":
        arrays["centers"] = _np(model._centroids)
    elif algo == "deeplearning":
        for i, (W, b) in enumerate(model._params_net):
            arrays[f"W_{i}"] = _np(W)
            arrays[f"b_{i}"] = _np(b)
        meta["n_layers"] = len(model._params_net)
        meta["activation"] = model.params.get("activation")
        # a carried net has no fit's loss: a classifier's is "ce"
        meta["loss_kind"] = getattr(model, "_loss_kind", None) or (
            "ce" if model._is_classifier else "quadratic")
        meta["autoencoder"] = bool(model.params.get("autoencoder"))
    elif algo == "naivebayes":
        arrays["priors"] = _np(model._priors)
        for i, t in enumerate(model._cat_probs):
            arrays[f"cat_{i}"] = _np(t)
        for i, m in enumerate(model._num_mean):
            arrays[f"nmean_{i}"] = _np(m)
            arrays[f"nsd_{i}"] = _np(model._num_sd[i])
        meta["cat_idx"] = list(model._cat_idx)
        meta["num_idx"] = list(model._num_idx)
    elif algo == "pca":
        arrays["rotation"] = _np(model._rotation)
        arrays["mean"] = _np(model._mean)
        arrays["sd"] = _np(model._sd)
        meta["transform"] = model._transform
    elif algo == "glrm":
        arrays["archetypes"] = _np(model._B)
    else:
        raise NotImplementedError(f"MOJO export for {algo}")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("model.json", json.dumps(meta, default=float))
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        zf.writestr("payload.npz", buf.getvalue())
    return path


class MojoModel:
    """The standalone scorer (hex/genmodel MojoModel and
    EasyPredictModelWrapper): numpy only, no cloud, no torch."""

    def __init__(self, meta: dict, arrays: dict):
        self.meta = meta
        self.arrays = arrays
        self.algo = meta["algo"]

    @staticmethod
    def load(path: str) -> "MojoModel":
        with zipfile.ZipFile(path) as zf:
            meta = json.loads(zf.read("model.json"))
            if meta.get("magic") != MAGIC:
                raise ValueError(f"{path}: not an h2o3_tpu MOJO")
            npz = np.load(io.BytesIO(zf.read("payload.npz")))
            arrays = {k: npz[k] for k in npz.files}
        return MojoModel(meta, arrays)

    # ---- rows or columns to the model-space matrix (GenModel data prep) --
    def _row_to_matrix(self, rows) -> np.ndarray:
        """Dict rows (a missing or None value is NA) to the matrix, a row
        at a time, as the JAX package builds it."""
        m = self.meta
        if isinstance(rows, dict):
            rows = [rows]
        n = len(rows)
        if m["cat_mode"] == "label":
            X = np.full((n, len(m["predictors"])), np.nan)
            for i, r in enumerate(rows):
                for j, c in enumerate(m["predictors"]):
                    v = r.get(c)
                    if v is None:
                        continue
                    if c in m["domains"]:
                        dom = m["domains"][c]
                        X[i, j] = dom.index(str(v)) if str(v) in dom \
                            else np.nan
                    else:
                        X[i, j] = float(v)
            return X
        out = []
        for r in rows:
            row = []
            for c in m["cat_cols"]:
                dom = m["domains"][c]
                oh = [0.0] * len(dom)
                v = r.get(c)
                if v is not None and str(v) in dom:
                    oh[dom.index(str(v))] = 1.0
                row.extend(oh)
            for c in m["num_cols"]:
                v = r.get(c)
                x = np.nan if v is None else float(v)
                if m["standardize"]:
                    mu = m["means"].get(c, 0.0)
                    sd = max(m["sigmas"].get(c, 1.0) or 1.0, 1e-10)
                    x = 0.0 if np.isnan(x) else (x - mu) / sd
                elif np.isnan(x):
                    x = m["means"].get(c, 0.0)
                row.append(x)
            out.append(row)
        return np.asarray(out, np.float64)

    def columns_to_matrix(self, cols: dict, n: int) -> np.ndarray:
        """The same matrix as `_row_to_matrix`, a column at a time. `cols`
        maps a predictor to (values, domain): float64 values with NaN for
        NA (a categorical's level codes into `domain`, its levels); a
        predictor not in `cols` is NA throughout."""
        m = self.meta

        def codes(c):
            """Level codes into the model's domain of c, NaN for NA or an
            unseen level."""
            vals, dom = cols[c]
            want = {lvl: i for i, lvl in enumerate(m["domains"][c])}
            if dom is None:     # numeric here: a value's str() is its level
                return np.array([np.nan if np.isnan(v) else
                                 want.get(str(v), np.nan) for v in vals],
                                np.float64)
            lut = np.array([want.get(str(lvl), np.nan) for lvl in dom]
                           + [np.nan], np.float64)
            ok = ~np.isnan(vals)
            return lut[np.where(ok, np.nan_to_num(vals), len(dom))
                       .astype(np.int64)]

        if m["cat_mode"] == "label":
            X = np.full((n, len(m["predictors"])), np.nan)
            for j, c in enumerate(m["predictors"]):
                if c not in cols:
                    continue
                X[:, j] = codes(c) if c in m["domains"] else cols[c][0]
            return X
        parts = []
        for c in m["cat_cols"]:
            k = len(m["domains"][c])
            oh = np.zeros((n, k))
            if c in cols:
                cd = codes(c)
                ok = ~np.isnan(cd)
                oh[np.flatnonzero(ok), cd[ok].astype(np.int64)] = 1.0
            parts.append(oh)
        for c in m["num_cols"]:
            x = cols[c][0] if c in cols else np.full(n, np.nan)
            if m["standardize"]:
                mu = m["means"].get(c, 0.0)
                sd = max(m["sigmas"].get(c, 1.0) or 1.0, 1e-10)
                x = np.where(np.isnan(x), 0.0, (x - mu) / sd)
            else:
                x = np.where(np.isnan(x), m["means"].get(c, 0.0), x)
            parts.append(x[:, None])
        if not parts:
            return np.zeros((n, 0))
        return np.concatenate(parts, axis=1).astype(np.float64)

    # ---- scoring ---------------------------------------------------------
    def _walk_trees(self, X, c_idx=0):
        col = self.arrays[f"col_{c_idx}"]
        thr = self.arrays[f"thr_{c_idx}"]
        nal = self.arrays[f"nal_{c_idx}"]
        val = self.arrays[f"val_{c_idx}"]
        cb = self.arrays.get(f"cb_{c_idx}")
        cic = self.arrays.get("cic")
        T = col.shape[0]
        n = X.shape[0]
        # X[row, col] as one flat gather (a 2-D fancy index costs twice)
        Xf = np.ascontiguousarray(X).ravel()
        base = np.arange(n, dtype=np.int64) * X.shape[1]
        out = np.zeros(n)
        for t in range(T):
            node = np.zeros(n, np.int64)
            for _ in range(self.meta["depth"]):
                c = col[t][node]
                leafish = c < 0
                cc = np.maximum(c, 0)
                x = Xf[base + cc]
                isna = np.isnan(x)
                right = x > thr[t][node]
                if cb is not None:
                    nb = cb.shape[-1] * 32
                    code = np.clip(np.nan_to_num(x), 0, nb - 1) \
                        .astype(np.int64)
                    word = cb[t][node, code // 32]
                    bit = (word >> (code % 32).astype(np.uint32)) & 1
                    right = np.where(cic[cc], bit == 1, right)
                right = np.where(isna, ~nal[t][node], right)
                child = 2 * node + 1 + right.astype(np.int64)
                node = np.where(leafish, node, child)
            out += val[t][node]
        return out

    def predict(self, data):
        """EasyPredictModelWrapper.predict: dict row(s) to a prediction
        dict."""
        return self.predict_matrix(self._row_to_matrix(data))

    def predict_matrix(self, X):
        """A prediction dict from the model-space matrix X."""
        m = self.meta
        algo = self.algo
        if algo in ("gbm", "xgboost"):
            if "nclass_trees" in m:
                K = m["nclass_trees"]
                F = np.stack([m["f0"][c] + m["learn_rate"]
                              * self._walk_trees(X, c) for c in range(K)], 1)
                eF = np.exp(F - F.max(1, keepdims=True))
                return self._cls_out(eF / eF.sum(1, keepdims=True))
            F = m["f0"] + m["learn_rate"] * self._walk_trees(X)
            if m["dist"] in ("bernoulli", "quasibinomial"):
                p = 1 / (1 + np.exp(-F))
                return self._cls_out(np.stack([1 - p, p], 1))
            if m["dist"] in ("poisson", "gamma", "tweedie"):
                return {"predict": np.exp(F)}
            return {"predict": F}
        if algo == "drf":
            T = self.arrays["col_0"].shape[0]
            if "nclass_trees" in m:
                P = np.stack([self._walk_trees(X, c) / T
                              for c in range(m["nclass_trees"])], 1)
                P = np.clip(P, 0, 1)
                P /= np.maximum(P.sum(1, keepdims=True), 1e-10)
                return self._cls_out(P)
            mean = self._walk_trees(X) / T
            if m["response_domain"]:
                p = np.clip(mean, 0, 1)
                return self._cls_out(np.stack([1 - p, p], 1))
            return {"predict": mean}
        if algo == "isolationforest":
            ml = self._walk_trees(X) / self.arrays["col_0"].shape[0]
            span = max(m["max_len"] - m["min_len"], 1e-12)
            return {"predict": (m["max_len"] - ml) / span, "mean_length": ml}
        if algo == "glm":
            beta = self.arrays["beta"]
            Xi = np.column_stack([np.nan_to_num(X), np.ones(len(X))])
            if m["family"] == "multinomial":
                F = Xi @ beta.T
                eF = np.exp(F - F.max(1, keepdims=True))
                return self._cls_out(eF / eF.sum(1, keepdims=True))
            eta = Xi @ beta
            link = m["link"]
            mu = (eta if link == "identity" else
                  1 / (1 + np.exp(-np.clip(eta, -40, 40)))
                  if link == "logit" else
                  np.exp(np.clip(eta, -700, 700)) if link == "log"
                  else 1.0 / eta)
            if m["family"] in ("binomial", "quasibinomial"):
                return self._cls_out(np.stack([1 - mu, mu], 1))
            return {"predict": mu}
        if algo == "kmeans":
            C = self.arrays["centers"]
            d = ((np.nan_to_num(X)[:, None, :] - C[None]) ** 2).sum(-1)
            return {"cluster": d.argmin(1)}
        if algo == "deeplearning":
            h = np.nan_to_num(X)
            nl = m["n_layers"]
            act = (m.get("activation") or "Rectifier").lower()
            for i in range(nl):
                z = h @ self.arrays[f"W_{i}"] + self.arrays[f"b_{i}"]
                if i < nl - 1:
                    if "maxout" in act:
                        z = z.reshape(z.shape[0], -1, 2).max(2)
                    elif "tanh" in act:
                        z = np.tanh(z)
                    else:
                        z = np.maximum(z, 0)
                h = z
            if m.get("autoencoder"):
                return {"reconstruction": h}
            if m["loss_kind"] == "ce":
                eF = np.exp(h - h.max(1, keepdims=True))
                return self._cls_out(eF / eF.sum(1, keepdims=True))
            return {"predict": h[:, 0]}
        if algo == "pca":
            x = np.nan_to_num(X)
            t = m["transform"]
            if t in ("DEMEAN", "STANDARDIZE"):
                x = x - self.arrays["mean"]
            if t in ("DESCALE", "STANDARDIZE", "NORMALIZE"):
                x = x / self.arrays["sd"]
            return {"scores": x @ self.arrays["rotation"]}
        raise NotImplementedError(self.algo)

    def _cls_out(self, P):
        dom = self.meta["response_domain"]
        idx = P.argmax(1)
        return {"predict": np.array([dom[i] for i in idx], object),
                "probs": P, "domain": dom}
