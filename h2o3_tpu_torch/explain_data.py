"""Model explanation tables of the port (h2o3_tpu/explain_data.py): partial
dependence, ICE, permutation importance, the varimp heatmap, model
correlation and the learning curve, as data (explain_plots.py draws
them).

Reference: water/rapids/PermutationVarImp.java, hex/PartialDependence,
the h2o-py explain module. Each grid point of a PDP or ICE scores the
whole design matrix once on its device, with the column overwritten in a
copy; permutation importance shuffles one design column at a time on the
device and rescores. The JAX package draws each shuffle from a
jax.random key chain (PRNGKey(seed), one split a shuffle); the port draws
them from `Permutations`, one torch.Generator on the frame's device,
which a test replaces to replay the JAX draws.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, T_CAT
from h2o3_tpu_torch.core.kvstore import DKV


class Permutations:
    """The shuffles of a permutation importance: one torch.Generator
    seeded with `seed` on `device`, `next(n)` a permutation of range(n)
    (int64 on the device)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def next(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen, device=self.device)


# ---------------------------------------------------------------------------
def _score_col(model, X):
    """P(class 1) of a binomial model, the class probabilities of a
    multinomial one, the prediction of a regression."""
    out = model._score_matrix(X)
    if model._is_classifier and model.nclasses == 2:
        return out[:, 1]
    return out


def _grid_for(frame, column, nbins):
    v = frame.vec(column)
    if v.type == T_CAT:
        return np.arange(len(v.levels()), dtype=np.float32), True
    col = v.to_numpy().astype(np.float32)   # the grid is spaced in f32
    return np.linspace(np.nanmin(col), np.nanmax(col), nbins,
                       dtype=np.float32), False


def _set_feature(di, X, column, g, is_cat):
    """A copy of the design matrix X with one original column set to g:
    its slot (label mode, or a numeric column of the one-hot design,
    standardised as the design is) or its indicator group."""
    if column in di.feature_names:
        if not is_cat and getattr(di, "standardize", False) \
                and di.cat_mode == "onehot" and column in di.means:
            g = (float(g) - di.means[column]) / max(di.sigmas[column], 1e-10)
        Xg = X.clone()
        Xg[:, di.feature_names.index(column)] = float(np.float32(g))
        return Xg
    if is_cat and column in di.cat_cols:
        base = 0
        for c in di.cat_cols:
            k = di.cardinalities[c] - di._first(c)
            if c == column:
                Xg = X.clone()
                Xg[:, base:base + k] = 0.0
                slot = int(g) - di._first(c)
                if slot >= 0:           # the dropped first level: all 0
                    Xg[:, base + slot] = 1.0
                return Xg
            base += k
    raise KeyError(f"column {column} not in the model's design matrix")


def _one_col(p):
    if p.dim() > 1:
        p = p[:, 1] if p.shape[1] == 2 else p[:, 0]
    return p


def partial_dependence(model, frame: Frame, column: str, nbins: int = 20,
                       targets=None):
    """PDP: the weighted mean prediction as `column` sweeps its range (its
    levels), every other column as observed (hex PartialDependence).
    Returns {'column', 'grid', 'mean_response', 'stddev_response'}."""
    di = model._dinfo
    X = di.matrix(frame)
    w = di.weights(frame)
    v = frame.vec(column)
    grid, is_cat = _grid_for(frame, column, nbins)
    means, sds = [], []
    wsum = float(torch.sum(w))
    for g in grid:
        p = _one_col(_score_col(model, _set_feature(di, X, column, g,
                                                    is_cat)))
        mu = float(torch.sum(p * w)) / max(wsum, 1e-30)
        var = float(torch.sum(w * (p - mu) ** 2)) / max(wsum, 1e-30)
        means.append(mu)
        sds.append(var ** 0.5)
    grid_out = list(v.levels()) if is_cat else [float(g) for g in grid]
    return {"column": column, "grid": grid_out,
            "mean_response": means, "stddev_response": sds}


def ice(model, frame: Frame, column: str, nbins: int = 20,
        row_fraction: float = 1.0):
    """Individual Conditional Expectation: each row's response over the
    grid. Returns (grid, curves (rows, G))."""
    di = model._dinfo
    X = di.matrix(frame)
    n = frame.nrows
    grid, is_cat = _grid_for(frame, column, nbins)
    if row_fraction < 1.0:
        k = max(1, int(round(row_fraction * n)))
        rows = torch.from_numpy(np.linspace(0, n - 1, k).astype(np.int64))
        X = X.index_select(0, rows.to(X.device))
    curves = [_one_col(_score_col(model, _set_feature(di, X, column, g,
                                                      is_cat)))
              for g in grid]
    return [float(g) for g in grid], torch.stack(curves, 1).cpu().numpy()


def permutation_varimp(model, frame: Frame, metric: str = "AUTO",
                       n_repeats: int = 1, seed: int = 42):
    """PermutationVarImp.java: the drop in the scoring metric when one
    design column is shuffled (AUC for a binomial model under "AUTO" or
    "auc", else logloss; logloss for multinomial, RMSE for regression),
    the mean over `n_repeats` shuffles, drawn by `Permutations(seed)`.
    Returns varimp rows."""
    from h2o3_tpu_torch.models import metrics as M
    di = model._dinfo
    X = di.matrix(frame)
    y = di.response(frame)
    w = di.weights(frame)
    w = torch.where(torch.isnan(y), 0.0, w)
    binomial = model._is_classifier and model.nclasses == 2

    def score(Xv):
        out = model._score_matrix(Xv)
        if binomial:
            m = M.binomial_metrics(y, out[:, 1], w)
            return m.auc if metric in ("AUTO", "auc") else m.logloss
        if model._is_classifier:
            return M.multinomial_metrics(y, out, w).logloss
        return M.regression_metrics(y, out, w).rmse
    base = score(X)
    higher_is_better = binomial and metric in ("AUTO", "auc")
    draws = Permutations(seed, X.device)
    rows = []
    n = frame.nrows
    for j, name in enumerate(di.feature_names):
        deltas = []
        for _ in range(n_repeats):
            perm = draws.next(n).to(X.device)
            Xp = X.clone()
            Xp[:, j] = X[perm, j]
            sc = score(Xp)
            deltas.append(base - sc if higher_is_better else sc - base)
        rows.append({"variable": name,
                     "relative_importance": float(np.mean(deltas))})
    mx = max((r["relative_importance"] for r in rows), default=1.0) or 1.0
    tot = sum(max(r["relative_importance"], 0.0) for r in rows) or 1.0
    for r in rows:
        r["scaled_importance"] = r["relative_importance"] / mx
        r["percentage"] = max(r["relative_importance"], 0.0) / tot
    rows.sort(key=lambda r: -r["relative_importance"])
    return rows


def varimp_heatmap(models):
    """h2o-py varimp_heatmap data: (features, model ids, the (feature x
    model) matrix of scaled importances, NaN where a model has none)."""
    feats = []
    cols = {}
    for m in models:
        vi = m.varimp() or []
        mid = m.model_id or m.algo
        cols[mid] = {r["variable"]: r["scaled_importance"] for r in vi}
        for r in vi:
            if r["variable"] not in feats:
                feats.append(r["variable"])
    mat = np.full((len(feats), len(cols)), np.nan)
    for cj, mid in enumerate(cols):
        for fi, f in enumerate(feats):
            if f in cols[mid]:
                mat[fi, cj] = cols[mid][f]
    return feats, list(cols), mat


def model_correlation(models, frame: Frame):
    """h2o-py model_correlation_heatmap data: the correlation of the
    models' predictions (the last class's probability of a classifier)."""
    preds, names = [], []
    for m in models:
        p = m.predict(frame)
        arr = p.to_numpy()
        preds.append(arr[:, -1] if arr.shape[1] > 1 else arr[:, 0])
        names.append(m.model_id or m.algo)
        DKV.remove(p.key)
    return names, np.corrcoef(np.stack(preds, axis=1), rowvar=False)


def learning_curve(model):
    """h2o-py learning_curve_plot data from the scoring history."""
    hist = model.scoring_history() or []
    if not hist:
        return {}
    xs = [h.get("number_of_trees") or h.get("iteration") or i
          for i, h in enumerate(hist)]
    series = {k: [h.get(k) for h in hist] for k in hist[-1]
              if k.startswith(("training_", "validation_"))}
    return {"x": xs, "series": series}


def explain(model, frame: Frame, columns: int = 3):
    """h2o.explain(model, frame) as data: the variable importances, the
    PDPs of the top `columns` predictors and the learning curve."""
    out = {"model_id": model.model_id, "algo": model.algo}
    if model.varimp():
        out["variable_importances"] = model.varimp()
        top = [r["variable"] for r in model.varimp()[:columns]]
    else:
        top = list(model._dinfo.feature_names[:columns])
    out["partial_dependence"] = {
        c: partial_dependence(model, frame, c)
        for c in top if c in model._dinfo.predictors}
    out["learning_curve"] = learning_curve(model)
    return out
