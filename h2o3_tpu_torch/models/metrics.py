"""Model metrics of the port (h2o3_tpu/models/metrics.py): regression,
binomial and multinomial, each one pass over (actual, predicted, weight)
tensors on their device into a small state, finished on the host exactly
as the JAX package finishes it. The AUC is the 4096-score-bin histogram
method (hex/AUC2.java with finer bins). `ClusteringMetrics` holds what
KMeans computes itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

NBINS_AUC = 4096


def _wmask(y, w):
    """Fold NaN responses (padding / missing) into zero weight."""
    valid = ~torch.isnan(y)
    return torch.where(valid, y, 0.0), torch.where(valid, w, 0.0)


# ===========================================================================
@dataclass
class RegressionMetrics:
    mse: float
    rmse: float
    mae: float
    rmsle: float
    mean_residual_deviance: float
    r2: float
    nobs: int

    def to_dict(self):
        return {"MSE": self.mse, "RMSE": self.rmse, "MAE": self.mae,
                "RMSLE": self.rmsle,
                "mean_residual_deviance": self.mean_residual_deviance,
                "r2": self.r2, "nobs": self.nobs}


def regression_metrics(y, p, w=None) -> RegressionMetrics:
    w = torch.ones_like(y) if w is None else w
    y, w = _wmask(y, w)
    p = torch.where(w > 0, p, 0.0)
    err = y - p
    sle = torch.log1p(p.clamp(min=0.0)) - torch.log1p(y.clamp(min=0.0))
    neg = ((w > 0) & ((y < 0) | (p < 0))).sum().float()
    n, sse, sae, ssle, neg, sy, syy = torch.stack([
        w.sum(), (w * err * err).sum(), (w * err.abs()).sum(),
        (w * sle * sle).sum(), neg, (w * y).sum(),
        (w * y * y).sum()]).cpu().tolist()
    mse = sse / n if n else math.nan
    var_y = syy / n - (sy / n) ** 2 if n else math.nan
    return RegressionMetrics(
        mse=mse, rmse=math.sqrt(mse) if mse == mse else math.nan,
        mae=sae / n if n else math.nan,
        rmsle=math.sqrt(ssle / n) if n and neg == 0 else math.nan,
        mean_residual_deviance=mse,
        r2=1.0 - mse / var_y if n and var_y > 0 else math.nan,
        nobs=int(n))


# ===========================================================================
@dataclass
class BinomialMetrics:
    auc: float
    pr_auc: float
    gini: float
    logloss: float
    mse: float
    rmse: float
    mean_per_class_error: float
    f1: float
    f2: float
    f0point5: float
    accuracy: float
    precision: float
    recall: float
    specificity: float
    mcc: float
    max_f1_threshold: float
    confusion_matrix: np.ndarray  # [[tn, fp], [fn, tp]] at the max-F1 threshold
    nobs: int = 0
    domain: Optional[list] = None

    def to_dict(self):
        d = {k: getattr(self, k) for k in
             ("auc", "pr_auc", "gini", "logloss", "mse", "rmse",
              "mean_per_class_error", "f1", "accuracy", "precision", "recall",
              "mcc", "max_f1_threshold", "nobs")}
        d["confusion_matrix"] = np.asarray(self.confusion_matrix).tolist()
        return d


def _binomial_pass(y, p, w):
    """Logloss, squared error and the per-score-bin pos/neg weights."""
    y, w = _wmask(y, w)
    p = torch.where(w > 0, p, 0.5).clamp(1e-15, 1 - 1e-15)
    ll = -(w * (y * torch.log(p) + (1 - y) * torch.log(1 - p))).sum()
    bins = (p * NBINS_AUC).to(torch.int64).clamp(0, NBINS_AUC - 1)
    pos = torch.zeros(NBINS_AUC, dtype=w.dtype, device=w.device) \
        .index_add_(0, bins, w * y)
    neg = torch.zeros(NBINS_AUC, dtype=w.dtype, device=w.device) \
        .index_add_(0, bins, w * (1.0 - y))
    sse = (w * (y - p) ** 2).sum()
    scal = torch.stack([w.sum(), ll, sse]).cpu().tolist()
    return (*scal, pos.cpu().numpy().astype(np.float64),
            neg.cpu().numpy().astype(np.float64))


def binomial_metrics(y, p, w=None, domain=None) -> BinomialMetrics:
    w = torch.ones_like(y) if w is None else w
    n, ll, sse, pos, neg = _binomial_pass(y, p, w)
    P, N = pos.sum(), neg.sum()
    # sweep thresholds high to low: cumulative TP/FP above each bin edge
    tp = np.cumsum(pos[::-1])[::-1]
    fp = np.cumsum(neg[::-1])[::-1]
    tp_all = np.concatenate([tp, [0.0]])
    fp_all = np.concatenate([fp, [0.0]])
    tpr = tp_all / P if P else np.zeros_like(tp_all)
    fpr = fp_all / N if N else np.zeros_like(fp_all)
    auc = float(np.trapezoid(tpr[::-1], fpr[::-1])) if P and N else math.nan
    with np.errstate(invalid="ignore", divide="ignore"):
        prec = np.where(tp_all + fp_all > 0, tp_all / (tp_all + fp_all), 1.0)
    pr_auc = float(np.trapezoid(prec[::-1], tpr[::-1])) if P else math.nan
    fn = P - tp_all
    tn = N - fp_all
    with np.errstate(invalid="ignore", divide="ignore"):
        f1 = np.nan_to_num(2 * tp_all / (2 * tp_all + fp_all + fn))
    bi = int(np.argmax(f1))
    thr = bi / NBINS_AUC
    TP, FP, FN, TN = tp_all[bi], fp_all[bi], fn[bi], tn[bi]
    precision = TP / (TP + FP) if TP + FP else 0.0
    recall = TP / (TP + FN) if TP + FN else 0.0
    spec = TN / (TN + FP) if TN + FP else 0.0
    acc = (TP + TN) / n if n else math.nan
    beta2, beta05 = 4.0, 0.25
    f2 = (1 + beta2) * precision * recall / (beta2 * precision + recall) \
        if precision + recall else 0.0
    f05 = (1 + beta05) * precision * recall / (beta05 * precision + recall) \
        if precision + recall else 0.0
    mcc_den = math.sqrt((TP + FP) * (TP + FN) * (TN + FP) * (TN + FN))
    mcc = (TP * TN - FP * FN) / mcc_den if mcc_den else 0.0
    mpce = 0.5 * ((FN / P if P else 0.0) + (FP / N if N else 0.0))
    return BinomialMetrics(
        auc=auc, pr_auc=pr_auc, gini=2 * auc - 1 if auc == auc else math.nan,
        logloss=ll / n if n else math.nan,
        mse=sse / n if n else math.nan,
        rmse=math.sqrt(sse / n) if n else math.nan,
        mean_per_class_error=mpce,
        f1=float(f1[bi]), f2=f2, f0point5=f05, accuracy=acc,
        precision=precision, recall=recall, specificity=spec, mcc=mcc,
        max_f1_threshold=thr,
        confusion_matrix=np.array([[TN, FP], [FN, TP]]), nobs=int(n),
        domain=domain)



# ===========================================================================
# Multinomial (hex/ModelMetricsMultinomial.java)
@dataclass
class MultinomialMetrics:
    logloss: float
    mse: float
    rmse: float
    mean_per_class_error: float
    error: float                # overall classification error
    confusion_matrix: np.ndarray
    hit_ratios: list
    nobs: int
    domain: Optional[list] = None

    def to_dict(self):
        return {"logloss": self.logloss, "MSE": self.mse, "RMSE": self.rmse,
                "mean_per_class_error": self.mean_per_class_error,
                "error": self.error,
                "confusion_matrix": self.confusion_matrix.tolist(),
                "hit_ratios": self.hit_ratios, "nobs": self.nobs}


def _multinomial_pass(y, probs, w):
    """Weight, logloss, the weighted confusion matrix (actual x argmax),
    the top-k hit weights for k up to min(10, K), and the squared error
    over the one-vs-all encoding."""
    y, w = _wmask(y, w)
    K = int(probs.shape[1])
    yi = y.long()
    py = probs.gather(1, yi[:, None])[:, 0]
    ll = -(w * torch.log(py.clamp(1e-15, 1.0))).sum()
    pred = probs.argmax(dim=1)
    cm = torch.zeros(K * K, dtype=w.dtype, device=w.device) \
        .index_add_(0, yi * K + pred, w).reshape(K, K)
    topk = probs.topk(min(10, K), dim=1).indices
    hit_k = (w[:, None] * (topk == yi[:, None]).to(w.dtype).cumsum(1)).sum(0)
    onehot = torch.nn.functional.one_hot(yi, K).to(probs.dtype)
    sse = (w[:, None] * (onehot - probs) ** 2).sum()
    n, ll, sse = torch.stack([w.sum(), ll, sse]).cpu().tolist()
    return n, ll, sse, cm.cpu().double().numpy(), \
        hit_k.cpu().double().numpy()


def multinomial_metrics(y, probs, w=None, domain=None) -> MultinomialMetrics:
    w = torch.ones_like(y) if w is None else w
    n, ll, sse, cm, hit_k = _multinomial_pass(y, probs, w)
    row_tot = cm.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        per_class_err = np.where(row_tot > 0, 1.0 - np.diag(cm) / row_tot, 0.0)
    seen = row_tot > 0
    mpce = float(per_class_err[seen].mean()) if seen.any() else math.nan
    err = 1.0 - np.diag(cm).sum() / n if n else math.nan
    return MultinomialMetrics(
        logloss=ll / n if n else math.nan,
        mse=sse / n if n else math.nan,
        rmse=math.sqrt(sse / n) if n else math.nan,
        mean_per_class_error=mpce, error=float(err),
        confusion_matrix=cm,
        hit_ratios=[float(h) / n for h in hit_k] if n else [],
        nobs=int(n), domain=domain)


# ===========================================================================
# Clustering (hex/ModelMetricsClustering.java)
@dataclass
class ClusteringMetrics:
    tot_withinss: float
    totss: float
    betweenss: float
    size: list
    withinss: list
    nobs: int

    def to_dict(self):
        return {"tot_withinss": self.tot_withinss, "totss": self.totss,
                "betweenss": self.betweenss, "size": self.size,
                "withinss": self.withinss, "nobs": self.nobs}
