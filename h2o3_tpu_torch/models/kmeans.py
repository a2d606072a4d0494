"""KMeans of the port (h2o3_tpu/models/kmeans.py, hex/kmeans/KMeans.java):
Lloyd iterations over the rows on the device.

One Lloyd step (`_lloyd_step`) takes the distances X² + C² − 2·X·Cᵀ by
one f32 matrix product (TF32 stays off), each row's nearest centroid,
and the per-cluster sums, weights and within-cluster squares in one
`engine.segment_sum`: exact 64-bit fixed point, so that every order of
the card's adds gives the same bits and two trainings the same centroids
(the JAX package's f32 segment sum has no order to keep). The loop stays
on the host for the convergence test, one copy of the k sums a step.

The initial centroids (Random, PlusPlus, Furthest or user points) come
from the same numpy draws as the JAX package's, on a host sample of at
most 100,000 live rows; only the weights and the sampled rows cross to
the host, not the matrix.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.model import ModelBase
from h2o3_tpu_torch.models.tree.engine import segment_sum


def _distances(X, C):
    """(n, k) squared distances X² + C² − 2·X·Cᵀ."""
    x2 = (X * X).sum(dim=1, keepdim=True)
    c2 = (C * C).sum(dim=1)
    return x2 + c2[None, :] - 2.0 * (X @ C.T)


def _lloyd_step(X, C, w):
    """One Lloyd iteration: assignments, and (k, p + 2) f32 sums by
    cluster: w·x, w, and w times the squared distance."""
    k, p = C.shape
    best, assign = torch.min(torch.clamp(_distances(X, C), min=0.0), dim=1)
    S = segment_sum(assign, torch.cat([w[:, None] * X, w[:, None],
                                       (w * best)[:, None]], dim=1), k)
    return assign, S[:, :p], S[:, p], S[:, p + 1]


def _totss(X, w):
    n = w.sum()
    mean = (w[:, None] * X).sum(dim=0) / n
    d = X - mean[None, :]
    return (w[:, None] * d * d).sum()


def _assign_only(X, C):
    best, assign = torch.min(_distances(X, C), dim=1)
    return assign, torch.clamp(best, min=0.0)


class H2OKMeansEstimator(ModelBase):
    algo = "kmeans"
    supervised = False
    _serving_param_attrs = ("_centroids",)
    _defaults = {
        "k": 1, "max_iterations": 10, "init": "Furthest", "estimate_k": False,
        "user_points": None, "standardize": True, "max_runtime_secs": 0.0,
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + (
        ("estimate_k", False, "the JAX package accepts it and never reads "
                              "it (h2o3_tpu/models/kmeans.py:_fit)"),)

    def _fit(self, frame: Frame):
        di = self._dinfo
        X = di.matrix(frame)
        w = di.weights(frame)
        Xz = torch.where(torch.isnan(X), 0.0, X)
        del X
        k = int(self.params["k"])
        seed = int(self.params.get("seed") or -1)
        rng = np.random.default_rng(seed if seed > 0 else 12345)
        C = self._init_centroids(Xz, w, k, rng)
        max_it = int(self.params["max_iterations"])
        prev_twss = math.inf
        history = []
        for it in range(max_it):
            _, sums, counts, wss = _lloyd_step(Xz, C, w)
            # keep empty clusters in place
            C = torch.where((counts > 0)[:, None], sums / counts[:, None], C)
            twss = float(wss.cpu().numpy().sum())
            history.append({"iteration": it, "tot_withinss": twss})
            if self._job is not None:
                self._job.update(0.5 + 0.5 * (it + 1) / max_it, f"iter {it}")
            if abs(prev_twss - twss) < 1e-7 * max(1.0, abs(prev_twss)):
                break
            prev_twss = twss
        # final stats
        _, _, counts, wss = _lloyd_step(Xz, C, w)
        totss = float(_totss(Xz, w))
        wss = wss.cpu().numpy()
        twss = float(wss.sum())
        self._centroids = C
        self._output.scoring_history = history
        self._output.training_metrics = M.ClusteringMetrics(
            tot_withinss=twss, totss=totss, betweenss=totss - twss,
            size=counts.cpu().numpy().tolist(), withinss=wss.tolist(),
            nobs=int(float(w.sum())))
        self._output.model_summary = {
            "k": k, "iterations": len(history), "tot_withinss": twss,
            "totss": totss, "betweenss": totss - twss,
        }

    def _init_centroids(self, Xz, w, k, rng) -> torch.Tensor:
        """Furthest / PlusPlus / Random init (KMeans.java init modes) on a
        host sample of at most 100,000 live rows, drawn as the JAX package
        draws it; user points as given (in the model's space)."""
        mode = (self.params.get("init") or "Furthest").lower()
        dev = Xz.device
        up = self.params.get("user_points")
        if up is not None:
            pts = up.to_numpy() if isinstance(up, Frame) else np.asarray(up)
            return torch.as_tensor(np.asarray(pts, np.float32), device=dev)
        live = np.where(w.cpu().numpy() > 0)[0]
        if len(live) > 100_000:
            live = rng.choice(live, 100_000, replace=False)
        Xs = Xz.index_select(0, torch.from_numpy(live).to(dev)).cpu().numpy()
        if mode == "random":
            idx = rng.choice(len(Xs), size=min(k, len(Xs)), replace=False)
            return torch.as_tensor(Xs[idx], device=dev)
        # Furthest & PlusPlus share the D² machinery
        first = rng.integers(len(Xs))
        cents = [Xs[first]]
        d2 = ((Xs - cents[0]) ** 2).sum(axis=1)
        for _ in range(1, min(k, len(Xs))):
            if mode == "plusplus":
                p = d2 / d2.sum() if d2.sum() > 0 else None
                nxt = rng.choice(len(Xs), p=p)
            else:  # furthest
                nxt = int(np.argmax(d2))
            cents.append(Xs[nxt])
            d2 = np.minimum(d2, ((Xs - Xs[nxt]) ** 2).sum(axis=1))
        return torch.as_tensor(np.stack(cents), device=dev)

    # ---- scoring ---------------------------------------------------------
    def _score_matrix(self, X):
        Xz = torch.where(torch.isnan(X), 0.0, X)
        return _assign_only(Xz, self._centroids)[0]

    def predict(self, test_data: Frame) -> Frame:
        # through the scorer cache (eager for big frames)
        assign = np.asarray(self._score_host(test_data))[: test_data.nrows]
        return Frame(["predict"], [Vec.from_numpy(assign.astype(np.float64))])

    def centers(self) -> np.ndarray:
        """Centroids in the (possibly standardized) model space."""
        return self._centroids.cpu().numpy()

    def centroid_stats(self):
        return self._output.training_metrics

    def tot_withinss(self):
        return self._output.training_metrics.tot_withinss

    def totss(self):
        return self._output.training_metrics.totss

    def betweenss(self):
        return self._output.training_metrics.betweenss
