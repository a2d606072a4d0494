"""Isolation forest of the port (h2o3_tpu/models/tree/isofor.py;
hex/tree/isofor/IsolationForest.java).

Each tree grows on a row sample of about sample_size rows: at every level
each leaf picks a random column among those its rows do not all share and
a threshold drawn uniformly inside the leaf's [min, max] of that column.
No histograms: a level needs only the per-(leaf, column) ranges
(`engine.leaf_ranges`). A node's value is its depth plus c(rows in it),
the average path length of an unsuccessful search in a binary search tree
of that many points, so the ensemble's mean "prediction" is the mean path
length, scored by the same walk as GBM. The random column and threshold
draws come in as tensors (`engine.Draws.iso_level`), as does the row
sample (`engine.Draws.rows`).
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.models.tree import engine as E
from h2o3_tpu_torch.models.tree.shared_tree import SharedTreeEstimator

_EULER = 0.5772156649


def _avg_path(n):
    """c(n): the average unsuccessful-search path length in a binary search
    tree of n points (f32)."""
    h = torch.log(torch.clamp(n - 1, min=1.0)) + _EULER
    c = 2.0 * h - 2.0 * (n - 1) / torch.clamp(n, min=1.0)
    return torch.where(n <= 1, 0.0, torch.where(n < 2.5, 1.0, c))


def _iso_level(X, w, leaf, heap, active, colA, thrA, valA, r, u, *, d):
    """One level of one isolation tree. r: (2^d, C) uniforms, each leaf
    splitting on the column with the largest among those with a nonzero
    range; u: (2^d,) uniforms placing the thresholds. Returns (leaf, heap,
    active, colA, thrA, valA)."""
    L = 2 ** d
    lv = torch.where(active & (w > 0), leaf, L)
    mn, mx = E.leaf_ranges(X, lv, L)
    cnt = E.segment_sum(lv, w[:, None], L + 1)[:L, 0]
    valid = (mx - mn) > 0
    c_sel = torch.argmax(torch.where(valid, r, -1.0), dim=1)
    has = valid.any(dim=1)
    mn_s = mn.gather(1, c_sel[:, None])[:, 0]
    mx_s = mx.gather(1, c_sel[:, None])[:, 0]
    thr = E.fma32(u, mx_s - mn_s, mn_s)
    did = has & (cnt > 1.5)
    base = L - 1
    valA[base:base + L] = d + _avg_path(cnt)
    colA[base:base + L] = torch.where(did, c_sel, -1).to(torch.int32)
    thrA[base:base + L] = thr
    # route; NA goes left
    x = X.gather(1, c_sel[leaf][:, None])[:, 0]
    go_right = torch.where(torch.isnan(x), False, x > thr[leaf]).long()
    splits = did[leaf] & active
    leaf = torch.where(splits, 2 * leaf + go_right, 0)
    heap = torch.where(splits, 2 * heap + 1 + go_right, heap)
    return leaf, heap, splits, colA, thrA, valA


def _iso_final(w, leaf, active, valA, *, D):
    """Values of the nodes at depth D: D + c(rows in the node)."""
    L = 2 ** D
    lv = torch.where(active & (w > 0), leaf, L)
    cnt = E.segment_sum(lv, w[:, None], L + 1)[:L, 0]
    valA[L - 1:] = D + _avg_path(cnt)
    return valA


class H2OIsolationForestEstimator(SharedTreeEstimator):
    algo = "isolationforest"
    supervised = False
    _defaults = dict(SharedTreeEstimator._tree_defaults)
    _defaults.update({"ntrees": 50, "max_depth": 8, "sample_size": 256,
                      "sample_rate": -1.0, "contamination": -1.0})

    def _fit(self, frame: Frame):
        di = self._dinfo
        X = di.matrix(frame)
        w = di.weights(frame)
        n, C = X.shape
        dev = X.device
        D = int(self.params["max_depth"])
        ntrees = int(self.params["ntrees"])
        draws = self._draws(dev)
        sample_size = int(self.params.get("sample_size") or 256)
        sample_rate = float(self.params.get("sample_rate") or -1.0)
        psi = (max(2, int(sample_rate * n)) if sample_rate > 0
               else min(sample_size, n))
        nodes = 2 ** (D + 1) - 1
        # the psi-row sample is a Bernoulli draw at rate psi/n (E[rows] =
        # psi, as the reference's sampler)
        rate = psi / max(n, 1)
        trees = []
        for _ in range(ntrees):
            wt = w * (draws.rows(n) < rate)
            leaf = torch.zeros(n, dtype=torch.int64, device=dev)
            heap = torch.zeros(n, dtype=torch.int64, device=dev)
            active = torch.ones(n, dtype=torch.bool, device=dev)
            colA = torch.full((nodes,), -1, dtype=torch.int32, device=dev)
            thrA = torch.zeros(nodes, dtype=torch.float32, device=dev)
            valA = torch.zeros(nodes, dtype=torch.float32, device=dev)
            for d in range(D):
                r, u = draws.iso_level(d, 2 ** d, C)
                leaf, heap, active, colA, thrA, valA = _iso_level(
                    X, wt, leaf, heap, active, colA, thrA, valA, r, u, d=d)
            valA = _iso_final(wt, leaf, active, valA, D=D)
            trees.append((colA, thrA,
                          torch.zeros(nodes, dtype=torch.bool, device=dev),
                          valA))
            if self._budget_exhausted():
                break
        self._trees = E.stack_trees(trees, D)
        self._psi = psi
        # the observed range of the mean path length, for the score
        ml = self._mean_length(X).double().cpu().numpy()
        self._min_len, self._max_len = float(ml.min()), float(ml.max())
        self._output.model_summary = {
            "number_of_trees": self._trees.ntrees, "max_depth": D,
            "sample_size": psi,
        }

    # ---- scoring ------------------------------------------------------------
    def _mean_length(self, X):
        return E.predict_ensemble(X, self._trees.to(X.device)) \
            / self._trees.ntrees

    def _score_matrix(self, X):
        return self._mean_length(X)

    def predict(self, test_data: Frame) -> Frame:
        """predict: the anomaly score (max_len − mean length) over the
        training rows' observed range of mean lengths; mean_length."""
        ml = np.asarray(self._score_host(test_data),
                        np.float64)[: test_data.nrows]
        span = max(self._max_len - self._min_len, 1e-12)
        score = (self._max_len - ml) / span
        return Frame(["predict", "mean_length"],
                     [Vec.from_numpy(score), Vec.from_numpy(ml)])
