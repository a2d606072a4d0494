"""Extended isolation forest of the port (h2o3_tpu/models/extended_isofor.py;
hex/tree/isoforextended/ExtendedIsolationForest.java).

As the isolation forest, but each node splits on a random hyperplane: a
normal vector n of N(0, 1) entries, `extension_level` + 1 of them nonzero
(0: one dimension, the classic forest), through a point p drawn uniformly
in the node's bounding box; a row goes right iff (x − p)·n > 0. NAs count
as 0. Trees are dense heap-order arrays of (normal, point, split?,
value), a node's value its depth plus c(rows in it), and scoring is a
fixed-depth walk whose every step gathers a row's node and takes one dot
product. The anomaly score is 2^(−E[h]/c(ψ)).

A level takes the per-(leaf, column) ranges (`engine.leaf_ranges`) and
the per-leaf counts (`engine.segment_sum`) of the tree's row sample, as
`models/tree/isofor.py` does; the random normals, points and dimension
masks come in as tensors (`engine.Draws.eif_level`), as does the row
sample (`engine.Draws.rows`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.models.tree import engine as E
from h2o3_tpu_torch.models.tree.isofor import _avg_path
from h2o3_tpu_torch.models.tree.shared_tree import SharedTreeEstimator


def _eif_level(X, w, leaf, active, normA, pointA, didA, valA, normal, u,
               r, *, d, ext):
    """One level of one tree. normal, u: (2^d, C) normals and uniforms of
    each leaf's hyperplane and point; r: (2^d, C) uniforms keeping the
    ext + 1 dimensions with the smallest, or None to keep every one.
    Returns (leaf, active, normA, pointA, didA, valA)."""
    L = 2 ** d
    lv = torch.where(active & (w > 0), leaf, L)
    mn, mx = E.leaf_ranges(X, lv, L)
    cnt = E.segment_sum(lv, w[:, None], L + 1)[:L, 0]
    if r is not None:
        kth = torch.sort(r, dim=1).values[:, ext:ext + 1]
        normal = torch.where(r <= kth, normal, 0.0)
    span = torch.clamp(mx - mn, min=0.0)
    point = E.fma32(u, span, mn)
    did = (cnt > 1.5) & (span.sum(dim=1) > 0)
    base = L - 1
    normA[base:base + L] = normal
    pointA[base:base + L] = point
    didA[base:base + L] = did
    valA[base:base + L] = d + _avg_path(cnt)
    proj = ((X - point[leaf]) * normal[leaf]).sum(dim=1)
    go_right = torch.where(torch.isnan(proj), False, proj > 0)
    splits = did[leaf] & active
    leaf = torch.where(splits, 2 * leaf + go_right.long(), 0)
    return leaf, splits, normA, pointA, didA, valA


def _eif_final(w, leaf, active, valA, *, D):
    """Values of the nodes at depth D: D + c(rows in the node)."""
    L = 2 ** D
    lv = torch.where(active & (w > 0), leaf, L)
    cnt = E.segment_sum(lv, w[:, None], L + 1)[:L, 0]
    valA[L - 1:] = D + _avg_path(cnt)
    return valA


def _eif_walk(X, norms, points, dids, vals, D):
    """Mean path length (n,) f32 of the rows X (NaN as 0) over the
    hyperplane trees, summed tree by tree in order."""
    n = X.shape[0]
    out = torch.zeros(n, dtype=torch.float32, device=X.device)
    for t in range(norms.shape[0]):
        node = torch.zeros(n, dtype=torch.int64, device=X.device)
        for _ in range(D):
            proj = ((X - points[t][node]) * norms[t][node]).sum(dim=1)
            right = torch.where(torch.isnan(proj), False, proj > 0)
            child = 2 * node + 1 + right.long()
            node = torch.where(dids[t][node], child, node)
        out = out + vals[t][node]
    return out / norms.shape[0]


class H2OExtendedIsolationForestEstimator(SharedTreeEstimator):
    algo = "extendedisolationforest"
    supervised = False
    _serving_param_attrs = ("_norms", "_points", "_dids", "_vals")
    _partition_rules = ((r"^_(norms|points|dids|vals)$", ("model",)),)
    _defaults = dict(SharedTreeEstimator._tree_defaults)
    _defaults.update({"ntrees": 100, "sample_size": 256, "extension_level": 0})

    def _fit(self, frame: Frame):
        di = self._dinfo
        X = di.matrix(frame)
        w = di.weights(frame)
        n, C = X.shape
        dev = X.device
        ntrees = int(self.params["ntrees"])
        psi = min(int(self.params.get("sample_size") or 256), n)
        ext = min(int(self.params.get("extension_level") or 0), C - 1)
        D = max(1, int(math.ceil(math.log2(max(psi, 2)))))
        draws = self._draws(dev)
        rate = psi / max(n, 1)
        Xz = torch.nan_to_num(X, nan=0.0)
        nodes = 2 ** (D + 1) - 1
        masked = ext + 1 < C
        norms, points, dids, vals = [], [], [], []
        for _ in range(ntrees):
            wt = w * (draws.rows(n) < rate)
            leaf = torch.zeros(n, dtype=torch.int64, device=dev)
            active = torch.ones(n, dtype=torch.bool, device=dev)
            normA = torch.zeros((nodes, C), dtype=torch.float32, device=dev)
            pointA = torch.zeros((nodes, C), dtype=torch.float32, device=dev)
            didA = torch.zeros(nodes, dtype=torch.bool, device=dev)
            valA = torch.zeros(nodes, dtype=torch.float32, device=dev)
            for d in range(D):
                normal, u, r = draws.eif_level(d, 2 ** d, C, masked)
                leaf, active, normA, pointA, didA, valA = _eif_level(
                    Xz, wt, leaf, active, normA, pointA, didA, valA,
                    normal, u, r, d=d, ext=ext)
            valA = _eif_final(wt, leaf, active, valA, D=D)
            norms.append(normA)
            points.append(pointA)
            dids.append(didA)
            vals.append(valA)
            if self._budget_exhausted():
                break
        self._norms = torch.stack(norms)
        self._points = torch.stack(points)
        self._dids = torch.stack(dids)
        self._vals = torch.stack(vals)
        self._D = D
        self._cn = float(_avg_path(torch.tensor(float(psi))))
        self._output.model_summary = {
            "number_of_trees": len(norms), "sample_size": psi,
            "extension_level": ext,
        }

    def _score_matrix(self, X):
        dev = X.device
        return _eif_walk(torch.nan_to_num(X, nan=0.0), self._norms.to(dev),
                         self._points.to(dev), self._dids.to(dev),
                         self._vals.to(dev), self._D)

    def predict(self, test_data: Frame) -> Frame:
        """anomaly_score 2^(−E[h]/c(ψ)) and mean_length E[h]."""
        ml = np.asarray(self._score_host(test_data),
                        np.float64)[: test_data.nrows]
        score = 2.0 ** (-ml / self._cn)
        return Frame(["anomaly_score", "mean_length"],
                     [Vec.from_numpy(score), Vec.from_numpy(ml)])
