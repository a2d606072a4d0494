"""Infogram of the port (h2o3_tpu/models/infogram.py; h2o-admissibleml,
ai.h2o.admissibleml).

For every predictor: a relevance index, its variable importance in one
GBM on all predictors over the largest one, and an information index,
the predictive performance of a GBM on the predictor alone (with the
protected columns: on them and the predictor, less theirs alone),
normalised by the largest. Performance is the Gini 2·AUC − 1 of a
classifier, else the training R². A predictor above both thresholds
(0.1 by default) is admissible. With `protected_columns` the information
index is the safety index: what the predictor tells of the response
beyond the protected columns.

Every model is a binned GBM of the port, so an infogram runs the binned
engine's kernels once per predictor and once more for the relevance.
"""

from __future__ import annotations

import time

import numpy as np

from h2o3_tpu_torch.core.frame import Frame, T_CAT
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models.tree.shared_tree import H2OGradientBoostingEstimator


class H2OInfogram:
    algo = "infogram"

    def __init__(self, protected_columns=None, net_information_threshold=0.1,
                 relevance_index_threshold=0.1, safety_index_threshold=0.1,
                 total_information_threshold=0.1, ntrees=20, max_depth=5,
                 nbins=20, seed=-1, algorithm="gbm"):
        if str(algorithm).lower() != "gbm":
            raise NotImplementedError(
                f"infogram: algorithm={algorithm!r} is not supported: the "
                "JAX package fits GBMs whatever it is given "
                "(h2o3_tpu/models/infogram.py:166)")
        self.protected_columns = list(protected_columns or [])
        self.rel_thresh = relevance_index_threshold
        self.info_thresh = (safety_index_threshold if protected_columns
                            else net_information_threshold
                            if net_information_threshold != 0.1
                            else total_information_threshold)
        self.ntrees = ntrees
        self.max_depth = max_depth
        self.nbins = nbins
        self.seed = seed
        self.algorithm = algorithm
        self._result = None
        self.key = None
        self.gbm_seconds = []      # each GBM's train() seconds, in order

    def _gbm(self, x, y, frame):
        """One of the infogram's GBMs, trained."""
        m = H2OGradientBoostingEstimator(
            ntrees=self.ntrees, max_depth=self.max_depth, nbins=self.nbins,
            seed=self.seed if self.seed > 0 else 7)
        t0 = time.perf_counter()
        m.train(x=x, y=y, training_frame=frame)
        self.gbm_seconds.append(time.perf_counter() - t0)
        return m

    def _perf(self, frame, x, y, is_cls):
        """Normalised predictive performance of x for y."""
        m = self._gbm(x, y, frame)
        tm = m._output.training_metrics
        DKV.remove(m.key)
        if is_cls and getattr(tm, "auc", None) is not None:
            return max(0.0, 2.0 * tm.auc - 1.0)          # Gini in [0, 1]
        # regression: the explained variance (R²)
        yv = frame.vec(y).as_f32().double()
        var = float(yv[~yv.isnan()].var(correction=0))
        r2 = 1.0 - tm.mse / max(var, 1e-30)
        return max(0.0, min(1.0, r2))

    def train(self, x=None, y=None, training_frame=None):
        f = training_frame
        if not isinstance(f, Frame) or y is None:
            raise ValueError("infogram needs a training Frame and y")
        prot = self.protected_columns
        if x is None:
            x = [c for c in f.names if c != y and c not in prot]
        is_cls = f.vec(y).type == T_CAT
        # relevance: the variable importances of the full model
        full = self._gbm(x, y, f)
        vi = {r["variable"]: r["relative_importance"]
              for r in (full.varimp() or [])}
        DKV.remove(full.key)
        mx = max(vi.values()) if vi else 1.0
        relevance = {c: vi.get(c, 0.0) / max(mx, 1e-30) for c in x}
        # the information index
        info = {}
        base = self._perf(f, prot, y, is_cls) if prot else 0.0
        for c in x:
            info[c] = max(0.0, self._perf(f, prot + [c], y, is_cls) - base)
        mx = max(info.values()) if info else 1.0
        info = {c: v / max(mx, 1e-30) for c, v in info.items()}
        ikey = "safety_index" if prot else "total_information_index"
        rows = []
        for c in x:
            rows.append({
                "column": c,
                "relevance_index": float(relevance[c]),
                ikey: float(info[c]),
                "admissible": bool(relevance[c] >= self.rel_thresh
                                   and info[c] >= self.info_thresh),
            })
        rows.sort(key=lambda r: -(r["relevance_index"] + r[ikey]))
        self._result = rows
        self.key = DKV.make_key("infogram")
        DKV.put(self.key, self)
        return self

    def get_admissible_features(self):
        return [r["column"] for r in self._result if r["admissible"]]

    def get_admissible_score_frame(self) -> Frame:
        cols = list(self._result[0].keys()) if self._result else []
        data = {k: np.array([r[k] for r in self._result],
                            object if k == "column" else np.float64)
                for k in cols}
        data["admissible"] = data["admissible"].astype(np.float64)
        return Frame.from_dict(data)

    @property
    def result(self):
        return self._result
