"""Aggregator of the port (h2o3_tpu/models/aggregator.py;
hex/aggregator/Aggregator.java): exemplar-based compression of a frame.

A sweep at radius r walks the rows in order: a row becomes an exemplar
iff its squared distance to every earlier exemplar is > r²; any other row
is counted to its nearest earlier exemplar, ties to the earliest. The
radius starts from the frame's diameter and is retuned toward
`target_num_exemplars` for at most 8 sweeps. The design matrix is the
standardised one-hot design, each column then divided by its population
sd.

The reference admits in a host loop, row by row. Here a sweep takes the
rows in batches of `BATCH` on the frame's device:
  1. the distances from the batch to the exemplars before it (the
     snapshot) and each row's nearest (`_nearest`);
  2. a row within r of the snapshot is settled; the rest are the
     candidates, resolved among themselves from their candidate x
     candidate matrix of "within r" (`_leaders`): the greedy leader set
     in row order, in rounds over the whole matrix;
  3. a masked argmin over the batch's new exemplars that come before each
     row, beside the snapshot's nearest (which wins ties, being earlier),
     gives each row its exemplar, and the counts are one scatter-add.
None of that depends on the batch size: any batch gives the leader set
and counts of the row-by-row walk. Every distance is the direct form
Σₖ(aₖ − bₖ)², summed column by column in f32 with separate subtract,
square and add (`_sqdist`): no matrix-product form rounds near r², and
the card and the CPU give the same bits. `_sweep_plain` is the
reference's row-by-row walk on these distances.
"""

from __future__ import annotations

import math
import time

import torch

from h2o3_tpu_torch.core.frame import Frame, Vec, T_STR
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models.model import ModelBase

BATCH = 4096
# Batch rows x exemplars of one block of distances
_BLOCK = 1 << 24


def _sqdist(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(a, b) f32 squared distances Σₖ(A[i, k] − B[j, k])², added column by
    column in order (the same bits on every device)."""
    d = torch.zeros((A.shape[0], B.shape[0]), dtype=torch.float32,
                    device=A.device)
    for k in range(A.shape[1]):
        diff = A[:, k, None] - B[None, :, k]
        d.add_(diff.square_())
    return d


def _nearest(A: torch.Tensor, E: torch.Tensor):
    """Each row of A's smallest squared distance to the rows of E and the
    first E row that has it, over blocks of E. Returns (dmin, argmin)."""
    a = A.shape[0]
    best = torch.full((a,), math.inf, dtype=torch.float32, device=A.device)
    arg = torch.zeros(a, dtype=torch.int64, device=A.device)
    step = max(1, _BLOCK // max(a, 1))
    for e0 in range(0, E.shape[0], step):
        dv, di = torch.min(_sqdist(A, E[e0:e0 + step]), dim=1)
        better = dv < best            # strict: an earlier block wins ties
        best = torch.where(better, dv, best)
        arg = torch.where(better, di + e0, arg)
    return best, arg


def _leaders(close: torch.Tensor) -> torch.Tensor:
    """The greedy leader set in order of a (c, c) bool "within r" matrix:
    candidate k leads iff no earlier leader is within r of it. Computed in
    rounds: a candidate next to a leader drops out, and one with no
    undecided or leading earlier neighbour leads."""
    c = close.shape[0]
    dev = close.device
    earlier = close & torch.ones((c, c), dtype=torch.bool,
                                 device=dev).tril(-1)
    lead = torch.zeros(c, dtype=torch.bool, device=dev)
    out = torch.zeros(c, dtype=torch.bool, device=dev)
    und = torch.ones(c, dtype=torch.bool, device=dev)
    while True:
        out |= und & (earlier & lead[None, :]).any(dim=1)
        und &= ~out
        lead |= und & ~(earlier & und[None, :]).any(dim=1)
        und &= ~lead
        if not bool(und.any()):
            return lead


def _sweep(X: torch.Tensor, radius: float, batch: int = BATCH):
    """The exemplar rows (int64) and their counts at `radius`, batched."""
    n = X.shape[0]
    dev = X.device
    r2 = radius * radius
    ex = torch.zeros(1, dtype=torch.int64, device=dev)
    owner = torch.zeros(n, dtype=torch.int64, device=dev)  # index into ex
    i = 1
    while i < n:
        j = min(i + batch, n)
        Xb = X[i:j]
        n_snap = ex.shape[0]
        dmin, amin = _nearest(Xb, X[ex])
        cand = torch.nonzero(dmin > r2).flatten()
        new = cand[:0]
        if cand.numel():
            Xc = Xb[cand]
            new = cand[_leaders(_sqdist(Xc, Xc) <= r2)]
        own = amin
        if new.numel():
            # in-batch exemplars before each row, strictly nearer than the
            # snapshot's nearest
            dn = _sqdist(Xb, Xb[new])
            pos = torch.arange(j - i, device=dev)
            dn = torch.where(new[None, :] < pos[:, None], dn, math.inf)
            nv, ni = torch.min(dn, dim=1)
            own = torch.where(nv < dmin, n_snap + ni, amin)
            own[new] = n_snap + torch.arange(new.numel(), device=dev)
            ex = torch.cat([ex, new + i])
        owner[i:j] = own
        i = j
    counts = torch.bincount(owner, minlength=ex.shape[0])
    return ex, counts


def _sweep_plain(X: torch.Tensor, radius: float):
    """The reference's row-by-row walk (the plain version of `_sweep`):
    one row at a time against every exemplar so far, on the same
    distances as `_sqdist` (each row's differences and squares at once,
    then the columns added in order)."""
    n, p = X.shape
    r2 = radius * radius
    Et = torch.empty((p, n), dtype=X.dtype, device=X.device)
    Et[:, 0] = X[0]
    ex, counts = [0], [1]
    for i in range(1, n):
        m = len(ex)
        diff = (X[i, :, None] - Et[:, :m]).square_()
        d = diff[0].clone()
        for k in range(1, p):
            d.add_(diff[k])
        j = int(torch.argmin(d))
        if float(d[j]) <= r2:
            counts[j] += 1
        else:
            Et[:, m] = X[i]
            ex.append(i)
            counts.append(1)
    return torch.tensor(ex), torch.tensor(counts)


class H2OAggregatorEstimator(ModelBase):
    algo = "aggregator"
    supervised = False
    _defaults = {
        "target_num_exemplars": 5000, "rel_tol_num_exemplars": 0.5,
        "transform": "NORMALIZE",
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + (
        ("transform", "NORMALIZE",
         "the JAX package always divides the standardised design by its "
         "sd (h2o3_tpu/models/aggregator.py:28, :61-63)"),)

    def _normalized(self, frame: Frame) -> torch.Tensor:
        """The standardised one-hot design, each column over its
        population sd (f32)."""
        X = torch.nan_to_num(self._dinfo.matrix(frame))
        sd = X.double().std(dim=0, correction=0).float()
        return X / torch.where(sd > 0, sd, 1.0)

    def _fit(self, frame: Frame):
        X = self._normalized(frame)
        n, p = X.shape
        target = int(self.params["target_num_exemplars"])
        span = X.max(dim=0).values - X.min(dim=0).values
        diam = float(torch.linalg.vector_norm(span.double()))
        radius = diam / max(target ** (1.0 / max(p, 1)), 2.0) * 0.5
        lo_tol = self.params["rel_tol_num_exemplars"]
        self._sweep_seconds = []
        for _ in range(8):  # tune the radius toward the exemplar budget
            t0 = time.perf_counter()
            ex_idx, counts = _sweep(X, radius)
            k = ex_idx.shape[0]
            self._sweep_seconds.append(time.perf_counter() - t0)
            if abs(k - target) <= lo_tol * target or k == n:
                break
            radius *= (k / max(target, 1)) ** (1.0 / max(p, 1))
        self._exemplar_rows = ex_idx
        self._counts = counts
        out = {f: Vec.from_tensor(frame.vec(f).as_f32()[ex_idx])
               for f in frame.names if frame.vec(f).type != T_STR}
        out["counts"] = Vec.from_tensor(counts.float())
        of = Frame(list(out), list(out.values()))
        self._output_frame_key = of.key
        self._output.model_summary = {"num_exemplars": k, "radius": radius}

    def aggregated_frame(self) -> Frame:
        return DKV.get(self._output_frame_key)

    def predict(self, test_data):
        raise NotImplementedError("Aggregator produces a frame, not "
                                  "predictions")
