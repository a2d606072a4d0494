"""Quantiles of the port (h2o3_tpu/models/quantile.py,
hex/quantile/Quantile.java).

`_order_stats` finds the k-th smallest value by cumulative weight for a
batch of ranks k. Like the JAX package it refines by 256-bin histograms,
and the answer is an observed value, an exact order statistic; unlike it,
each rank keeps its candidates by bin rather than by a range whose edges
are recomputed in f32. The JAX package narrows each rank's range to
[lo + span·i/256, lo + span·(i+1)/256] in f32 for a fixed 4 rounds;
those edges can leave out a value of the chosen bin or take in one of
its neighbour's, and at 11M rows its ranks come out wrong (run (ad) of
`chip_smoke.py`), while the fixed rounds can end with several distinct
values in a bin. Here the first round is one 256-bin histogram of every
row over the global range, shared by all ranks; each rank then keeps the
rows of its bin (one gather a distinct bin), and refines over their own
minimum and maximum until they are one value. The bin of a value is
floor((x − lo) / span · 256) in f32 as in the JAX package, monotone in
x, so each round's bins partition the candidates in sorted order. The
weights are summed in float64 (the JAX package sums them in f32, exact
only below 2^24 rows of unit weight). `quantile` interpolates between
the two ranks that bracket p·(W−1) (Type 7: numpy's default with unit
weights) or combines them as `combine_method` says; `frame_quantiles`
does every numeric column.

The JAX package's `global_quantile_edges` has no caller there and is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch

_B = 256           # bins a refinement round
_MAX_ROUNDS = 64   # a bound; f32 candidates are one value within ~6


def _bin_of(x, lo, hi):
    span = torch.clamp(hi - lo, min=1e-37)
    return torch.floor((x - lo) / span * _B).clamp_(0, _B - 1).long()


def _pick(counts, below, k):
    """The first bin whose cumulative weight passes k, and the weight
    below it."""
    cum = below + np.cumsum(counts)
    hit = np.flatnonzero((cum > k) & (counts > 0))
    i = int(hit[0]) if hit.size else int(np.flatnonzero(counts > 0)[-1])
    return i, (below if i == 0 else float(cum[i - 1]))


def _order_stats(x: torch.Tensor, w: torch.Tensor, ks) -> torch.Tensor:
    """(P,) f32 k-th smallest values by cumulative weight, one for each k
    of `ks` (0-based ranks, float); x (n,) f32 with NaN for NA, w (n,) f32
    weights (0 leaves a row out)."""
    valid = (w > 0) & ~torch.isnan(x)
    xv = x[valid]
    wv = w[valid].to(torch.float64)
    lo, hi = xv.min(), xv.max()
    b = _bin_of(xv, lo, hi)
    counts = torch.bincount(b, weights=wv, minlength=_B).cpu().numpy()
    out = []
    members = {}
    for k in np.asarray(ks, np.float64):
        i, below = _pick(counts, 0.0, k)
        if i not in members:
            sel = b == i
            members[i] = (xv[sel], wv[sel])
        cx, cw = members[i]
        for _ in range(_MAX_ROUNDS):
            clo, chi = cx.min(), cx.max()
            if bool(clo == chi):
                break
            cb = _bin_of(cx, clo, chi)
            cc = torch.bincount(cb, weights=cw, minlength=_B).cpu().numpy()
            j, below = _pick(cc, below, k)
            sel = cb == j
            cx, cw = cx[sel], cw[sel]
        out.append(cx.min())
    return torch.stack(out)


def quantile(values, probs, weights=None, combine_method="interpolate"):
    """Weighted quantiles of a device vector: Type 7 on cumulative-weight
    ranks h = p·(W−1) ("interpolate"), or the lower, the upper or the
    average of the two bracketing order statistics ("low", "high",
    "average"), as float64 numpy."""
    x = torch.as_tensor(values).to(torch.float32)
    w = torch.ones_like(x) if weights is None \
        else torch.as_tensor(weights).to(device=x.device, dtype=torch.float32)
    w = torch.where(torch.isnan(x), 0.0, w)
    W = float(w.to(torch.float64).sum())
    if W <= 0:
        return np.full(len(probs), np.nan)
    probs = np.asarray(probs, np.float64)
    if np.any((probs < 0) | (probs > 1)):
        raise ValueError(f"probabilities must be in [0, 1], got {probs}")
    h = probs * (W - 1.0)
    klo, khi = np.floor(h), np.ceil(h)
    vals = _order_stats(x, w, np.concatenate([klo, khi])).cpu().numpy() \
        .astype(np.float64)
    vlo, vhi = vals[:len(probs)], vals[len(probs):]
    if combine_method in ("interpolate", "interpolated", None, "AUTO"):
        return vlo + (h - klo) * (vhi - vlo)
    if combine_method == "low":
        return vlo
    if combine_method == "high":
        return vhi
    if combine_method == "average":
        return 0.5 * (vlo + vhi)
    raise ValueError(f"combine_method {combine_method!r}")


DEFAULT_PROBS = (0.01, 0.1, 0.25, 1 / 3, 0.5, 2 / 3, 0.75, 0.9, 0.99)


def frame_quantiles(frame, probs=None, weights_column=None,
                    combine_method="interpolate"):
    """h2o.quantile: the quantiles of every numeric column (the weights
    column aside), as (probs, {column: values})."""
    from h2o3_tpu_torch.core.frame import T_NUM, T_TIME
    probs = list(probs) if probs is not None else list(DEFAULT_PROBS)
    w = frame.matrix([weights_column])[:, 0] if weights_column else None
    out = {}
    for name in frame.names:
        if frame.vec(name).type not in (T_NUM, T_TIME) \
                or name == weights_column:
            continue
        out[name] = quantile(frame.vec(name).as_f32(), probs, weights=w,
                             combine_method=combine_method)
    return probs, out
