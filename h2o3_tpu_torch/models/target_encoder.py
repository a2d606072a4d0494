"""Target encoding of the port (h2o3_tpu/models/target_encoder.py;
h2o-extensions/target-encoder, ai.h2o.targetencoding).

Each categorical column's levels are replaced by the (blended) mean
response of the level, under one of three leakage controls:
  * "none": the level's mean over every training row;
  * "loo" (or "leave_one_out"): the row's own response left out;
  * "kfold": the level's mean over the other folds' rows.
Blending shrinks a small level's mean toward the prior (the mean
response): λ = 1 / (1 + exp(-(n - k) / f)) with inflection point k and
smoothing f; a level with no row left (n <= 0) and an NA level take the
prior.

The per-level sums and counts, and the per-(fold, level) ones, are
`index_add_`s in float64 on the frame's device; a transform encodes every
row at once (gather by level, the leave-one-out or out-of-fold
subtraction, then the blend), where the reference loops over the rows on
the host. `noise` adds uniforms in [-noise, noise) drawn through `Draws`,
which a test replaces.
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch.core.frame import Frame, Vec, T_CAT


class Draws:
    """The encoder's random draws: the noise uniforms of a transform, from
    one torch.Generator, landing on `device`. Unseeded (seed <= 0) the
    generator takes a fresh seed, as the reference's numpy generator
    does."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator()
        if seed > 0:
            self.gen.manual_seed(seed)
        else:
            self.gen.seed()

    def noise(self, n: int, amount: float) -> torch.Tensor:
        """(n,) float64 uniforms in [-amount, amount)."""
        u = torch.rand(n, generator=self.gen, dtype=torch.float64)
        return (u * (2 * amount) - amount).to(self.device)


class H2OTargetEncoderEstimator:
    algo = "targetencoder"

    def __init__(self, data_leakage_handling="none", blending=False,
                 inflection_point=10.0, smoothing=20.0, noise=0.0,
                 seed=-1, fold_column=None, columns_to_encode=None):
        self.params = dict(data_leakage_handling=data_leakage_handling.lower(),
                           blending=blending,
                           inflection_point=inflection_point,
                           smoothing=smoothing, noise=noise, seed=seed,
                           fold_column=fold_column,
                           columns_to_encode=columns_to_encode)
        self._encodings: dict = {}
        self._prior = 0.0
        self._y = None

    def _draws(self, device):
        return Draws(int(self.params["seed"]), device)

    def _folds(self, frame: Frame):
        """The fold column's ids (int64 on the frame's device) when the
        mode is kfold and the frame has the column, else None."""
        fold_col = self.params["fold_column"]
        if fold_col and fold_col in frame.names and \
                self.params["data_leakage_handling"] == "kfold":
            return frame.vec(fold_col).as_f32().long()
        return None

    def train(self, x=None, y=None, training_frame=None, **kw):
        f = training_frame
        self._y = y
        yv = f.vec(y)
        if yv.type == T_CAT and len(yv.levels()) != 2:
            raise ValueError("target encoding supports numeric or binary "
                             "response")
        yn = yv.as_f32().double()
        ok = ~torch.isnan(yn)
        self._prior = float(yn[ok].mean())
        cols = self.params["columns_to_encode"] or [
            c for c in (x or f.names)
            if c != y and f.vec(c).type == T_CAT]
        self._cols = [c if isinstance(c, str) else f.names[c] for c in cols]
        folds = self._folds(f)
        if folds is not None:
            self._nfolds = int(folds.max()) + 1
        for c in self._cols:
            v = f.vec(c)
            codes = v.as_f32()
            nd = len(v.levels())
            sel = ok & ~torch.isnan(codes)
            ci = codes[sel].long()
            ys = yn[sel]
            enc = {"domain": v.levels(),
                   "sums": _bincount(ci, ys, nd),
                   "counts": _bincount(ci, torch.ones_like(ys), nd)}
            if folds is not None:
                # one pass over the joint (fold, level) key: a row's kfold
                # encoding is the total less its own fold's part
                key = folds[sel] * nd + ci
                size = self._nfolds * nd
                enc["fold_sums"] = _bincount(key, ys, size) \
                    .view(self._nfolds, nd)
                enc["fold_counts"] = _bincount(key, torch.ones_like(ys),
                                               size).view(self._nfolds, nd)
            self._encodings[c] = enc
        return self

    def _encode_col(self, c, codes, yn=None, folds=None) -> torch.Tensor:
        """(n,) float64 encoding of the level ids `codes` (f32, NaN = NA);
        `yn` the rows' responses (float64) for loo, `folds` their fold ids
        for kfold."""
        enc = self._encodings[c]
        mode = self.params["data_leakage_handling"]
        dev = codes.device
        sums = enc["sums"].to(dev)
        cnts = enc["counts"].to(dev)
        na = torch.isnan(codes)
        lvl = torch.where(na, 0.0, codes).long()
        s, n = sums[lvl], cnts[lvl]
        if mode in ("leave_one_out", "loo"):
            if yn is not None:
                own = ~torch.isnan(yn)
                s = torch.where(own, s - yn, s)
                n = torch.where(own, n - 1, n)
        elif mode == "kfold" and folds is not None and "fold_sums" in enc:
            s = s - enc["fold_sums"].to(dev)[folds, lvl]
            n = n - enc["fold_counts"].to(dev)[folds, lvl]
        prior = self._prior
        mean = s / torch.where(n > 0, n, 1.0)
        if self.params["blending"]:
            k = self.params["inflection_point"]
            fsm = self.params["smoothing"]
            lam = 1.0 / (1.0 + torch.exp(-(n - k) / fsm))
            mean = lam * mean + (1 - lam) * prior
        out = torch.where(na | (n <= 0), prior, mean)
        noise = self.params["noise"]
        if noise and yn is not None:
            out = out + self._draws(dev).noise(out.shape[0], noise)
        return out

    def transform(self, frame: Frame, as_training=False) -> Frame:
        """The frame's columns and one `<column>_te` column per encoded
        column it holds; `as_training` applies the leakage control (and
        the noise) with the frame's response and folds."""
        yn = frame.vec(self._y).as_f32().double() if (
            as_training and self._y in frame.names) else None
        folds = self._folds(frame) if as_training else None
        out = Frame(list(frame.names), list(frame.vecs))
        for c in self._cols:
            if c not in frame.names:
                continue
            enc = self._encode_col(c, frame.vec(c).as_f32(), yn=yn,
                                   folds=folds)
            out[f"{c}_te"] = Vec.from_tensor(enc)
        return out


def _bincount(index, weights, size) -> torch.Tensor:
    """(size,) float64 sums of `weights` by `index`."""
    return torch.zeros(size, dtype=torch.float64, device=weights.device) \
        .index_add_(0, index, weights)
