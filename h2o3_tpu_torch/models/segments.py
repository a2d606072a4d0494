"""Segment models of the port (h2o3_tpu/models/segments.py,
hex/segments/SegmentModelsBuilder.java): one model a segment, a distinct
combination of the segment columns' values.

The segments are found on the host from the segment columns alone; each
segment's rows are taken on the frame's device (`model._subframe`), not
through a host copy of the whole frame as in the JAX package. Segments
come in the JAX package's order (sorted by value, categorical columns by
level id). A segment whose training raises is recorded as FAILED with its
error, as in the reference; the others go on.

One difference: the JAX package keys segments by Python tuples, in which
NaN never equals itself, so every row with an NA segment value becomes a
segment of its own with no rows, which fails. The port makes the rows
with NA in a segment column one segment, labelled NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models.model import _subframe


class SegmentModels:
    """The per-segment results: segment label, model key, status, rows."""

    def __init__(self, results: list):
        self._results = results

    def as_list(self):
        return self._results

    def __len__(self):
        return len(self._results)


def train_segments(estimator_cls, params: dict, segment_columns, x=None,
                   y=None, training_frame: Frame = None) -> SegmentModels:
    """ModelBuilder.trainSegments: split the frame by the segment columns
    and train one model a segment; a failure is recorded, not raised."""
    f = training_frame
    seg_cols = ([segment_columns] if isinstance(segment_columns, str)
                else list(segment_columns))
    vals = np.column_stack([f.vec(c).to_numpy() for c in seg_cols])
    doms = [f.vec(c).levels() for c in seg_cols]
    # one row per segment, sorted as the JAX package sorts its tuples
    # (NaN as -1 in the sort key)
    key = np.where(np.isnan(vals), -1.0, vals)
    nan = np.isnan(vals)
    rows = np.concatenate([key, nan], axis=1)
    uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    order = sorted(range(len(uniq)),
                   key=lambda i: tuple(uniq[i][:len(seg_cols)]))
    dev = f.vecs[0].device
    results = []
    for u in order:
        seg = [np.nan if uniq[u][len(seg_cols) + i] else uniq[u][i]
               for i in range(len(seg_cols))]
        label = {c: (doms[i][int(seg[i])] if doms[i] is not None
                     and seg[i] == seg[i] else seg[i])
                 for i, c in enumerate(seg_cols)}
        mask = inverse.reshape(-1) == u
        try:
            sub = _subframe(f, torch.from_numpy(np.flatnonzero(mask)).to(dev))
            m = estimator_cls(**params)
            m.train(x=x, y=y, training_frame=sub)
            results.append({"segment": label, "model": m.key,
                            "status": "SUCCEEDED", "nrows": int(mask.sum())})
            DKV.remove(sub.key)
        except Exception as ex:  # noqa: BLE001 - a segment's failure is kept
            results.append({"segment": label, "model": None,
                            "status": "FAILED", "error": repr(ex)})
    return SegmentModels(results)
