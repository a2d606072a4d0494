"""Serving fast path of the port (h2o3_tpu/serving/): the row-bucketed
scorer cache (a CUDA graph per bucket on the card) and the shared param
placements under their tier ladder.

Entry points:
  * score_frame / score_frame_with_response — used by ModelBase.predict /
    _compute_metrics: bucketed scoring, or None → the eager path.
  * payload_to_raw — JSON rows to the staged raw buffer of a model.

The micro-batcher, `predict_via_rest` and `score_payload` come with the
QoS slice (ROADMAP.md §1).
"""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch.serving.scorer_cache import (     # noqa: F401
    CACHE, FALLBACKS, Ineligible, model_token, prewarm, prewarm_all,
    prewarm_enabled, row_bucket, score_frame, score_frame_with_response,
    score_rows, stage_frame, stage_frame_device, stage_response,
    _fastpath_reason)
from h2o3_tpu_torch.serving.params import PARAMS      # noqa: F401


def _cat_code(v, lut):
    if v is None or (isinstance(v, str) and v == ""):
        return np.nan
    if isinstance(v, str):
        return lut.get(v, np.nan)
    try:
        code = int(v)
    except (TypeError, ValueError):
        return np.nan
    return float(code) if 0 <= code < len(lut) else np.nan


def _num(v):
    if v is None or (isinstance(v, str) and v.strip() == ""):
        return np.nan
    try:
        return float(v)
    except (TypeError, ValueError):
        return np.nan


def payload_to_raw(model, rows, columns=None) -> np.ndarray:
    """JSON rows → (n, C_raw) staged f32 buffer in raw_columns() order.
    Rows are dicts {col: value} or lists aligned with `columns` (or with
    raw_columns() when columns is omitted). Categorical values may be
    level strings or in-domain integer codes; anything else is NA."""
    di = model._dinfo
    raw_cols = di.raw_columns()
    n = len(rows)
    raw = np.full((n, len(raw_cols)), np.nan, np.float32)
    if n == 0:
        return raw
    if isinstance(rows[0], dict):
        cells = {c: [r.get(c) for r in rows] for c in raw_cols}
    else:
        names = [str(c) for c in (columns or raw_cols)]
        pos = {c: names.index(c) for c in raw_cols if c in names}
        cells = {c: ([r[pos[c]] if pos[c] < len(r) else None for r in rows]
                     if c in pos else [None] * n)
                 for c in raw_cols}
    for j, c in enumerate(raw_cols):
        dom = di.domains.get(c)
        if dom is not None:
            lut = {str(lvl): float(i) for i, lvl in enumerate(dom)}
            raw[:, j] = [_cat_code(v, lut) for v in cells[c]]
        else:
            raw[:, j] = [_num(v) for v in cells[c]]
    return raw


def _payload_frame(model, raw: np.ndarray):
    """Rebuild a typed Frame from a staged raw buffer — the way for models
    the fast path cannot serve (custom predict schemas, scorers whose
    capture failed)."""
    from h2o3_tpu_torch.core.frame import Frame, Vec, T_CAT
    di = model._dinfo
    names, vecs = [], []
    for j, c in enumerate(di.raw_columns()):
        col = raw[:, j].astype(np.float64)
        dom = di.domains.get(c)
        if dom is not None:
            vecs.append(Vec.from_numpy(col, type=T_CAT, domain=list(dom)))
        else:
            vecs.append(Vec.from_numpy(col))
        names.append(c)
    return Frame(names, vecs)


def _frame_rows_to_dicts(pred) -> list:
    """Generic per-row dicts from a predictions Frame (whatever columns
    the model's predict emits: predict/p<level>, anomaly_score, Arch…)."""
    from h2o3_tpu_torch.core.frame import T_CAT
    cols = []
    for name, vec in zip(pred.names, pred.vecs):
        vals = vec.to_numpy()
        if vec.type == T_CAT:
            dom = vec.domain
            cols.append((name, [None if np.isnan(v) else str(dom[int(v)])
                                for v in vals]))
        else:
            cols.append((name, [None if np.isnan(v) else float(v)
                                for v in vals]))
    return [{name: vals[i] for name, vals in cols}
            for i in range(pred.nrows)]
