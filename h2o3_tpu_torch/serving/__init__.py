"""Serving fast path of the port (h2o3_tpu/serving/): the row-bucketed
scorer cache (a CUDA graph per bucket on the card), the shared param
placements under their tier ladder, and micro-batched REST scoring under
multi-tenant QoS.

Entry points:
  * score_frame / score_frame_with_response — used by ModelBase.predict /
    _compute_metrics: bucketed scoring, or None → the eager path.
  * predict_via_rest — frame-based REST predictions routed through the
    micro-batch queue (concurrent requests coalesce into one dispatch).
  * score_payload — the lightweight row-payload scoring route: JSON rows
    in, per-row prediction dicts out, no DKV frame round-trip.
  * payload_to_raw — JSON rows to the staged raw buffer of a model.

Both REST entry points pay QoS admission (serving/qos.py: deadline shed
→ DeadlineExceeded, token bucket → RateLimited, queue share and depth →
QueueFull) before any decode; a scorer error degrades to `model.predict`
(counted as `h2o3_scorer_fallbacks_total{reason="trace-error"}`).
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.serving.scorer_cache import (     # noqa: F401
    CACHE, FALLBACKS, Ineligible, model_token, prewarm, prewarm_all,
    prewarm_enabled, row_bucket, score_frame, score_frame_with_response,
    score_rows, stage_frame, stage_frame_device, stage_response,
    _fastpath_reason)
from h2o3_tpu_torch.serving.params import PARAMS      # noqa: F401
from h2o3_tpu_torch.serving.microbatch import (   # noqa: F401
    BATCHER, MicroBatcher, QueueFull)
from h2o3_tpu_torch.serving import qos as _qos
from h2o3_tpu_torch.serving.qos import (          # noqa: F401
    DeadlineExceeded, QuotaExceeded, RateLimited)
from h2o3_tpu_torch.obs import usage as _usage


def _microbatch_eligible(model, nrows: int) -> bool:
    """Shared predicate for the two micro-batch entry points: models with
    a custom predict (KMeans, isolation forests, GLRM archetypes, …) own
    their output schema and must answer through model.predict; huge
    inputs and strike-parked models fall back too. Keep the frame route
    and the row-payload route agreeing on this."""
    from h2o3_tpu_torch.serving import scorer_cache as _sc
    from h2o3_tpu_torch.models.model import ModelBase
    return (type(model).predict is ModelBase.predict
            and _fastpath_reason(model, nrows) is None
            and not _sc._is_broken((model.key, model_token(model))))


def predict_via_rest(model, frame):
    """Micro-batched frame prediction for the REST layer. Ineligible
    inputs (huge frames, custom-predict models) fall back to
    model.predict, which itself prefers the scorer cache."""
    from h2o3_tpu_torch.serving import scorer_cache as _sc
    if not _microbatch_eligible(model, frame.nrows):
        # the HEAVY requests are exactly the ones a flooding tenant leans
        # on: QoS admission (deadline shed + token charge) applies here
        # too — only the queue-share cap is micro-batch-specific
        _qos.admit()
        return model.predict(frame)
    # shed BEFORE staging: a 503-bound request must not pay the
    # per-column decode only to be rejected at enqueue
    BATCHER.check_capacity()
    try:
        # frame adaptation + staging is the request's decode stage
        with _usage.stage("decode"):
            di = model._dinfo
            af = di.adapt(frame)
            # a frame in HBM is staged on the card (the frame's cached
            # matrix) and comes to the host in ONE copy; the JAX package
            # decodes every column to the host, one transfer a column
            dev = stage_frame_device(di, af)
            raw = dev.cpu().numpy() if dev is not None \
                else stage_frame(di, af, frame.nrows)
        out = BATCHER.score(model, raw, frame.nrows)
    except QueueFull:
        # backpressure is NOT degradation: falling back to model.predict
        # would put the shed load right back on the stalled device
        raise
    except (RateLimited, QuotaExceeded, DeadlineExceeded):
        # QoS rejections likewise: a deadline-shed request scored on the
        # eager path would pay the device for an answer nobody awaits
        raise
    except Exception:   # noqa: BLE001 — serving must degrade, not 500
        _sc._note_failure((model.key, model_token(model)))
        FALLBACKS.inc(reason="trace-error")
        return model.predict(frame)
    return model._prediction_frame(out, frame.nrows)


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
            vals = cells[c]
            # JSON numbers (the common case) convert in one numpy call,
            # to the same f32 values `_num` gives one cell at a time
            if all(type(v) is float or type(v) is int for v in vals):
                raw[:, j] = np.asarray(vals, np.float64)
            else:
                raw[:, j] = [_num(v) for v in vals]
    return raw


def _payload_frame(model, raw: np.ndarray):
    """Rebuild a typed Frame from a staged raw buffer — the way for models
    the fast path cannot serve (custom predict schemas, scorers whose
    capture failed). The buffer goes to the cloud's device in one copy
    and each column keeps the f32 codec (the JAX package packs each
    column on the host and copies it alone); which columns hold a NaN
    comes from the host's test, so no column is tested on the device."""
    from h2o3_tpu_torch.core.frame import Frame, Vec, T_CAT, T_NUM
    from h2o3_tpu_torch.parallel import mesh as _mesh
    di = model._dinfo
    raw = np.ascontiguousarray(raw, np.float32)
    na = np.isnan(raw).any(axis=0)
    t = torch.from_numpy(raw).to(_mesh.cloud().device)
    names, vecs = [], []
    for j, c in enumerate(di.raw_columns()):
        dom = di.domains.get(c)
        vecs.append(Vec.from_tensor(
            t[:, j], T_CAT if dom is not None else T_NUM,
            list(dom) if dom is not None else None, has_na=bool(na[j])))
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


def score_payload(model, rows, columns=None) -> list:
    """Score raw JSON rows; returns one prediction dict per row. Models
    served by the base predict ride the micro-batch queue; custom-predict
    models and parked scorers go through a reconstructed Frame +
    model.predict so the route's answer always matches frame-based
    scoring."""
    from h2o3_tpu_torch.serving import scorer_cache as _sc
    from h2o3_tpu_torch.core.kvstore import DKV
    use_fast = _microbatch_eligible(model, len(rows))
    if use_fast:
        # shed before decoding the payload into a staging buffer
        BATCHER.check_capacity()
    else:
        # ineligible payloads still pay QoS admission (rate limit +
        # deadline shed) before any decode work — see predict_via_rest
        _qos.admit()
    with _usage.stage("decode"):
        raw = payload_to_raw(model, rows, columns)
    n = raw.shape[0]
    if n == 0:
        return []
    if use_fast:
        try:
            out = BATCHER.score(model, raw, n)
        except QueueFull:
            raise       # shed load at the REST edge (503), don't reroute
        except (RateLimited, QuotaExceeded, DeadlineExceeded):
            raise       # QoS rejections: 429/504, never an eager re-score
        except Exception:   # noqa: BLE001 — degrade to the frame path
            _sc._note_failure((model.key, model_token(model)))
            FALLBACKS.inc(reason="trace-error")
            use_fast = False
    if use_fast:
        # same assembly as frame-based predict (_prediction_columns is
        # the single source of truth), just formatted as dicts
        # formatted a column at a time: tolist() gives the Python floats
        # float(v) would, x != x is the NaN test
        conv = []
        for name, vals, dom in model._prediction_columns(np.asarray(out),
                                                          n):
            vals = np.asarray(vals)[:n]
            if vals.ndim > 1:                       # multi-output rows
                lst = vals.astype(np.float64).tolist()
            elif dom is not None:
                lst = [None if x != x else str(dom[int(x)])
                       for x in vals.tolist()]
            else:
                lst = [None if x != x else x
                       for x in vals.astype(np.float64).tolist()]
            conv.append((name, lst))
        return [{name: lst[i] for name, lst in conv} for i in range(n)]
    f = _payload_frame(model, raw)
    try:
        pred = model.predict(f)
    finally:
        DKV.remove(f.key)
    out_rows = _frame_rows_to_dicts(pred)
    DKV.remove(pred.key)
    return out_rows
