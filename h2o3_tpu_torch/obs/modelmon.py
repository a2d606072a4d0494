"""Model & data drift observability of the port (h2o3_tpu/obs/modelmon.py).

Every prediction funnels through `serving/scorer_cache.score_rows`:

  * **Baseline profile** — at train time every `_serving_params` family
    stamps a per-feature mergeable sketch of its TRAINING distribution
    into the model: fixed-bin histograms over quantile edges for
    numerics, top-K + other for categoricals, NA rates, plus the
    prediction distribution. Stored in DKV beside the model
    (npz-serializable). The quantile edges come from the first
    H2O3_MODELMON_SAMPLE rows in numpy, as the JAX package computes
    them; the counts are taken on the cloud's device a column at a time
    (`torch.bucketize` against the f64 edges is numpy's
    `searchsorted(side="right")`, `torch.bincount` the counts, exact
    integers), a column in HBM where it lives, any other copied over
    from the pager's host or disk copy without being faulted in.
  * **Streaming live sketches** — a low-overhead tap in `score_rows`
    folds each scored batch into a per-(model, generation) sketch of
    the SAME shape, host-side on the staged buffer (rows staged on the
    card are stride-sampled first and copied back): integer counts make
    the merge associative and commutative by construction.
  * **Drift evaluation** — a background evaluator computes PSI per
    feature and Jensen-Shannon divergence for the prediction
    distribution, exported as `h2o3_model_drift{model,feature_kind}` /
    `h2o3_model_prediction_drift{model}` gauges +
    `h2o3_model_scored_rows_total{model}`.
  * **Generation shadow-compare** — a retrain over the same key
    retains the previous generation's live sketch; traffic still
    scoring the OLD model object keeps folding into it, and
    `h2o3_model_generation_skew{model}` compares the two generations'
    prediction distributions — the rollback signal.
  * `snapshot`/`merged_report` are the cluster merge the JAX package's
    GET /3/ModelMonitor serves; the SLO engine's `drift` SLI kind and
    the `drift` pressure dimension (obs/usage.py) read the gauges.

Cardinality is folded as QoS folds principals: at most
H2O3_MODELMON_MAX_MODELS models are monitored; later trains are
skipped (counted), never unbounded label churn. All per-model series
are removed exactly once on model DELETE (`forget`).

Env surface:
  H2O3_MODELMON            master switch (default on)
  H2O3_MODELMON_BINS       numeric histogram bins (default 20)
  H2O3_MODELMON_TOPK       categorical top-K levels (default 32)
  H2O3_MODELMON_SAMPLE     max training rows for quantile edges
                           (default 65536)
  H2O3_MODELMON_EVAL_S     background drift evaluation period
                           (default 30; 0 = evaluate only on demand)
  H2O3_MODELMON_MAX_MODELS monitored-model cardinality cap (default 64)
  H2O3_MODELMON_PSI_SAT    PSI score treated as saturated pressure
                           (default 0.5)
  H2O3_MODELMON_TAP_ROWS   per-fold row cap of the serving tap
                           (default 512; 0 folds every row)
  H2O3_MODELMON_TAP_PCT    duty-cycle budget of the tap, percent of
                           serving wall time (default 0.5)

`reset()` forgets every model and retires the evaluator thread.
"""

from __future__ import annotations

import io
import threading
import time

import numpy as np
import torch

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.utils.env import env_bool, env_float, env_int

# ---------------------------------------------------------------------------
# metrics (one declaration site each)

DRIFT = _om.gauge(
    "h2o3_model_drift",
    "population-stability-index drift of live scoring traffic against "
    "the model's training baseline, per model and feature kind "
    "(numeric|categorical|na): the worst feature of that kind")
PRED_DRIFT = _om.gauge(
    "h2o3_model_prediction_drift",
    "Jensen-Shannon divergence between the live prediction "
    "distribution and the training-time prediction distribution")
GEN_SKEW = _om.gauge(
    "h2o3_model_generation_skew",
    "Jensen-Shannon divergence between the current generation's live "
    "prediction distribution and the PREVIOUS generation's (retained "
    "across a retrain/hot-swap) — the rollback signal")
SCORED = _om.counter(
    "h2o3_model_scored_rows_total",
    "rows seen by the model's serving drift tap (batches deferred by "
    "the duty-cycle throttle count too; the live sketch holds the "
    "folded sample)")
SKIPPED = _om.counter(
    "h2o3_modelmon_skipped_models_total",
    "trained models NOT monitored because the "
    "H2O3_MODELMON_MAX_MODELS cardinality cap was reached")

_LOCK = make_lock("modelmon")
_TLS = threading.local()        # .suppress: tap off for baseline scoring
_STATE: dict = {}               # model key -> _ModelState
_OVERRIDE = [None]              # set_enabled override (None = env)
_EVAL_THREAD = [None]
_LAST_EVAL: dict = {}           # model key -> last drift document

_KINDS = ("numeric", "categorical", "na")
_LAPLACE = 0.5                  # add-half count smoothing: an empty bin
                                # must not blow PSI up at small samples


# ---------------------------------------------------------------------------
# env surface


def _env_enabled() -> bool:
    return env_bool("H2O3_MODELMON", True)


def enabled() -> bool:
    ov = _OVERRIDE[0]
    return _env_enabled() if ov is None else bool(ov)


def set_enabled(on):
    """Override the H2O3_MODELMON switch from code (None restores the
    env reading) — the bench's monitor on/off A-B loop."""
    _OVERRIDE[0] = on


def _n_bins() -> int:
    # 10 equal-population bins is the standard PSI discipline — small
    # live samples stay quiet in-distribution, real shift still screams
    return max(2, env_int("H2O3_MODELMON_BINS", 10))


def _top_k() -> int:
    return max(1, env_int("H2O3_MODELMON_TOPK", 32))


def _sample_rows() -> int:
    return max(256, env_int("H2O3_MODELMON_SAMPLE", 65536))


def _tap_rows() -> int:
    # per-fold row cap: a serving batch bigger than this is stride-
    # sampled before folding, so one fold's cost stays bounded no
    # matter how large the micro-batches coalesce. Deterministic
    # (every step-th row), and drift statistics don't need every row —
    # 512 per batch converges the same PSI within noise. 0 disables
    # the cap (fold everything).
    return env_int("H2O3_MODELMON_TAP_ROWS", 512)


def _tap_pct() -> float:
    # duty-cycle budget for the tap, percent of serving wall time: each
    # fold is timed, and the next fold is deferred until the fold's own
    # duration amortizes below this fraction (0.4ms fold at 0.5% ->
    # ~80ms gap). Overhead is bounded BY CONSTRUCTION instead of hoping
    # per-batch numpy stays cheap; skipped batches still count into
    # h2o3_model_scored_rows_total. >=100 folds every batch (tests);
    # <=0 disables the tap's folding entirely.
    return env_float("H2O3_MODELMON_TAP_PCT", 0.5)


def _eval_period_s() -> float:
    return env_float("H2O3_MODELMON_EVAL_S", 30.0)


def _max_models() -> int:
    return env_int("H2O3_MODELMON_MAX_MODELS", 64)


def _psi_saturation() -> float:
    return env_float("H2O3_MODELMON_PSI_SAT", 0.5)


def monitor_key(model_key: str) -> str:
    """DKV key of the model's baseline profile (beside the params)."""
    return f"{model_key}__modelmon_baseline"


# ---------------------------------------------------------------------------
# divergence math — pure float64 over summed int64 counts, so a merge
# in ANY order (associative/commutative integer addition) yields the
# identical score bit-for-bit


def _proportions(counts: np.ndarray) -> np.ndarray:
    c = np.asarray(counts, np.float64)
    total = float(c.sum())
    k = len(c)
    return (c + _LAPLACE) / (total + _LAPLACE * k)


def psi(base_counts, live_counts) -> float:
    """Population stability index between two count vectors."""
    live = np.asarray(live_counts, np.float64)
    if float(live.sum()) <= 0.0:
        return 0.0
    p = _proportions(base_counts)
    q = _proportions(live_counts)
    return float(np.sum((q - p) * np.log(q / p)))


def js_divergence(p_counts, q_counts) -> float:
    """Jensen-Shannon divergence (natural log, in [0, ln 2])."""
    pc = np.asarray(p_counts, np.float64)
    qc = np.asarray(q_counts, np.float64)
    if float(pc.sum()) <= 0.0 or float(qc.sum()) <= 0.0:
        return 0.0
    p = _proportions(pc)
    q = _proportions(qc)
    m = 0.5 * (p + q)
    return float(0.5 * np.sum(p * np.log(p / m))
                 + 0.5 * np.sum(q * np.log(q / m)))


# ---------------------------------------------------------------------------
# baseline profile


class BaselineProfile:
    """Training-time distribution profile: per-feature binning spec +
    baseline counts + the prediction distribution. Mergeable shape —
    live sketches bin against the SAME edges/slots, so baseline vs live
    is a straight count comparison. Deterministic (no wall clock, no
    host id): the profile is DKV-replicated state and must be
    bit-identical on every host."""

    def __init__(self, features, counts, na, pred_kind, pred_edges,
                 pred_counts, resp_counts=None, n_rows=0):
        # features: [{"name", "kind", "edges"|("codes","levels","card")}]
        self.features = features
        self.counts = counts            # list of int64 arrays
        self.na = na                    # int64 array, one per feature
        self.pred_kind = pred_kind      # "class" | "reg" | "none"
        self.pred_edges = pred_edges    # f64 array for "reg", else None
        self.pred_counts = pred_counts  # int64 array
        self.resp_counts = resp_counts  # int64 array or None
        self.n_rows = int(n_rows)

    def n_slots(self, j: int) -> int:
        return len(self.counts[j])

    # ---- npz wire form (rides DKV re-home / disk tiering) ---------------
    def to_npz_bytes(self) -> bytes:
        import json as _json
        arrs = {"na": self.na, "pred_counts": self.pred_counts,
                "meta": np.frombuffer(_json.dumps({
                    "features": [
                        {k: (v.tolist() if isinstance(v, np.ndarray)
                             else v) for k, v in f.items()}
                        for f in self.features],
                    "pred_kind": self.pred_kind,
                    "n_rows": self.n_rows,
                }).encode(), np.uint8)}
        if self.pred_edges is not None:
            arrs["pred_edges"] = self.pred_edges
        if self.resp_counts is not None:
            arrs["resp_counts"] = self.resp_counts
        for j, c in enumerate(self.counts):
            arrs[f"counts_{j}"] = c
        buf = io.BytesIO()
        np.savez(buf, **arrs)
        return buf.getvalue()

    @classmethod
    def from_npz_bytes(cls, data: bytes) -> "BaselineProfile":
        import json as _json
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            meta = _json.loads(bytes(z["meta"].tobytes()).decode())
            feats = []
            for f in meta["features"]:
                if "edges" in f:
                    f = dict(f, edges=np.asarray(f["edges"], np.float64))
                feats.append(f)
            counts = [np.asarray(z[f"counts_{j}"], np.int64)
                      for j in range(len(feats))]
            return cls(
                feats, counts, np.asarray(z["na"], np.int64),
                meta["pred_kind"],
                (np.asarray(z["pred_edges"], np.float64)
                 if "pred_edges" in z.files else None),
                np.asarray(z["pred_counts"], np.int64),
                (np.asarray(z["resp_counts"], np.int64)
                 if "resp_counts" in z.files else None),
                meta["n_rows"])

    @property
    def nbytes(self) -> int:
        return (sum(int(c.nbytes) for c in self.counts)
                + int(self.na.nbytes) + int(self.pred_counts.nbytes))


def _quantile_edges(col: np.ndarray, nbins: int) -> np.ndarray:
    """Global quantile cut points (the tree binner's make_bins shape):
    nbins-1 ascending edges; duplicate edges simply leave empty bins."""
    ok = col[np.isfinite(col)]
    if len(ok) == 0:
        return np.zeros(nbins - 1, np.float64)
    qs = np.arange(1, nbins, dtype=np.float64) / nbins
    return np.quantile(ok, qs).astype(np.float64)


def _slot_counts(slot, finite, nslots: int):
    """(counts[nslots], n_na) from a column's slot ids on the card: the
    non-finite rows go to one extra slot, so one bincount (exact
    integers) and one copy back give both."""
    slot = torch.where(finite, slot, nslots)
    c = torch.bincount(slot, minlength=nslots + 1).cpu().numpy()
    return c[:nslots].astype(np.int64), int(c[nslots])


def _codes(col):
    """Integer codes of a float column on the card, truncated toward zero
    as numpy's astype(np.int64); non-finite rows read 0 (masked later)."""
    return torch.nan_to_num(col, nan=0.0, posinf=0.0, neginf=0.0).long()


def _bin_numeric(col, edges: np.ndarray, nbins: int):
    """(counts[nbins], n_na) for one numeric column — a numpy array, or a
    tensor on the card: `bucketize(right=True)` of the f64 values against
    the f64 edges is searchsorted(side="right") of the numpy path."""
    if torch.is_tensor(col):
        e = torch.from_numpy(np.asarray(edges, np.float64)).to(col.device)
        idx = torch.bucketize(col.double(), e, right=True)
        return _slot_counts(idx, torch.isfinite(col), nbins)
    finite = np.isfinite(col)
    idx = np.searchsorted(edges, col[finite], side="right")
    return (np.bincount(idx, minlength=nbins).astype(np.int64),
            int(len(col) - int(finite.sum())))


def _cat_slots(card: int, codes: np.ndarray) -> np.ndarray:
    """code -> slot lookup: tracked top-K codes get 0..K-1, everything
    else folds into slot K ("other")."""
    lut = np.full(card + 1, len(codes), np.int64)
    lut[codes] = np.arange(len(codes), dtype=np.int64)
    return lut


def _bin_categorical(col, lut: np.ndarray, nslots: int):
    if torch.is_tensor(col):
        lut_t = torch.from_numpy(lut).to(col.device)
        codes = _codes(col).clamp_(0, len(lut) - 1)
        return _slot_counts(lut_t[codes], torch.isfinite(col), nslots)
    finite = np.isfinite(col)
    codes = col[finite].astype(np.int64)
    # out-of-domain codes (adapted frames clamp, but stay defensive)
    codes = np.clip(codes, 0, len(lut) - 1)
    return (np.bincount(lut[codes], minlength=nslots).astype(np.int64),
            int(len(col) - int(finite.sum())))


def _level_counts(col, card: int) -> np.ndarray:
    """Per-level counts of a categorical column (codes clipped into the
    domain, NAs dropped), in numpy or on the card."""
    if torch.is_tensor(col):
        cc = _codes(col).clamp_(0, card - 1)
        return _slot_counts(cc, torch.isfinite(col), card)[0]
    full = np.zeros(card, np.int64)
    finite = np.isfinite(col)
    cc = np.clip(col[finite].astype(np.int64), 0, card - 1)
    full += np.bincount(cc, minlength=card).astype(np.int64)
    return full


def _column_on(vec, dev):
    """One column decoded on `dev` (f32, NaN NAs) without promoting it: a
    plane resident in HBM as it is, any other from the pager's staging
    view (the host copy; a disk chunk is read back to the host tier,
    never into HBM), its packed bytes copied over and decoded there by
    the same codec arithmetic as `Vec.as_f32`."""
    from h2o3_tpu_torch.core.frame import _decode_f32
    ch = vec._chunk
    if ch.tier == "hbm" and ch.target.type == dev.type:
        return vec.as_f32()
    data, mask = ch.staging_view()
    n = vec.nrows
    d = torch.from_numpy(np.ascontiguousarray(data[:n])).to(dev)
    m = None if mask is None else \
        torch.from_numpy(np.ascontiguousarray(mask[:n])).to(dev)
    return _decode_f32(d, vec.codec, m)


class FrameColumns:
    """An adapted frame's raw predictor columns for `build_baseline`,
    staged one at a time on `dev` (`_column_on`): never the (n, C)
    row-major matrix, so a frame the HBM budget keeps partly on the host
    stays there and a frame in HBM gains no cached matrix."""

    def __init__(self, frame, names, dev):
        self._vecs = [frame.vec(c) for c in names]
        self._dev = dev
        self.shape = (frame.nrows, len(names))

    def column(self, j):
        return _column_on(self._vecs[j], self._dev)


def build_baseline(dinfo, raw, preds, resp=None,
                   nbins=None, topk=None) -> BaselineProfile:
    """Profile the training distribution from the staged raw columns (cat
    codes + numerics, NaN NAs — `stage_frame`'s (n, C) layout as a numpy
    array or a tensor, or a `FrameColumns`) and the training predictions.
    Deterministic: the edges come from each column's first
    H2O3_MODELMON_SAMPLE rows in numpy either way, and the counts are the
    same integers from a tensor (`bucketize` + `bincount`) as from numpy."""
    nbins = nbins or _n_bins()
    topk = topk or _top_k()
    names = dinfo.raw_columns()
    cat = set(dinfo.cat_cols)
    n = raw.shape[0]
    n_sample = min(n, _sample_rows())
    features, counts, na = [], [], []
    for j, name in enumerate(names):
        col = raw.column(j) if isinstance(raw, FrameColumns) else raw[:, j]
        if name in cat:
            card = int(dinfo.cardinalities[name])
            full = _level_counts(col, card)
            order = np.argsort(-full, kind="stable")[:topk]
            tracked = np.sort(order).astype(np.int64)
            lut = _cat_slots(card, tracked)
            c, nna = _bin_categorical(col, lut, len(tracked) + 1)
            features.append({
                "name": name, "kind": "categorical",
                "codes": tracked.tolist(), "card": card,
                "levels": [dinfo.domains[name][k] for k in tracked]})
            counts.append(c)
            na.append(nna)
        else:
            head = col[:n_sample]
            edges = _quantile_edges(
                head.cpu().numpy() if torch.is_tensor(head) else head, nbins)
            c, nna = _bin_numeric(col, edges, nbins)
            features.append({"name": name, "kind": "numeric",
                             "edges": edges})
            counts.append(c)
            na.append(nna)
    pred_kind, pred_edges, pred_counts = "none", None, \
        np.zeros(1, np.int64)
    if preds is not None:
        preds = np.asarray(preds)
        if preds.ndim == 2 and preds.shape[1] > 1:
            pred_kind = "class"
            cls = preds.argmax(axis=1)
            pred_counts = np.bincount(
                cls, minlength=preds.shape[1]).astype(np.int64)
        else:
            pred_kind = "reg"
            flat = preds.reshape(len(preds), -1)[:, 0].astype(np.float64)
            pred_edges = _quantile_edges(
                flat[:min(len(flat), _sample_rows())], nbins)
            pc, _ = _bin_numeric(flat, pred_edges, nbins)
            pred_counts = pc
    resp_counts = None
    if resp is not None and torch.is_tensor(resp):
        # the response on the card: the same integers as the numpy path
        if dinfo.response_domain is not None:
            resp_counts = _level_counts(resp, len(dinfo.response_domain))
        elif pred_edges is not None:
            resp_counts, _ = _bin_numeric(resp, pred_edges,
                                          len(pred_counts))
    elif resp is not None:
        r = np.asarray(resp, np.float64)
        if dinfo.response_domain is not None:
            k = len(dinfo.response_domain)
            finite = np.isfinite(r)
            resp_counts = np.bincount(
                np.clip(r[finite].astype(np.int64), 0, k - 1),
                minlength=k).astype(np.int64)
        elif pred_edges is not None:
            resp_counts, _ = _bin_numeric(r[np.isfinite(r)], pred_edges,
                                          len(pred_counts))
    return BaselineProfile(features, counts, np.asarray(na, np.int64),
                           pred_kind, pred_edges, pred_counts,
                           resp_counts, n_rows=n)


# ---------------------------------------------------------------------------
# live sketches


class LiveSketch:
    """Streaming counts in the baseline's shape. fold() is the serving
    hot-path cost: one searchsorted/bincount per feature on the staged
    host buffer. Counts are int64 — merge is plain addition."""

    __slots__ = ("counts", "na", "pred_counts", "rows", "batches",
                 "_luts", "_edges")

    def __init__(self, profile: BaselineProfile):
        self.counts = [np.zeros(profile.n_slots(j), np.int64)
                       for j in range(len(profile.features))]
        self.na = np.zeros(len(profile.features), np.int64)
        self.pred_counts = np.zeros(len(profile.pred_counts), np.int64)
        self.rows = 0
        self.batches = 0
        # fold plans, prebuilt once per generation
        self._luts = {}
        self._edges = {}
        for j, f in enumerate(profile.features):
            if f["kind"] == "categorical":
                self._luts[j] = _cat_slots(
                    int(f["card"]), np.asarray(f["codes"], np.int64))
            else:
                self._edges[j] = np.asarray(f["edges"], np.float64)

    def fold(self, profile: BaselineProfile, raw: np.ndarray,
             preds, n: int):
        for j in range(len(profile.features)):
            col = raw[:n, j]
            edges = self._edges.get(j)
            if edges is not None:
                c, nna = _bin_numeric(col, edges, len(self.counts[j]))
            else:
                c, nna = _bin_categorical(col, self._luts[j],
                                          len(self.counts[j]))
            self.counts[j] += c
            self.na[j] += nna
        if preds is not None and profile.pred_kind != "none":
            p = np.asarray(preds)[:n]
            if profile.pred_kind == "class" and p.ndim == 2:
                cls = p.argmax(axis=1)
                self.pred_counts += np.bincount(
                    cls, minlength=len(self.pred_counts)).astype(np.int64)
            elif profile.pred_kind == "reg":
                flat = p.reshape(len(p), -1)[:, 0].astype(np.float64)
                c, _ = _bin_numeric(flat[np.isfinite(flat)],
                                    profile.pred_edges,
                                    len(self.pred_counts))
                self.pred_counts += c
        self.rows += int(n)
        self.batches += 1

    def merge_doc(self, doc: dict):
        """Fold a snapshot document (another host's counts) in."""
        for j, c in enumerate(doc.get("counts") or []):
            if j < len(self.counts) and len(c) == len(self.counts[j]):
                self.counts[j] += np.asarray(c, np.int64)
        na = doc.get("na") or []
        for j, v in enumerate(na):
            if j < len(self.na):
                self.na[j] += int(v)
        pc = doc.get("pred_counts") or []
        if len(pc) == len(self.pred_counts):
            self.pred_counts += np.asarray(pc, np.int64)
        self.rows += int(doc.get("rows") or 0)
        self.batches += int(doc.get("batches") or 0)

    def to_doc(self) -> dict:
        """JSON-serializable counts (the collect-op wire form)."""
        return {"counts": [c.tolist() for c in self.counts],
                "na": self.na.tolist(),
                "pred_counts": self.pred_counts.tolist(),
                "rows": self.rows, "batches": self.batches}


class _ModelState:
    """Per-monitored-model registry entry: baseline + current live
    sketch + the retained previous generation."""

    __slots__ = ("key", "baseline", "live", "prev", "prev_baseline",
                 "gen", "token", "prev_token", "lock", "next_fold")

    def __init__(self, key, baseline, token):
        self.key = key
        self.baseline = baseline
        self.live = LiveSketch(baseline)
        self.prev = None
        self.prev_baseline = None
        self.gen = 1
        self.token = token
        self.prev_token = None
        self.lock = make_lock("modelmon.state")
        # duty-cycle throttle (see observe): perf_counter time before
        # which incoming batches are counted but not folded
        self.next_fold = 0.0


# ---------------------------------------------------------------------------
# lifecycle: install (train), rotate (retrain), forget (DELETE)


def install_baseline(model, frame):
    """Train-time hook (ModelBase.train, before DKV.put): profile the
    training frame + predictions, stamp the profile into DKV beside the
    model, and (re)register the model for live monitoring. A retrain
    over the same key ROTATES: the old generation's live sketch is
    retained for shadow-compare. Never raises — monitoring must not
    fail training."""
    if not enabled():
        return None
    try:
        if model._serving_params() is None:
            return None
        from h2o3_tpu_torch.core.kvstore import DKV
        from h2o3_tpu_torch.serving import scorer_cache as _sc
        di = model._dinfo
        if frame.is_sparse(di.raw_columns()):
            # sparse predictors are scored sparsely (GLM's sparse path),
            # never through score_rows and its tap, and staging them dense
            # is what that path avoids: rcv1.binary's 697,641 x 47,236 is
            # 132 GB of f32 (the JAX package's attempt ends in its
            # MemoryError guard, unmonitored)
            return None
        af = di.adapt(frame)
        # binned on the cloud's device a column at a time (the JAX package
        # stages the whole frame to the host: 1.23 GB of f32 at HIGGS's
        # 11M x 28, then numpy over every row)
        from h2o3_tpu_torch.parallel import mesh as _mesh
        dev = _mesh.cloud().device
        raw = FrameColumns(af, di.raw_columns(), dev)
        preds = None
        # the serving tap must not see the baseline pass itself: on a
        # same-object retrain the training predictions would otherwise
        # fold into the outgoing generation's live sketch
        _TLS.suppress = True
        try:
            out = _sc.score_frame(model, frame)
        finally:
            _TLS.suppress = False
        if out is not None:
            preds = np.asarray(out)[:frame.nrows]
        resp = None
        if di.response_name and di.response_name in af.names:
            resp = _column_on(af.vec(di.response_name), dev)
        profile = build_baseline(di, raw, preds, resp)
        del raw
        token = _sc.model_token(model)
        with _LOCK:
            st = _STATE.get(model.key)
            if st is None:
                if len(_STATE) >= _max_models():
                    SKIPPED.inc()
                    return None
                _STATE[model.key] = _ModelState(model.key, profile,
                                                token)
            else:
                with st.lock:
                    st.prev = st.live
                    st.prev_baseline = st.baseline
                    st.prev_token = st.token
                    st.baseline = profile
                    st.live = LiveSketch(profile)
                    st.token = token
                    st.gen += 1
        DKV.put(monitor_key(model.key), profile)
        _ensure_evaluator()
        return profile
    except Exception:   # noqa: BLE001 — baseline capture must never fail train
        from h2o3_tpu_torch.utils import log as _log
        import traceback
        _log.warn("modelmon baseline capture failed for %r: %s",
                  getattr(model, "key", None),
                  traceback.format_exc(limit=3))
        return None


def forget(model_key: str):
    """Model DELETE: drop sketches and remove every per-model metric
    series exactly once (Gauge.remove).
    Idempotent — a second call is a no-op."""
    with _LOCK:
        st = _STATE.pop(model_key, None)
    _LAST_EVAL.pop(model_key, None)
    if st is None:
        return False
    for kind in _KINDS:
        DRIFT.remove(model=model_key, feature_kind=kind)
    PRED_DRIFT.remove(model=model_key)
    GEN_SKEW.remove(model=model_key)
    SCORED.remove(model=model_key)
    try:
        from h2o3_tpu_torch.core.kvstore import DKV
        DKV.remove(monitor_key(model_key))
    except Exception:   # noqa: BLE001 — series removal must not fail the op
        pass
    return True


def monitored(model_key: str) -> bool:
    with _LOCK:
        return model_key in _STATE


# ---------------------------------------------------------------------------
# the serving tap


def observe(model, raw: np.ndarray, preds, n: int):
    """score_rows tap: fold one scored batch into the model's live
    sketch (or the RETAINED previous generation's, when the caller is
    still holding the pre-swap model object — that is exactly the
    shadow-compare traffic). Host-side numpy on the already-staged
    buffer; must never break scoring."""
    if n <= 0 or not enabled() or getattr(_TLS, "suppress", False):
        return
    key = getattr(model, "key", None)
    if key is None:
        return
    with _LOCK:
        st = _STATE.get(key)
    if st is None:
        return
    try:
        from h2o3_tpu_torch.serving import scorer_cache as _sc
        token = _sc.model_token(model)
        pct = _tap_pct()
        now = time.perf_counter()
        with st.lock:
            if token == st.token:
                sk, profile = st.live, st.baseline
            elif st.prev is not None and token == st.prev_token:
                sk, profile = st.prev, st.prev_baseline
            else:
                return
            # duty-cycle throttle: inside the deferral window the batch
            # is counted (SCORED below) but not folded — the sketch is
            # a sample of the stream, which is all PSI/JS need
            if pct > 0.0 and now >= st.next_fold:
                cap = _tap_rows()
                if 0 < cap < n:
                    # deterministic stride sample bounds ONE fold's cost
                    step = -(-n // cap)
                    raw, preds = raw[:n:step], preds[:n:step]
                    n_fold = raw.shape[0]
                else:
                    n_fold = n
                if torch.is_tensor(raw):
                    # rows staged on the card (`stage_frame_device`): the
                    # sample comes back to the host, inside the fold's
                    # timed budget
                    raw = raw[:n_fold].cpu().numpy()
                sk.fold(profile, raw, preds, n_fold)
                if pct < 100.0:
                    df = time.perf_counter() - now
                    st.next_fold = now + df * (100.0 - pct) / pct
        SCORED.inc(n, model=key)
    except Exception:   # noqa: BLE001 — the tap must never break scoring
        pass


# ---------------------------------------------------------------------------
# drift evaluation


def _feature_doc(profile, sketch):
    feats = []
    for j, f in enumerate(profile.features):
        base = profile.counts[j]
        live = sketch.counts[j]
        base_n = int(base.sum()) + int(profile.na[j])
        live_n = int(live.sum()) + int(sketch.na[j])
        base_na = (profile.na[j] / base_n) if base_n else 0.0
        live_na = (sketch.na[j] / live_n) if live_n else 0.0
        feats.append({
            "name": f["name"], "kind": f["kind"],
            "psi": round(psi(base, live), 6),
            "na_rate_baseline": round(float(base_na), 6),
            "na_rate_live": round(float(live_na), 6),
            "baseline_counts": base.tolist(),
            "live_counts": live.tolist()})
    return feats


def _drift_doc(st: "_ModelState") -> dict:
    """One model's drift document from ITS OWN host-local sketches
    (the background evaluator / gauge feed); the REST handler builds
    the same shape from cluster-merged sketches."""
    with st.lock:
        return drift_from_sketches(st.key, st.baseline, st.live,
                                   st.prev, st.gen)


def drift_from_sketches(key, baseline, live, prev, gen) -> dict:
    feats = _feature_doc(baseline, live)
    worst = {"numeric": 0.0, "categorical": 0.0}
    worst_na = 0.0
    for f in feats:
        worst[f["kind"]] = max(worst[f["kind"]], f["psi"])
        worst_na = max(worst_na,
                       abs(f["na_rate_live"] - f["na_rate_baseline"]))
    pred_drift = js_divergence(baseline.pred_counts, live.pred_counts)
    gen_skew = None
    if prev is not None and prev.rows > 0 and live.rows > 0:
        gen_skew = js_divergence(prev.pred_counts, live.pred_counts)
    return {"model": key, "generation": gen,
            "rows": live.rows, "batches": live.batches,
            "drift": {"numeric": round(worst["numeric"], 6),
                      "categorical": round(worst["categorical"], 6),
                      "na": round(worst_na, 6)},
            "prediction_drift": round(pred_drift, 6),
            "generation_skew": (round(gen_skew, 6)
                                if gen_skew is not None else None),
            "prev_rows": prev.rows if prev is not None else 0,
            "features": feats,
            "prediction": {
                "kind": baseline.pred_kind,
                "baseline_counts": baseline.pred_counts.tolist(),
                "live_counts": live.pred_counts.tolist()}}


def evaluate() -> dict:
    """Refresh the drift gauges for every monitored model from this
    host's sketches; returns {model_key: drift document}. Called by the
    background evaluator, the SLO drift SLI, the pressure model and
    GET /3/ModelMonitor."""
    with _LOCK:
        states = list(_STATE.values())
    out = {}
    for st in states:
        doc = _drift_doc(st)
        for kind in _KINDS:
            DRIFT.set(doc["drift"][kind], model=st.key,
                      feature_kind=kind)
        PRED_DRIFT.set(doc["prediction_drift"], model=st.key)
        if doc["generation_skew"] is not None:
            GEN_SKEW.set(doc["generation_skew"], model=st.key)
        out[st.key] = doc
        _LAST_EVAL[st.key] = doc
    return out


def pressure() -> tuple:
    """(drift pressure in [0,1], detail dict) from the LAST evaluation
    — 1.0 when any model's worst PSI (or prediction drift) reaches
    H2O3_MODELMON_PSI_SAT."""
    sat = max(_psi_saturation(), 1e-9)
    worst = 0.0
    worst_model = None
    for key, doc in list(_LAST_EVAL.items()):
        score = max(max(doc["drift"].values()), doc["prediction_drift"])
        if score > worst:
            worst, worst_model = score, key
    return (min(1.0, worst / sat),
            {"worst_model": worst_model, "worst_score": round(worst, 6),
             "saturation_psi": sat, "monitored": len(_LAST_EVAL)})


# ---------------------------------------------------------------------------
# cluster merge (the `modelmon:` collect op)


def snapshot(model_key: str):
    """This host's sketches for ONE model, JSON-serializable — the
    worker-side answer to the `modelmon:<key>` collect op. None when
    the model is not monitored here."""
    with _LOCK:
        st = _STATE.get(model_key)
    if st is None:
        return None
    from h2o3_tpu_torch.obs import timeline as _tl
    with st.lock:
        doc = {"host": _tl.host_id(), "model": model_key,
               "generation": st.gen, "live": st.live.to_doc(),
               "prev": st.prev.to_doc() if st.prev is not None else None}
    return doc


def merged_report(model_key: str, snaps) -> dict:
    """Cluster-merged drift report: fold every host's live (and prev)
    counts into this host's shape, then score ONCE over the sums —
    integer merge, so host count and arrival order never change the
    result bit-for-bit. Local sketches must NOT appear in `snaps` (the
    local host contributes via its own snapshot like any other)."""
    with _LOCK:
        st = _STATE.get(model_key)
    if st is None:
        return {"model": model_key, "monitored": False}
    with st.lock:
        baseline, prev_baseline = st.baseline, st.prev_baseline
        gen = st.gen
    live = LiveSketch(baseline)
    prev = LiveSketch(prev_baseline) if prev_baseline is not None \
        else None
    hosts = []
    for s in snaps:
        if not isinstance(s, dict) or s.get("model") != model_key:
            continue
        if s.get("live") is None:
            # a host that answered but does not monitor this model
            # (trained elsewhere, or over its cardinality cap)
            hosts.append({"host": s.get("host"), "monitored": False})
            continue
        if s.get("generation") != gen:
            hosts.append({"host": s.get("host"), "stale_generation":
                          s.get("generation")})
            continue
        live.merge_doc(s.get("live") or {})
        if prev is not None and s.get("prev"):
            prev.merge_doc(s["prev"])
        hosts.append({"host": s.get("host"),
                      "rows": (s.get("live") or {}).get("rows", 0)})
    doc = drift_from_sketches(model_key, baseline, live, prev, gen)
    doc["monitored"] = True
    doc["hosts"] = hosts
    return doc


# ---------------------------------------------------------------------------
# background evaluator


def _ensure_evaluator():
    period = _eval_period_s()
    if period <= 0:
        return
    with _LOCK:
        t = _EVAL_THREAD[0]
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=_eval_loop, args=(period,),
                             daemon=True, name="h2o3-modelmon-eval")
        _EVAL_THREAD[0] = t
    t.start()


def _eval_loop(period: float):
    while True:
        time.sleep(period)
        if _EVAL_THREAD[0] is not threading.current_thread():
            return              # reconfigured: a newer loop owns this
        try:
            if _STATE:
                evaluate()
        except Exception:   # noqa: BLE001 — the evaluator must survive
            import traceback
            traceback.print_exc()


def reset():
    """Test isolation: drop all monitored state and the per-model
    series; restore the env-driven enable switch; retire the evaluator
    thread (it exits at its next wake, no longer owning the loop)."""
    with _LOCK:
        keys = list(_STATE.keys())
        _EVAL_THREAD[0] = None
    for k in keys:
        forget(k)
    _LAST_EVAL.clear()
    _OVERRIDE[0] = None
    DRIFT.clear()
    PRED_DRIFT.clear()
    GEN_SKEW.clear()
    SCORED.clear()
