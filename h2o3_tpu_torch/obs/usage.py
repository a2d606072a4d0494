"""Usage attribution & capacity observability of the port
(h2o3_tpu/obs/usage.py) — the device-time ledger, per-request stage
waterfall, and the cloud pressure model.

Three jobs:

  * **Device-time attribution** — the dispatch funnel (in the port the
    scorer cache; the JAX package's collective guard and mrtask dispatch
    come with the multi-device item) wraps every device execution in
    `meter(kind, ...)`, which charges the
    elapsed wall seconds to the ambient (principal, model, kind) read
    from the obs TLS that QoS already stamps. Charges land in
    `h2o3_device_seconds_total{principal,kind}` plus a per-model series
    (`h2o3_model_device_seconds_total{model,kind}`, capped by
    H2O3_USAGE_MAX_MODELS the way QoS caps principals) and in an
    in-memory ledger `usage_snapshot()` renders per-tenant/per-model
    (GET /3/Usage in the JAX package's REST server). Nested meters never
    double-charge: the OUTERMOST meter on a thread wins (a scorer
    dispatch contains a guarded jit launch; only the scorer charges).

  * **Per-request latency decomposition** — a TLS stage recorder the
    REST layer opens per request (`begin_request`) and the serving path
    feeds (`stage(name)` blocks around edge admission, queue wait, fair-
    gate wait, decode/staging, device, readback). The micro-batcher
    times its shared dispatch stages once per chunk (`capture_stages`)
    and stamps them onto every coalesced request, so followers get the
    same waterfall the leader measured. `finish_request` folds the
    un-attributed remainder into an `app` stage, feeds
    `h2o3_request_stage_seconds{stage}`, and the server returns the
    breakdown as a standard `Server-Timing` response header.

  * **Pressure** — `evaluate_pressure()` fuses SLO burn rates, queue
    depths, device utilization (device-seconds rate over wall), tier-
    pager occupancy + fault rate, and watchdog stalls into one
    HPA-external-metric-shaped document per host (`GET /3/CloudHealth`
    merges the cloud over the `cloudhealth` collect op), cached for the
    `h2o3_pressure{dimension}` gauges — the sensor the ROADMAP
    autoscaling item consumes. `reset()` drops it all.

Import discipline: this module imports only metrics/tracing/env at the
top so the parallel layer can reach it lazily without cycles; QoS (for
principal folding) and the serving/tiering/SLO subsystems are imported
at call time, by which point the import graph is settled.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager

from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs import tracing as _tracing
from h2o3_tpu_torch.utils.env import env_bool, env_float, env_int

DEVICE_SECONDS = _om.counter(
    "h2o3_device_seconds_total",
    "device execution wall seconds charged to the requesting tenant "
    "(obs-TLS principal) per op kind — the accelerator analog of "
    "WaterMeter's per-core CPU ticks")
MODEL_DEVICE_SECONDS = _om.counter(
    "h2o3_model_device_seconds_total",
    "device execution wall seconds per model key and op kind; models "
    "past H2O3_USAGE_MAX_MODELS fold into the _other series")
STAGE_SECONDS = _om.histogram(
    "h2o3_request_stage_seconds",
    "per-request latency decomposition: wall seconds spent in each "
    "serving stage (edge admission, queue wait, gate wait, "
    "decode/staging, device, readback, app remainder) — the same "
    "breakdown the Server-Timing response header returns to callers")

# canonical waterfall order — `app` is the computed remainder so the
# emitted stages always sum to the request's measured wall time
STAGE_ORDER = ("edge", "queue", "gate", "decode", "device", "readback",
               "app")

# fold target for per-model series past the cardinality cap (the QoS
# principal-folding discipline applied to model keys)
OTHER_MODEL = "_other"

_TLS = threading.local()
_LOCK = threading.Lock()          # leaf lock: ledger + model census
_LEDGER: dict = {}                # (principal, model, kind) -> [s, calls, rows]
_TOTAL = [0.0]                    # cumulative device seconds, all series
_RATE: deque = deque(maxlen=4096)   # (monotonic, cumulative) rate samples
_KNOWN_MODELS: set = set()
_OVERRIDE: list = [None]          # set_enabled() override (None = env)
_TIER_PREV = [None]               # (monotonic, faults) for the fault rate
_TIER_RATE = [0.0]                # last fault rate over a full interval
_LAST_PRESSURE: dict = {}         # last evaluate_pressure() doc (gauge feed)

# burn rate at which the fast-burn multi-window alert pages (obs/slo.py
# default windows): pressure 1.0 on the slo_burn dimension = paging
_SLO_PAGE_BURN = 14.4
# tier faults/second treated as saturation on the tier_faults dimension
_TIER_FAULT_SATURATION = 100.0
# floor on the fault-rate interval: concurrent evaluations (a client GET
# racing a cluster collect) must not amplify a few faults over near-zero dt
_TIER_MIN_INTERVAL_S = 0.25


def _env_enabled() -> bool:
    """H2O3_USAGE master switch (attribution + stage recording)."""
    return env_bool("H2O3_USAGE", True)


def _max_models() -> int:
    return env_int("H2O3_USAGE_MAX_MODELS", 64)


def _rate_window_s() -> float:
    """Trailing window for the device-seconds rate → utilization."""
    return env_float("H2O3_USAGE_RATE_WINDOW_S", 60.0)


def enabled() -> bool:
    ov = _OVERRIDE[0]
    return _env_enabled() if ov is None else bool(ov)


def set_enabled(on):
    """Override the H2O3_USAGE switch from code (None restores the env
    reading) — the bench's ledger on/off A-B loop."""
    _OVERRIDE[0] = on


# ---------------------------------------------------------------------------
# device-time attribution


def _fold_principal(p) -> str:
    """The QoS principal discipline (sanitize + cardinality fold) owns
    principal naming; reuse it so usage series can never exceed the
    cardinality /metrics already admits."""
    try:
        from h2o3_tpu_torch.serving import qos as _qos
        return _qos.resolve_principal(p or "")
    except Exception:   # noqa: BLE001 — attribution must never break dispatch
        return p or "anonymous"


def _fold_model(key) -> str:
    k = str(key)[:128]
    with _LOCK:
        if k in _KNOWN_MODELS:
            return k
        if len(_KNOWN_MODELS) < _max_models():
            _KNOWN_MODELS.add(k)
            return k
    return OTHER_MODEL


def charge(kind: str, seconds: float, model=None, rows: int = 0,
           principal=None):
    """Charge `seconds` of device time to (principal, model, kind).
    The principal defaults to the obs-TLS principal QoS stamped for the
    current request (anonymous otherwise)."""
    if not enabled():
        return
    s = max(0.0, float(seconds))
    p = _fold_principal(principal if principal is not None
                        else _tracing.principal())
    m = _fold_model(model) if model else ""
    DEVICE_SECONDS.inc(s, principal=p, kind=kind)
    if m:
        MODEL_DEVICE_SECONDS.inc(s, model=m, kind=kind)
    now = time.monotonic()
    with _LOCK:
        ent = _LEDGER.setdefault((p, m, kind), [0.0, 0, 0])
        ent[0] += s
        ent[1] += 1
        ent[2] += int(rows)
        _TOTAL[0] += s
        # rate samples keep a minimum spacing so a hot dispatch loop
        # updates the newest sample in place instead of churning the ring;
        # the retained timestamp must NOT advance, or sustained load pins
        # the ring to one ever-fresh sample and device_rate reads 0
        if _RATE and now - _RATE[-1][0] < 0.05:
            _RATE[-1] = (_RATE[-1][0], _TOTAL[0])
        else:
            _RATE.append((now, _TOTAL[0]))


class _Meter:
    """Outermost-wins device-time meter: a scorer dispatch CONTAINS a
    guarded jit launch, and both funnel layers are instrumented — the
    TLS flag makes the inner meter a no-op so the seconds charge once,
    at the layer that knows the model and row count."""

    __slots__ = ("kind", "model", "rows", "t0", "active")

    def __init__(self, kind, model, rows):
        self.kind = kind
        self.model = model
        self.rows = rows
        self.active = False

    def __enter__(self):
        if enabled() and not getattr(_TLS, "metering", False):
            self.active = True
            _TLS.metering = True
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.active:
            _TLS.metering = False
            # an erroring dispatch still spent the device time it spent
            charge(self.kind, time.perf_counter() - self.t0,
                   model=self.model, rows=self.rows)
        return False


def meter(kind: str, model=None, rows: int = 0) -> _Meter:
    """Context manager metering device wall seconds into `charge()`."""
    return _Meter(kind, model, rows)


def device_seconds_total() -> float:
    with _LOCK:
        return _TOTAL[0]


def device_rate(window_s=None) -> float:
    """Trailing device-seconds per wall second over `window_s`."""
    window = _rate_window_s() if window_s is None else float(window_s)
    now = time.monotonic()
    with _LOCK:
        cum = _TOTAL[0]
        base_t, base_c = None, None
        for t, c in reversed(_RATE):
            base_t, base_c = t, c
            if now - t >= window:
                break
        if base_t is None or now - base_t <= 0.0:
            return 0.0
        return max(0.0, (cum - base_c) / (now - base_t))


def _device_count() -> int:
    """Devices the cloud holds (the JAX package counts
    jax.local_device_count()): the port's cloud is one device, the card
    or the CPU (parallel/mesh.py)."""
    return 1


# ---------------------------------------------------------------------------
# per-request stage waterfall


def begin_request():
    """Open the calling thread's stage recorder (REST entry)."""
    _TLS.stages = {} if enabled() else None


def clear_request():
    _TLS.stages = None


def stage_active() -> bool:
    return getattr(_TLS, "stages", None) is not None \
        or getattr(_TLS, "capture", None) is not None


def add_stage(name: str, seconds: float):
    """Add wall seconds to stage `name`. A capture (micro-batch shared
    dispatch timing) takes precedence over the request recorder so the
    leader's own request is stamped via the shared dict like every
    follower's — never twice."""
    s = max(0.0, float(seconds))
    cap = getattr(_TLS, "capture", None)
    if cap is not None:
        cap[name] = cap.get(name, 0.0) + s
        return
    st = getattr(_TLS, "stages", None)
    if st is not None:
        st[name] = st.get(name, 0.0) + s


@contextmanager
def stage(name: str):
    """Time a block into stage `name` (no-op when nobody is recording)."""
    if not stage_active():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_stage(name, time.perf_counter() - t0)


@contextmanager
def capture_stages():
    """Collect stage() recordings into a plain dict regardless of the
    request recorder — the micro-batch leader times gate/decode/device/
    readback ONCE per coalesced chunk and stamps the dict onto every
    request it served."""
    prev = getattr(_TLS, "capture", None)
    cap: dict = {}
    _TLS.capture = cap
    try:
        yield cap
    finally:
        _TLS.capture = prev


def merge_stages(d):
    """Fold a stamped stage dict (micro-batch shared timings) into the
    calling thread's request recorder."""
    st = getattr(_TLS, "stages", None)
    if st is None or not d:
        return
    for k, v in d.items():
        st[k] = st.get(k, 0.0) + float(v)


def finish_request(wall=None):
    """Close the recorder: fold the un-attributed remainder of `wall`
    into `app`, feed the per-stage histograms, return the breakdown
    (None when nothing was recorded)."""
    st = getattr(_TLS, "stages", None)
    _TLS.stages = None
    if st is None:
        return None
    if wall is not None:
        rest = float(wall) - sum(st.values())
        if rest > 0.0:
            st["app"] = st.get("app", 0.0) + rest
    for k, v in st.items():
        STAGE_SECONDS.observe(v, stage=k)
    return st


def server_timing(stages: dict) -> str:
    """RFC Server-Timing header value: `name;dur=<ms>` entries in
    waterfall order."""
    order = {n: i for i, n in enumerate(STAGE_ORDER)}
    items = sorted(stages.items(),
                   key=lambda kv: (order.get(kv[0], len(order)), kv[0]))
    return ", ".join(f"{k};dur={v * 1e3:.3f}" for k, v in items)


# ---------------------------------------------------------------------------
# /3/Usage — the per-tenant/per-model cost table


def usage_snapshot() -> dict:
    """This host's attribution ledger + HBM occupancy (tier pager,
    ParamStore) — the `usage` collect op's payload."""
    from h2o3_tpu_torch.obs import timeline as _tl
    with _LOCK:
        rows = [{"principal": p, "model": m, "kind": k,
                 "device_seconds": round(e[0], 6), "calls": e[1],
                 "rows": e[2]}
                for (p, m, k), e in sorted(_LEDGER.items())]
        total = _TOTAL[0]
    hbm: dict = {}
    try:
        from h2o3_tpu_torch.serving.params import PARAMS
        hbm["params_by_model"] = PARAMS.by_model()
        hbm["params_total_bytes"] = PARAMS.total_bytes()
        hbm["params_tier_bytes"] = PARAMS.tier_bytes()
        hbm["params_serving"] = PARAMS.stats()
    except Exception:   # noqa: BLE001 — a probe error must not kill the snapshot
        pass
    try:
        from h2o3_tpu_torch.core.tiering import PAGER
        hbm["tier"] = PAGER.stats()
    except Exception:   # noqa: BLE001
        pass
    return {"host": _tl.host_id(), "device_seconds_total": round(total, 6),
            "ledger": rows, "hbm": hbm}


def merge_usage(snaps) -> dict:
    """Cluster merge of usage_snapshot() payloads: ledger entries sum
    across hosts, HBM byte maps sum, per-host tier stats ride along."""
    agg: dict = {}
    hosts, tier_by_host = [], {}
    total = 0.0
    params_by_model: dict = {}
    params_total = 0
    params_tier: dict = {}
    for s in snaps:
        if not isinstance(s, dict):
            continue
        hosts.append(s.get("host"))
        total += float(s.get("device_seconds_total") or 0.0)
        for r in s.get("ledger") or []:
            k = (r.get("principal"), r.get("model"), r.get("kind"))
            e = agg.setdefault(k, [0.0, 0, 0])
            e[0] += float(r.get("device_seconds") or 0.0)
            e[1] += int(r.get("calls") or 0)
            e[2] += int(r.get("rows") or 0)
        hb = s.get("hbm") or {}
        for m, b in (hb.get("params_by_model") or {}).items():
            params_by_model[m] = params_by_model.get(m, 0) + int(b)
        params_total += int(hb.get("params_total_bytes") or 0)
        for t, b in (hb.get("params_tier_bytes") or {}).items():
            params_tier[t] = params_tier.get(t, 0) + int(b)
        if hb.get("tier") is not None:
            tier_by_host[str(s.get("host"))] = hb["tier"]
    ledger = [{"principal": p, "model": m, "kind": k,
               "device_seconds": round(e[0], 6), "calls": e[1],
               "rows": e[2]}
              for (p, m, k), e in agg.items()]
    ledger.sort(key=lambda r: -r["device_seconds"])
    return {"hosts": hosts, "device_seconds_total": round(total, 6),
            "ledger": ledger,
            "hbm": {"params_by_model": params_by_model,
                    "params_total_bytes": params_total,
                    "params_tier_bytes": params_tier,
                    "tier_by_host": tier_by_host}}


# ---------------------------------------------------------------------------
# /3/CloudHealth — the pressure model


def _pressure_series():
    """h2o3_pressure{dimension} gauge callback: reads ONLY the cached
    last evaluation (the registry lock forbids subsystem locks here)."""
    doc = _LAST_PRESSURE
    dims = doc.get("dimensions") or {}
    out = [({"dimension": k}, float(v)) for k, v in sorted(dims.items())]
    if "overall" in doc:
        out.append(({"dimension": "overall"}, float(doc["overall"])))
    return out


PRESSURE = _om.gauge(
    "h2o3_pressure",
    "synthesized capacity pressure per dimension (1.0 = saturated): "
    "slo_burn, queue, utilization, tier_occupancy, tier_faults, stalls, "
    "drift, and the overall max — refreshed by GET /3/CloudHealth "
    "evaluations",
    fn=_pressure_series)


def evaluate_pressure(window_s=None) -> dict:
    """Compute this host's pressure document and cache it for the
    h2o3_pressure gauges. Every dimension is normalized so 1.0 means
    saturated (HPA external-metric shape: scale out when overall
    approaches 1)."""
    global _LAST_PRESSURE
    window = _rate_window_s() if window_s is None else float(window_s)
    dims: dict = {}
    detail: dict = {}
    # queue: global depth against the micro-batch bound, and the worst
    # tenant against its share cap; the fair gate's waiter count rides
    # the detail for the autoscaler's drain decision
    try:
        from h2o3_tpu_torch.serving import microbatch as _mb
        from h2o3_tpu_torch.serving import qos as _qos
        limit = _mb._queue_depth_limit()
        queued = _mb.BATCHER.queued_by_principal()
        depth = _mb.BATCHER._depth
        share_cap = _qos.tenant_share_cap(limit)
        q = depth / limit if limit > 0 else 0.0
        if share_cap > 0:
            for held in queued.values():
                q = max(q, held / share_cap)
        dims["queue"] = round(q, 4)
        detail["queue"] = {"depth": depth, "limit": limit,
                           "by_principal": queued,
                           "share_cap": share_cap,
                           "gate_depth": _qos.GATE.depth()}
    except Exception:   # noqa: BLE001 — a probe error zeroes one dimension
        pass
    # utilization: device-seconds accumulation rate over wall, per chip
    rate = device_rate(window)
    ndev = _device_count()
    dims["utilization"] = round(rate / ndev, 4)
    detail["device"] = {"device_seconds_rate": round(rate, 6),
                        "devices": ndev,
                        "device_seconds_total":
                            round(device_seconds_total(), 6),
                        "window_s": window}
    # SLO burn: fresh evaluation (like GET /3/Alerts), normalized so 1.0
    # is the fast-burn paging threshold
    try:
        from h2o3_tpu_torch.obs import slo as _slo
        alerts = _slo.ENGINE.evaluate()
        max_burn = max((b for a in alerts
                        for b in (a.get("burn") or {}).values()),
                       default=0.0)
        dims["slo_burn"] = round(max_burn / _SLO_PAGE_BURN, 4)
        detail["slo"] = {"max_burn": round(max_burn, 4),
                         "firing": [a["slo"] for a in alerts
                                    if a.get("firing")]}
    except Exception:   # noqa: BLE001
        pass
    # tier pager: HBM budget occupancy + fault rate since the previous
    # evaluation
    try:
        from h2o3_tpu_torch.core import tiering as _tiering
        stats = _tiering.PAGER.stats()
        tb = stats.get("tier_bytes") or {}
        hbm_budget = stats.get("hbm_budget") or 0
        hbm_bytes = max((v for k, v in tb.items()
                         if "hbm" in str(k).lower()
                         or "device" in str(k).lower()), default=0)
        dims["tier_occupancy"] = \
            round(hbm_bytes / hbm_budget, 4) if hbm_budget else 0.0
        now_m = time.monotonic()
        faults = float(stats.get("faults") or 0)
        with _LOCK:
            prev = _TIER_PREV[0]
            if prev is None:
                _TIER_PREV[0] = (now_m, faults)
            elif now_m - prev[0] >= _TIER_MIN_INTERVAL_S:
                _TIER_RATE[0] = max(0.0, (faults - prev[1])
                                    / (now_m - prev[0]))
                _TIER_PREV[0] = (now_m, faults)
            # a sub-floor re-evaluation reuses the last full-interval rate
            fault_rate = _TIER_RATE[0]
        dims["tier_faults"] = round(fault_rate / _TIER_FAULT_SATURATION, 4)
        detail["tier"] = {"stats": stats,
                          "fault_rate": round(fault_rate, 4)}
    except Exception:   # noqa: BLE001
        pass
    # watchdog: any currently-stalled operation saturates the dimension
    try:
        from h2o3_tpu_torch.obs import watchdog as _wd
        stalled = _wd.WATCHDOG.stalled()
        dims["stalls"] = 1.0 if stalled else 0.0
        detail["stalls"] = {"stalled": stalled,
                            "trips": len(_wd.WATCHDOG.trips())}
    except Exception:   # noqa: BLE001
        pass
    # model drift: worst monitored model's PSI/prediction drift against
    # its training baseline, saturated at H2O3_MODELMON_PSI_SAT — a
    # drifting fleet is a capacity problem for the RETRAIN pipeline even
    # when serving latency looks healthy
    try:
        from h2o3_tpu_torch.obs import modelmon as _mm
        _mm.evaluate()
        drift, ddetail = _mm.pressure()
        dims["drift"] = round(drift, 4)
        detail["drift"] = ddetail
    except Exception:   # noqa: BLE001
        pass
    epoch = 0
    try:
        from h2o3_tpu_torch.deploy import membership as _mbr
        epoch = _mbr.MEMBERSHIP.epoch
    except Exception:   # noqa: BLE001
        pass
    from h2o3_tpu_torch.obs import timeline as _tl
    doc = {"host": _tl.host_id(), "epoch": epoch,
           "overall": round(max(dims.values(), default=0.0), 4),
           "dimensions": dims, "detail": detail, "ts": time.time()}
    _LAST_PRESSURE = doc
    return doc


def merge_cloudhealth(snaps) -> dict:
    """Cluster merge of evaluate_pressure() documents: each dimension is
    the MAX across hosts (pressure is a weakest-link signal — one
    saturated host gates the cloud), per-host docs ride along."""
    docs = [s for s in snaps if isinstance(s, dict)]
    dims: dict = {}
    for d in docs:
        for k, v in (d.get("dimensions") or {}).items():
            dims[k] = max(dims.get(k, 0.0), float(v))
    return {"overall": round(max(dims.values(), default=0.0), 4),
            "dimensions": dims,
            "epoch": max((int(d.get("epoch") or 0) for d in docs),
                         default=0),
            "hosts": [{"host": d.get("host"),
                       "overall": d.get("overall", 0.0),
                       "dimensions": d.get("dimensions") or {},
                       "detail": d.get("detail") or {}} for d in docs]}


def last_pressure() -> dict:
    return _LAST_PRESSURE


def forget_model(key):
    """Model DELETE hygiene: drop the model's attribution state — ledger
    rows, the fold census slot, and every {model=…} series on the
    device-seconds counter — exactly once (Gauge.remove). Idempotent;
    never raises."""
    k = str(key)[:128]
    try:
        with _LOCK:
            for lk in [lk for lk in _LEDGER if lk[1] == k]:
                del _LEDGER[lk]
            _KNOWN_MODELS.discard(k)
        for row in MODEL_DEVICE_SECONDS._json():
            lbl = row.get("labels") or {}
            if lbl.get("model") == k:
                MODEL_DEVICE_SECONDS.remove(**lbl)
    except Exception:   # noqa: BLE001 — hygiene must not fail the DKV op
        pass


def reset():
    """Test isolation: drop the ledger, rate samples, model census,
    cached pressure, and the calling thread's recorder state."""
    global _LAST_PRESSURE
    with _LOCK:
        _LEDGER.clear()
        _TOTAL[0] = 0.0
        _RATE.clear()
        _KNOWN_MODELS.clear()
    _TIER_PREV[0] = None
    _TIER_RATE[0] = 0.0
    _LAST_PRESSURE = {}
    _TLS.stages = None
    _TLS.capture = None
    _TLS.metering = False
