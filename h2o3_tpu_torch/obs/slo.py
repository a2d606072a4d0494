"""Declarative SLOs of the port (h2o3_tpu/obs/slo.py), with multi-window
burn-rate alerting.

Specs (deploy/slo.json, pointed at by H2O3_SLO_FILE) declare objectives
over the registry's latency histograms — "99% of /3/Predictions requests
under 250ms" — and the engine evaluates them the Site Reliability
Workbook way (Beyer et al., ch. 5): the ERROR BUDGET is 1-objective, the
BURN RATE is the fraction of bad events over a trailing window divided
by the budget, and an alert fires only when BOTH a short and a long
window exceed the same burn factor — fast-burn pages fire in minutes
(14.4x over 5m AND 1h), slow burns surface in hours (6x over 30m AND 6h)
— so a single outlier scrape can't page and a slow leak can't hide.

The registry's histograms are cumulative since process start; windowed
rates come from the engine's own sample ring: every evaluate() appends
(timestamp, total, bad) per SLO and window deltas are taken against the
newest sample at least `window` old (the oldest available while history
is still shorter than the window — burn converges as the ring fills).

Outputs:
  * h2o3_slo_burn_rate{slo,window} gauges — the Grafana "SLO & alerts"
    row reads these;
  * h2o3_slo_alert_active{slo} + h2o3_slo_alert_transitions_total;
  * GET /3/Alerts (the JAX package's api/server; the port's REST server
    comes with the front-end item of ROADMAP.md §1) — specs, live burn
    rates, alert states, which `evaluate()` returns;
  * every firing/resolve transition is recorded as a `slo.alert`
    timeline span under its own trace id with a `sampled` attr, so the
    flight recorder retains it and the alert episode is itself a trace.

SLO spec fields (JSON object per SLO):
  name          unique id (required)
  kind          "" (infer latency/availability from threshold_ms) or
                "drift" — a model-drift SLI over the modelmon gauges
  metric        histogram name (default "h2o3_rest_request_seconds");
                for kind=drift a GAUGE name (default "h2o3_model_drift",
                also works against h2o3_model_prediction_drift /
                h2o3_model_generation_skew)
  route         regex matched against the series' route label ("" = all)
  model         drift SLOs: regex over the series' model label ("" = all)
  objective     good-event fraction target, e.g. 0.99 (required)
  threshold_ms  latency SLO: observations over this are bad; omit for an
                availability SLO (bad = series with a 5xx status label)
  threshold     drift SLO: gauge value (PSI/JS) above which an
                evaluation tick is bad (default 0.2)
  windows       [[short_s, long_s, burn_factor], ...] (default
                [[300, 3600, 14.4], [1800, 21600, 6.0]])

A drift SLI reads the modelmon gauges through the same sample ring as
every other SLI: the gauges are LEVELS, not event counts, so each
evaluation tick contributes one synthetic observation per matching
series (bad when the level exceeds `threshold`) to an engine-held
cumulative counter — the multi-window burn machinery then applies
unchanged, and a drifting model fires at GET /3/Alerts with a pinned
flight-recorder trace exactly like a latency breach.

Durability: the sample ring is periodically persisted to
`<ice_root>/obs/slo/samples-h<host>.json` and reloaded on start, so
multi-window burn HISTORY survives a process restart — the warm-up
coverage scaling then applies only to genuinely unseen history, not to
history the previous process already observed. Restored rings carry the
old process's cumulative totals; fresh totals (which restart at zero)
are rebased onto them so deltas stay monotone across the boundary.

`reset()` empties the process ENGINE and retires its evaluator thread.

Env surface:
  H2O3_SLO_FILE       path to the spec file (unset = engine idle)
  H2O3_SLO_EVAL_S     background evaluation period (default 30; 0 = only
                      evaluate on GET /3/Alerts)
  H2O3_SLO_PERSIST_S  min seconds between sample-ring persists
                      (default 30; 0 disables persistence)
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.utils.env import env_float, env_str

DEFAULT_WINDOWS = ((300.0, 3600.0, 14.4), (1800.0, 21600.0, 6.0))


def _window_label(seconds: float) -> str:
    s = int(seconds)
    if s % 86400 == 0:
        return f"{s // 86400}d"
    if s % 3600 == 0:
        return f"{s // 3600}h"
    if s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


class SLOSpec:
    def __init__(self, d: dict):
        self.name = str(d["name"])
        self.kind = str(d.get("kind") or "")
        if self.kind not in ("", "drift"):
            raise ValueError(f"slo {self.name}: unknown kind "
                             f"{self.kind!r} (expected '' or 'drift')")
        self.metric = str(d.get("metric") or (
            "h2o3_model_drift" if self.kind == "drift"
            else "h2o3_rest_request_seconds"))
        self.route = str(d.get("route") or "")
        # drift SLOs: scope to models whose key matches, and call a tick
        # bad when the drift gauge exceeds `threshold` (PSI/JS units)
        self.model = str(d.get("model") or "")
        self.threshold = float(d["threshold"]) if "threshold" in d \
            else (0.2 if self.kind == "drift" else None)
        # per-tenant SLOs (multi-tenant QoS): a `principal` regex scopes
        # the SLI to series whose principal label matches — point the
        # spec at h2o3_qos_request_seconds{principal,status} and the
        # burn-rate engine answers "is THIS tenant inside its SLO"
        self.principal = str(d.get("principal") or "")
        self.objective = float(d["objective"])
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"slo {self.name}: objective must be in "
                             f"(0,1), got {self.objective}")
        self.threshold_ms = d.get("threshold_ms")
        if self.threshold_ms is not None:
            self.threshold_ms = float(self.threshold_ms)
        self.windows = tuple(
            (float(w[0]), float(w[1]), float(w[2]))
            for w in (d.get("windows") or DEFAULT_WINDOWS))
        self._route_re = re.compile(self.route) if self.route else None
        self._principal_re = re.compile(self.principal) \
            if self.principal else None
        self._model_re = re.compile(self.model) if self.model else None

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def to_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "route": self.route, "principal": self.principal,
                "model": self.model,
                "objective": self.objective,
                "threshold_ms": self.threshold_ms,
                "threshold": self.threshold,
                "windows": [list(w) for w in self.windows],
                "kind": self.kind or
                        ("latency" if self.threshold_ms is not None
                         else "availability")}


def load_specs(path: str) -> list:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if isinstance(data, dict):
        data = data.get("slos") or []
    specs = [SLOSpec(d) for d in data]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate slo names in {path}: {names}")
    return specs


def _alert_span(spec: SLOSpec, state: str, burn: float, window: str,
                trace_id: str):
    """One firing/resolve transition as a (root) timeline span under the
    alert episode's own trace id: `sampled` forces the flight recorder to
    retain it, so GET /3/Trace/{episode} replays the alert's history."""
    from h2o3_tpu_torch.obs import tracing as _tracing
    from h2o3_tpu_torch.obs import timeline as _timeline
    with _tracing.trace(trace_id):
        with _timeline.span("slo.alert", slo=spec.name, state=state,
                            burn=round(burn, 3), window=window,
                            sampled=1) as sp:
            # evaluate() usually runs inside a GET /3/Alerts request span:
            # detach, or the episode's root would point into the polling
            # request's (unrelated) trace and never close the episode
            sp.parent_id = 0


class SLOEngine:
    """Spec store + window sampler + alert state machine. One instance
    per process (module-level ENGINE); tests construct their own with an
    isolated registry."""

    def __init__(self, specs=None, registry=None):
        self._lock = make_lock("slo")
        self._registry = registry or _om.REGISTRY
        self._specs: list = list(specs or [])
        self._samples: dict = {}    # name -> deque[(ts, total, bad)]
        self._state: dict = {}      # name -> alert state dict
        self._drift_counts: dict = {}   # name -> [ticks, bad_ticks]
        self._offset: dict = {}     # name -> (total0, bad0): restored
        #                             history's final cumulative counts,
        #                             added to fresh post-restart totals
        self._last_persist = 0.0
        self._thread = None
        # output metrics live on THIS engine's registry: a scratch
        # engine over an isolated registry (tests) must not publish
        # into — or configure()-clear — the process ENGINE's series
        with self._lock:
            self._burn = self._registry.gauge(
                "h2o3_slo_burn_rate",
                "error-budget burn rate per SLO and trailing window "
                "(1.0 = burning exactly the budget; a fast-burn alert "
                "fires at 14.4x over 5m+1h)")
            self._active = self._registry.gauge(
                "h2o3_slo_alert_active",
                "1 while the SLO's multi-window burn-rate alert is "
                "firing")
            self._transitions = self._registry.counter(
                "h2o3_slo_alert_transitions_total",
                "SLO alert state transitions, labeled "
                "state=firing|resolved")

    # ---- configuration --------------------------------------------------
    def configure(self, specs, registry=None):
        with self._lock:
            self._specs = list(specs or [])
            if registry is not None and registry is not self._registry:
                self._registry = registry
                self._burn = registry.gauge(self._burn.name,
                                            self._burn.help)
                self._active = registry.gauge(self._active.name,
                                              self._active.help)
                self._transitions = registry.counter(
                    self._transitions.name, self._transitions.help)
            self._samples.clear()
            self._state.clear()
            self._offset.clear()
            self._drift_counts.clear()
            self._burn.clear()
            self._active.clear()

    def load(self, path: str):
        self.configure(load_specs(path))

    def specs(self) -> list:
        with self._lock:
            return list(self._specs)

    # ---- sample-ring durability -----------------------------------------
    @staticmethod
    def persist_path() -> str:
        """Per-host state file under the ice root (two processes sharing
        an ice root in tests must not clobber each other's history)."""
        from h2o3_tpu_torch.io import spill as _spill
        from h2o3_tpu_torch.obs import timeline as _tl
        return os.path.join(_spill.get_ice_root(), "obs", "slo",
                            f"samples-h{_tl.host_id()}.json")

    @staticmethod
    def _persist_min_s() -> float:
        return env_float("H2O3_SLO_PERSIST_S", 30.0)

    def persist(self):
        """Write the sample rings (and alert states) atomically. The
        snapshot is taken under the lock; the file write happens outside
        it (no disk I/O while locked)."""
        path = self.persist_path()
        with self._lock:
            state = {
                "version": 1,
                "saved_at": time.time(),
                "samples": {name: [list(s) for s in ring]
                            for name, ring in self._samples.items()},
                "firing": {name: {k: v for k, v in st.items()
                                  if k in ("firing", "since", "trace",
                                           "window")}
                           for name, st in self._state.items()},
            }
        tmp = path + f".tmp{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(state, fh)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def restore(self) -> bool:
        """Reload persisted burn history for the CONFIGURED specs and
        rebase the registry's CURRENT totals onto each ring's final
        cumulative counts, so the first post-restore delta is the real
        traffic since the save — not a negative (fresh process) and not
        a double count (an in-process re-install over a registry that
        already holds live totals). Returns True when any history was
        restored."""
        path = self.persist_path()
        try:
            with open(path, encoding="utf-8") as fh:
                state = json.load(fh)
        except (OSError, json.JSONDecodeError, ValueError):
            return False
        got = False
        with self._lock:
            by_name = {s.name: s for s in self._specs}
            for name, samples in (state.get("samples") or {}).items():
                spec = by_name.get(name)
                if spec is None or not samples:
                    continue
                ring = deque((float(t), float(tot), float(bad))
                             for t, tot, bad in samples)
                self._samples[name] = ring
                # offset = persisted_last - current: future totals read
                # persisted_last + (traffic since this restore), whether
                # the registry restarted at zero or kept counting
                cur_total, cur_bad = self._totals(spec)
                self._offset[name] = (ring[-1][1] - cur_total,
                                      ring[-1][2] - cur_bad)
                st = self._state.setdefault(
                    name, {"slo": name, "firing": False, "since": None,
                           "trace": None, "burn": {}, "window": None})
                st.update({k: v for k, v in
                           (state.get("firing") or {}).get(name, {}).items()
                           if k in ("firing", "since", "trace", "window")})
                got = True
        return got

    # ---- SLI extraction -------------------------------------------------
    def _drift_totals(self, spec: SLOSpec):
        """Cumulative (ticks, bad_ticks) for a drift SLI. The drift
        metric is a gauge — a LEVEL, not an event stream — so each call
        (one per evaluate) counts one synthetic observation per matching
        {model=…} series, bad when the level exceeds spec.threshold, and
        accumulates them engine-side. The counts are monotone, so the
        sample ring and burn-rate deltas apply unchanged."""
        # h2o3-ok: R003 every caller (_totals, from evaluate and restore) holds self._lock
        ent = self._drift_counts.setdefault(spec.name, [0, 0])
        g = self._registry.get(spec.metric)
        if isinstance(g, _om.Gauge):
            thr = spec.threshold if spec.threshold is not None else 0.2
            for lkey, val in g._collect():
                labels = dict(lkey)
                if spec._model_re is not None and \
                        not spec._model_re.search(labels.get("model", "")):
                    continue
                ent[0] += 1
                if val > thr:
                    ent[1] += 1
        return ent[0], ent[1]

    def _totals(self, spec: SLOSpec):
        """(total, bad) cumulative event counts for one SLO, summed over
        the matching histogram series. Latency SLOs count observations
        over threshold_ms as bad via the cumulative buckets (a threshold
        between bucket bounds rounds the GOOD side down — conservative);
        availability SLOs count series with a 5xx status label; drift
        SLOs tick against the modelmon gauges (_drift_totals)."""
        if spec.kind == "drift":
            return self._drift_totals(spec)
        h = self._registry.get(spec.metric)
        if not isinstance(h, _om.Histogram):
            return 0, 0
        total = bad = 0
        thr = None if spec.threshold_ms is None \
            else spec.threshold_ms / 1000.0
        for labels, snap in h.series_snapshots():
            if spec._route_re is not None and \
                    not spec._route_re.search(labels.get("route", "")):
                continue
            if spec._principal_re is not None and \
                    not spec._principal_re.search(
                        labels.get("principal", "")):
                continue
            c = snap["count"]
            total += c
            if thr is not None:
                good = sum(cnt for ub, cnt in zip(h.buckets, snap["counts"])
                           if ub <= thr * (1 + 1e-9))
                bad += c - good
            elif str(labels.get("status", "")).startswith("5"):
                bad += c
        return total, bad

    def _burn_rate(self, spec: SLOSpec, ring, window_s: float, now: float):
        """Burn rate over one trailing window from the sample ring: the
        bad fraction of events since the newest sample at least
        `window_s` old, over the error budget. While history is still
        shorter than the window the unobserved remainder is assumed
        CLEAN traffic at the observed rate (burn scales by
        coverage/window): without that, every window clamps to the same
        short history after a restart, short == long burn, and the
        multi-window guard ("one outlier scrape never pages") is
        defeated exactly when deploy rollouts make blips likeliest."""
        if not ring:
            return 0.0
        cur_ts, cur_total, cur_bad = ring[-1]
        base = ring[0]
        for s in ring:
            if s[0] <= now - window_s:
                base = s
            else:
                break
        d_total = cur_total - base[1]
        d_bad = cur_bad - base[2]
        if d_total <= 0:
            return 0.0
        burn = (d_bad / d_total) / spec.budget
        coverage = now - ring[0][0]
        if coverage < window_s:
            burn *= max(coverage, 0.0) / window_s
        return burn

    # ---- evaluation -----------------------------------------------------
    def evaluate(self, now: float | None = None) -> list:
        """Sample every SLO, publish burn-rate gauges, advance the alert
        state machine. Returns the alert list (the GET /3/Alerts body)."""
        now = time.time() if now is None else now
        transitions = []
        with self._lock:
            for spec in self._specs:
                total, bad = self._totals(spec)
                off = self._offset.get(spec.name)
                if off:
                    # restored history: fresh totals restart at zero —
                    # rebase onto the persisted cumulative counts so the
                    # cross-restart delta is traffic, not a negative
                    total += off[0]
                    bad += off[1]
                ring = self._samples.setdefault(spec.name, deque())
                max_w = max((w[1] for w in spec.windows),
                            default=3600.0)
                # bound the ring by COUNT as well as time: persisted
                # samples keep a minimum spacing, so a dashboard polling
                # /3/Alerts every second can't grow the ring (or the
                # per-evaluate window scan) past ~4096 entries — the
                # newest sample is instead updated in place
                spacing = max(1.0, 1.5 * max_w / 4096.0)
                if len(ring) >= 2 and now - ring[-2][0] < spacing:
                    ring[-1] = (now, total, bad)
                else:
                    ring.append((now, total, bad))
                while len(ring) > 2 and ring[1][0] < now - 1.5 * max_w:
                    ring.popleft()
                st = self._state.setdefault(
                    spec.name, {"slo": spec.name, "firing": False,
                                "since": None, "trace": None,
                                "burn": {}, "window": None})
                firing_pair = None
                short_ok = True
                burns = {}
                for short_s, long_s, factor in spec.windows:
                    b_short = self._burn_rate(spec, ring, short_s, now)
                    b_long = self._burn_rate(spec, ring, long_s, now)
                    wl_s = _window_label(short_s)
                    wl_l = _window_label(long_s)
                    burns[wl_s] = b_short
                    burns[wl_l] = b_long
                    self._burn.set(b_short, slo=spec.name, window=wl_s)
                    self._burn.set(b_long, slo=spec.name, window=wl_l)
                    if b_short > factor and b_long > factor:
                        firing_pair = (wl_s, wl_l, factor,
                                       max(b_short, b_long))
                    if b_short > factor:
                        short_ok = False
                st["burn"] = {k: round(v, 4) for k, v in burns.items()}
                if not st["firing"] and firing_pair is not None:
                    import secrets
                    st["firing"] = True
                    st["since"] = now
                    st["trace"] = f"slo-{spec.name}-{secrets.token_hex(4)}"
                    st["window"] = f"{firing_pair[0]}+{firing_pair[1]}"
                    transitions.append((spec, "firing", firing_pair[3],
                                        st["window"], st["trace"]))
                elif st["firing"] and firing_pair is None and short_ok:
                    st["firing"] = False
                    transitions.append((spec, "resolved",
                                        max(burns.values(), default=0.0),
                                        st["window"] or "",
                                        st["trace"] or ""))
                self._active.set(1.0 if st["firing"] else 0.0, slo=spec.name)
            alerts = [dict(st) for st in self._state.values()]
        # transitions emit OUTSIDE the engine lock: span recording takes
        # the timeline ring + recorder locks
        for spec, state, burn, window, trace_id in transitions:
            self._transitions.inc(slo=spec.name, state=state)
            _alert_span(spec, state, burn, window, trace_id)
        # periodic durability (gated, outside the lock): burn history
        # survives a restart instead of resetting with the process
        min_s = self._persist_min_s()
        if self._specs and min_s > 0 and now - self._last_persist >= min_s:
            # h2o3-ok: R003 _last_persist is the evaluator thread's persist rate-limit stamp; reset() zeroes it under the lock after retiring the thread, and a race costs at most one persist early or late
            self._last_persist = now
            self.persist()
        return alerts

    def alerts(self) -> list:
        with self._lock:
            return [dict(st) for st in self._state.values()]

    # ---- background evaluation ------------------------------------------
    def start(self):
        """Start the periodic evaluator (idempotent; daemon thread). No
        specs or H2O3_SLO_EVAL_S=0 → nothing to do."""
        period = env_float("H2O3_SLO_EVAL_S", 30.0)
        if not self._specs or period <= 0:
            return None
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self._thread
            t = threading.Thread(target=self._run, args=(period,),
                                 daemon=True, name="h2o3-slo-eval")
            self._thread = t
        t.start()
        return t

    def _run(self, period: float):
        while True:
            time.sleep(period)
            if self._thread is not threading.current_thread():
                return              # reconfigured: a newer loop owns this
            try:
                self.evaluate()
            except Exception:   # noqa: BLE001 — the evaluator must survive
                import traceback
                traceback.print_exc()


    def reset(self):
        """Drop every spec, sample and alert state and retire the
        evaluator thread (it exits at its next wake, no longer owning
        the loop)."""
        self.configure([])
        with self._lock:
            self._thread = None
            self._last_persist = 0.0


ENGINE = SLOEngine()


def reset():
    """Test isolation: an idle process ENGINE, no evaluator thread."""
    ENGINE.reset()


def install_from_env():
    """Server-start hook: load H2O3_SLO_FILE into the process ENGINE and
    start the background evaluator. Unset env — or a pointed-at file
    that is absent (the k8s ConfigMap mount is optional) — leaves the
    engine idle; the /3/Alerts route still answers with an empty spec
    list. A file that EXISTS but fails to parse raises: a deployment
    that ships broken SLOs should fail loudly at start, not alert on
    nothing."""
    path = env_str("H2O3_SLO_FILE", "")
    # isfile, not exists: with an absent optional ConfigMap the mount
    # materializes as an empty directory (or the pointed-at file simply
    # never appears), and a directory path must idle, not raise
    if not path or not os.path.isfile(path):
        return None
    ENGINE.load(path)
    # reload persisted burn history (multi-window history survives the
    # restart; warm-up scaling then covers only genuinely unseen time)
    ENGINE.restore()
    return ENGINE.start()
