"""Metrics registry of the port (h2o3_tpu/obs/metrics.py) — water/util/WaterMeter*
rebuilt as a Prometheus-style process registry.

Counters, gauges and fixed-bucket histograms with label support, the
Prometheus 0.0.4 and OpenMetrics 1.0 text, the JSON snapshot and the
cluster merge of snapshots are the JAX package's. The runtime gauges read
the card through torch: `h2o3_device_memory_bytes` from
`torch.cuda.memory_stats` (bytes_in_use is `torch.cuda.memory_allocated`),
`h2o3_build_info` carries the torch and CUDA versions and the card's
name, and in place of the JAX package's XLA compile counters the scorer
cache counts its CUDA graph captures (`h2o3_cuda_graph_captures_total`,
and their seconds in `h2o3_cuda_graph_capture_seconds`).
"""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, Optional

# Default latency buckets (seconds): sub-ms dispatches up to multi-minute
# jobs — one decade finer at the low end than Prometheus' defaults because
# device-program enqueues sit in the 0.1-10ms range.
DEFAULT_BUCKETS = (0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: tuple, extra: tuple = ()) -> str:
    items = list(key) + list(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def _fmt_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 2 ** 53 else repr(f)


class _Metric:
    kind = ""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict = {}

    def clear(self):
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)

    def remove(self, **labels):
        """Drop one label series — the per-entity hygiene discipline
        (see Gauge.remove): a deleted model's counters must leave
        /metrics entirely, not linger as frozen series. Scrapers see a
        counter reset, which Prometheus-style rate() already handles."""
        with self._lock:
            self._series.pop(_label_key(labels), None)

    def _expose(self) -> list:
        with self._lock:
            items = sorted(self._series.items())
        return [f"{self.name}{_fmt_labels(k)} {_fmt_num(v)}"
                for k, v in items]

    def _json(self):
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._series.items())]


class Gauge(_Metric):
    """Settable gauge, or a callback gauge when `fn` is given: fn() returns
    a scalar or a {labels_dict: value}-style list of (labels, value) pairs,
    evaluated at scrape time (WaterMeter's read-on-request semantics)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable] = None):
        super().__init__(name, help)
        self._fn = fn

    def set(self, value: float, **labels):
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def remove(self, **labels):
        """Drop one label series — for per-entity gauges (per-model HBM
        occupancy) whose entity was deleted: a freed model must leave
        /metrics entirely, not linger as a forever-zero series."""
        with self._lock:
            self._series.pop(_label_key(labels), None)

    def value(self, **labels) -> float:
        for k, v in self._collect():
            if k == _label_key(labels):
                return v
        return 0.0

    def _collect(self) -> list:
        if self._fn is not None:
            try:
                out = self._fn()
            except Exception:   # noqa: BLE001 — a dead probe must not 500 /metrics
                # the scrape stays alive (this gauge just emits no
                # series), but the failure is COUNTED — a silently dead
                # probe looks exactly like a healthy zero otherwise
                _note_collect_error(self.name)
                return []
            if isinstance(out, (int, float)):
                return [((), float(out))]
            return [(_label_key(dict(lbl)), float(v)) for lbl, v in out]
        with self._lock:
            return sorted(self._series.items())

    def _expose(self) -> list:
        return [f"{self.name}{_fmt_labels(k)} {_fmt_num(v)}"
                for k, v in self._collect()]

    def _json(self):
        return [{"labels": dict(k), "value": v} for k, v in self._collect()]


class Histogram(_Metric):
    """Fixed-bucket cumulative histogram (Prometheus semantics: _bucket
    series are cumulative counts with a +Inf catch-all, plus _sum/_count)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels):
        """Record one observation. `exemplar` is NOT a label: it is an
        OpenMetrics exemplar — typically the observing request's trace id
        — remembered per bucket and emitted by openmetrics_text() so a
        latency spike on a dashboard clicks through to a stored trace."""
        k = _label_key(labels)
        v = float(value)
        with self._lock:
            st = self._series.get(k)
            if st is None:
                st = self._series[k] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    st["counts"][i] += 1
                    break
            else:
                i = len(self.buckets)
                st["counts"][-1] += 1
            st["sum"] += v
            st["count"] += 1
            if exemplar:
                # last-write-wins per bucket: the freshest exemplar is
                # the most likely to still be in the flight recorder
                st.setdefault("exemplars", {})[i] = (
                    str(exemplar), v, _time.time())

    def time(self, **labels):
        """Context manager: observe the block's wall time in seconds."""
        import contextlib
        import time as _time

        @contextlib.contextmanager
        def _cm():
            t0 = _time.perf_counter()
            try:
                yield
            finally:
                self.observe(_time.perf_counter() - t0, **labels)
        return _cm()

    def snapshot(self, **labels) -> dict:
        with self._lock:
            st = self._series.get(_label_key(labels))
            if st is None:
                return {"sum": 0.0, "count": 0,
                        "counts": [0] * (len(self.buckets) + 1)}
            return {"sum": st["sum"], "count": st["count"],
                    "counts": list(st["counts"])}

    def series_snapshots(self) -> list:
        """[(labels_dict, {"sum","count","counts"})] for every live
        series — the SLO engine's window sampler walks this."""
        with self._lock:
            return [(dict(k), {"sum": s["sum"], "count": s["count"],
                               "counts": list(s["counts"])})
                    for k, s in sorted(self._series.items())]

    def _expose(self, exemplars: bool = False) -> list:
        """Cumulative-bucket text exposition; with `exemplars` (the
        OpenMetrics renderer) each bucket a stored exemplar covers gets
        `... # {trace_id="<id>"} <value> <unix_ts>` appended."""
        with self._lock:
            items = sorted((k, {"counts": list(s["counts"]),
                                "sum": s["sum"], "count": s["count"],
                                "ex": dict(s.get("exemplars") or {})
                                if exemplars else {}})
                           for k, s in self._series.items())
        lines = []
        for k, st in items:
            cum = 0
            bounds = [(_fmt_num(ub), c)
                      for ub, c in zip(self.buckets, st["counts"])]
            bounds.append(("+Inf", st["counts"][-1]))
            for i, (le, c) in enumerate(bounds):
                cum += c
                line = (f"{self.name}_bucket"
                        f"{_fmt_labels(k, (('le', le),))} {cum}")
                ex = st["ex"].get(i)
                if ex is not None:
                    tid, v, ts = ex
                    line += (f' # {{trace_id="{_escape(tid)}"}} '
                             f"{_fmt_num(v)} {ts:.3f}")
                lines.append(line)
            lines.append(f"{self.name}_sum{_fmt_labels(k)}"
                         f" {_fmt_num(st['sum'])}")
            lines.append(f"{self.name}_count{_fmt_labels(k)} {st['count']}")
        return lines

    def _json(self):
        bounds = [_fmt_num(b) for b in self.buckets] + ["+Inf"]
        with self._lock:
            out = []
            for k, s in sorted(self._series.items()):
                d = {"labels": dict(k), "sum": s["sum"],
                     "count": s["count"],
                     "buckets": dict(zip(bounds, s["counts"]))}
                ex = s.get("exemplars")
                if ex:
                    # exemplars ride the JSON snapshot so the CLUSTER
                    # merge can re-emit them host-tagged
                    d["exemplars"] = [
                        {"le": bounds[i], "trace_id": tid,
                         "value": v, "ts": ts}
                        for i, (tid, v, ts) in sorted(ex.items())]
                out.append(d)
            return out


class MetricsRegistry:
    def __init__(self):
        # lockdep-instrumented (lock class "metrics.registry"): the
        # registry nests under every subsystem that declares or scrapes.
        # Local import — lockdep's own counters import THIS module, so a
        # top-level import would cycle; per-series _Metric._lock objects
        # stay plain threading.Lock (leaf locks on the counter hot path).
        from h2o3_tpu_torch.analysis.lockdep import make_lock
        self._lock = make_lock("metrics.registry")
        self._metrics: dict[str, _Metric] = {}

    def _get_or_make(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(f"metric {name!r} already registered "
                                    f"as {m.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(Counter, name, help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable] = None) -> Gauge:
        return self._get_or_make(Gauge, name, help, fn=fn)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._get_or_make(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str):
        with self._lock:
            self._metrics.pop(name, None)

    def metrics(self) -> list:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    # ---- exposition -----------------------------------------------------
    def prometheus_text(self) -> str:
        """Text exposition format 0.0.4 (the GET /metrics body)."""
        out = []
        for m in self.metrics():
            out.append(f"# HELP {m.name} {_escape(m.help)}")
            out.append(f"# TYPE {m.name} {m.kind}")
            out.extend(m._expose())
        return "\n".join(out) + "\n"

    def openmetrics_text(self) -> str:
        """OpenMetrics 1.0 exposition — what Prometheus negotiates (via
        Accept) when --enable-feature=exemplar-storage wants exemplars.
        Differences from 0.0.4 that matter here: counter families drop
        the _total suffix in metadata (samples keep it), histogram
        _bucket samples may carry `# {trace_id="..."} value ts`
        exemplars, and the body terminates with `# EOF`."""
        out = []
        for m in self.metrics():
            family = m.name
            if m.kind == "counter" and family.endswith("_total"):
                family = family[: -len("_total")]
            out.append(f"# HELP {family} {_escape(m.help)}")
            out.append(f"# TYPE {family} {m.kind}")
            if isinstance(m, Histogram):
                out.extend(m._expose(exemplars=True))
            else:
                out.extend(m._expose())
        out.append("# EOF")
        return "\n".join(out) + "\n"

    def to_dict(self) -> dict:
        """JSON exposition (the GET /3/WaterMeter body)."""
        return {m.name: {"kind": m.kind, "help": m.help,
                         "series": m._json()}
                for m in self.metrics()}


REGISTRY = MetricsRegistry()

COLLECT_ERRORS = REGISTRY.counter(
    "h2o3_metric_collect_errors_total",
    "gauge callback exceptions swallowed during a scrape (the scrape "
    "stays alive; the failing gauge emits no series)")


def _note_collect_error(gauge_name: str):
    """Count a gauge callback exception (Gauge._collect swallowed it so
    the scrape survives). A function, not an inline emit: Gauge is
    defined before the module-level REGISTRY/COLLECT_ERRORS exist."""
    COLLECT_ERRORS.inc(metric=gauge_name)


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "", fn: Optional[Callable] = None) -> Gauge:
    return REGISTRY.gauge(name, help, fn=fn)


def histogram(name: str, help: str = "", buckets=None) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


# ---------------------------------------------------------------------------
# Cluster metrics federation. Workers ship REGISTRY.to_dict()
# snapshots over the replay channel (deploy/multihost._collect_local); the
# coordinator merges them here with a per-host `host=` label. Counters and
# histograms stay summable downstream (Prometheus `sum without (host)`);
# gauges stay per-host by construction — HBM on host 2 is not HBM on
# host 0. A host that outwaits the collect deadline is simply absent from
# the merge, counted in h2o3_cluster_scrape_timeouts_total by the caller.
CLUSTER_SCRAPE_TIMEOUTS = REGISTRY.counter(
    "h2o3_cluster_scrape_timeouts_total",
    "hosts absent from a cluster-scope metrics scrape — they outwaited "
    "the collect deadline (H2O3_OBS_COLLECT_TIMEOUT_S) or answered with "
    "an error; their series are missing from that merge")


def merge_cluster_snapshots(snapshots: list) -> dict:
    """[(host, REGISTRY.to_dict()-shaped dict)] → one merged dict of the
    same shape, every series labeled host=<id>. Kind/help come from the
    first host that declares the metric (hosts run the same code, so
    drift here would be a deploy skew, not a merge concern)."""
    merged: dict = {}
    for host, snap in snapshots:
        for name, m in (snap or {}).items():
            dst = merged.setdefault(name, {"kind": m.get("kind", "gauge"),
                                           "help": m.get("help", ""),
                                           "series": []})
            for s in m.get("series") or []:
                s2 = dict(s)
                s2["labels"] = dict(s.get("labels") or {}, host=str(host))
                if s.get("exemplars"):
                    # host-tag each exemplar too: the trace id resolves
                    # at GET /3/Trace/{id} on the coordinator either
                    # way, but Grafana shows WHICH host observed it
                    s2["exemplars"] = [dict(e, host=str(host))
                                       for e in s["exemplars"]]
                dst["series"].append(s2)
    return merged


def _exemplar_suffix(exemplars: list, le: str) -> str:
    """OpenMetrics exemplar suffix for one merged bucket line, or ""."""
    for e in exemplars or ():
        if e.get("le") == le and e.get("trace_id"):
            lbls = f'trace_id="{_escape(str(e["trace_id"]))}"'
            if e.get("host") is not None:
                lbls += f',host="{_escape(str(e["host"]))}"'
            return (f" # {{{lbls}}} {_fmt_num(e.get('value', 0.0))}"
                    f" {float(e.get('ts', 0.0)):.3f}")
    return ""


def _render_series(name: str, kind: str, series: list,
                   exemplars: bool = False) -> list:
    """Exposition lines for one metric's merged JSON series (the
    registry's _expose over live objects, re-done over snapshots that
    crossed the wire as JSON). With `exemplars` (the cluster OpenMetrics
    renderer) histogram bucket lines re-emit the host-tagged exemplars
    the snapshots carried."""
    lines = []
    for s in series:
        key = _label_key(s.get("labels") or {})
        ex = s.get("exemplars") if exemplars else None
        if kind == "histogram":
            buckets = s.get("buckets") or {}
            cum = 0
            for ub, c in buckets.items():
                if ub == "+Inf":
                    continue
                cum += int(c)
                lines.append(f"{name}_bucket"
                             f"{_fmt_labels(key, (('le', ub),))} {cum}"
                             + _exemplar_suffix(ex, ub))
            cum += int(buckets.get("+Inf", 0))
            lines.append(f"{name}_bucket"
                         f"{_fmt_labels(key, (('le', '+Inf'),))} {cum}"
                         + _exemplar_suffix(ex, "+Inf"))
            lines.append(f"{name}_sum{_fmt_labels(key)}"
                         f" {_fmt_num(s.get('sum', 0.0))}")
            lines.append(f"{name}_count{_fmt_labels(key)}"
                         f" {int(s.get('count', 0))}")
        else:
            lines.append(f"{name}{_fmt_labels(key)}"
                         f" {_fmt_num(s.get('value', 0.0))}")
    return lines


def cluster_prometheus_text(snapshots: list) -> str:
    """Text exposition 0.0.4 of the merged cluster view (the
    GET /metrics?scope=cluster body)."""
    merged = merge_cluster_snapshots(snapshots)
    out = []
    for name in sorted(merged):
        m = merged[name]
        out.append(f"# HELP {name} {_escape(m['help'])}")
        out.append(f"# TYPE {name} {m['kind']}")
        out.extend(_render_series(name, m["kind"], m["series"]))
    return "\n".join(out) + "\n"


def cluster_openmetrics_text(snapshots: list) -> str:
    """OpenMetrics 1.0 exposition of the merged cluster view — the
    GET /metrics?scope=cluster body when the scraper negotiates
    OpenMetrics: same merge as cluster_prometheus_text, but histogram
    buckets keep their (host-tagged) exemplars so Grafana click-through
    works on the federated scrape too."""
    merged = merge_cluster_snapshots(snapshots)
    out = []
    for name in sorted(merged):
        m = merged[name]
        family = name
        if m["kind"] == "counter" and family.endswith("_total"):
            family = family[: -len("_total")]
        out.append(f"# HELP {family} {_escape(m['help'])}")
        out.append(f"# TYPE {family} {m['kind']}")
        out.extend(_render_series(name, m["kind"], m["series"],
                                  exemplars=True))
    out.append("# EOF")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Runtime gauges: device memory through torch, DKV census, graph captures.
def _device_memory_series():
    """Per-card allocator bytes; no series until CUDA is initialised (a
    scrape never initialises it)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    out = []
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        if not stats:
            continue
        lbl = {"device": str(d)}
        out.append((dict(lbl, kind="bytes_in_use"),
                    stats.get("allocated_bytes.all.current", 0)))
        out.append((dict(lbl, kind="peak_bytes_in_use"),
                    stats.get("allocated_bytes.all.peak", 0)))
        out.append((dict(lbl, kind="bytes_reserved"),
                    stats.get("reserved_bytes.all.current", 0)))
        out.append((dict(lbl, kind="bytes_limit"),
                    torch.cuda.get_device_properties(d).total_memory))
    return out


def _dkv_series():
    from h2o3_tpu_torch.core.kvstore import DKV
    st = DKV.stats()
    return [({"what": "keys"}, st["keys"]),
            ({"what": "frames"}, st["frames"]),
            ({"what": "frame_bytes"}, st["frame_bytes"]),
            ({"what": "write_locked"}, st["write_locked"])]


def _capture_series():
    """The graph-capture counter and histogram (the port's counterpart of
    the JAX package's XLA compile counters), fed by the scorer cache."""
    return (counter("h2o3_cuda_graph_captures_total",
                    "CUDA graph captures of serving scorer programs (one "
                    "per row bucket, and one more after each re-placement "
                    "of the model's params)"),
            histogram("h2o3_cuda_graph_capture_seconds",
                      "wall time of one scorer program's warm-up runs and "
                      "CUDA graph capture"))


def graph_capture_count() -> float:
    """Process-wide count of CUDA graph captures — the serving fast
    path's regression metric (a warm bucket adds zero)."""
    m = REGISTRY.get("h2o3_cuda_graph_captures_total")
    return m.value() if m is not None else 0.0


_BUILD_INFO = None


def _build_info_series():
    """h2o3_build_info callback: the identity labels are immutable for
    the process lifetime, so they resolve once, at the first scrape."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        import torch
        import h2o3_tpu_torch as _pkg
        if torch.cuda.is_available():
            backend, card = "cuda", torch.cuda.get_device_name(0)
        else:
            backend, card = "cpu", "none"
        _BUILD_INFO = ({"version": str(getattr(_pkg, "__version__", "0")),
                        "backend": backend,
                        "torch": str(torch.__version__),
                        "cuda": str(torch.version.cuda or "none"),
                        "device": card}, 1.0)
    return [_BUILD_INFO]


def install_runtime_gauges():
    """Register the default runtime gauges (idempotent)."""
    gauge("h2o3_device_memory_bytes",
          "per-card allocator bytes from torch.cuda.memory_stats "
          "(bytes_in_use = torch.cuda.memory_allocated)",
          fn=_device_memory_series)
    gauge("h2o3_dkv_objects",
          "DKV registry census: live keys, frames, frame bytes",
          fn=_dkv_series)
    gauge("h2o3_build_info",
          "build/runtime identity info-gauge (value always 1): package "
          "version, backend, torch and CUDA versions and the card's name",
          fn=_build_info_series)
    _capture_series()


# Registered at import: the registry must answer a scrape even if the
# server never called install explicitly (tests, notebooks).
install_runtime_gauges()
