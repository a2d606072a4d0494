"""Span timeline of the port (h2o3_tpu/obs/timeline.py) — water.TimeLine
rebuilt as a ring of timed spans.

The unit of "what happened" is a timed SPAN (a job phase, a tree level, an
IRLSM iteration), nested via a per-thread stack so a model build shows as
a call tree. The ring holds COMPLETED spans (recorded at exit);
`snapshot()` is the per-host view. Spans are host-clock spans: a span
around asynchronous card work can close before the card has finished it,
exactly as in the JAX package, and no span synchronises the stream.

Profiler bridge: when H2O3_OBS_TRACE_DIR is set and a span's name starts
with H2O3_OBS_TRACE_SPAN, the span also runs a `torch.profiler` capture
(CPU and, where there is a card, CUDA activity) and writes it as a Chrome
trace `<dir>/<span>-p<pid>-<n>.json` at the span's end.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import random
import threading
import time
from dataclasses import dataclass, field
from collections import deque

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.utils import env as _env
from h2o3_tpu_torch.obs import tracing as _tracing


def _dropped_counter():
    """Ring-overflow counter, declared lazily: the flight recorder (and
    through it the metrics registry) imports this module, so a top-level
    metrics import here would cycle."""
    from h2o3_tpu_torch.obs import metrics as _om
    return _om.counter(
        "h2o3_timeline_dropped_spans_total",
        "completed spans pushed out of the bounded timeline ring by "
        "overflow (H2O3_OBS_TIMELINE_CAPACITY) — under load the ring "
        "forgets; the flight recorder (obs/recorder) is the durable tier")


def host_id() -> int:
    """This process' rank in the cloud. Env-derived (the multihost
    bootstrap wires H2O3_PROCESS_ID via utils.env.process_id) so reading
    it never initializes the JAX backend."""
    return _env.process_id()


@dataclass
class Span:
    name: str
    t_start: float
    span_id: int
    parent_id: int = 0           # 0 = root (no parent)
    t_end: float | None = None
    host: int = 0
    attrs: dict = field(default_factory=dict)
    # originating request's trace id (obs/tracing), None when untraced
    trace: str | None = None

    @property
    def duration_ms(self) -> float | None:
        if self.t_end is None:
            return None
        return 1000.0 * (self.t_end - self.t_start)

    def event(self, name: str, **attrs):
        """Record a point-in-time event on this span (the OpenTelemetry
        span-event analog): lands in attrs["events"] and is rendered by
        /3/Timeline and GET /3/Trace/{id}. The DKV pager uses this to
        mark chunk faults/evictions inside MRTask spans. Call from the
        span's owning thread (same contract as mutating attrs)."""
        self.attrs.setdefault("events", []).append(
            dict({"name": name, "t": time.time()}, **attrs))

    def to_dict(self) -> dict:
        return {"name": self.name, "id": self.span_id,
                "parent": self.parent_id, "host": self.host,
                "start": self.t_start, "end": self.t_end,
                "duration_ms": self.duration_ms, "attrs": self.attrs,
                "trace": self.trace}


class SpanTimeline:
    """Bounded ring of completed spans + per-thread open-span stack."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = _env.env_int("H2O3_OBS_TIMELINE_CAPACITY", 4096)
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = make_lock("timeline.ring")
        # span ids start at a random per-process base (not 1): the
        # recorder's durability story spans restarts, and the (host, id)
        # dedup keys in /3/Trace/{id} + recorder.search would otherwise
        # collide a fresh process's ring spans 1..N with a dead process's
        # on-disk spans for the same reused trace id, silently hiding the
        # stored ones. Base < 2^52 keeps ids exact in JSON doubles.
        self._ids = itertools.count(
            (random.getrandbits(31) << 20) + 1)
        self._tls = threading.local()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # ---- span lifecycle -------------------------------------------------
    def begin(self, name: str, **attrs) -> Span:
        st = self._stack()
        sp = Span(name=name, t_start=time.time(),
                  span_id=next(self._ids),
                  parent_id=st[-1].span_id if st else 0,
                  host=host_id(), attrs=attrs,
                  trace=_tracing.current())
        st.append(sp)
        return sp

    def end(self, sp: Span):
        sp.t_end = time.time()
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:           # mis-nested exit: unwind through it
            while st and st.pop() is not sp:
                pass
        with self._lock:
            # deque(maxlen) overflow is SILENT — count the span the
            # append is about to push out, so ring data loss is a signal
            # (h2o3_timeline_dropped_spans_total), not a mystery
            dropped = (self.capacity is not None
                       and len(self._ring) == self.capacity)
            self._ring.append(sp)
        if dropped:
            _dropped_counter().inc()
        # durable tier: traced spans stream to the flight recorder, which
        # makes the keep/drop call at trace completion (tail sampling).
        # Untraced spans return after one attribute read. Lazy import —
        # the recorder imports the metrics registry; this module must
        # stay importable underneath both.
        if sp.trace is not None:
            from h2o3_tpu_torch.obs import recorder as _recorder
            _recorder.RECORDER.on_span_end(sp)

    def current(self) -> Span | None:
        st = self._stack()
        return st[-1] if st else None

    # ---- views ----------------------------------------------------------
    def snapshot(self, limit: int = 0) -> list:
        """Completed spans, oldest first (the /3/Timeline per-host body)."""
        with self._lock:
            spans = list(self._ring)
        if limit and len(spans) > limit:
            spans = spans[-limit:]
        return [s.to_dict() for s in spans]

    def trace_snapshot(self, trace_id: str, limit: int = 0) -> list:
        """Completed spans belonging to one trace: tagged with the id, or
        LINKING it via attrs["links"] (a coalesced micro-batch dispatch
        serving N parent traces records every parent there)."""
        with self._lock:
            spans = list(self._ring)
        out = [s for s in spans
               if s.trace == trace_id
               or trace_id in (s.attrs.get("links") or ())]
        if limit and len(out) > limit:
            out = out[-limit:]
        return [s.to_dict() for s in out]

    def clear(self):
        with self._lock:
            self._ring.clear()


SPANS = SpanTimeline()


# ---------------------------------------------------------------------------
# torch.profiler bridge (env-gated; one capture at a time)
_TRACE_LOCK = make_lock("timeline.trace")
_TRACE_ACTIVE = None            # the running torch.profiler.profile
_TRACE_SEQ = itertools.count(1)


def _profiler_trace_dir() -> str:
    """H2O3_OBS_TRACE_DIR declaration site ("" = profiler bridge off)."""
    return _env.env_str("H2O3_OBS_TRACE_DIR", "")


def _maybe_start_trace(name: str) -> bool:
    trace_dir = _profiler_trace_dir()
    want = _env.env_str("H2O3_OBS_TRACE_SPAN", "")
    if not trace_dir or not want or not name.startswith(want):
        return False
    global _TRACE_ACTIVE
    with _TRACE_LOCK:
        if _TRACE_ACTIVE is not None:
            return False        # nested match: outer capture already running
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        except Exception:   # noqa: BLE001 — profiler trouble must not kill the span
            return False
        _TRACE_ACTIVE = prof
        return True


def _stop_trace(name: str):
    global _TRACE_ACTIVE
    with _TRACE_LOCK:
        prof = _TRACE_ACTIVE
        if prof is None:
            return None
        _TRACE_ACTIVE = None
        try:
            prof.__exit__(None, None, None)
            d = _profiler_trace_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"{name}-p{os.getpid()}-{next(_TRACE_SEQ)}.json")
            prof.export_chrome_trace(path)
            return path
        except Exception:   # noqa: BLE001
            return None


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a block as one span: `with span("gbm.histogram", job=k): ...`.
    Nesting is tracked per thread; attrs land in the /3/Timeline record."""
    sp = SPANS.begin(name, **attrs)
    traced = _maybe_start_trace(name)
    try:
        yield sp
    finally:
        if traced:
            sp.attrs["profile"] = _stop_trace(name)
        SPANS.end(sp)
