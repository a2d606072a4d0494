"""Stall watchdog of the port (h2o3_tpu/obs/watchdog.py) — turns hangs
into diagnostics.

A hung process stops emitting metrics AND traces — the two pillars that
exist to explain it. Code that is about to perform a wait that CAN wedge
wraps it in `watch(kind, ...)`; in the port today that is the
micro-batch follower wait (serving/microbatch). The JAX package also
watches REST handler dispatch (api/server), the replay-channel broadcast
barrier (deploy/multihost) and device dispatches (parallel/mrtask); those
call sites come with the REST server and the multi-device items
(ROADMAP.md §1) and use the same kinds.

A daemon sentinel thread scans the live entries; one older than
H2O3_WATCHDOG_STALL_S (or its explicit per-watch deadline) trips the
watchdog, which — from its own, unstalled thread — captures a JStack
(every thread's stack; a cluster collector, when one is set, adds every
worker's), the recent structured log tail, and the stalled operations'
descriptions, and writes it all into a PINNED flight-recorder trace
(`watchdog.trip` root span). It also logs a structured ERROR correlated
to that trace and bumps `h2o3_watchdog_trips_total{kind}`. `reset()`
retires the sentinel and forgets every entry and trip.

Env surface:
  H2O3_WATCHDOG          "0" disables the sentinel (default on)
  H2O3_WATCHDOG_STALL_S  seconds a watched op may run before it is a
                         stall (default 300; per-watch deadline_s wins)
  H2O3_WATCHDOG_POLL_S   sentinel scan period (default min(stall/4, 5))
  H2O3_OBS_COLLECT_TIMEOUT_S  per-host deadline of the cluster JStack
                         collect (default 2)
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
import traceback

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs import tracing as _tracing
from h2o3_tpu_torch.utils.env import env_bool, env_float

TRIPS = _om.counter(
    "h2o3_watchdog_trips_total",
    "watchdog trips — a watched operation (rest handler, micro-batch "
    "wait, replay ack barrier, device dispatch) ran past its stall "
    "deadline and a pinned diagnostic trace was captured, labeled by "
    "the stalled operation's kind")


# cached enable flag: watch() wraps EVERY device dispatch, and an
# os.environ read per call is measurable there (the utils/log _LEVEL
# discipline). Tests that flip H2O3_WATCHDOG reset the cache to None
# (monkeypatch.setattr restores it on teardown).
_ENABLED = None

# nullcontext carries no per-use state: one shared instance serves every
# disabled watch() call
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = env_bool("H2O3_WATCHDOG", True)
    return _ENABLED


def _stall_s() -> float:
    return env_float("H2O3_WATCHDOG_STALL_S", 300.0)


def _poll_s() -> float:
    v = env_float("H2O3_WATCHDOG_POLL_S", 0.0)
    return v if v > 0 else min(max(_stall_s() / 4.0, 0.05), 5.0)


# ---------------------------------------------------------------------------
# JStack — water/util/JStack + water/api/JStackHandler analog
def thread_dump() -> list:
    """Every live thread's stack as [{name, ident, daemon, stack}] —
    this process's half of GET /3/JStack and the watchdog's capture."""
    frames = sys._current_frames()
    out = []
    for t in threading.enumerate():
        fr = frames.get(t.ident)
        out.append({
            "name": t.name, "ident": t.ident,
            "daemon": bool(t.daemon),
            "alive": t.is_alive(),
            "stack": "".join(traceback.format_stack(fr)) if fr else "",
        })
    return out


def format_dump(threads: list) -> str:
    parts = []
    for t in threads:
        parts.append(f'--- thread "{t.get("name")}"'
                     f'{" daemon" if t.get("daemon") else ""} ---\n'
                     f'{t.get("stack") or "<no frame>"}')
    return "\n".join(parts)


class _Watch:
    """Slotted context manager for one watched operation — dispatch-path
    cheap: no generator frame, one dict insert/remove under a leaf lock.
    (mrtask calls this per device dispatch; a @contextmanager generator
    plus per-call imports was measurable there.)"""

    __slots__ = ("_wd", "_ent", "_token")

    def __init__(self, wd, kind, desc, deadline_s, trace):
        self._wd = wd
        self._token = next(wd._ids)
        self._ent = {"kind": kind, "desc": desc,
                     "thread": threading.current_thread().name,
                     "ident": threading.get_ident(),
                     "t0": time.monotonic(),
                     "deadline_s": deadline_s,
                     "trace": trace if trace is not None
                     else _tracing.current(),
                     "tripped": False}

    def __enter__(self):
        wd = self._wd
        with wd._lock:
            wd._entries[self._token] = self._ent
        if not wd._started:
            wd._ensure_thread()
        return self._ent

    def __exit__(self, *exc):
        with self._wd._lock:
            self._wd._entries.pop(self._token, None)
        return False


class Watchdog:
    """Registry of in-flight watched operations + the sentinel thread."""

    def __init__(self):
        self._lock = make_lock("watchdog")
        self._entries: dict = {}     # token -> entry dict
        self._ids = itertools.count(1)
        self._thread = None
        self._started = False        # fast-path flag: is_alive() per
        #                              watch is measurable on hot paths
        self._collector = None       # fn(op, timeout) -> [worker replies]
        self._trips: list = []       # recent trip summaries (diagnostics)

    # ---- wiring ---------------------------------------------------------
    def set_collector(self, fn):
        """Give the watchdog a cluster fan-out: the coordinator passes
        `lambda op, t: broadcaster.collect(op, timeout=t)` so a trip's
        JStack covers every host, not just this one."""
        self._collector = fn

    # ---- watched-operation registry -------------------------------------
    def watch(self, kind: str, desc: str = "", deadline_s=None,
              trace=None):
        """Context manager: register the calling thread's operation for
        the duration of the block. Near-free (one dict insert/remove
        under a leaf lock); the sentinel thread pays the scan cost."""
        if not enabled():
            return _NULL
        return _Watch(self, kind, desc, deadline_s, trace)

    def stalled(self) -> list:
        """Currently-stalled entries (sentinel's view; also the
        stalled-ops gauge and the /3/JStack `stalled` report)."""
        now = time.monotonic()
        default = _stall_s()
        with self._lock:
            return [dict(e, stalled_s=round(now - e["t0"], 3))
                    for e in self._entries.values()
                    if now - e["t0"] >= (e["deadline_s"] or default)]

    def trips(self) -> list:
        with self._lock:
            return list(self._trips)

    # ---- sentinel --------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            t = threading.Thread(target=self._run, daemon=True,
                                 name="h2o3-watchdog")
            self._thread = t
            self._started = True
        t.start()

    def start(self):
        """Explicit start (the API server calls this; watch() also
        starts lazily so bare library use is covered)."""
        if enabled():
            self._ensure_thread()

    def _run(self):
        while True:
            time.sleep(_poll_s())
            if self._thread is not threading.current_thread():
                return               # a newer sentinel owns the scan
            try:
                self._scan()
            except Exception:   # noqa: BLE001 — the sentinel must survive
                traceback.print_exc()

    def _scan(self):
        now = time.monotonic()
        default = _stall_s()
        fresh = []
        with self._lock:
            for e in self._entries.values():
                limit = e["deadline_s"] or default
                if now - e["t0"] >= limit and not e["tripped"]:
                    e["tripped"] = True
                    fresh.append(dict(e, stalled_s=round(now - e["t0"], 3)))
        if fresh:
            # capture OUTSIDE the registry lock: the dump walks every
            # thread and the cluster collect does network waits
            self.trip(fresh)

    # ---- the trip --------------------------------------------------------
    def trip(self, stalls: list) -> str:
        """Capture a diagnostic artifact for the given stalled entries:
        one pinned flight-recorder trace holding a cluster JStack, the
        recent log tail and the stall descriptions. Returns the trace
        id. Runs on the sentinel thread (or a test's thread) — NEVER on
        a stalled one."""
        import secrets
        from h2o3_tpu_torch.obs import recorder as _rec
        from h2o3_tpu_torch.obs import timeline as _tl
        from h2o3_tpu_torch.utils import log as _log

        tid = f"watchdog-{secrets.token_hex(4)}"
        _rec.RECORDER.pin(tid)
        local = thread_dump()
        cluster = [{"host": _tl.host_id(), "n_threads": len(local)}]
        remote_dumps = []
        # when the REPLAY CHANNEL is what stalled, its broadcast lock is
        # held by the stuck thread — a cluster collect would queue behind
        # it until the (much longer) ack deadline. Ship the local dump
        # promptly instead; the channel being wedged IS the finding.
        channel_stalled = any(s["kind"] == "replay" for s in stalls)
        if self._collector is not None and not channel_stalled:
            from h2o3_tpu_torch.api.server import _collect_timeout
            timeout = _collect_timeout()
            try:
                for i, remote in enumerate(self._collector("jstack",
                                                           timeout)):
                    if isinstance(remote, dict):
                        cluster.append({"host": remote.get("host", i + 1),
                                        "n_threads":
                                        len(remote.get("threads") or [])})
                        remote_dumps.append(remote)
                    else:
                        cluster.append({"host": i + 1, "lagging": True})
            except Exception:   # noqa: BLE001 — a wedged channel IS the
                pass            # incident; capture what we have locally
        kinds = sorted({s["kind"] for s in stalls})
        with _tracing.trace(tid):
            with _tl.span("watchdog.trip", kinds=",".join(kinds)) as sp:
                sp.parent_id = 0     # always a root: the episode is its
                #                      own trace, never a child of the
                #                      sentinel's ambient context
                sp.attrs["stalls"] = [
                    {k: s.get(k) for k in ("kind", "desc", "thread",
                                           "stalled_s", "trace")}
                    for s in stalls]
                # bounded attrs: segments are JSONL — a runaway dump must
                # not turn one span into a multi-MB line
                sp.attrs["jstack"] = format_dump(local)[:200_000]
                for r in remote_dumps:
                    sp.attrs[f"jstack_host{r.get('host')}"] = \
                        format_dump(r.get("threads") or [])[:200_000]
                sp.attrs["hosts"] = cluster
                if channel_stalled:
                    sp.attrs["cluster_jstack_skipped"] = \
                        "replay channel stalled: collect would queue " \
                        "behind the stuck broadcast lock"
                sp.attrs["logs"] = _log.records(100)
            # the ERROR record is trace-correlated (and itself a keep-rule
            # producer, so the trip trace is doubly retained)
            _log.err("watchdog: %s stalled past deadline — diagnostic "
                     "trace %s (stalls: %s)", ",".join(kinds), tid,
                     "; ".join(f'{s["kind"]}:{s["desc"]} '
                               f'{s["stalled_s"]}s' for s in stalls))
        for k in kinds:
            TRIPS.inc(kind=k)
        with self._lock:
            self._trips.append({"trace": tid, "t": time.time(),
                                "kinds": kinds,
                                "stalls": [s["desc"] for s in stalls]})
            del self._trips[:-32]
        return tid


    # ---- test isolation --------------------------------------------------
    def reset(self):
        """Forget every watched entry and trip and retire the sentinel:
        the running thread sees it no longer owns the scan at its next
        wake and exits; the next watch() starts a fresh one on the
        current env's poll period."""
        with self._lock:
            self._entries.clear()
            self._trips.clear()
            self._thread = None
            self._started = False
        self._collector = None


WATCHDOG = Watchdog()


def watch(kind: str, desc: str = "", deadline_s=None, trace=None):
    """Module-level convenience: `with watchdog.watch("rest", path): ...`"""
    return WATCHDOG.watch(kind, desc=desc, deadline_s=deadline_s,
                          trace=trace)


def _stalled_series():
    from collections import Counter as _Counter
    counts = _Counter(e["kind"] for e in WATCHDOG.stalled())
    return [({"kind": k}, float(v)) for k, v in sorted(counts.items())]


_om.gauge("h2o3_watchdog_stalled_ops",
          "watched operations currently past their stall deadline, by "
          "kind — nonzero means a hang is IN PROGRESS right now",
          fn=_stalled_series)


def reset():
    """Test isolation: see Watchdog.reset (the enable flag's cache is
    dropped too, so an env change takes)."""
    global _ENABLED
    _ENABLED = None
    WATCHDOG.reset()
