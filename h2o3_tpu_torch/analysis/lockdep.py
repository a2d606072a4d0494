"""Runtime lockdep of the port (h2o3_tpu/analysis/lockdep.py) —
Linux-lockdep-style lock-order validation.

Every lock gets a CLASS (a name), each thread tracks the stack of classes
it holds, and acquiring B while holding A records the order edge A→B in
one global graph. The first acquisition that would close a cycle
(B→…→A already recorded) is reported at the acquisition that PROVES the
inversion — no actual deadlock, no special interleaving needed: if
thread 1 ever did A→B and thread 2 ever does B→A, the second order is
caught even when the threads never overlap.

Usage: subsystem locks are created through `make_lock("name")` /
`make_rlock("name")` instead of `threading.Lock()`. Disabled (the
default), the wrapper delegates straight to the underlying lock — one
flag check of overhead. Enabled (env `H2O3_LOCKDEP=1|raise`, or
`H2O3_LOCKDEP=log` to count without raising, or `enable()` from code),
every acquisition is checked against the global order graph BEFORE
blocking, so an inversion raises `LockOrderInversion` instead of
deadlocking under the unlucky schedule.

Instrumented lock classes of the port: `dkv`, `scorer_cache`,
`scorer_cache.tokens`, `scorer_cache.broken`, `scorer_cache.build`,
`scorer_cache.program` (a captured graph's replay lock),
`serving.params`, `serving.params.io`, `metrics.registry`,
`timeline.ring`, `timeline.trace`, `recorder`, and the chunk pager's
`tiering.io` (per-chunk transfer lock, one class for every instance) and
`tiering.residency` (pager maps/accounting) — ordered io → residency,
neither ever nested under `dkv`. Per-metric series locks stay plain
`threading.Lock` — they are leaf locks on the hottest counter path and
never nest.

Manual `.acquire()`/`.release()` calls on a DepLock are instrumented
exactly like `with`-blocks (acquire/release ARE the with-protocol).
A non-blocking try-acquire (`acquire(blocking=False)`) records the lock
as held but adds NO order edge and is never reported as an inversion —
a trylock cannot wait, so it cannot complete a deadlock cycle (Linux
lockdep's trylock rule). Bounded acquires (`timeout=`) still record
order: timing out rescues the schedule but the ordering bug remains.

Metrics: `h2o3_lockdep_edges_total` (distinct order edges recorded),
`h2o3_lockdep_inversions_total` (cycles detected). Both are declared
lazily so this module can be imported by the metrics registry itself
without an import cycle.
"""

from __future__ import annotations

import os
import threading

# explicit "off" spellings — H2O3_LOCKDEP=0 must DISABLE, not enable
_OFF_VALUES = ("", "0", "false", "off", "no", "none")


def _mode_from_env(value: str) -> str:
    v = (value or "").strip().lower()
    if v in _OFF_VALUES:
        return ""
    return "log" if v == "log" else "raise"


class LockOrderInversion(RuntimeError):
    """Acquiring this lock would close a cycle in the global lock-order
    graph — the AB/BA deadlock schedule exists even if this exact run
    never interleaves into it."""


def env_mode() -> str:
    """The H2O3_LOCKDEP mode from the environment ("" disabled / "log" /
    "raise") — the variable's one declaration site; sanitizers
    install_from_env() reads it through this helper too."""
    from h2o3_tpu_torch.utils.env import env_str
    return _mode_from_env(env_str("H2O3_LOCKDEP", ""))


class _State:
    def __init__(self):
        self.mode = env_mode()

    @property
    def enabled(self) -> bool:
        return bool(self.mode)


_STATE = _State()
_TLS = threading.local()

# global order graph: _SUCC[a] = {b: "file:line of the first a→b"}
_GRAPH_LOCK = threading.Lock()
_SUCC: dict = {}
_EDGE_COUNT = 0
_INVERSION_COUNT = 0


def enable(mode: str = "raise"):
    """Turn the checker on process-wide ('raise' or 'log')."""
    if mode not in ("raise", "log"):
        raise ValueError(f"lockdep mode {mode!r} (want 'raise' or 'log')")
    _STATE.mode = mode
    try:
        _metrics()      # counters visible at zero before the first edge
    except ImportError:     # metrics registry mid-import: stays lazy
        pass


def disable():
    _STATE.mode = ""


def enabled() -> bool:
    return _STATE.enabled


def reset():
    """Drop the recorded order graph (test isolation)."""
    global _SUCC, _EDGE_COUNT, _INVERSION_COUNT
    with _GRAPH_LOCK:
        _SUCC = {}
        _EDGE_COUNT = 0
        _INVERSION_COUNT = 0


def edges() -> dict:
    """{(a, b): first_site} snapshot of the recorded order graph."""
    with _GRAPH_LOCK:
        return {(a, b): site for a, nxt in _SUCC.items()
                for b, site in nxt.items()}


def _metrics():
    """Lazy counter lookup: metrics.py itself creates its registry lock
    through make_lock, so importing it at module top would cycle."""
    from h2o3_tpu_torch.obs import metrics as _om
    return (_om.counter("h2o3_lockdep_edges_total",
                        "distinct lock-order edges recorded by the "
                        "runtime lockdep sanitizer (H2O3_LOCKDEP)"),
            _om.counter("h2o3_lockdep_inversions_total",
                        "lock-order inversions (cycles) detected by the "
                        "runtime lockdep sanitizer"))


def _held() -> list:
    st = getattr(_TLS, "held", None)
    if st is None:
        st = _TLS.held = []
    return st


def _busy() -> bool:
    return getattr(_TLS, "busy", False)


def _path(src: str, dst: str) -> list:
    """Shortest recorded path src→…→dst, as [(a, b, site), ...], or []."""
    prev: dict = {src: None}
    queue = [src]
    while queue:
        cur = queue.pop(0)
        for nxt in sorted(_SUCC.get(cur, ())):
            if nxt not in prev:
                prev[nxt] = cur
                if nxt == dst:
                    queue = []
                    break
                queue.append(nxt)
    if dst not in prev:
        return []
    hops = []
    cur = dst
    while prev[cur] is not None:
        hops.append((prev[cur], cur, _SUCC[prev[cur]][cur]))
        cur = prev[cur]
    hops.reverse()
    return hops


def _caller_site() -> str:
    import traceback
    for frame in reversed(traceback.extract_stack(limit=16)):
        if os.path.basename(frame.filename) != "lockdep.py":
            return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


def _note_acquire(name: str, trylock: bool = False):
    """Record intent to acquire `name`; raises on inversion BEFORE the
    underlying acquire, so the error surfaces instead of the deadlock.
    `trylock` (a non-blocking acquire) records held-ness only: it cannot
    wait, so it adds no order edge and never proves an inversion."""
    global _EDGE_COUNT, _INVERSION_COUNT
    held = _held()
    if trylock or name in held:  # trylock / re-entry: no new order edge
        held.append(name)
        return
    if not held:
        held.append(name)
        return
    _TLS.busy = True            # counters below take metric locks: the
    try:                        # instrumentation must not instrument itself
        site = None             # stack walk only when an edge is NEW —
        inversion = None        # steady state stays a dict lookup
        new_edges = 0
        with _GRAPH_LOCK:
            for h in held:
                if h == name:
                    continue
                if name not in _SUCC.get(h, ()):
                    if site is None:
                        site = _caller_site()
                    back = _path(name, h)
                    if back:
                        _INVERSION_COUNT += 1
                        inversion = (h, back)
                        break
                    _SUCC.setdefault(h, {})[name] = site
                    _EDGE_COUNT += 1
                    new_edges += 1
        try:
            e, i = _metrics()
            if new_edges:
                e.inc(new_edges)
            if inversion is not None:
                i.inc()
        except Exception:   # noqa: BLE001 — metrics must not break locking
            pass
        if inversion is not None and _STATE.mode == "raise":
            h, back = inversion
            chain = " ; ".join(f"{a}→{b} (first seen {s})"
                               for a, b, s in back)
            raise LockOrderInversion(
                f"lock-order inversion: acquiring {name!r} while holding "
                f"{h!r} at {site}, but the opposite order is already "
                f"recorded: {chain} — two threads running these paths "
                "concurrently deadlock")
    finally:
        _TLS.busy = False
    held.append(name)


def _note_release(name: str):
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


class DepLock:
    """Drop-in threading.Lock/RLock with lockdep instrumentation. The
    `name` is the lock CLASS: every instance created with the same name
    shares an identity in the order graph (all per-key build locks are
    one class), matching how the static rules key locks by attribute."""

    __slots__ = ("name", "_reentrant", "_lock")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _STATE.enabled and not _busy():
            _note_acquire(self.name, trylock=not blocking)
            ok = self._lock.acquire(blocking, timeout)
            if not ok:
                _note_release(self.name)
            return ok
        return self._lock.acquire(blocking, timeout)

    def release(self):
        self._lock.release()
        if _STATE.enabled and not _busy():
            _note_release(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        inner = getattr(self._lock, "locked", None)
        return inner() if inner is not None else False

    def __repr__(self):
        kind = "RLock" if self._reentrant else "Lock"
        return f"<DepLock {self.name!r} ({kind})>"


def make_lock(name: str) -> DepLock:
    """A named, lockdep-instrumented mutual-exclusion lock."""
    return DepLock(name, reentrant=False)


def make_rlock(name: str) -> DepLock:
    """A named, lockdep-instrumented re-entrant lock."""
    return DepLock(name, reentrant=True)


def counts() -> dict:
    with _GRAPH_LOCK:
        return {"edges": _EDGE_COUNT, "inversions": _INVERSION_COUNT}
