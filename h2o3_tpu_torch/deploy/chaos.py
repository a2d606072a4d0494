"""Deterministic fault injection of the port (h2o3_tpu/deploy/chaos.py)
— the standing chaos layer, copied whole.

Of the points below the port wires `microbatch.dispatch`
(serving/microbatch.py); the replay-channel, worker and mrtask points
come with the multi-device item (ROADMAP.md §1), and a rule naming them
simply never fires until then.

Elastic membership (deploy/membership.py) only counts as robustness if a
fault can be produced ON DEMAND, at a deterministic point, in a test that
runs on every commit. This module is that lever: a small rule engine that
injects failures at named points in the replay channel, the worker loop
and the serving dispatch path. It ships in the tree (not in tests/) so a
staging cloud can run the same faults via env.

Spec grammar (env `H2O3_CHAOS`, or `install()` from a test):

    rule[;rule...]
    rule  := key=value[,key=value...]
    keys  := point   (required: where to fire, see POINTS below)
             action  (required: drop | delay | sever | kill | fail)
             worker  (optional int: only when the point names this worker)
             after   (skip the first N matching hits; default 0)
             times   (fire at most N times; default 1)
             delay_s (sleep length for action=delay; default 0.2)

Example: `H2O3_CHAOS="point=replay.send,worker=1,after=3,action=sever"`
severs worker 1's replay socket immediately before the 4th frame the
coordinator would send it.

Points wired in the tree (each caller documents its own semantics):
  replay.send        coordinator, before sending a broadcast/collect frame
                       (sever closes the socket, drop skips the send,
                        delay sleeps first)
  collect.ack        worker, before answering a collect op (delay/drop)
  worker.replay      worker, before replaying a request (kill = hard
                       process exit — the "lost pod")
  microbatch.dispatch  serving, inside the coalesced dispatch (fail
                       raises EpochChanged so the epoch-retry path runs)
  mrtask.dispatch    parallel, inside a device dispatch (fail as above)

Determinism: rules carry no randomness — `after`/`times` counters make
the Nth hit fire, every run. The spec is parsed once at install; when no
rules are installed every hook is one module-global read.
"""

from __future__ import annotations

import os
import threading
import time

from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.utils.env import env_str

ACTIONS = ("drop", "delay", "sever", "kill", "fail")

INJECTIONS = _om.counter(
    "h2o3_chaos_injections_total",
    "faults the chaos layer actually injected, by point and action "
    "(zero outside chaos runs — a nonzero rate in production means "
    "H2O3_CHAOS leaked into a real deployment)")


class ChaosFault(RuntimeError):
    """Raised by action=fail at points whose caller did not map the
    failure to a domain exception."""


class _Rule:
    __slots__ = ("point", "action", "worker", "after", "times",
                 "delay_s", "_hits", "_fired")

    def __init__(self, point, action, worker=None, after=0, times=1,
                 delay_s=0.2):
        if action not in ACTIONS:
            raise ValueError(f"chaos action {action!r} not in {ACTIONS}")
        self.point = point
        self.action = action
        self.worker = worker
        self.after = int(after)
        self.times = int(times)
        self.delay_s = float(delay_s)
        self._hits = 0
        self._fired = 0

    def match(self, point: str, worker) -> bool:
        if point != self.point:
            return False
        if self.worker is not None and worker != self.worker:
            return False
        self._hits += 1
        if self._hits <= self.after or self._fired >= self.times:
            return False
        self._fired += 1
        return True

    def to_dict(self) -> dict:
        return {"point": self.point, "action": self.action,
                "worker": self.worker, "after": self.after,
                "times": self.times, "fired": self._fired}


_RULES: list = []
_LOCK = threading.Lock()


def parse(spec: str) -> list:
    """Parse a spec string into rules (see module grammar)."""
    rules = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        kv = {}
        for item in part.split(","):
            k, _, v = item.partition("=")
            kv[k.strip()] = v.strip()
        if "point" not in kv or "action" not in kv:
            raise ValueError(f"chaos rule needs point= and action=: {part!r}")
        rules.append(_Rule(
            kv["point"], kv["action"],
            worker=int(kv["worker"]) if kv.get("worker") else None,
            after=int(kv.get("after") or 0),
            times=int(kv.get("times") or 1),
            delay_s=float(kv.get("delay_s") or 0.2)))
    return rules


def _chaos_spec() -> str:
    """The H2O3_CHAOS rule spec ("" = chaos disabled) — declaration
    site for the variable; install()/install_from_env() both read it."""
    return env_str("H2O3_CHAOS", "")


def install(spec: str | None = None):
    """(Re)install rules from `spec` (or H2O3_CHAOS when None). The test
    API: install at setup, reset() at teardown."""
    global _RULES
    rules = parse(spec if spec is not None else _chaos_spec())
    with _LOCK:
        _RULES = rules
    return rules


def reset():
    global _RULES
    with _LOCK:
        _RULES = []


def active() -> bool:
    return bool(_RULES)


def rules() -> list:
    with _LOCK:
        return [r.to_dict() for r in _RULES]


def _fire(rule: _Rule, point: str):
    INJECTIONS.inc(point=point, action=rule.action)
    from h2o3_tpu_torch.utils import log as _ulog
    _ulog.warn("chaos: injecting %s at %s (worker=%s)", rule.action,
               point, rule.worker)


def at(point: str, worker=None):
    """The coordinator-side hook: returns the matched rule's action dict
    ({"action": ..., "delay_s": ...}) or None. `delay` sleeps HERE so
    simple callers need no handling; drop/sever/kill/fail are returned
    for the caller to apply (it owns the socket / process / exception)."""
    if not _RULES:
        return None
    with _LOCK:
        hit = next((r for r in _RULES if r.match(point, worker)), None)
    if hit is None:
        return None
    _fire(hit, point)
    if hit.action == "delay":
        time.sleep(hit.delay_s)
        return None
    return {"action": hit.action, "delay_s": hit.delay_s}


def maybe_raise(point: str, worker=None, exc=None):
    """Dispatch-path hook: action=fail raises (`exc` factory result, or
    ChaosFault); kill hard-exits the process; delay sleeps. One global
    read when chaos is idle — safe on hot paths."""
    if not _RULES:
        return
    act = at(point, worker=worker)
    if act is None:
        return
    if act["action"] == "kill":
        os._exit(17)
    if act["action"] == "fail":
        raise (exc() if exc is not None
               else ChaosFault(f"chaos fail at {point}"))


def install_from_env():
    """Called at server/worker start: arms H2O3_CHAOS when present."""
    if _chaos_spec():
        install()
