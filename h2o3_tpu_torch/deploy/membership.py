"""Cloud membership of the port (h2o3_tpu/deploy/membership.py), in its
single-process form: the epoch state machine and the one-shot epoch retry.

The cloud has an integer **epoch**, bumped on every membership change
(excision, join, drain-leave); workers are tracked per epoch with a state
(`active` → `draining` → `left`, or `active` → `dead`). `retry_once`
retries an operation that failed while the epoch moved under it (or
raised EpochChanged) exactly once, with jittered backoff — the
micro-batcher's coalesced dispatch runs through it, so a request
straddling an excision succeeds against the new epoch instead of failing.

The port runs one process: nothing excises a worker yet, so the epoch
moves only when a test or the chaos layer (`deploy/chaos.py`, action
`fail` at `microbatch.dispatch` raises EpochChanged) moves it. The
elastic broadcaster, the heartbeat, the drain and the mesh listener that
rebuilds the device mesh on every epoch need the replay channel
(`deploy/multihost.py`) and come with the multi-device item (ROADMAP.md
§1).

Env surface:
  H2O3_EPOCH_RETRY_BACKOFF_S  base of the jittered backoff before the one
                              epoch retry (default 0.05)
"""

from __future__ import annotations

import random
import time

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs.timeline import span as _span
from h2o3_tpu_torch.utils.env import env_float

ACTIVE = "active"
DRAINING = "draining"
DEAD = "dead"
LEFT = "left"

EXCISIONS = _om.counter(
    "h2o3_cloud_excisions_total",
    "workers excised from the cloud, by reason (ack_timeout/send_error/"
    "bad_ack/recv_error/heartbeat/eof/drain/error) — each excision bumps "
    "h2o3_cloud_epoch and re-homes DKV keys")
JOINS = _om.counter(
    "h2o3_cloud_joins_total",
    "workers that joined (or re-joined) the elastic cloud after "
    "formation, each syncing the current epoch + state snapshot")
EPOCH_RETRIES = _om.counter(
    "h2o3_epoch_retries_total",
    "serving/dispatch operations retried once against a new cloud epoch "
    "after straddling a membership change, by op "
    "(microbatch/mrtask)")


class EpochChanged(RuntimeError):
    """An operation straddled a cloud-epoch bump (membership changed
    under it). retry_once treats this as always retryable."""

    def __init__(self, msg="cloud epoch changed", old=None, new=None):
        super().__init__(msg)
        self.old = old
        self.new = new


class Membership:
    """Per-epoch worker tracking. One per process."""

    def __init__(self):
        self._lock = make_lock("membership")
        self.epoch = 1
        self.multi = False        # any worker ever registered
        self._workers: dict = {}  # pid -> {"state", "epoch", "reason"}
        self._listeners: list = []

    def reset(self):
        """Test harness: back to a fresh single-host cloud."""
        with self._lock:
            self.epoch = 1
            self.multi = False
            self._workers = {}
            self._listeners = []

    def add_listener(self, fn):
        """fn(epoch, alive_worker_pids) after every membership change —
        called OUTSIDE the membership lock (listeners may take dkv)."""
        with self._lock:
            self._listeners.append(fn)

    def register(self, pid: int):
        """Record a formation-time worker (no epoch bump: formation IS
        epoch 1)."""
        with self._lock:
            self._workers[pid] = {"state": ACTIVE, "epoch": self.epoch,
                                  "reason": None}
            self.multi = True

    def observe_epoch(self, e: int):
        """Worker side: adopt the coordinator's epoch (monotone)."""
        with self._lock:
            if e > self.epoch:
                self.epoch = e

    def _change_locked(self, pid, state, reason):
        self._workers[pid] = {"state": state, "epoch": self.epoch + 1,
                              "reason": reason}
        self.epoch += 1
        return self.epoch

    def excise(self, pid: int, reason: str) -> int:
        """A dead/unresponsive worker leaves the set; the epoch bumps and
        survivors carry on. Returns the new epoch."""
        with self._lock:
            ep = self._change_locked(pid, DEAD, reason)
            alive = self._alive_locked()
        EXCISIONS.inc(reason=reason)
        with _span("membership.excise", node=pid, reason=reason, epoch=ep):
            from h2o3_tpu_torch.utils import log as _ulog
            _ulog.err("membership: excised worker %s (%s) -> epoch %s, "
                      "%s live workers", pid, reason, ep, len(alive))
        self._notify(ep, alive)
        return ep

    def leave(self, pid: int) -> int:
        """Clean drain-initiated departure (state `left`, reason drain)."""
        with self._lock:
            ep = self._change_locked(pid, LEFT, "drain")
            alive = self._alive_locked()
        EXCISIONS.inc(reason="drain")
        from h2o3_tpu_torch.utils import log as _ulog
        _ulog.info("membership: worker %s drained and left -> epoch %s",
                   pid, ep)
        self._notify(ep, alive)
        return ep

    def join(self, pid: int, synced: bool = True) -> int:
        """A joining/replacement worker enters the set. Returns the new
        epoch. `synced=False` records that its join-sync snapshot was
        truncated."""
        with self._lock:
            ep = self._change_locked(pid, ACTIVE, None)
            self._workers[pid]["synced"] = synced
            self.multi = True
            alive = self._alive_locked()
        JOINS.inc()
        with _span("membership.join", node=pid, epoch=ep):
            from h2o3_tpu_torch.utils import log as _ulog
            if synced:
                _ulog.info("membership: worker %s joined -> epoch %s, "
                           "%s live workers", pid, ep, len(alive))
            else:
                _ulog.err("membership: worker %s joined UNSYNCED -> "
                          "epoch %s (snapshot log overflowed "
                          "H2O3_REPLAY_LOG_MAX; its replayed state may "
                          "diverge — prefer draining and re-parsing, or "
                          "raise the log bound)", pid, ep)
        self._notify(ep, alive)
        return ep

    def start_drain(self, pid: int):
        with self._lock:
            w = self._workers.get(pid)
            if w is None or w["state"] not in (ACTIVE, DRAINING):
                raise ValueError(f"node {pid} is not an active worker")
            w["state"] = DRAINING

    def state(self, pid: int):
        with self._lock:
            w = self._workers.get(pid)
            return w["state"] if w else None

    def _alive_locked(self) -> list:
        return sorted(p for p, w in self._workers.items()
                      if w["state"] in (ACTIVE, DRAINING))

    def alive(self) -> list:
        with self._lock:
            return self._alive_locked()

    def active(self) -> list:
        """Workers eligible for NEW work: ACTIVE only."""
        with self._lock:
            return sorted(p for p, w in self._workers.items()
                          if w["state"] == ACTIVE)

    def nodes(self) -> list:
        """Per-worker view (the JAX package's GET /3/Cloud)."""
        with self._lock:
            return [dict(pid=p, **w)
                    for p, w in sorted(self._workers.items())]

    def _notify(self, epoch: int, alive: list):
        # the JAX package first rebuilds the device mesh for the new epoch
        # (_mesh_epoch_listener); the port's one-card cloud has no mesh to
        # rebuild until the multi-device item
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(epoch, alive)
            except Exception:   # noqa: BLE001 — a listener must not fail it
                from h2o3_tpu_torch.utils import log as _ulog
                _ulog.err("membership listener failed for epoch %s", epoch)


MEMBERSHIP = Membership()

# module-level gauges reading the module global (bound to whatever
# MEMBERSHIP currently is, resilient to reset())
_om.gauge("h2o3_cloud_epoch",
          "current cloud membership epoch (bumps on every excision, "
          "join and drain-leave)",
          fn=lambda: float(MEMBERSHIP.epoch))
_om.gauge("h2o3_cloud_live_workers",
          "workers currently in the broadcast set (active or draining)",
          fn=lambda: float(len(MEMBERSHIP.alive())))


def current_epoch() -> int:
    return MEMBERSHIP.epoch


def _retry_backoff_s() -> float:
    """Jittered backoff before the one epoch retry: base from
    H2O3_EPOCH_RETRY_BACKOFF_S (default 50ms), uniform jitter in
    [0.5x, 1.5x] so a herd of straddled requests doesn't re-dispatch in
    lockstep."""
    base = env_float("H2O3_EPOCH_RETRY_BACKOFF_S", 0.05)
    return base * (0.5 + random.random())


def retry_once(fn, op: str = "op"):
    """Run `fn()`; when it raises EpochChanged — or any exception while
    the cloud epoch moved under it — back off (jittered) and retry
    exactly once against the new epoch. Exceptions with a stable epoch
    propagate unchanged: a real bug must not get a free second attempt
    that hides it."""
    e0 = MEMBERSHIP.epoch
    try:
        return fn()
    except EpochChanged:
        pass
    except Exception:
        if MEMBERSHIP.epoch == e0:
            raise
    EPOCH_RETRIES.inc(op=op)
    time.sleep(_retry_backoff_s())
    return fn()
