"""Elastic cloud membership of the port (h2o3_tpu/deploy/membership.py) —
the epoch state machine over the replay channel.

The reference freezes membership at `Paxos.lockCloud()` (water/Paxos.java:
145): after formation a lost node kills the cloud. Here membership is a
state machine:

  * The cloud has an integer **epoch**, bumped on every membership change
    (excision, join, drain-leave); workers are tracked per epoch with a
    state (`active` → `draining` → `left`, or `active` → `dead`).
  * `ElasticBroadcaster` replaces the fixed-membership Broadcaster on the
    coordinator: a worker that blows the ack deadline, drops its socket or
    misses heartbeats is **excised** — marked dead, epoch bumped, replay
    resumed over the surviving set — instead of failing the request.
  * A joining/replacement worker handshakes on the still-open listener,
    receives the current epoch + a replayed-state snapshot (the bounded
    log of already-broadcast mutating requests), replays it to converge,
    and enters the broadcast set.
  * `POST /3/Cloud/drain` finishes in-flight jobs and micro-batches, then
    sends the worker a clean `leave` op before excising it.
  * Every epoch bump re-homes DKV keys through the consistent-hash ring
    (core/kvstore.set_membership) and tells the cloud (parallel/mesh
    `note_epoch`): the process group the world was formed with has lost
    or changed a rank, so its next collective raises WorldBroken instead
    of waiting on a peer that is gone. Scoring needs no collective and
    carries on; a replacement is a world of one that replays the snapshot
    on all the rows.

Detection bounds: the broadcast ack deadline (H2O3_REPLAY_ACK_TIMEOUT_S)
for workers that wedge mid-request, plus a heartbeat loop
(H2O3_HEARTBEAT_S, excise after H2O3_HEARTBEAT_MISSES consecutive
misses) for workers that die while the channel is idle.

`retry_once` retries an operation that failed while the epoch moved
under it (or raised EpochChanged) exactly once, with jittered backoff —
wired into micro-batch dispatch and the mrtask dispatch funnel.

Env surface: H2O3_EPOCH_RETRY_BACKOFF_S (0.05), H2O3_HEARTBEAT_S (10),
H2O3_HEARTBEAT_MISSES (3), H2O3_DRAIN_TIMEOUT_S (30),
H2O3_REPLAY_LOG_MAX (256).
"""

from __future__ import annotations

import random
import socket as _socket_mod
import threading
import time

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.deploy import chaos as _chaos
from h2o3_tpu_torch.deploy import multihost as _mh
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs import watchdog as _wd
from h2o3_tpu_torch.obs.timeline import span as _span
from h2o3_tpu_torch.utils.env import env_float, env_int

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
        # h2o3-ok: R003 _locked helper — every caller holds self._lock
        self._workers[pid] = {"state": state, "epoch": self.epoch + 1,
                              "reason": reason}
        # h2o3-ok: R003 _locked helper — every caller holds self._lock
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
        # built-in first: the cloud's epoch is part of the epoch contract
        # (not a removable listener — reset() must not detach it)
        _mesh_epoch_listener(epoch, alive)
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(epoch, alive)
            except Exception:   # noqa: BLE001 — a listener must not fail it
                from h2o3_tpu_torch.utils import log as _ulog
                _ulog.err("membership listener failed for epoch %s", epoch)


MEMBERSHIP = Membership()


def _mesh_epoch_listener(epoch: int, alive: list):
    """Every membership change moves the cloud to the new epoch
    (parallel.mesh.note_epoch): a world formed with a process group that
    lost or changed a rank stops issuing collectives."""
    del alive
    try:
        from h2o3_tpu_torch.parallel import mesh as _pmesh
        _pmesh.note_epoch(epoch)
    except Exception:   # noqa: BLE001 — a cloud update failure must not
        from h2o3_tpu_torch.utils import log as _ulog   # kill the channel
        _ulog.err("cloud update for epoch %s failed", epoch)

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


def _heartbeat_s() -> float:
    return env_float("H2O3_HEARTBEAT_S", 10.0)


def _heartbeat_misses() -> int:
    return env_int("H2O3_HEARTBEAT_MISSES", 3)


def _drain_timeout_s() -> float:
    return env_float("H2O3_DRAIN_TIMEOUT_S", 30.0)


def _replay_log_max() -> int:
    return env_int("H2O3_REPLAY_LOG_MAX", 256)


class ElasticBroadcaster(_mh.Broadcaster):
    """The elastic coordinator: the fixed-membership Broadcaster plus the
    epoch state machine. Differences from the base:

      * `broadcast` excises a failing worker (ack timeout, send error,
        bad ack) and finishes over the survivors instead of raising.
      * The formation listener stays open; an acceptor thread admits
        joining/replacement workers (handshake → epoch + snapshot
        welcome → broadcast set).
      * A heartbeat loop (`ping` collect op) excises workers that die
        while the channel is idle.
      * `drain` quiesces in-flight jobs + micro-batches, sends the
        worker a clean `leave`, and excises it with reason `drain`.
    """

    def __init__(self, n_workers: int, port: int, membership=None):
        from collections import deque
        super().__init__(n_workers, port, keep_listener=True)
        self.membership = membership if membership is not None \
            else MEMBERSHIP
        self._replay_log = deque(maxlen=_replay_log_max())
        self._log_total = 0
        self._hb_misses: dict = {}
        for pid in self._pids:
            self.membership.register(pid)
        # every membership change re-homes DKV keys over the new ring
        # (node 0 = the coordinator itself, always a member)
        from h2o3_tpu_torch.core.kvstore import DKV as _dkv
        self.membership.add_listener(
            lambda epoch, alive, _d=_dkv: _d.set_membership(
                [0] + list(alive), epoch=epoch))
        _dkv.set_membership([0] + self.membership.alive(),
                            epoch=self.membership.epoch)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="h2o3-membership-accept")
        self._accept_thread.start()
        if _heartbeat_s() > 0:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True, name="h2o3-heartbeat")
            self._hb_thread.start()

    # ---- lifecycle -------------------------------------------------------
    def close(self):
        self._closed = True
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        with self._lock:
            for c, _k in self._conns:
                try:
                    c.close()
                except OSError:
                    pass

    # ---- excision --------------------------------------------------------
    def _excise_locked(self, i: int, reason: str, state: str = DEAD):
        """Caller holds self._lock. Marks the slot dead, closes its
        socket, and advances the membership epoch."""
        if self._dead[i]:
            return
        self._dead[i] = True   # h2o3-ok: R003 only reachable with self._lock held (broadcast/collect/drain paths)
        try:
            self._conns[i][0].close()
        except OSError:
            pass
        if reason in ("ack_timeout",):
            _mh._ack_timeouts_counter().inc()
        if state == LEFT:
            self.membership.leave(self._pids[i])
        else:
            self.membership.excise(self._pids[i], reason)

    def _reconcile_dead(self):
        """Lift slots the BASE collect path marked dead (send/recv
        errors) into proper excisions with an epoch bump."""
        with self._lock:
            # only a pid's latest slot speaks for it: a replacement that
            # rejoined under a dead worker's id must not be excised for
            # the old slot (the JAX broadcaster lifts every dead slot)
            latest = {p: i for i, p in enumerate(self._pids)}
            stale = [i for i in range(len(self._conns))
                     if self._dead[i] and latest[self._pids[i]] == i
                     and self.membership.state(self._pids[i])
                     in (ACTIVE, DRAINING)]
            for i in stale:
                try:
                    self._conns[i][0].close()
                except OSError:
                    pass
        for i in stale:
            self.membership.excise(self._pids[i], "error")

    # ---- replay ----------------------------------------------------------
    def _drain_owed_elastic(self, i: int, deadline: float):
        """Bounded owed-ack drain that signals failure by exception (the
        caller excises) instead of wedging the whole broadcast."""
        import time as _time
        while self._owed[i] > 0:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise TimeoutError("owed-ack drain deadline")
            if self._recv_frame_at(i, timeout=remaining) is None:
                break                        # peer gone: excised below
            self._owed[i] -= 1   # h2o3-ok: R003 only reachable from broadcast(), which holds self._lock

    def broadcast(self, method: str, path: str, params: dict, trace=None,
                  sampled=False, log=True):
        """Fan out + ack barrier over the LIVE set; a worker that fails
        any step is excised (epoch bump) and the broadcast completes
        over the survivors — replay resumes instead of raising. `log`
        False keeps a request that changes no replicated state (payload
        scoring) out of the join-sync snapshot."""
        import time as _time
        with _wd.watch("replay", desc=f"broadcast {method} {path}",
                       deadline_s=min(_mh._ack_timeout() / 2,
                                      _wd._stall_s()),
                       trace=trace), \
                self._lock:
            self._seq += 1
            msg = {"seq": self._seq, "method": method, "path": path,
                   "params": params, "epoch": self.membership.epoch}
            if trace:
                msg["trace"] = trace
            if sampled:
                msg["sampled"] = 1
            # the join-sync snapshot: a bounded log of MUTATING requests a
            # replacement worker replays to converge (GETs are broadcast
            # for SPMD lockstep but change no state worth syncing)
            if method != "GET" and log:
                self._replay_log.append({"method": method, "path": path,
                                         "params": params})
                self._log_total += 1   # h2o3-ok: R003 only reachable from broadcast(), which holds self._lock
            deadline = _time.monotonic() + _mh._ack_timeout()
            failed: list = []
            awaiting: list = []
            for i in range(len(self._conns)):
                if self._dead[i]:
                    continue
                c, key = self._conns[i]
                act = _chaos.at("replay.send", worker=self._pids[i])
                if act is not None and act["action"] == "sever":
                    try:
                        c.close()            # fault: cut the socket NOW
                    except OSError:
                        pass
                dropped = act is not None and act["action"] == "drop"
                try:
                    # grace floor mirrors the recv phase: a wedged worker
                    # ahead of us consuming the shared deadline must not
                    # cascade healthy peers (whose sends are instant and
                    # owed-ack queues empty) into excisions
                    remaining = max(deadline - _time.monotonic(), 0.25)
                    self._drain_owed_elastic(
                        i, _time.monotonic() + remaining)
                    remaining = max(deadline - _time.monotonic(), 0.25)
                    if not dropped:
                        _mh._send_frame(c, key, msg, timeout=remaining)
                    awaiting.append(i)
                except TimeoutError:
                    failed.append((i, "ack_timeout"))
                except Exception:   # noqa: BLE001 — peer broken: excise
                    failed.append((i, "send_error"))
            for i in awaiting:
                try:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        # a wedged worker ahead of us consumed the shared
                        # budget; healthy peers' acks are (almost always)
                        # already in their buffers — a small grace keeps
                        # ONE dead worker from cascading the whole
                        # barrier into excisions, while still bounding
                        # the total hold at deadline + grace×workers
                        remaining = 0.25
                    ack = self._recv_frame_at(i, timeout=remaining)
                    if not ack or ack.get("ack") != self._seq:
                        failed.append((i, "bad_ack"))
                except (_socket_mod.timeout, TimeoutError):
                    failed.append((i, "ack_timeout"))
                except Exception:   # noqa: BLE001 — peer broken: excise
                    failed.append((i, "recv_error"))
            for i, reason in failed:
                self._excise_locked(i, reason)
            # seq hands the divergence sanitizer this request's identity
            # (mismatches must never raise in here: an exception in the
            # send/ack loops above reads as a broken peer and excises it
            # — the dispatcher's raise_if_pending owns surfacing them)
            return self._seq

    def collect(self, op: str, timeout: float = 2.0) -> list:
        """Base collect, then lift peers it found broken into proper
        excisions (epoch bump). Lagging-but-alive workers still just owe
        an ack — laggards are a heartbeat concern, not a collect one."""
        out = super().collect(op, timeout=timeout)
        self._reconcile_dead()
        return out

    def live_pids(self) -> list:
        """Fan-out share-holders: the base live set minus DRAINING
        workers (a drain must not be handed fresh parse chunks)."""
        active = set(self.membership.active())
        return [p for p in super().live_pids() if p in active]

    # ---- joins -----------------------------------------------------------
    def _accept_loop(self):
        """Admit joining/replacement workers on the still-open listener.
        The 1s accept timeout keeps shutdown prompt (R013 bound)."""
        from h2o3_tpu_torch.utils import log as _ulog
        while not self._closed:
            try:
                conn, addr = self._srv.accept()
            except _socket_mod.timeout:
                continue
            except OSError:
                return                       # listener closed: shutting down
            try:
                self._admit(conn, addr)
            except Exception as ex:  # noqa: BLE001 — reject peer, keep serving
                _ulog.warn("membership: rejected joining peer %s: %s",
                           addr, ex)
                try:
                    conn.close()
                except OSError:
                    pass

    def _admit(self, conn, addr):
        """Handshake a joiner, sync epoch + snapshot, enter the set."""
        hello, key = _mh._challenge_peer(conn, self._secret)
        pid = hello["hello"]
        with self._lock:
            for i, known in enumerate(self._pids):
                if known == pid and not self._dead[i]:
                    raise RuntimeError(
                        f"worker id {pid} is still live (rejoin requires "
                        "the old connection dead)")
            truncated = self._log_total > len(self._replay_log)
            # send the welcome BEFORE committing the join: a joiner whose
            # socket dies mid-handshake must not become a ghost ACTIVE
            # member (epoch bumped, keys re-homed onto a node with no
            # connection, un-excisable because it never entered _pids).
            # Every membership change happens under self._lock, so the
            # epoch the join WILL produce is deterministic here.
            welcome = {"welcome": pid, "epoch": self.membership.epoch + 1,
                       "seq": self._seq + 1,
                       "snapshot": list(self._replay_log),
                       "snapshot_truncated": truncated}
            _mh._send_frame(conn, key, welcome, timeout=10.0)
            self.membership.join(pid, synced=not truncated)
            conn.settimeout(None)
            self._conns.append((conn, key))
            self._owed.append(0)
            self._bufs.append(b"")
            self._dead.append(False)
            self._pids.append(pid)
            self._hb_misses.pop(pid, None)

    # ---- heartbeat -------------------------------------------------------
    def _hb_loop(self):
        """Idle-channel liveness: a `ping` collect every H2O3_HEARTBEAT_S;
        H2O3_HEARTBEAT_MISSES consecutive silent rounds excise the worker
        — bounded detection even when no requests are flowing."""
        while not self._closed:
            time.sleep(_heartbeat_s())
            if self._closed:
                return
            try:
                res = self.collect("ping",
                                   timeout=min(_heartbeat_s() / 2, 2.0))
            except Exception:   # noqa: BLE001 — next round retries
                continue
            lagging = []
            with self._lock:
                for i, r in enumerate(res):
                    if i >= len(self._pids) or self._dead[i]:
                        continue
                    pid = self._pids[i]
                    if r is None:
                        n = self._hb_misses.get(pid, 0) + 1
                        self._hb_misses[pid] = n
                        if n >= _heartbeat_misses():
                            lagging.append(i)
                    else:
                        self._hb_misses[pid] = 0
                for i in lagging:
                    self._excise_locked(i, "heartbeat")

    # ---- drain -----------------------------------------------------------
    def drain(self, pid: int) -> dict:
        """Graceful departure: finish in-flight jobs and micro-batches
        (bounded by H2O3_DRAIN_TIMEOUT_S), send the worker a clean
        `leave` op, then excise it with an epoch bump."""
        with self._lock:
            slot = next((i for i, p in enumerate(self._pids)
                         if p == pid and not self._dead[i]), None)
        if slot is None:
            raise ValueError(f"node {pid} is not a live worker")
        with _span("membership.drain", node=pid):
            self.membership.start_drain(pid)
            quiesced = self._wait_quiesce(_drain_timeout_s())
            with self._lock:
                if not self._dead[slot]:
                    # OUT-OF-BAND leave (seq -1): this frame goes to ONE
                    # worker only, so it must not consume a shared
                    # sequence number — a hole in the survivors' streams
                    # would kill them at their next continuity check
                    try:
                        c, key = self._conns[slot]
                        _mh._send_frame(c, key,
                                        {"seq": -1, "op": "leave"},
                                        timeout=5.0)
                        # absorb any owed acks ahead of the leave ack
                        deadline = time.monotonic() + 5.0
                        left_ok = False
                        while time.monotonic() < deadline:
                            ack = self._recv_frame_at(
                                slot,
                                timeout=deadline - time.monotonic())
                            if ack is None:
                                break
                            if ack.get("ack") == -1:
                                left_ok = True
                                break
                            if self._owed[slot] > 0:
                                self._owed[slot] -= 1   # h2o3-ok: R003 under self._lock (drain holds it)
                    except Exception:   # noqa: BLE001 — leave is best-effort
                        left_ok = False
                    self._excise_locked(slot, "drain", state=LEFT)
                else:
                    left_ok = False
        return {"node": pid, "epoch": self.membership.epoch,
                "quiesced": quiesced, "left_cleanly": left_ok}

    @staticmethod
    def _wait_quiesce(timeout_s: float) -> bool:
        """Poll until no job is RUNNING and the micro-batch queue is
        empty, bounded by `timeout_s`. Returns whether it quiesced."""
        from h2o3_tpu_torch.core.jobs import jobs_list
        from h2o3_tpu_torch.serving.microbatch import BATCHER
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                busy_jobs = any(j.get("status") == "RUNNING"
                                for j in jobs_list())
            except Exception:   # noqa: BLE001 — job census best-effort
                busy_jobs = False
            if not busy_jobs and BATCHER._depth == 0:
                return True
            time.sleep(0.05)
        return False
