"""Micro-batching queue of the port (h2o3_tpu/serving/microbatch.py) for
REST scoring — one padded dispatch per bucket.

Concurrent `POST /3/Predictions/...` requests against the same model
coalesce into ONE device dispatch: the first arrival becomes the batch
leader, lingers a few milliseconds (H2O3_SCORE_LINGER_MS, default 2) for
followers, stacks every request's staged rows into one bucket-padded
host buffer, runs the cached scorer once (`scorer_cache.score_rows`: on
the card one replay of the CUDA graph of the bucket that holds the rows
of all its requests), and fans the result rows back out per request. Requests for different models (or different DKV
generations of the same key) never mix.

This converts serving throughput from O(dispatches == requests) to
O(dispatches == buckets): at high concurrency the accelerator sees a few
large padded batches instead of a stream of tiny ones.

On the card a program replays one dispatch at a time (its graph's input
and output are fixed buffers), so with a linger a group keeps at most
one dispatch in flight: a leader whose linger ends while its group's
previous dispatch is still on the device keeps its batch open until
that dispatch lands, and every request that arrives meanwhile joins it.
With H2O3_SCORE_LINGER_MS=0 a leader dispatches at once, as in the JAX
package.

Multi-tenant QoS (serving/qos.py): the single FIFO became per-principal
weighted-fair queues — requests coalesce only within their principal
(group key carries it), each tenant's occupancy of the global depth
bound is capped at its share, device slots are granted to ready
dispatches by deficit round-robin over configured weights, and a
request whose X-H2O3-Deadline-Ms budget elapsed is shed before staging
(entry) or skipped by its coalesced dispatch (a dead follower) — never
paid for on the device.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.deploy import chaos as _chaos
from h2o3_tpu_torch.deploy import membership as _mb
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs import tracing as _tracing
from h2o3_tpu_torch.obs import usage as _usage
from h2o3_tpu_torch.obs.timeline import span as _span
from h2o3_tpu_torch.serving import qos as _qos
from h2o3_tpu_torch.serving import scorer_cache as _sc
from h2o3_tpu_torch.utils.env import env_float, env_int

REQUESTS = _om.counter("h2o3_score_microbatch_requests_total",
                       "scoring requests entering the micro-batch queue")
DISPATCHES = _om.counter("h2o3_score_microbatch_dispatches_total",
                         "coalesced device dispatches leaving the queue")
REJECTED = _om.counter("h2o3_microbatch_rejected_total",
                       "scoring requests rejected by queue-depth "
                       "backpressure (HTTP 503 + Retry-After)")
WAIT_TIMEOUTS = _om.counter("h2o3_microbatch_wait_timeouts_total",
                            "follower requests whose bounded wait on the "
                            "batch leader expired (H2O3_SCORE_WAIT_S) — "
                            "a nonzero rate means dispatches are stalling")
BATCH_ROWS = _om.histogram("h2o3_score_microbatch_rows",
                           "real rows per coalesced dispatch",
                           buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                    1024, 4096, 16384, 65536))
BATCH_SECONDS = _om.histogram(
    "h2o3_score_microbatch_seconds",
    "coalesced dispatch wall time (staging + device + readback); the "
    "exemplar carries one served request's trace id")

def _wait_s() -> float:
    """Follower safety timeout (seconds): no Event.wait on the serving
    path is unbounded — a leader that died between
    registration and dispatch must strand followers for a bounded time,
    not forever. Dispatch failures set per-request errors well before
    this fires; it is the backstop, not the control path."""
    return max(1.0, env_float("H2O3_SCORE_WAIT_S", 120.0))


class QueueFull(Exception):
    """Queue-depth backpressure: the caller should answer 503 with
    Retry-After rather than stacking another blocked thread. Raised
    instead of queueing so an overloaded accelerator sheds load at the
    REST edge (bounded memory, bounded thread count) — the ROADMAP's
    "micro-batch queue depth limit" gap."""

    def __init__(self, depth: int, limit: int, retry_after_s: int = 1):
        super().__init__(
            f"micro-batch queue full ({depth} pending >= limit {limit})")
        self.retry_after_s = retry_after_s


def _linger_s() -> float:
    return max(0.0, env_float("H2O3_SCORE_LINGER_MS", 2.0)) / 1e3


def _queue_depth_limit() -> int:
    """Max in-flight requests across all models (0 disables the bound).
    Default 512: at the default 2ms linger a healthy queue drains in a
    couple of dispatches, so hundreds of waiters means the device is
    stalled — shed rather than queue."""
    return env_int("H2O3_SCORE_QUEUE_DEPTH", 512)


class _Request:
    __slots__ = ("raw", "n", "event", "result", "error", "trace",
                 "principal", "deadline", "t_enqueue", "stages")

    def __init__(self, raw: np.ndarray, n: int):
        self.raw = raw
        self.n = n
        self.event = threading.Event()
        self.result = None
        self.error = None
        # latency decomposition: enqueue time anchors the per-request
        # queue-wait stage; the coalesced dispatch stamps its shared
        # stage timings (gate/decode/device/readback) here so the
        # submitting thread can merge them into its own waterfall
        self.t_enqueue = time.perf_counter()
        self.stages = None
        # submitting request's trace id: the coalesced dispatch span
        # links every parent trace it served
        self.trace = _tracing.current()
        # QoS context, captured on the submitting thread: the principal
        # keys the weighted-fair queue, and the deadline rides the
        # micro-batch so the coalesced dispatch can skip a follower
        # whose caller already gave up
        self.principal = _tracing.principal()
        self.deadline = _tracing.deadline()


class MicroBatcher:
    def __init__(self):
        self._lock = make_lock("microbatch")
        self._pending: dict = {}
        self._depth = 0       # in-flight requests (entered, not yet woken)
        self._queued: dict = {}   # principal -> in-flight request count
        self._inflight: dict = {}  # group key -> Event set when it lands

    def check_capacity(self):
        """Raise QueueFull when the in-flight bound is already hit — for
        callers to shed load BEFORE paying frame adaptation + staging.
        Also the QoS admission point (deadline shed → 504, token-bucket
        rate limit → 429, per-tenant queue share → 503): everything that
        can reject a request does so before the per-column decode.
        Advisory (no reservation): score() re-checks authoritatively."""
        _qos.admit()
        limit = _queue_depth_limit()
        principal = _tracing.principal()
        share_cap = _qos.tenant_share_cap(limit)
        with self._lock:
            if limit > 0 and self._depth >= limit:
                REJECTED.inc()
                raise QueueFull(self._depth, limit)
            held = self._share_held_locked(principal, limit, share_cap)
        if held is not None:
            self._share_rejected(principal, held, share_cap)

    def _share_held_locked(self, principal, limit, share_cap):
        """This principal's in-flight count when it is at/over its queue
        share (caller holds self._lock), else None. The one owner of the
        share-cap comparison for both admission sites."""
        if limit <= 0 or not principal:
            return None
        held = self._queued.get(principal, 0)
        return held if held >= share_cap else None

    @staticmethod
    def _share_rejected(principal, held, share_cap):
        """Share-cap rejection (→ 503): counters + raise, called OUTSIDE
        self._lock so the reject path never nests the metrics-registry
        lock inside the micro-batch lock in a new order."""
        REJECTED.inc()
        _qos.note_share_reject(principal)
        raise QueueFull(held, share_cap)

    def queued_by_principal(self) -> dict:
        """Snapshot of per-principal in-flight counts (the
        h2o3_qos_queue_depth{principal} gauge callback). LOCK-FREE
        (GIL-atomic dict copy), like the depth gauge: the callback runs
        under the metrics-registry lock while admission emits counters
        under the micro-batch lock — taking self._lock here would be
        the reverse order edge (lockdep inversion)."""
        return dict(self._queued)

    def score(self, model, raw: np.ndarray, n: int) -> np.ndarray:
        """Submit (n, C) staged raw rows; returns the (n, ...) host result
        for exactly these rows. Blocks until the coalesced dispatch lands.
        Raises QueueFull (→ HTTP 503) when the in-flight bound — or the
        submitting tenant's share of it — is hit.
        """
        REQUESTS.inc()
        req = _Request(np.asarray(raw[:n], np.float32), n)
        # token (not DKV version): requests only coalesce when they hold
        # the SAME model object, so a mid-stream overwrite can never mix
        # two generations in one dispatch. The PRINCIPAL is part of the
        # key: tenants never share a coalesced dispatch, so each group
        # charges exactly one tenant at the fair gate.
        key = (model.key, _sc.model_token(model), raw.shape[1],
               req.principal)
        limit = _queue_depth_limit()
        share_cap = _qos.tenant_share_cap(limit)
        share_held = None
        with self._lock:
            if limit > 0 and self._depth >= limit:
                REJECTED.inc()
                raise QueueFull(self._depth, limit)
            share_held = self._share_held_locked(req.principal, limit,
                                                 share_cap)
            if share_held is None:
                self._depth += 1
                if req.principal:
                    self._queued[req.principal] = \
                        self._queued.get(req.principal, 0) + 1
                group = self._pending.get(key)
                leader = group is None
                if leader:
                    group = self._pending[key] = []
                group.append(req)
        if share_held is not None:
            # deferred out of the lock: enqueue must be atomic with the
            # check, but the rejection counters must not emit under it
            self._share_rejected(req.principal, share_held, share_cap)
        _qos.note_interactive_start()
        try:
            out = self._await_result(model, key, req, leader)
            # fold the dispatch's stamped stage timings (queue/gate/
            # device/readback) into THIS thread's request waterfall —
            # followers inherit the breakdown the leader measured
            if req.stages:
                _usage.merge_stages(req.stages)
            return out
        finally:
            _qos.note_interactive_end()
            with self._lock:
                self._depth -= 1
                if req.principal:
                    left = self._queued.get(req.principal, 0) - 1
                    if left <= 0:
                        self._queued.pop(req.principal, None)
                    else:
                        self._queued[req.principal] = left

    def _await_result(self, model, key, req, leader) -> np.ndarray:
        if leader:
            batch = None
            try:
                linger = _linger_s()
                if linger > 0:
                    time.sleep(linger)
                batch, done = self._take_batch(key, turn=linger > 0)
                try:
                    self._dispatch(model, batch)
                finally:
                    if done is not None:
                        with self._lock:
                            if self._inflight.get(key) is done:
                                del self._inflight[key]
                        done.set()
            except BaseException as ex:
                # the group must NEVER be orphaned: a leader failure
                # before the pop (or a non-Exception during dispatch)
                # would otherwise leave followers blocking on a dead
                # batch — and every later request joining it
                if batch is None:
                    with self._lock:
                        batch = self._pending.pop(key, None) or []
                err = ex if isinstance(ex, Exception) \
                    else RuntimeError(repr(ex))
                for r in batch:
                    if not r.event.is_set():
                        r.error = r.error or err
                        r.event.set()
                raise
        else:
            # watchdog-watched: a follower stuck behind a wedged leader
            # dispatch is a stall the sentinel should diagnose (cluster
            # JStack shows WHERE the leader is stuck) before the bounded
            # wait below turns it into a plain timeout — so the watch
            # deadline must undercut H2O3_SCORE_WAIT_S, after which this
            # context exits and the sentinel has nothing left to see
            from h2o3_tpu_torch.obs import watchdog as _wd
            with _wd.watch("microbatch",
                           desc=f"follower wait {model.key}",
                           deadline_s=min(_wait_s() / 2,
                                          _wd._stall_s()),
                           trace=req.trace):
                ok = req.event.wait(timeout=_wait_s())
            if not ok:
                WAIT_TIMEOUTS.inc()
                raise TimeoutError(
                    "micro-batched scoring dispatch timed out "
                    f"after {_wait_s():g}s (H2O3_SCORE_WAIT_S)")
        if req.error is not None:
            raise req.error
        return req.result

    def _take_batch(self, key, turn: bool):
        """Close the group's batch: (batch, None) at once without a turn;
        with one, wait (bounded by H2O3_SCORE_WAIT_S, then fail open)
        until the group's previous dispatch has landed — the batch stays
        open to new requests meanwhile — and return (batch, the Event to
        set when this dispatch lands)."""
        if not turn:
            with self._lock:
                return self._pending.pop(key), None
        give_up = time.monotonic() + _wait_s()
        while True:
            with self._lock:
                busy = self._inflight.get(key)
                if busy is None or time.monotonic() >= give_up:
                    done = self._inflight[key] = threading.Event()
                    return self._pending.pop(key), done
            busy.wait(timeout=max(0.0, give_up - time.monotonic()))

    @staticmethod
    def _dispatch(model, batch):
        # chunk so one coalesced dispatch never exceeds the fast-path row
        # ceiling each request passed individually — 32×65k-row requests
        # must not fuse into one 2M-row bucket (new giant program, HBM
        # spike). A single request is already ≤ the cap by eligibility.
        cap = _sc._max_rows()
        chunks, cur, cur_rows = [], [], 0
        for r in batch:
            if cur and cur_rows + r.n > cap:
                chunks.append(cur)
                cur, cur_rows = [], 0
            cur.append(r)
            cur_rows += r.n
        chunks.append(cur)
        for chunk in chunks:
            MicroBatcher._dispatch_chunk(model, chunk)

    @staticmethod
    def _dispatch_chunk(model, batch):
        # deadline-aware shedding BEFORE staging or device dispatch: a
        # follower whose X-H2O3-Deadline-Ms budget elapsed while the
        # batch formed is answered 504 here — it contributes no rows, no
        # staging copy, and (when the whole chunk is dead) no dispatch
        # and no scorer compile at all. Gated off on multi-controller
        # runtimes: the workers replayed the broadcast and will join the
        # collective dispatch regardless, so the coordinator must too
        # (see qos.single_controller).
        now = time.monotonic()
        dead = [r for r in batch
                if _qos.deadline_dead(r.deadline, now)] \
            if _qos.single_controller() else []
        if dead:
            batch = [r for r in batch if not _qos.deadline_dead(r.deadline,
                                                                now)]
            for r in dead:
                r.error = _qos.DeadlineExceeded(now - r.deadline)
                r.event.set()
                _qos.SHED.inc(reason="batch")
        if not batch:
            return
        try:
            total = sum(r.n for r in batch)
            bucket = _sc.row_bucket(total)
            C = batch[0].raw.shape[1]
            # one coalesced dispatch serves N parent requests: the span
            # carries the leader's trace id AND links every follower's,
            # so each parent's GET /3/Trace/{id} shows this dispatch.
            # Trace-gated like scorer/mrtask spans: fully untraced
            # dispatches must not churn the bounded timeline ring
            links = sorted({r.trace for r in batch if r.trace})
            ctx = _span("microbatch.dispatch", rows=total,
                        requests=len(batch), links=links) \
                if links or _tracing.current() is not None \
                else contextlib.nullcontext()
            # weighted-fair gate: groups are single-principal (the key
            # carries it), so the whole chunk charges one tenant; under
            # device-slot contention grants follow deficit round-robin
            # over the configured weights. The queue-wait stage for every
            # request ends HERE (batch formed, dispatch starting); the
            # gate wait is its own stage.
            t_gate = time.perf_counter()
            took = _qos.GATE.acquire(batch[0].principal or _qos.ANONYMOUS,
                                     total)
            try:
                # timing reads live INSIDE the try: any statement between
                # acquire and the finally is a path that leaks the slot
                # if it raises
                t0 = time.perf_counter()
                gate_s = t0 - t_gate
                with ctx as sp, _usage.capture_stages() as shared:
                    with _usage.stage("decode"):
                        raw = np.full((bucket, C), np.nan, np.float32)
                        off = 0
                        for r in batch:
                            raw[off:off + r.n] = r.raw
                            off += r.n
                    # membership-aware dispatch: a scoring batch straddling
                    # a cloud-epoch bump (a worker excised mid-request)
                    # retries once with jittered backoff against the new
                    # epoch instead of failing all N coalesced requests.
                    # The chaos hook lets the fault harness fail a seeded
                    # dispatch deterministically.
                    def _score():
                        _chaos.maybe_raise("microbatch.dispatch",
                                           exc=_mb.EpochChanged)
                        return _sc.score_rows(model, raw, total,
                                              links=links)

                    out = _mb.retry_once(_score, op="microbatch")
                    # gate wait joins the captured decode/device/readback
                    # splits; the breakdown rides the dispatch span too
                    # (stamped before the span closes — the flight
                    # recorder snapshots at end)
                    shared["gate"] = shared.get("gate", 0.0) + gate_s
                    if sp is not None:
                        sp.attrs["stages"] = {k: round(v, 6)
                                              for k, v in shared.items()}
            finally:
                _qos.GATE.release(took)
            DISPATCHES.inc()
            # one served trace id rides each histogram as an OpenMetrics
            # exemplar, so a dispatch-latency spike resolves to a trace
            ex = links[0] if links else _tracing.current()
            BATCH_ROWS.observe(total, exemplar=ex)
            BATCH_SECONDS.observe(time.perf_counter() - t0, exemplar=ex)
            # stamp the waterfall onto every served request: queue wait
            # is per-request (enqueue → dispatch start); the gate wait
            # and captured decode/device/readback are chunk-shared —
            # each coalesced caller experienced that same wall time
            off = 0
            for r in batch:
                st = {"queue": max(0.0, t_gate - r.t_enqueue)}
                st.update(shared)
                r.stages = st
                r.result = out[off:off + r.n]
                off += r.n
        except Exception as ex:   # noqa: BLE001 — every waiter must wake
            for r in batch:
                r.error = ex
        finally:
            for r in batch:
                r.event.set()


BATCHER = MicroBatcher()

# module-level registration reading the module global: bound to whatever
# BATCHER currently is, not to the first instance ever constructed (the
# registry keeps the first fn per name, so an instance-bound closure
# would pin a replaced batcher and report its dead depth forever)
_om.gauge("h2o3_microbatch_queue_depth",
          "scoring requests currently inside the micro-batch queue",
          fn=lambda: float(BATCHER._depth))
