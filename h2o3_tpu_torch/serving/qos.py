"""Multi-tenant QoS of the port (h2o3_tpu/serving/qos.py) — admission
control for the serving path.

The north star is heavy traffic from millions of users, but until this
module the serving path had exactly one overload valve: the global
micro-batch depth bound (H2O3_SCORE_QUEUE_DEPTH → 503). One flooding
tenant filled that queue and starved every well-behaved caller — the
overload failure mode "The Tail at Scale" (Dean & Barroso, CACM 2013)
warns against, and the one the SRE Workbook's load-shedding chapter
prescribes per-client fairness for. This module is the per-client half:

  * **Principals.** The REST layer (the JAX package's; the port's comes
    with the front-end item of ROADMAP.md §1, and until then callers
    enter `tracing.request_context`) resolves every request to a principal
    (the authenticated Basic user; the stable ``anonymous`` bucket on an
    unauthenticated server — the QoS path never branches on auth mode)
    and stamps it into the obs TLS alongside the trace id
    (obs/tracing.set_principal). Everything below keys on it.
  * **Token buckets** (per tenant): H2O3_QOS_RATE_RPS requests/second
    with H2O3_QOS_BURST capacity, per-principal overrides in
    H2O3_QOS_RATES. Over-rate requests get **429 + Retry-After** — the
    caller is misbehaving — which is deliberately distinct from the
    capacity **503** (the *server* is saturated).
  * **Weighted-fair dispatch** (the micro-batcher's per-principal
    queues): when more coalesced dispatches are ready than
    H2O3_QOS_MAX_INFLIGHT device slots, the fair gate grants slots by
    deficit round-robin over H2O3_QOS_WEIGHTS (default equal), charging
    each grant its real row count — a flood of big batches from one
    tenant cannot starve another tenant's next dispatch.
  * **Queue share**: one principal may hold at most
    H2O3_QOS_TENANT_SHARE of the global depth bound, so a flood can
    never occupy the whole queue and 503 a newcomer's first request.
  * **Concurrent-job quotas**: H2O3_QOS_MAX_JOBS bounds RUNNING Jobs per
    principal, enforced where Job.start runs (nested jobs a build spawns
    internally are not double-counted).
  * **Priority lanes**: interactive scoring preempts batch work at the
    scheduler — an mrtask device dispatch issued from a Job thread (the
    port's `batch_yield` has no caller until the mrtask dispatch comes
    with the multi-device item)
    defers (bounded by H2O3_QOS_BATCH_YIELD_S) while interactive
    requests are pending in the micro-batch queue. Never mid-batch: an
    in-flight device program always runs to completion.
  * **Deadline-aware shedding**: a request whose ``X-H2O3-Deadline-Ms``
    budget already elapsed is dropped with **504** *before* staging or
    device dispatch (h2o3_qos_shed_total{reason}); the deadline rides
    the micro-batch so a coalesced dispatch skips dead followers.

The uncontended path stays ≈ free: with one tenant under the in-flight
bound every check is a TLS read plus a couple of dict hits, the fair
gate takes its fast path, and no thread ever parks.

Env surface (all knobs declared here):
  H2O3_QOS               master switch (default on)
  H2O3_QOS_RATE_RPS      default per-tenant token rate (0 = unlimited)
  H2O3_QOS_BURST         token-bucket capacity (0 → max(1, 2×rate))
  H2O3_QOS_RATES         per-tenant rate overrides "alice:100,bob:5"
  H2O3_QOS_WEIGHTS       DRR weights "alice:4,bob:1" (default 1 each)
  H2O3_QOS_QUANTUM_ROWS  DRR quantum (rows added per round, default 2048)
  H2O3_QOS_MAX_INFLIGHT  device dispatch slots before the gate queues
  H2O3_QOS_GATE_WAIT_S   bounded wait for a slot (then fail open)
  H2O3_QOS_TENANT_SHARE  max fraction of the global queue one tenant
                         may hold (default 0.5; 1.0 disables)
  H2O3_QOS_MAX_JOBS      concurrent jobs per tenant (0 = unlimited)
  H2O3_QOS_BATCH_YIELD_S max per-dispatch batch-lane deferral
  H2O3_QOS_MAX_PRINCIPALS distinct principals tracked before folding
                         into the "_overflow" bucket (metric-cardinality
                         bound under credential churn)
"""

from __future__ import annotations

import math
import re
import threading
import time

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.obs import tracing as _tracing
from h2o3_tpu_torch.utils.env import env_bool, env_float, env_int, env_str

ANONYMOUS = "anonymous"
OVERFLOW = "_overflow"


# ---------------------------------------------------------------------------
# exceptions → HTTP status mapping (api/server._route_inner)
class RateLimited(Exception):
    """Token bucket empty → HTTP 429 + Retry-After. The CALLER is over
    its configured rate — distinct from QueueFull's 503, where the
    SERVER is out of capacity."""

    def __init__(self, principal: str, retry_after_s: float):
        super().__init__(
            f"tenant {principal!r} is over its request rate "
            "(H2O3_QOS_RATE_RPS / H2O3_QOS_RATES)")
        self.principal = principal
        self.retry_after_s = max(1, int(math.ceil(retry_after_s)))


class QuotaExceeded(Exception):
    """Concurrent-job quota hit → HTTP 429 + Retry-After."""

    def __init__(self, principal: str, limit: int):
        super().__init__(
            f"tenant {principal!r} already runs {limit} concurrent "
            "jobs (H2O3_QOS_MAX_JOBS)")
        self.principal = principal
        self.retry_after_s = 1


class DeadlineExceeded(Exception):
    """The caller's X-H2O3-Deadline-Ms budget elapsed → HTTP 504. Raised
    BEFORE staging/device work — the whole point is to never spend
    accelerator time on an answer nobody is waiting for."""

    def __init__(self, overrun_s: float):
        super().__init__(
            f"request deadline elapsed {overrun_s * 1e3:.0f}ms ago "
            "(X-H2O3-Deadline-Ms)")
        self.overrun_s = overrun_s


# ---------------------------------------------------------------------------
# config (one accessor site per variable)
def enabled() -> bool:
    """Master switch: H2O3_QOS=0 turns every mechanism in this module
    into a no-op (principals still resolve for metric labels)."""
    return env_bool("H2O3_QOS", True)


def _rate_rps() -> float:
    return env_float("H2O3_QOS_RATE_RPS", 0.0)


def _burst() -> float:
    return env_float("H2O3_QOS_BURST", 0.0)


def _rates_raw() -> str:
    return env_str("H2O3_QOS_RATES", "")


def _weights_raw() -> str:
    return env_str("H2O3_QOS_WEIGHTS", "")


def _quantum_rows() -> int:
    return max(1, env_int("H2O3_QOS_QUANTUM_ROWS", 2048))


def _max_inflight() -> int:
    return env_int("H2O3_QOS_MAX_INFLIGHT", 4)


def _gate_wait_s() -> float:
    return max(0.1, env_float("H2O3_QOS_GATE_WAIT_S", 30.0))


def tenant_share() -> float:
    return env_float("H2O3_QOS_TENANT_SHARE", 0.5)


def _max_jobs() -> int:
    return env_int("H2O3_QOS_MAX_JOBS", 0)


def _batch_yield_s() -> float:
    return env_float("H2O3_QOS_BATCH_YIELD_S", 0.5)


def _max_principals() -> int:
    return max(1, env_int("H2O3_QOS_MAX_PRINCIPALS", 256))


# ---------------------------------------------------------------------------
# metrics (declared once; per-principal label cardinality bounded by the
# principal fold below)
ADMITTED = _om.counter(
    "h2o3_qos_admitted_total",
    "requests admitted past QoS admission, by principal")
REJECTS = _om.counter(
    "h2o3_qos_rejected_total",
    "requests rejected by QoS admission, by principal and reason "
    "(rate = token bucket → 429; quota = concurrent-job cap → 429; "
    "share = per-tenant queue share → 503)")
SHED = _om.counter(
    "h2o3_qos_shed_total",
    "requests dropped because their X-H2O3-Deadline-Ms budget elapsed "
    "(→ 504), by where the corpse was found: entry = at the REST edge, "
    "admission = before staging, batch = a coalesced dispatch skipped "
    "the dead follower")
GATE_WAITS = _om.counter(
    "h2o3_qos_gate_waits_total",
    "coalesced dispatches that queued at the weighted-fair gate "
    "(device slots exhausted), by principal")
GATE_TIMEOUTS = _om.counter(
    "h2o3_qos_gate_timeouts_total",
    "fair-gate waits that hit H2O3_QOS_GATE_WAIT_S and failed OPEN "
    "(dispatched anyway) — nonzero means the device is badly stalled")
BATCH_YIELDS = _om.counter(
    "h2o3_qos_batch_yields_total",
    "batch-lane device dispatches (Job threads) that deferred to "
    "pending interactive scoring at the scheduler")
QOS_SECONDS = _om.histogram(
    "h2o3_qos_request_seconds",
    "scoring-request wall time by principal and status — the per-tenant "
    "SLI series; per-tenant SLO specs (obs/slo.py `principal` filter) "
    "burn against it")


def observe_request(seconds: float, exemplar, principal: str, status: str):
    """Record one scoring request in the per-tenant SLI histogram.
    The REST layer calls this rather than QOS_SECONDS.observe, so the
    label set is declared in one place."""
    QOS_SECONDS.observe(seconds, exemplar=exemplar,
                        principal=principal, status=status)


# ---------------------------------------------------------------------------
# principal resolution (bounded label cardinality)
_SAFE_PRINCIPAL = re.compile(r"[0-9a-zA-Z_.\-@]{1,64}")
_KNOWN_LOCK = make_lock("qos.principals")
_known: set = set()


def resolve_principal(user) -> str:
    """Auth outcome → stable principal: the authenticated user name
    (sanitized — it becomes a metric label and crosses the federation
    merge), else the one shared ``anonymous`` bucket. Distinct
    principals beyond H2O3_QOS_MAX_PRINCIPALS fold into ``_overflow``
    so credential churn can't blow up metric cardinality or tenant
    state."""
    if not user:
        return ANONYMOUS
    s = str(user).strip()[:64]
    if not _SAFE_PRINCIPAL.fullmatch(s):
        s = re.sub(r"[^0-9a-zA-Z_.\-@]", "_", s)[:64]
        if not s:
            return ANONYMOUS
    with _KNOWN_LOCK:
        if s in _known:
            return s
        if len(_known) < _max_principals():
            _known.add(s)
            return s
    return OVERFLOW


def _parse_map(raw: str) -> dict:
    """"alice:4,bob:1" → {"alice": 4.0, "bob": 1.0}; junk entries are
    dropped (config typos must not crash admission)."""
    out = {}
    for part in raw.split(","):
        name, sep, val = part.strip().partition(":")
        if not sep or not name:
            continue
        try:
            out[name] = float(val)
        except ValueError:
            continue
    return out


_weight_cache: tuple = ("", {})
_rate_cache: tuple = ("", {})


def weight(principal: str) -> float:
    """DRR weight for a principal (H2O3_QOS_WEIGHTS, default 1.0)."""
    global _weight_cache
    raw = _weights_raw()
    if raw != _weight_cache[0]:
        _weight_cache = (raw, _parse_map(raw))
    w = _weight_cache[1].get(principal, 1.0)
    return w if w > 0 else 1.0


def _rate_for(principal: str) -> float:
    global _rate_cache
    raw = _rates_raw()
    if raw != _rate_cache[0]:
        _rate_cache = (raw, _parse_map(raw))
    return _rate_cache[1].get(principal, _rate_rps())


# ---------------------------------------------------------------------------
# per-tenant token buckets (429 + Retry-After)
class _Bucket:
    __slots__ = ("tokens", "stamp", "rate", "burst")


_BUCKET_LOCK = make_lock("qos.tokens")
_buckets: dict = {}


def _bucket_burst(rate: float) -> float:
    b = _burst()
    return b if b > 0 else max(1.0, 2.0 * rate)


def charge_token(principal: str):
    """Take one token from the principal's bucket; raises RateLimited
    (→ 429) when empty, with Retry-After = time until the next token.
    Rate 0 (the default) means unlimited — no state is kept at all."""
    rate = _rate_for(principal)
    if rate <= 0:
        return
    burst = _bucket_burst(rate)
    now = time.monotonic()
    retry = None
    with _BUCKET_LOCK:
        b = _buckets.get(principal)
        if b is None:
            b = _buckets[principal] = _Bucket()
            b.tokens, b.stamp = burst, now
        b.rate, b.burst = rate, burst
        b.tokens = min(burst, b.tokens + (now - b.stamp) * rate)
        b.stamp = now
        if b.tokens < 1.0:
            retry = (1.0 - b.tokens) / rate
        else:
            b.tokens -= 1.0
    if retry is not None:
        REJECTS.inc(principal=principal, reason="rate")
        raise RateLimited(principal, retry)


def _token_series():
    """h2o3_qos_tokens{principal}: live bucket levels (refilled to the
    scrape instant so an idle tenant shows a full bucket)."""
    now = time.monotonic()
    with _BUCKET_LOCK:
        return [({"principal": p},
                 min(b.burst, b.tokens + (now - b.stamp) * b.rate))
                for p, b in sorted(_buckets.items())]


_om.gauge("h2o3_qos_tokens",
          "per-tenant token-bucket level (requests admissible right "
          "now before a 429)", fn=_token_series)


def _queue_series():
    """h2o3_qos_queue_depth{principal}: requests each tenant currently
    holds inside the micro-batch queue (the share-cap input)."""
    from h2o3_tpu_torch.serving import microbatch as _mb
    return [({"principal": p}, float(n))
            for p, n in sorted(_mb.BATCHER.queued_by_principal().items())]


_om.gauge("h2o3_qos_queue_depth",
          "scoring requests inside the micro-batch queue, by principal",
          fn=_queue_series)


# ---------------------------------------------------------------------------
# multi-controller guard: on a multi-controller runtime every host
# replays each broadcast request and launches the SAME collective
# scoring program — a coordinator that refuses a request AFTER the
# broadcast (rate 429, share 503, mid-pipeline 504) while the workers
# dispatch it would leave them alone in the collective (rendezvous
# wedge). So on process_count() > 1 the only rejection points are the
# PRE-broadcast ones (entry deadline shed + edge admission, see
# api/server._route_inner); mid-pipeline sheds and the share cap gate
# themselves off here. Replay-channel clouds of single-process-jax
# hosts (elastic joiners) are unaffected: their scoring programs never
# rendezvous across hosts, so a divergent refusal only wastes one
# worker-side score.
def single_controller() -> bool:
    """True unless this process is one rank of a world of several (the
    JAX package asks jax.process_count()). A replacement worker joined to
    the replay channel is a world of one and answers True."""
    from h2o3_tpu_torch.parallel import mesh as _mesh
    c = _mesh._CLOUD
    return c is None or c.world == 1


# ---------------------------------------------------------------------------
# deadlines
def check_deadline(reason: str):
    """Shed the current request (504) when its deadline already elapsed.
    No deadline in the TLS → free pass."""
    d = _tracing.deadline()
    if d is None:
        return
    over = time.monotonic() - d
    if over > 0:
        SHED.inc(reason=reason)
        raise DeadlineExceeded(over)


def deadline_dead(deadline, now: float) -> bool:
    """Is an absolute monotonic deadline already blown? (micro-batch
    follower check — the TLS belongs to a different thread there)."""
    return deadline is not None and now > deadline


# ---------------------------------------------------------------------------
# admission (called from microbatch.check_capacity, i.e. BEFORE payload
# decode / frame staging): deadline shed + token charge. Internal
# callers with no request context pass through untouched — QoS is a
# REST-edge mechanism, and in-process library use must stay unchanged.
def admit():
    if not enabled():
        return
    if single_controller():
        # mid-pipeline deadline shed — gated off on multi-controller
        # runtimes where the workers already replayed the broadcast and
        # will dispatch the collective regardless (see single_controller)
        check_deadline("admission")
    if getattr(_QTLS, "edge_admitted", False):
        return      # the REST edge already charged, pre-broadcast
    p = _tracing.principal()
    if p is None:
        return
    charge_token(p)
    ADMITTED.inc(principal=p)


def edge_admit():
    """REST-edge admission for scoring routes (handlers marked
    server.scores), taken BEFORE the replay broadcast — the same
    pre-broadcast discipline as prepay_job_slot: a 429 raised after the
    broadcast would leave every worker dispatching a collective scoring
    program the coordinator refused (lone-host rendezvous wedge). The
    in-pipeline admit() sees the TLS flag and skips the double charge;
    end_request() clears it at request teardown."""
    admit()
    _QTLS.edge_admitted = True


def end_request():
    """Request teardown (api/server._route_inner finally): clear the
    edge-admission flag and release a prepaid job charge no Job
    adopted (the handler 4xx'd before Job.start)."""
    _QTLS.edge_admitted = False
    settle_prepaid_job_slot()


def tenant_share_cap(limit: int) -> int:
    """Max slots of the global queue depth bound one principal may hold
    (H2O3_QOS_TENANT_SHARE). A flood therefore saturates its share and
    starts eating 503s while headroom remains for everyone else — the
    SRE Workbook's per-client fairness for load shedding."""
    share = tenant_share()
    if not enabled() or share >= 1.0 or share <= 0.0 or limit <= 0 \
            or not single_controller():
        # multi-controller: a share-cap 503 fires AFTER the broadcast
        # (queue state is coordinator-local), which would strand the
        # workers' replayed collective — keep the pre-QoS behavior there
        return limit
    return max(1, int(limit * share))


def note_share_reject(principal: str):
    REJECTS.inc(principal=principal, reason="share")


def eviction_standing(principal: str) -> float:
    """A [0, 1] standing score for cross-tenant param eviction
    (serving/params.py victim ordering): token-bucket headroom × queue
    -share headroom. Lower = heavier consumer right now = that tenant's
    cold placements are demoted first when ANOTHER tenant faults and
    no same-tenant victim exists. A tenant with no QoS state (idle, or
    rate 0 = unlimited with an empty queue) scores 1.0 — last to lose
    its models to someone else's churn."""
    tok = 1.0
    rate = _rate_for(principal)
    if rate > 0:
        now = time.monotonic()
        with _BUCKET_LOCK:
            b = _buckets.get(principal)
            if b is not None and b.burst > 0:
                tok = min(b.burst,
                          b.tokens + (now - b.stamp) * b.rate) / b.burst
    share = 1.0
    try:
        from h2o3_tpu_torch.serving import microbatch as _mb
        cap = tenant_share_cap(_mb._queue_depth_limit())
        if cap > 0:
            held = _mb.BATCHER.queued_by_principal().get(principal, 0)
            share = max(0.0, 1.0 - held / cap)
    except Exception:   # noqa: BLE001 — standing is advisory ordering only
        pass
    return max(0.0, min(1.0, tok * share))


# ---------------------------------------------------------------------------
# weighted-fair dispatch gate (deficit round-robin over principals)
class _Ticket:
    __slots__ = ("principal", "rows", "event", "granted")

    def __init__(self, principal: str, rows: int):
        self.principal = principal
        self.rows = max(1, int(rows))
        self.event = threading.Event()
        self.granted = False


class FairGate:
    """Bounds concurrently in-flight coalesced device dispatches at
    H2O3_QOS_MAX_INFLIGHT; excess dispatches park in per-principal
    queues and slots are granted by deficit round-robin: each grant
    round credits every waiting principal quantum×weight rows and the
    principal whose head ticket needs the fewest rounds wins (ties go
    round-robin), so over time granted ROWS converge to the weight
    ratio regardless of how many tickets a flood stacks up.

    Fast path (uncontended): one lock acquire, an int compare, no
    parking. Fail-open: a ticket that outwaits H2O3_QOS_GATE_WAIT_S
    dispatches anyway (counted) — fairness must never turn a slow
    device into a total outage.
    """

    def __init__(self):
        self._lock = make_lock("qos.gate")
        self._waiting: dict = {}     # principal -> list of _Ticket
        self._order: list = []       # round-robin order of waiting keys
        self._deficit: dict = {}     # principal -> credited rows
        self._inflight = 0

    # -- public -----------------------------------------------------------
    def acquire(self, principal: str, rows: int) -> bool:
        """Take a dispatch slot (blocks under contention). Returns True
        when a slot was taken — pass that token to release() in a
        finally. The token, not a re-read of the env, decides whether
        release decrements: flipping H2O3_QOS/H2O3_QOS_MAX_INFLIGHT
        while dispatches are in flight must not leak slots."""
        if not enabled():
            return False
        limit = _max_inflight()
        if limit <= 0:
            return False
        t = _Ticket(principal or ANONYMOUS, rows)
        with self._lock:
            if self._inflight < limit and not self._order:
                self._inflight += 1
                return True
            self._waiting.setdefault(t.principal, []).append(t)
            if t.principal not in self._deficit:
                self._deficit[t.principal] = 0.0
                self._order.append(t.principal)
        GATE_WAITS.inc(principal=t.principal)
        if t.event.wait(timeout=_gate_wait_s()):
            return True
        # timed out: fail open — withdraw the ticket if it is still
        # queued and take a slot anyway; if a grant raced the timeout,
        # the slot is already ours
        with self._lock:
            q = self._waiting.get(t.principal)
            if q is not None and t in q:
                q.remove(t)
                self._inflight += 1
            elif not t.granted:
                self._inflight += 1
        GATE_TIMEOUTS.inc()
        return True

    def release(self, took: bool = True):
        """Give a slot back. `took` is acquire()'s return value — a
        dispatch that never took a slot (QoS disabled at acquire time)
        must not decrement, and one that DID must decrement even if the
        env has been flipped off since."""
        if not took:
            return
        wake = []
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            limit = _max_inflight()
            if not enabled() or limit <= 0:
                # the gate was turned off mid-flight: drain every parked
                # waiter now instead of letting each fail open after the
                # full gate wait
                for q in self._waiting.values():
                    for t in q:
                        t.granted = True
                        wake.append(t)
                self._waiting.clear()
                self._order.clear()
                self._deficit.clear()
            else:
                while self._inflight < limit:
                    t = self._pick_locked()
                    if t is None:
                        break
                    self._inflight += 1
                    t.granted = True
                    wake.append(t)
        for t in wake:
            t.event.set()

    def depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._waiting.values())

    def reset(self):
        with self._lock:
            for q in self._waiting.values():
                for t in q:
                    t.granted = True
                    t.event.set()
            self._waiting.clear()
            self._order.clear()
            self._deficit.clear()
            self._inflight = 0

    # -- DRR core ---------------------------------------------------------
    def _pick_locked(self) -> _Ticket | None:
        """Grant one ticket by deficit round-robin: find the principal
        whose head ticket needs the fewest whole quantum rounds to
        afford, credit every waiting principal that many rounds, charge
        the winner its rows. O(#waiting principals) per grant; the one
        caller, release(), holds self._lock."""
        quantum = float(_quantum_rows())
        best = best_rounds = None
        for p in self._order:
            q = self._waiting.get(p)
            if not q:
                continue
            need = q[0].rows - self._deficit.get(p, 0.0)
            rounds = max(0, math.ceil(need / (quantum * weight(p))))
            if best_rounds is None or rounds < best_rounds:
                best, best_rounds = p, rounds
        if best is None:
            # h2o3-ok: R003 _locked helper — only caller is release(), which holds self._lock
            self._order.clear()
            # h2o3-ok: R003 _locked helper — only caller is release(), which holds self._lock
            self._deficit.clear()
            return None
        if best_rounds:
            for p in self._order:
                if self._waiting.get(p):
                    # h2o3-ok: R003 _locked helper — only caller is release(), which holds self._lock
                    self._deficit[p] = (self._deficit.get(p, 0.0)
                                        + best_rounds * quantum * weight(p))
        # h2o3-ok: R003 _locked helper — only caller is release(), which holds self._lock
        t = self._waiting[best].pop(0)
        # h2o3-ok: R003 _locked helper — only caller is release(), which holds self._lock
        self._deficit[best] = self._deficit.get(best, 0.0) - t.rows
        # rotate the winner to the back so equal-rounds ties round-robin
        # h2o3-ok: R003 _locked helper — only caller is release(), which holds self._lock
        self._order.remove(best)
        if self._waiting.get(best):
            # h2o3-ok: R003 _locked helper — only caller is release(), which holds self._lock
            self._order.append(best)
        else:
            # h2o3-ok: R003 _locked helper — only caller is release(), which holds self._lock
            self._waiting.pop(best, None)
            # h2o3-ok: R003 _locked helper — only caller is release(), which holds self._lock
            self._deficit.pop(best, None)
        return t


GATE = FairGate()


# ---------------------------------------------------------------------------
# priority lanes: interactive scoring preempts batch (Job-thread) device
# dispatches AT THE SCHEDULER — a batch dispatch about to launch defers
# while interactive requests are pending, bounded by
# H2O3_QOS_BATCH_YIELD_S; an in-flight device program is never aborted.
_LANE_COND = threading.Condition(make_lock("qos.lanes"))
_interactive_pending = 0

_QTLS = threading.local()


def in_job() -> bool:
    """Is this thread a Job worker (the batch lane)?"""
    return getattr(_QTLS, "in_job", False)


def note_interactive_start():
    global _interactive_pending
    with _LANE_COND:
        _interactive_pending += 1


def note_interactive_end():
    global _interactive_pending
    with _LANE_COND:
        _interactive_pending -= 1
        if _interactive_pending <= 0:
            _interactive_pending = max(0, _interactive_pending)
            _LANE_COND.notify_all()


def interactive_pending() -> int:
    return _interactive_pending


def batch_yield():
    """Called by the mrtask dispatch funnel just before launching a
    device program: a BATCH dispatch (Job thread) yields to pending
    interactive scoring. The racy lock-free fast-path read is deliberate
    — a stale zero just skips one yield, and the steady-state training
    loop pays a single int compare."""
    if _interactive_pending == 0 or not in_job() or not enabled():
        return
    limit = _batch_yield_s()
    if limit <= 0:
        return
    deadline = time.monotonic() + limit
    waited = False
    with _LANE_COND:
        while _interactive_pending > 0:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            waited = True
            _LANE_COND.wait(timeout=remaining)
    if waited:
        BATCH_YIELDS.inc()


# ---------------------------------------------------------------------------
# concurrent-job quotas (enforced where Job.start runs)
_JOBS_LOCK = make_lock("qos.jobs")
_job_counts: dict = {}


def acquire_job_slot():
    """Charge the current principal's concurrent-job quota. Returns the
    charge token to hand back to release_job_slot, or None when no
    charge applies (no request context, a nested job started from
    inside another counted job, quota unlimited, QoS off). Raises
    QuotaExceeded (→ 429) at the cap."""
    if not enabled():
        return None
    p = _tracing.principal()
    if p is None or in_job():
        return None
    limit = _max_jobs()
    if limit <= 0:
        return None
    over = False
    with _JOBS_LOCK:
        n = _job_counts.get(p, 0)
        if n >= limit:
            over = True
        else:
            _job_counts[p] = n + 1
    if over:
        REJECTS.inc(principal=p, reason="quota")
        raise QuotaExceeded(p, limit)
    return p


def release_job_slot(token):
    if token is None:
        return
    with _JOBS_LOCK:
        n = _job_counts.get(token, 0) - 1
        if n <= 0:
            _job_counts.pop(token, None)
        else:
            _job_counts[token] = n


def prepay_job_slot():
    """REST-layer quota charge for job-starting routes, taken BEFORE the
    replay broadcast: on a multi-host cloud the workers replay a request
    the moment the coordinator broadcasts it, so a quota rejection must
    happen before that point — a 429 AFTER the broadcast would leave the
    build running on every worker but not the coordinator (divergent DKV
    state, orphaned collectives). The charge parks in the request
    thread's TLS; the Job the handler starts ADOPTS it (and releases it
    at completion), and settle_prepaid_job_slot() at request teardown
    releases a charge no job consumed (handler 4xx'd first)."""
    token = acquire_job_slot()
    if token is not None:
        _QTLS.prepaid_job = token
    return token


def adopt_prepaid_job_slot():
    """Hand the request's prepaid charge (if any) to the Job that will
    own its release; returns None when nothing was prepaid."""
    tok = getattr(_QTLS, "prepaid_job", None)
    _QTLS.prepaid_job = None
    return tok


def settle_prepaid_job_slot():
    """Request teardown: release a prepaid charge no Job adopted."""
    release_job_slot(adopt_prepaid_job_slot())


def _jobs_series():
    with _JOBS_LOCK:
        return [({"principal": p}, float(n))
                for p, n in sorted(_job_counts.items())]


_om.gauge("h2o3_qos_active_jobs",
          "concurrently RUNNING jobs by principal (quota: "
          "H2O3_QOS_MAX_JOBS)", fn=_jobs_series)


class job_context:
    """Worker-thread context for Job._run: re-enters the launching
    request's principal (for metric attribution and so dispatches the
    job issues ride the BATCH lane) and marks the thread as in-job so
    nested Job.start calls skip the quota. Deadlines do NOT propagate —
    a build outlives its launching request's budget."""

    __slots__ = ("_principal", "_prev_p", "_prev_d", "_prev_flag")

    def __init__(self, principal):
        self._principal = principal

    def __enter__(self):
        self._prev_p = _tracing.set_principal(self._principal)
        self._prev_d = _tracing.set_deadline(None)
        self._prev_flag = getattr(_QTLS, "in_job", False)
        _QTLS.in_job = True
        return self

    def __exit__(self, *exc):
        _QTLS.in_job = self._prev_flag
        _tracing.set_deadline(self._prev_d)
        _tracing.set_principal(self._prev_p)
        return False


# ---------------------------------------------------------------------------
def reset():
    """Test hook: drop all tenant state (buckets, principals, quotas,
    gate queues, lane counters)."""
    global _interactive_pending
    _QTLS.edge_admitted = False
    _QTLS.prepaid_job = None
    with _BUCKET_LOCK:
        _buckets.clear()
    with _KNOWN_LOCK:
        _known.clear()
    with _JOBS_LOCK:
        _job_counts.clear()
    GATE.reset()
    with _LANE_COND:
        _interactive_pending = 0
        _LANE_COND.notify_all()
