"""The port's multi-tenant QoS (serving/qos.py) against the JAX package's,
on the CPU. Mirrors tests/test_qos.py where its cases need no REST
server (those wait for the port's server, ROADMAP.md §1).

- principals: the same names resolve to the same principals, the
  cardinality fold included;
- token buckets under a FAKE clock: the same script of charges at the
  same instants admits and rejects the same requests with the same
  Retry-After in both packages (exact: the same float arithmetic);
  through `score_payload` an over-rate principal gets RateLimited and an
  unprincipaled caller never does;
- the fair gate: a scripted arrival sequence (principals, rows, weights,
  quantum) is granted in the SAME order as by the JAX FairGate, exactly;
  the victim is served within the first round; a wedged slot fails open;
- the queue share (QueueFull for the tenant at its share, none for
  another), the job quotas (a second job raises QuotaExceeded and frees
  nothing it did not take; nested jobs and jobs without a request
  context are not charged; a failed Thread.start releases its slot),
  the batch lane (bounded deferral, woken when interactive drains,
  never for a non-job thread), deadline shedding before staging, and
  `eviction_standing`.
"""

import threading
import time
import types

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu.serving import qos as JQ
from h2o3_tpu_torch import serving
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.obs import tracing
from h2o3_tpu_torch.serving import microbatch as mb
from h2o3_tpu_torch.serving import qos
from h2o3_tpu_torch.serving import scorer_cache as SC

RNG = np.random.default_rng(7)
ROW = [{"a": 0.1, "b": 0.2}]


@pytest.fixture(autouse=True)
def _fresh_qos():
    qos.reset()
    JQ.reset()
    yield
    qos.reset()
    JQ.reset()


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _mk_glm():
    fr = Frame.from_dict(
        {"a": RNG.normal(size=240), "b": RNG.normal(size=240),
         "resp": RNG.choice(["no", "yes"], size=240)})
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="binomial")
    m.train(x=["a", "b"], y="resp", training_frame=fr)
    return fr, m


@pytest.fixture(scope="module")
def glm_model(port_cpu):
    fr, m = _mk_glm()
    yield m
    DKV.remove(fr.key)
    DKV.remove(m.key)


# ---------------------------------------------------------------------------
# principals and config
def test_resolve_principal_matches_jax(monkeypatch):
    names = [None, "", "alice@ex.com", 'ev"il{x="1"}', "x" * 200, "  bob ",
             "ü-nicode", "a b c"]
    assert [qos.resolve_principal(n) for n in names] == \
        [JQ.resolve_principal(n) for n in names]
    assert '"' not in qos.resolve_principal('ev"il{x="1"}')
    monkeypatch.setenv("H2O3_QOS_MAX_PRINCIPALS", "2")
    qos.reset()
    JQ.reset()
    seq = ["u1", "u2", "u3", "u1", "u4"]
    assert [qos.resolve_principal(n) for n in seq] == \
        [JQ.resolve_principal(n) for n in seq] == \
        ["u1", "u2", qos.OVERFLOW, "u1", qos.OVERFLOW]


def test_weights_and_rates_parse(monkeypatch):
    monkeypatch.setenv("H2O3_QOS_WEIGHTS", "alice:4, bob:2, junk, x:oops")
    monkeypatch.setenv("H2O3_QOS_RATE_RPS", "7")
    monkeypatch.setenv("H2O3_QOS_RATES", "bob:2")
    for Q in (qos, JQ):
        assert (Q.weight("alice"), Q.weight("bob"), Q.weight("x")) == \
            (4.0, 2.0, 1.0)
        assert (Q._rate_for("bob"), Q._rate_for("alice")) == (2.0, 7.0)


# ---------------------------------------------------------------------------
# token buckets under a fake clock
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.mark.parametrize("rate,burst", [(2.0, 1.0), (5.0, 0.0),
                                        (0.5, 3.0)])
def test_token_bucket_script_matches_jax(monkeypatch, rate, burst):
    monkeypatch.setenv("H2O3_QOS_RATE_RPS", repr(rate))
    monkeypatch.setenv("H2O3_QOS_BURST", repr(burst))
    # arrivals at four times the rate: the bucket drains and refills
    gaps = np.random.default_rng(3).exponential(0.25 / rate, 60)
    got = {}
    for name, Q in (("jax", JQ), ("port", qos)):
        clock = _Clock()
        monkeypatch.setattr(Q, "time", types.SimpleNamespace(
            monotonic=clock.monotonic, sleep=time.sleep))
        Q.reset()
        out = []
        for i, gap in enumerate(gaps):
            clock.t += float(gap)
            p = "alice" if i % 3 else "bob"
            try:
                Q.charge_token(p)
                out.append((p, "ok"))
            except Q.RateLimited as e:
                out.append((p, "429", e.retry_after_s))
        levels = sorted((lbl["principal"], v)
                        for lbl, v in Q._token_series())
        got[name] = (out, levels)
    assert got["port"] == got["jax"]
    assert any(o[1] == "429" for o in got["port"][0])
    assert any(o[1] == "ok" for o in got["port"][0])


def test_rate_limit_through_score_payload(monkeypatch, glm_model):
    serving.score_payload(glm_model, ROW)
    monkeypatch.setenv("H2O3_QOS_RATE_RPS", "2")
    monkeypatch.setenv("H2O3_QOS_BURST", "1")
    qos.reset()
    r0 = qos.REJECTS.value(principal="alice", reason="rate")
    with tracing.request_context("alice"):
        assert len(serving.score_payload(glm_model, ROW)) == 1
        with pytest.raises(qos.RateLimited) as ei:
            serving.score_payload(glm_model, ROW)
    assert ei.value.retry_after_s >= 1
    assert qos.REJECTS.value(principal="alice", reason="rate") == r0 + 1
    time.sleep(0.6)                         # the bucket refills
    with tracing.request_context("alice"):
        assert len(serving.score_payload(glm_model, ROW)) == 1
    for _ in range(5):                      # no principal: never limited
        serving.score_payload(glm_model, ROW)


def test_edge_admit_charges_once(monkeypatch):
    monkeypatch.setenv("H2O3_QOS_RATE_RPS", "100")
    monkeypatch.setenv("H2O3_QOS_BURST", "5")
    qos.reset()
    with tracing.request_context("edge-tenant"):
        try:
            qos.edge_admit()
            qos.admit()
            qos.admit()
        finally:
            qos.end_request()
    assert qos.ADMITTED.value(principal="edge-tenant") == 1
    tokens = dict((lbl["principal"], v) for lbl, v in qos._token_series())
    assert tokens["edge-tenant"] == pytest.approx(4.0, abs=0.2)
    with tracing.request_context("edge-tenant"):
        qos.admit()
    assert qos.ADMITTED.value(principal="edge-tenant") == 2


def test_single_controller_gates_mid_pipeline_rejections(monkeypatch):
    assert qos.single_controller() is True      # the port is one process
    monkeypatch.setattr(qos, "single_controller", lambda: False)
    monkeypatch.setenv("H2O3_QOS_TENANT_SHARE", "0.5")
    assert qos.tenant_share_cap(100) == 100
    with tracing.request_context("t", time.monotonic() - 1.0):
        qos.admit()
        with pytest.raises(qos.DeadlineExceeded):
            qos.check_deadline("entry")
    monkeypatch.setattr(qos, "single_controller", lambda: True)
    assert qos.tenant_share_cap(100) == 50
    with tracing.request_context("t", time.monotonic() - 1.0):
        with pytest.raises(qos.DeadlineExceeded):
            qos.admit()


# ---------------------------------------------------------------------------
# the queue share
def test_queue_share_cap(monkeypatch, glm_model):
    monkeypatch.setenv("H2O3_SCORE_QUEUE_DEPTH", "8")
    monkeypatch.setenv("H2O3_QOS_TENANT_SHARE", "0.5")
    assert qos.tenant_share_cap(8) == JQ.tenant_share_cap(8) == 4
    monkeypatch.setattr(mb.BATCHER, "_queued", {"flood": 4})
    monkeypatch.setattr(mb.BATCHER, "_depth", 4)
    s0 = qos.REJECTS.value(principal="flood", reason="share")
    with tracing.request_context("flood"):
        with pytest.raises(serving.QueueFull):
            serving.score_payload(glm_model, ROW)
    assert qos.REJECTS.value(principal="flood", reason="share") == s0 + 1
    with tracing.request_context("victim"):
        assert len(serving.score_payload(glm_model, ROW)) == 1
    # the standing of the flood (its whole share held) is 0, the victim's 1
    assert qos.eviction_standing("flood") == 0.0
    assert qos.eviction_standing("victim") == 1.0
    monkeypatch.setenv("H2O3_QOS_TENANT_SHARE", "1.0")
    assert qos.tenant_share_cap(8) == 8


# ---------------------------------------------------------------------------
# the weighted-fair gate
def _grant_order(Q, arrivals):
    """Park `arrivals` behind one held slot exactly as acquire() parks a
    ticket, then release one slot at a time and record who is granted."""
    g = Q.FairGate()
    assert g.acquire("_holder", 1)
    tickets = []
    for p, rows in arrivals:
        t = Q._Ticket(p, rows)
        with g._lock:
            g._waiting.setdefault(t.principal, []).append(t)
            if t.principal not in g._deficit:
                g._deficit[t.principal] = 0.0
                g._order.append(t.principal)
        tickets.append(t)
    order, seen = [], set()
    for _ in arrivals:
        g.release(True)
        new = [i for i, t in enumerate(tickets)
               if t.granted and i not in seen]
        assert len(new) == 1
        seen.add(new[0])
        order.append((arrivals[new[0]][0], new[0]))
    assert g.depth() == 0
    return order


_SCRIPTS = {
    "flood-victim": ([("flood", 128)] * 6 + [("victim", 128)], "", 2048),
    "weighted": ([("heavy", 128), ("light", 128)] * 8,
                 "heavy:3,light:1", 128),
    "mixed-rows": ([("gold", 64), ("flood", 4096), ("silver", 8),
                    ("flood", 4096), ("gold", 1), ("silver", 512),
                    ("flood", 64), ("gold", 4096), ("silver", 1)] * 3,
                   "gold:4,silver:1,flood:1", 256),
}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_fair_gate_grant_order_equals_jax(monkeypatch, script):
    arrivals, weights, quantum = _SCRIPTS[script]
    monkeypatch.setenv("H2O3_QOS_MAX_INFLIGHT", "1")
    monkeypatch.setenv("H2O3_QOS_WEIGHTS", weights)
    monkeypatch.setenv("H2O3_QOS_QUANTUM_ROWS", str(quantum))
    port, jax_ = _grant_order(qos, arrivals), _grant_order(JQ, arrivals)
    assert port == jax_
    names = [p for p, _ in port]
    if script == "flood-victim":
        assert names.index("victim") <= 1
    if script == "weighted":
        assert names[:8].count("heavy") >= 2 * names[:8].count("light")


def test_fair_gate_threads_serve_the_victim_first_round(monkeypatch):
    monkeypatch.setenv("H2O3_QOS_MAX_INFLIGHT", "1")
    qos.GATE.acquire("_holder", 1)
    order, threads = [], []

    def worker(p, rows):
        took = qos.GATE.acquire(p, rows)
        order.append(p)
        qos.GATE.release(took)

    for p, rows in [("flood", 128)] * 6 + [("victim", 128)]:
        t = threading.Thread(target=worker, args=(p, rows))
        t.start()
        threads.append(t)
        time.sleep(0.01)
    qos.GATE.release()
    for t in threads:
        t.join(10)
    assert len(order) == 7 and order.index("victim") <= 1, order


def test_fair_gate_fail_open(monkeypatch):
    monkeypatch.setenv("H2O3_QOS_MAX_INFLIGHT", "1")
    monkeypatch.setenv("H2O3_QOS_GATE_WAIT_S", "0.2")
    qos.GATE.acquire("wedged", 1)
    t0 = qos.GATE_TIMEOUTS.value()
    assert qos.GATE.acquire("waiter", 1)
    assert qos.GATE_TIMEOUTS.value() == t0 + 1
    qos.GATE.release()
    qos.GATE.release()


# ---------------------------------------------------------------------------
# concurrent-job quotas
def test_job_quota(monkeypatch, port_cpu):
    from h2o3_tpu_torch.core.jobs import Job
    monkeypatch.setenv("H2O3_QOS_MAX_JOBS", "1")
    gate = threading.Event()
    with tracing.request_context("alice"):
        j1 = Job(description="slow").start(lambda j: gate.wait(10))
        assert dict(qos._jobs_series()[0][0]) == {"principal": "alice"}
        q0 = qos.REJECTS.value(principal="alice", reason="quota")
        with pytest.raises(qos.QuotaExceeded) as ei:
            Job(description="over-quota").start(lambda j: None)
        assert ei.value.retry_after_s >= 1
        assert qos.REJECTS.value(principal="alice", reason="quota") == q0 + 1
    with tracing.request_context("bob"):
        j2 = Job(description="bob's").start(lambda j: None)
    gate.set()
    j1.join()
    j2.join()
    assert qos._jobs_series() == []         # every slot released
    with tracing.request_context("alice"):
        Job(description="after-release").start(lambda j: None).join()


def test_job_quota_nested_jobs_exempt(monkeypatch, port_cpu):
    from h2o3_tpu_torch.core.jobs import Job
    monkeypatch.setenv("H2O3_QOS_MAX_JOBS", "1")
    inner = []

    def work(job):
        assert qos.in_job() and tracing.principal() == "alice"
        Job(description="nested").start(lambda j: inner.append(1)).join()

    with tracing.request_context("alice", time.monotonic() + 60):
        Job(description="parent").start(work).join()
    assert inner == [1]
    # no request context: never charged
    gate = threading.Event()
    j1 = Job(description="internal-1").start(lambda j: gate.wait(10))
    j2 = Job(description="internal-2").start(lambda j: None)
    gate.set()
    j1.join()
    j2.join()


def test_job_slot_released_when_the_thread_cannot_start(monkeypatch,
                                                        port_cpu):
    from h2o3_tpu_torch.core import jobs as J
    monkeypatch.setenv("H2O3_QOS_MAX_JOBS", "1")

    class _NoThread:
        def __init__(self, *a, **kw):
            pass

        def start(self):
            raise RuntimeError("can't start new thread")

    monkeypatch.setattr(J.threading, "Thread", _NoThread)
    with tracing.request_context("alice"):
        job = J.Job(description="doomed")
        with pytest.raises(RuntimeError):
            job.start(lambda j: None)
    assert job.status == J.FAILED and job.is_done
    assert qos._jobs_series() == []
    monkeypatch.undo()
    monkeypatch.setenv("H2O3_QOS_MAX_JOBS", "1")
    with tracing.request_context("alice"):
        J.Job(description="next").start(lambda j: None).join()


def test_second_concurrent_train_raises_quota(monkeypatch, port_cpu):
    """A train() as a principal already at its quota raises, and its
    Job frees nothing it did not take."""
    from h2o3_tpu_torch.core.jobs import Job
    monkeypatch.setenv("H2O3_QOS_MAX_JOBS", "1")
    fr = Frame.from_dict({"a": RNG.normal(size=100),
                          "y": RNG.normal(size=100)})
    gate = threading.Event()
    try:
        with tracing.request_context("alice"):
            j1 = Job(description="holder").start(lambda j: gate.wait(10))
            m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(
                family="gaussian")
            with pytest.raises(qos.QuotaExceeded):
                m.train(x=["a"], y="y", training_frame=fr)
        gate.set()
        j1.join()
        assert qos._jobs_series() == []
        with tracing.request_context("alice"):
            m.train(x=["a"], y="y", training_frame=fr)
        DKV.remove(m.key)
    finally:
        gate.set()
        DKV.remove(fr.key)


# ---------------------------------------------------------------------------
# the batch lane (the port's mrtask dispatch, its caller, comes later)
def test_batch_lane_defers_to_interactive(monkeypatch):
    monkeypatch.setenv("H2O3_QOS_BATCH_YIELD_S", "0.25")
    qos.note_interactive_start()
    try:
        y0 = qos.BATCH_YIELDS.value()
        t0 = time.monotonic()
        with qos.job_context("trainer"):
            assert qos.in_job()
            qos.batch_yield()
        assert 0.2 < time.monotonic() - t0 < 2.0
        assert qos.BATCH_YIELDS.value() == y0 + 1
        t0 = time.monotonic()
        qos.batch_yield()                   # not in a job: immediate
        assert time.monotonic() - t0 < 0.05
    finally:
        qos.note_interactive_end()
    t0 = time.monotonic()
    with qos.job_context("trainer"):
        qos.batch_yield()                   # nothing pending: immediate
    assert time.monotonic() - t0 < 0.05
    assert not qos.in_job() and qos.interactive_pending() == 0


def test_batch_lane_releases_when_interactive_drains(monkeypatch):
    monkeypatch.setenv("H2O3_QOS_BATCH_YIELD_S", "5")
    qos.note_interactive_start()
    done = []

    def trainer():
        with qos.job_context("trainer"):
            qos.batch_yield()
        done.append(time.monotonic())

    t = threading.Thread(target=trainer)
    t0 = time.monotonic()
    t.start()
    time.sleep(0.1)
    qos.note_interactive_end()
    t.join(5)
    assert done and done[0] - t0 < 1.0


# ---------------------------------------------------------------------------
# deadline-aware shedding
def test_deadline_shed_before_staging(glm_model):
    fr, m = _mk_glm()       # a fresh model: no program built yet
    try:
        SC.CACHE.invalidate_key(m.key)
        m0 = SC.MISSES.value()
        d0 = mb.DISPATCHES.value()
        s0 = qos.SHED.value(reason="admission")
        with tracing.request_context("late", time.monotonic() - 0.5):
            with pytest.raises(qos.DeadlineExceeded):
                serving.score_payload(m, ROW)
        assert qos.SHED.value(reason="admission") == s0 + 1
        assert mb.DISPATCHES.value() == d0
        assert SC.MISSES.value() == m0      # nothing built for the corpse
    finally:
        DKV.remove(fr.key)
        DKV.remove(m.key)


def test_deadline_expiring_in_queue_propagates(glm_model, monkeypatch):
    monkeypatch.setenv("H2O3_SCORE_LINGER_MS", "200")
    fb0 = SC.FALLBACKS.value(reason="trace-error")
    with tracing.request_context("slowpoke", time.monotonic() + 0.05):
        with pytest.raises(qos.DeadlineExceeded):
            serving.score_payload(glm_model, ROW)
    assert SC.FALLBACKS.value(reason="trace-error") == fb0
    monkeypatch.setenv("H2O3_SCORE_LINGER_MS", "1")
    assert len(serving.score_payload(glm_model, ROW)) == 1


def test_eviction_standing_follows_the_bucket(monkeypatch):
    monkeypatch.setenv("H2O3_QOS_RATES", "flood:1")
    monkeypatch.setenv("H2O3_QOS_BURST", "4")
    assert qos.eviction_standing("flood") == 1.0    # no state yet
    for _ in range(3):
        qos.charge_token("flood")
    assert qos.eviction_standing("flood") == pytest.approx(0.25, abs=0.05)
    assert qos.eviction_standing("other") == 1.0
