"""The port's SLO engine, stall watchdog, chaos layer and single-process
membership against the JAX package's, on the CPU.

- SLO burn rates: the same synthetic histogram series (seeded numpy
  latencies and statuses, the same `now` instants) through a JAX
  `SLOEngine` and a port one, each on its own isolated registry: the
  alert documents (burn per window, firing, windows) are EQUAL — both
  engines are the same float64 arithmetic over the same integer counts,
  so the tolerance is exact. Drift SLIs tick against a gauge the same in
  both; the sample ring persists under the ice root and a fresh engine
  restores and rebases it.
- The watchdog: a seeded stall past its deadline trips once, with a
  pinned `watchdog.trip` trace whose JStack names the stalled thread;
  nothing trips under the deadline; H2O3_WATCHDOG=0 watches nothing;
  `reset()` retires the sentinel thread.
- Chaos: the same spec parses to the same rules in both packages, and
  the same sequence of hits fires on the same hits (after/times are
  deterministic counters).
- Membership: `retry_once` as the JAX test_membership case, and the same
  excise/join/leave script moves the epoch, the live workers and the
  counters the same way in both.
"""

import threading
import time

import numpy as np
import pytest

from h2o3_tpu.deploy import chaos as JC
from h2o3_tpu.deploy import membership as JMB
from h2o3_tpu.obs import metrics as JM
from h2o3_tpu.obs import slo as JS
from h2o3_tpu_torch.deploy import chaos as TC
from h2o3_tpu_torch.deploy import membership as TMB
from h2o3_tpu_torch.io import spill
from h2o3_tpu_torch.obs import metrics as TM
from h2o3_tpu_torch.obs import recorder as TR
from h2o3_tpu_torch.obs import slo as TS
from h2o3_tpu_torch.obs import watchdog as TW

PKGS = {"jax": (JM, JS), "port": (TM, TS)}


@pytest.fixture(autouse=True)
def _no_slo_persist(monkeypatch):
    # scratch engines must not write their rings under the real ice root
    monkeypatch.setenv("H2O3_SLO_PERSIST_S", "0")


# ---------------------------------------------------------------------------
# SLO burn rates: the same series through both engines
def _lat_spec(S, **kw):
    d = {"name": "test-lat", "metric": "t_port_slo_seconds",
         "objective": 0.99, "threshold_ms": 100, "route": "/3/P",
         "windows": [[60, 120, 10.0]]}
    d.update(kw)
    return S.SLOSpec(d)


def _series(seed, n_steps=12):
    """Per evaluation step: (latencies, statuses) of the requests that
    arrived since the previous one — a calm start, a regression, a
    recovery."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(n_steps):
        n = int(rng.integers(50, 400))
        bad_share = 0.0 if i < 3 else (0.6 if i < 7 else 0.001)
        lat = np.where(rng.random(n) < bad_share,
                       rng.uniform(0.2, 2.0, n), rng.uniform(0.001, 0.05, n))
        status = np.where(rng.random(n) < bad_share / 4, "500", "200")
        steps.append((lat, status))
    return steps


def _lat_histogram(reg):
    """The latency series the SLO specs read, on an isolated registry."""
    return reg.histogram("t_port_slo_seconds", "t")


def _persist_histogram(reg):
    return reg.histogram("t_port_persist_seconds", "t",
                         buckets=(0.25, 0.5, 1.0))


def _drive(M, S, spec_kw, seed, t0):
    reg = M.MetricsRegistry()
    lat = _lat_histogram(reg)
    eng = S.SLOEngine(specs=[_lat_spec(S, **spec_kw)], registry=reg)
    docs = []
    for i, (ls, st) in enumerate(_series(seed)):
        for v, s in zip(ls, st):
            lat.observe(float(v), route="/3/P", status=str(s))
        for a in eng.evaluate(now=t0 + 15.0 * i):
            docs.append({k: a[k] for k in ("slo", "firing", "burn",
                                           "window", "since")})
        docs.append(sorted(
            (tuple(sorted(k)), v)
            for k, v in reg.get("h2o3_slo_burn_rate")._collect()))
    return docs


@pytest.mark.parametrize("spec_kw", [
    {},                                              # latency, fire+resolve
    {"windows": [[60, 3600, 10.0]]},                 # warm-up scaling
    {"name": "avail", "threshold_ms": None, "objective": 0.999},
    {"windows": [[30, 90, 2.0], [60, 240, 1.5]]},    # two window pairs
])
@pytest.mark.parametrize("seed", [1, 2])
def test_slo_burn_rates_equal_the_jax_engine(spec_kw, seed):
    t0 = 1.7e9
    got = {name: _drive(M, S, spec_kw, seed, t0)
           for name, (M, S) in PKGS.items()}
    assert got["port"] == got["jax"]
    fired = [d for d in got["port"] if isinstance(d, dict) and d["firing"]]
    if not spec_kw.get("windows") == [[60, 3600, 10.0]]:
        assert fired, "the regression never fired"


def test_slo_ring_stays_bounded_under_fast_polling():
    got = {}
    for name, (M, S) in PKGS.items():
        reg = M.MetricsRegistry()
        lat = _lat_histogram(reg)
        eng = S.SLOEngine(specs=[_lat_spec(S)], registry=reg)
        t0 = 1.7e9
        for i in range(500):
            lat.observe(0.01, route="/3/P", status="200")
            eng.evaluate(now=t0 + i * 0.01)
        got[name] = list(eng._samples["test-lat"])
    assert got["port"] == got["jax"]
    assert len(got["port"]) <= 8 and got["port"][-1][1] == 500


def test_drift_sli_ticks_as_the_jax_engine():
    got = {}
    for name, (M, S) in PKGS.items():
        reg = M.MetricsRegistry()
        g = reg.gauge("t_port_drift", "t")
        eng = S.SLOEngine([S.SLOSpec({"name": "d", "kind": "drift",
                                      "metric": "t_port_drift",
                                      "objective": 0.5,
                                      "model": "^hot$"})], registry=reg)
        spec = eng.specs()[0]
        g.set(0.5, model="hot", feature_kind="numeric")
        g.set(0.01, model="hot", feature_kind="na")
        g.set(0.01, model="cold", feature_kind="numeric")
        ticks = [eng._totals(spec), eng._totals(spec)]
        g.set(0.05, model="hot", feature_kind="numeric")
        ticks.append(eng._totals(spec))
        got[name] = ticks
    assert got["port"] == got["jax"] == [(2, 1), (4, 2), (6, 2)]
    s = TS.SLOSpec({"name": "drift-all", "kind": "drift", "objective": 0.9})
    assert (s.metric, s.threshold, s.to_dict()["kind"]) == \
        ("h2o3_model_drift", 0.2, "drift")
    with pytest.raises(ValueError):
        TS.SLOSpec({"name": "x", "kind": "latency99", "objective": 0.9})


@pytest.fixture()
def ice_root(tmp_path):
    old = spill.get_ice_root()
    spill.set_ice_root(str(tmp_path / "ice"))
    yield tmp_path / "ice"
    spill.set_ice_root(old)


def test_slo_samples_persist_and_restore(ice_root, monkeypatch):
    monkeypatch.setenv("H2O3_SLO_PERSIST_S", "0")
    spec = {"name": "t-persist", "metric": "t_port_persist_seconds",
            "objective": 0.9, "threshold_ms": 500.0,
            "windows": [[2.0, 8.0, 2.0]]}
    reg1 = TM.MetricsRegistry()
    h1 = _persist_histogram(reg1)
    eng1 = TS.SLOEngine([TS.SLOSpec(spec)], registry=reg1)
    now = time.time()
    for i in range(20):
        h1.observe(2.0)
        eng1.evaluate(now=now - 10 + i * 0.5)
    eng1.persist()
    path = TS.SLOEngine.persist_path()
    assert path.startswith(str(ice_root))
    ring1 = list(eng1._samples["t-persist"])
    # a restart: a fresh engine over a fresh registry whose totals are 0
    reg2 = TM.MetricsRegistry()
    h2 = _persist_histogram(reg2)
    eng2 = TS.SLOEngine([TS.SLOSpec(spec)], registry=reg2)
    assert eng2.restore()
    assert list(eng2._samples["t-persist"]) == ring1
    h2.observe(2.0)
    eng2.evaluate(now=now + 1)
    ring2 = list(eng2._samples["t-persist"])
    assert ring2[-1][1] == ring1[-1][1] + 1         # rebased, monotone
    assert eng2._burn_rate(eng2.specs()[0], ring2, 8.0, now + 1) > 2.0
    other = TS.SLOEngine(registry=TM.MetricsRegistry())
    other.configure([TS.SLOSpec({"name": "different", "objective": 0.9})])
    assert not other.restore()


def test_slo_reset_retires_the_evaluator(monkeypatch, tmp_path):
    monkeypatch.setenv("H2O3_SLO_EVAL_S", "0.05")
    eng = TS.SLOEngine([_lat_spec(TS)], registry=TM.MetricsRegistry())
    t = eng.start()
    assert t is not None and t.daemon and t.is_alive()
    eng.reset()
    t.join(timeout=5)
    assert not t.is_alive() and eng.specs() == []
    monkeypatch.setenv("H2O3_SLO_FILE", str(tmp_path))   # a directory
    assert TS.install_from_env() is None


# ---------------------------------------------------------------------------
# the watchdog
@pytest.fixture()
def watchdog_env(tmp_path, monkeypatch):
    monkeypatch.setenv("H2O3_WATCHDOG_STALL_S", "0.15")
    monkeypatch.setenv("H2O3_WATCHDOG_POLL_S", "0.05")
    old = TR.RECORDER._root         # None: the default root
    TR.RECORDER.set_root(str(tmp_path / "rec"))
    TW.reset()
    yield
    TW.reset()
    TR.RECORDER.set_root(old)


def test_watchdog_trips_on_a_seeded_stall(watchdog_env):
    before = TW.TRIPS.value(kind="microbatch")
    release = threading.Event()

    def _stalled():
        with TW.watch("microbatch", desc="follower wait seeded"):
            release.wait(timeout=10)

    t = threading.Thread(target=_stalled, name="seeded-stall", daemon=True)
    t.start()
    deadline = time.monotonic() + 8
    while not TW.WATCHDOG.trips() and time.monotonic() < deadline:
        time.sleep(0.05)
    stalled = TW.WATCHDOG.stalled()
    release.set()
    t.join(timeout=10)
    trips = TW.WATCHDOG.trips()
    assert len(trips) == 1, trips                   # one trip per stall
    assert trips[0]["kinds"] == ["microbatch"]
    assert stalled and stalled[0]["thread"] == "seeded-stall"
    assert TW.TRIPS.value(kind="microbatch") == before + 1
    TR.RECORDER.flush()
    spans = TR.RECORDER.load_trace(trips[0]["trace"])
    sp = next(s for s in spans if s["name"] == "watchdog.trip")
    assert sp["parent"] == 0
    assert sp["attrs"]["stalls"][0]["desc"] == "follower wait seeded"
    assert 'thread "seeded-stall"' in sp["attrs"]["jstack"]
    assert isinstance(sp["attrs"]["logs"], list)
    assert TW.WATCHDOG.stalled() == []


def test_watchdog_quiet_under_deadline_and_when_disabled(watchdog_env,
                                                         monkeypatch):
    monkeypatch.setenv("H2O3_WATCHDOG_STALL_S", "5")
    with TW.watch("rest", desc="GET /3/Quick"):
        time.sleep(0.05)
    assert TW.WATCHDOG.stalled() == [] and TW.WATCHDOG.trips() == []
    monkeypatch.setenv("H2O3_WATCHDOG", "0")
    TW.reset()
    with TW.watch("rest", desc="off") as ent:
        assert ent is None
    assert TW.WATCHDOG.stalled() == []


def test_watchdog_reset_retires_the_sentinel(watchdog_env):
    with TW.watch("device", desc="start the sentinel"):
        pass
    t = TW.WATCHDOG._thread
    assert t is not None and t.daemon and t.is_alive()
    TW.reset()
    t.join(timeout=5)
    assert not t.is_alive()


def test_thread_dump_lists_every_thread():
    names = {d["name"] for d in TW.thread_dump()}
    assert threading.current_thread().name in names
    text = TW.format_dump(TW.thread_dump())
    assert "test_thread_dump_lists_every_thread" in text


# ---------------------------------------------------------------------------
# chaos
SPECS = ["point=microbatch.dispatch,action=fail,times=2,after=1",
         "point=replay.send,worker=1,after=3,action=sever;"
         "point=collect.ack,action=delay,delay_s=0.01,times=3",
         " point=a,action=drop ; ; point=b,action=kill,times=0 "]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_parses_and_fires_as_the_jax_layer(spec):
    got = {}
    for name, C in (("jax", JC), ("port", TC)):
        C.install(spec)
        try:
            rules = C.rules()
            fired = []
            for i in range(12):
                for point, worker in (("microbatch.dispatch", None),
                                      ("replay.send", 1),
                                      ("replay.send", 2),
                                      ("collect.ack", None),
                                      ("a", None), ("b", None)):
                    act = C.at(point, worker=worker)
                    fired.append((i, point, worker,
                                  act and act["action"]))
            got[name] = (rules, fired, C.rules())
        finally:
            C.reset()
    assert got["port"] == got["jax"]
    assert not TC.active()


def test_chaos_rejects_bad_specs_and_raises_the_given_exception():
    for bad in ("point=x", "action=fail", "point=x,action=explode"):
        with pytest.raises(ValueError):
            TC.parse(bad)
    TC.install("point=microbatch.dispatch,action=fail,times=1")
    try:
        i0 = TC.INJECTIONS.value(point="microbatch.dispatch", action="fail")
        with pytest.raises(TMB.EpochChanged):
            TC.maybe_raise("microbatch.dispatch", exc=TMB.EpochChanged)
        TC.maybe_raise("microbatch.dispatch", exc=TMB.EpochChanged)
        assert TC.INJECTIONS.value(point="microbatch.dispatch",
                                   action="fail") == i0 + 1
    finally:
        TC.reset()
    TC.install("point=p,action=fail")
    try:
        with pytest.raises(TC.ChaosFault):
            TC.maybe_raise("p")
    finally:
        TC.reset()


# ---------------------------------------------------------------------------
# membership, single process
@pytest.fixture()
def cloud_env():
    TMB.MEMBERSHIP.reset()
    JMB.MEMBERSHIP.reset()
    yield
    TMB.MEMBERSHIP.reset()
    JMB.MEMBERSHIP.reset()


def test_retry_once_semantics(cloud_env, monkeypatch):
    monkeypatch.setenv("H2O3_EPOCH_RETRY_BACKOFF_S", "0.001")
    calls = {"n": 0}

    def flaky_epoch():
        calls["n"] += 1
        if calls["n"] == 1:
            raise TMB.EpochChanged()
        return "ok"

    before = TMB.EPOCH_RETRIES.value(op="t")
    assert TMB.retry_once(flaky_epoch, op="t") == "ok"
    assert TMB.EPOCH_RETRIES.value(op="t") == before + 1

    def boom():
        raise ValueError("real bug")

    with pytest.raises(ValueError):         # a stable epoch propagates
        TMB.retry_once(boom, op="t")
    calls["n"] = 0

    def flaky_while_epoch_moves():
        calls["n"] += 1
        if calls["n"] == 1:
            TMB.MEMBERSHIP.observe_epoch(TMB.MEMBERSHIP.epoch + 1)
            raise RuntimeError("dispatch torn by an excision")
        return 42

    assert TMB.retry_once(flaky_while_epoch_moves, op="t") == 42
    assert calls["n"] == 2


def test_membership_script_matches_jax(cloud_env, monkeypatch):
    # the JAX package's excise/join also rebuild its mesh for the epoch
    # (a listener the port has no mesh for): stub it out of the compare
    monkeypatch.setattr(JMB, "_mesh_epoch_listener", lambda e, a: None)
    got = {}
    for name, MB, M in (("jax", JMB, JM), ("port", TMB, TM)):
        seen = []
        MB.MEMBERSHIP.add_listener(lambda e, a: seen.append((e, list(a))))
        for pid in (1, 2, 3):
            MB.MEMBERSHIP.register(pid)
        steps = [MB.MEMBERSHIP.excise(2, "heartbeat"),
                 MB.MEMBERSHIP.join(4),
                 MB.MEMBERSHIP.join(5, synced=False)]
        MB.MEMBERSHIP.start_drain(1)
        steps.append(MB.MEMBERSHIP.leave(1))
        with pytest.raises(ValueError):
            MB.MEMBERSHIP.start_drain(2)
        gauges = {n: M.REGISTRY.get(n).value()
                  for n in ("h2o3_cloud_epoch", "h2o3_cloud_live_workers")}
        got[name] = (steps, seen, MB.MEMBERSHIP.nodes(),
                     MB.MEMBERSHIP.alive(), MB.MEMBERSHIP.active(),
                     MB.current_epoch(), gauges)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [2, 3, 4, 5]
