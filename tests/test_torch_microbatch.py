"""The port's micro-batcher (serving/microbatch.py) and its REST entry
points (`score_payload`, `predict_via_rest`), on the CPU.

- coalescing: concurrent requests for one model inside the linger window
  become ONE dispatch of the bucket that holds all their rows, and every
  request gets its own rows back — a GBM bit for bit as the rows scored
  alone, a GLM and a DL net within 1e-6 (their products may round in
  another order at another row count);
- with a linger a group keeps one dispatch in flight: requests that
  arrive while it is on the device coalesce into the next one;
- a dead follower is answered DeadlineExceeded and costs no rows; an
  all-dead batch makes no dispatch and builds no program; a leader
  failure wakes every follower with its error (and leaves the depth at
  0); a dispatch failed by the chaos layer with EpochChanged is retried
  once and answered (`h2o3_epoch_retries_total{op="microbatch"}` +1);
- a scorer failure under `score_payload` degrades to model.predict (its
  eager path) and counts `h2o3_scorer_fallbacks_total{reason=
  "trace-error"}`;
- every request's stage waterfall holds queue, gate, decode, device and
  readback; under 32 threads of four tenants switching every 10 µs each
  request still gets its own rows and the queue's counts return to 0;
- a JAX model carried across by convert.py answers `score_payload` and
  `predict_via_rest` on the same rows as the JAX package's within 1e-5
  (the tolerance tests/test_torch_serving.py states for carried models),
  with the same labels.
"""

import threading
import time

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu import models as JE
from h2o3_tpu import serving as JSV
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu_torch import serving
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.deploy import chaos
from h2o3_tpu_torch.deploy import membership as MBR
from h2o3_tpu_torch.obs import tracing, usage
from h2o3_tpu_torch.serving import microbatch as mb
from h2o3_tpu_torch.serving import qos
from h2o3_tpu_torch.serving import scorer_cache as SC
from test_torch_genmodel import carry

XS = ["x0", "x1", "x2", "x3", "c"]


def _cols(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, n))
    y = (x[0] - x[1] + rng.normal(0, 0.5, n)) > 0
    return {"x0": x[0], "x1": x[1], "x2": x[2], "x3": x[3],
            "c": rng.choice(["u", "v", "w"], size=n),
            "y": np.array(["n", "p"], object)[y.astype(int)]}


def _rows(n, seed):
    cols = _cols(n, seed)
    return [{k: (str(cols[k][i]) if k == "c" else float(cols[k][i]))
             for k in XS} for i in range(n)]


@pytest.fixture(autouse=True)
def _fresh():
    qos.reset()
    usage.reset()
    yield
    chaos.reset()
    qos.reset()
    usage.reset()


@pytest.fixture(scope="module")
def models():
    h2o3_tpu_torch.init(device="cpu")
    fr = Frame.from_dict(_cols(400, 3))
    out = {
        "gbm": h2o3_tpu_torch.H2OGradientBoostingEstimator(
            ntrees=5, max_depth=3, seed=1),
        "glm": h2o3_tpu_torch.H2OGeneralizedLinearEstimator(
            family="binomial"),
        "dl": h2o3_tpu_torch.H2ODeepLearningEstimator(
            hidden=[8], epochs=1, seed=1),
    }
    for m in out.values():
        m.train(x=XS, y="y", training_frame=fr)
    yield out
    for m in out.values():
        DKV.remove(m.key)
    DKV.remove(fr.key)
    h2o3_tpu_torch.shutdown()


def _alone(m, raw):
    """The rows scored alone: their own bucket, their own dispatch."""
    n = raw.shape[0]
    buf = np.full((SC.row_bucket(n), raw.shape[1]), np.nan, np.float32)
    buf[:n] = raw
    return SC.score_rows(m, buf, n)[:n]


def _concurrent(fn, args_list):
    barrier = threading.Barrier(len(args_list))
    out = [None] * len(args_list)

    def run(i):
        barrier.wait()
        try:
            out[i] = fn(*args_list[i])
        except Exception as e:      # noqa: BLE001 — returned to the test
            out[i] = e
    ts = [threading.Thread(target=run, args=(i,))
          for i in range(len(args_list))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    return out


@pytest.mark.parametrize("algo,tol", [("gbm", 0.0), ("glm", 1e-6),
                                      ("dl", 1e-6)])
def test_concurrent_requests_coalesce_into_one_dispatch(models, algo, tol,
                                                        monkeypatch):
    monkeypatch.setenv("H2O3_SCORE_LINGER_MS", "300")
    m = models[algo]
    sizes = [1, 8, 1, 64, 1, 8, 3, 1]
    raws = [serving.payload_to_raw(m, _rows(k, 10 + i))
            for i, k in enumerate(sizes)]
    want = [_alone(m, r) for r in raws]
    d0, q0 = mb.DISPATCHES.value(), mb.REQUESTS.value()
    got = _concurrent(lambda r: mb.BATCHER.score(m, r, r.shape[0]),
                      [(r,) for r in raws])
    assert mb.REQUESTS.value() - q0 == len(sizes)
    assert mb.DISPATCHES.value() - d0 == 1          # one coalesced dispatch
    assert mb.BATCHER._depth == 0 and mb.BATCHER._pending == {}
    for g, w, k in zip(got, want, sizes):
        assert not isinstance(g, Exception), g
        assert g.shape[0] == k
        d = np.abs(g.astype(np.float64) - w).max()
        assert d <= tol, (algo, k, d)
        if tol == 0.0:
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


def test_a_group_keeps_one_dispatch_in_flight(models, monkeypatch):
    """While a group's dispatch is on the device, the next leader's batch
    stays open past its linger: five requests queued behind it go out in
    one dispatch when it lands, each with its own rows bit for bit."""
    monkeypatch.setenv("H2O3_SCORE_LINGER_MS", "1")
    m = models["gbm"]
    raws = [serving.payload_to_raw(m, _rows(1, 200 + i)) for i in range(6)]
    want = [_alone(m, r) for r in raws]
    real = SC.score_rows
    entered, release = threading.Event(), threading.Event()
    sizes = []

    def held_first(model, raw, n, **kw):
        sizes.append(n)
        if len(sizes) == 1:
            entered.set()
            assert release.wait(30)
        return real(model, raw, n, **kw)
    monkeypatch.setattr(SC, "score_rows", held_first)
    d0 = mb.DISPATCHES.value()
    got = [None] * 6

    def one(i):
        got[i] = mb.BATCHER.score(m, raws[i], 1)
    ts = [threading.Thread(target=one, args=(0,))]
    ts[0].start()
    assert entered.wait(30)
    ts += [threading.Thread(target=one, args=(i,)) for i in range(1, 6)]
    for t in ts[1:]:
        t.start()
    give_up = time.monotonic() + 30
    while mb.BATCHER._depth < 6 and time.monotonic() < give_up:
        time.sleep(0.001)
    time.sleep(0.05)            # 50 lingers: the next leader waits its turn
    assert sizes == [1]
    release.set()
    for t in ts:
        t.join(timeout=30)
    assert sizes == [1, 5]
    assert mb.DISPATCHES.value() - d0 == 2
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))
    assert mb.BATCHER._depth == 0 and mb.BATCHER._pending == {}
    assert mb.BATCHER._inflight == {}


def test_dead_followers_skipped_and_all_dead_batch_skips_dispatch(models):
    m = models["glm"]
    raw = serving.payload_to_raw(m, _rows(1, 5))
    with tracing.request_context("live"):
        alive = mb._Request(raw, 1)
    with tracing.request_context("late", time.monotonic() - 1.0):
        dead = mb._Request(raw, 1)
    b0 = qos.SHED.value(reason="batch")
    mb.MicroBatcher._dispatch_chunk(m, [alive, dead])
    assert dead.event.is_set() and isinstance(dead.error,
                                              qos.DeadlineExceeded)
    assert alive.error is None and alive.result.shape[0] == 1
    assert qos.SHED.value(reason="batch") == b0 + 1
    # all dead: no dispatch, no program built for the corpses
    SC.CACHE.invalidate_key(m.key)
    with tracing.request_context("late", time.monotonic() - 1.0):
        reqs = [mb._Request(raw, 1) for _ in range(3)]
    d0, m0 = mb.DISPATCHES.value(), SC.MISSES.value()
    mb.MicroBatcher._dispatch_chunk(m, reqs)
    assert all(isinstance(r.error, qos.DeadlineExceeded) for r in reqs)
    assert mb.DISPATCHES.value() == d0 and SC.MISSES.value() == m0


def test_leader_failure_wakes_every_follower(models, monkeypatch):
    m = models["gbm"]
    monkeypatch.setenv("H2O3_SCORE_LINGER_MS", "200")

    def boom(*a, **kw):
        raise RuntimeError("scorer exploded")

    monkeypatch.setattr(mb._sc, "score_rows", boom)
    raws = [serving.payload_to_raw(m, _rows(2, 30 + i)) for i in range(5)]
    got = _concurrent(lambda r: mb.BATCHER.score(m, r, 2),
                      [(r,) for r in raws])
    assert all(isinstance(g, RuntimeError) and "exploded" in str(g)
               for g in got), got
    assert mb.BATCHER._depth == 0 and mb.BATCHER._pending == {}
    assert mb.BATCHER.queued_by_principal() == {}


def test_scorer_failure_degrades_to_predict(models, monkeypatch):
    fr = Frame.from_dict(_cols(200, 4))
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="binomial")
    m.train(x=XS, y="y", training_frame=fr)
    rows = _rows(4, 41)
    want = serving.score_payload(m, rows)

    def boom(*a, **kw):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(mb._sc, "score_rows", boom)
    f0 = SC.FALLBACKS.value(reason="trace-error")
    got = serving.score_payload(m, rows)
    # one for the micro-batched dispatch, one for predict's own fast path
    # (the same broken score_rows), which then scores eagerly
    assert SC.FALLBACKS.value(reason="trace-error") == f0 + 2
    assert [g["predict"] for g in got] == [w["predict"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["pp"] - w["pp"]) <= 1e-6
    DKV.remove(m.key)
    DKV.remove(fr.key)


def test_epoch_change_is_retried_once(models, monkeypatch):
    monkeypatch.setenv("H2O3_EPOCH_RETRY_BACKOFF_S", "0.001")
    m = models["gbm"]
    rows = _rows(8, 51)
    want = serving.score_payload(m, rows)
    chaos.install("point=microbatch.dispatch,action=fail,times=1")
    r0 = MBR.EPOCH_RETRIES.value(op="microbatch")
    got = serving.score_payload(m, rows)
    assert MBR.EPOCH_RETRIES.value(op="microbatch") == r0 + 1
    assert got == want
    assert chaos.rules()[0]["fired"] == 1


def test_stage_waterfall_of_a_request(models):
    m = models["gbm"]
    usage.begin_request()
    t0 = time.perf_counter()
    serving.score_payload(m, _rows(3, 61))
    st = usage.finish_request(time.perf_counter() - t0)
    assert {"queue", "gate", "decode", "device", "readback"} <= set(st)
    assert abs(sum(st.values()) - (time.perf_counter() - t0)) < 0.05
    hdr = usage.server_timing(st)
    assert hdr.index("queue") < hdr.index("gate") < hdr.index("decode") \
        < hdr.index("device") < hdr.index("readback")
    ledger = usage.usage_snapshot()["ledger"]
    assert [(r["principal"], r["model"], r["kind"], r["rows"])
            for r in ledger] == [("anonymous", m.key, "score", 3)]


def test_predict_via_rest_frames(models, monkeypatch):
    monkeypatch.setenv("H2O3_SCORE_LINGER_MS", "100")
    m = models["gbm"]
    frames = [Frame.from_dict({k: v[:k_n] for k, v in _cols(64, 70 + i)
                               .items() if k != "y"})
              for i, k_n in enumerate((1, 8, 64, 5))]
    d0 = mb.DISPATCHES.value()
    got = _concurrent(lambda f: serving.predict_via_rest(m, f),
                      [(f,) for f in frames])
    assert mb.DISPATCHES.value() - d0 == 1
    for f, p in zip(frames, got):
        want = m.predict(f)
        assert p.names == want.names and p.nrows == f.nrows
        for name in p.names:
            a, b = p.vec(name).to_numpy(), want.vec(name).to_numpy()
            assert np.array_equal(a, b), name
        DKV.remove(p.key)
        DKV.remove(want.key)
        DKV.remove(f.key)


@pytest.mark.parametrize("algo", ["gbm", "glm", "deeplearning", "kmeans"])
def test_carried_jax_models_answer_as_the_jax_package(algo, models):
    cols = _cols(300, 22)
    jf = JFrame.from_dict(cols)
    params = {"gbm": dict(ntrees=4, max_depth=3, seed=1),
              "glm": dict(family="binomial"),
              "deeplearning": dict(hidden=[6], epochs=1, seed=1),
              "kmeans": dict(k=3, seed=1)}[algo]
    jm = JE.ESTIMATORS[algo](**params)
    if algo == "kmeans":
        jm.train(x=["x0", "x1", "x2", "x3"], training_frame=jf)
    else:
        jm.train(x=XS, y="y", training_frame=jf)
    tm = carry(jm)
    DKV.put(tm.key, tm)
    rows = _rows(40, 23)
    want = JSV.score_payload(jm, rows)
    got = serving.score_payload(tm, rows)
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if isinstance(w[k], float):
                assert abs(g[k] - w[k]) <= 1e-5, (k, g[k], w[k])
            else:
                assert g[k] == w[k], (k, g, w)
    tf_cols = {k: v[:40] for k, v in _cols(40, 24).items() if k != "y"}
    jp = JSV.predict_via_rest(jm, JFrame.from_dict(tf_cols))
    tp = serving.predict_via_rest(tm, Frame.from_dict(tf_cols))
    assert tp.names == jp.names
    for name in tp.names:
        a = tp.vec(name).to_numpy()
        b = np.asarray(jp.vec(name).to_numpy(), np.float64)
        assert np.abs(a - b).max() <= 1e-5, name
    DKV.remove(tm.key)
    JDKV.remove(jm.key)


def test_depth_accounting_under_thread_stress(models, monkeypatch):
    """32 threads (more than the cores) as four tenants, with the
    interpreter switching threads every 10 µs: every request gets its own
    rows, and the queue's depth and per-tenant counts return to zero (a
    lost update in their read-modify-write would leave them off)."""
    import sys
    monkeypatch.setenv("H2O3_SCORE_LINGER_MS", "1")
    m = models["gbm"]
    raws = [serving.payload_to_raw(m, _rows(1 + i % 5, 80 + i))
            for i in range(32)]
    want = [_alone(m, r) for r in raws]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(i, r):
            with tracing.request_context(f"tenant{i % 4}"):
                return [mb.BATCHER.score(m, r, r.shape[0])
                        for _ in range(10)]
        got = _concurrent(work, [(i, r) for i, r in enumerate(raws)])
    finally:
        sys.setswitchinterval(old)
    for outs, w in zip(got, want):
        assert not isinstance(outs, Exception), outs
        for o in outs:
            assert np.array_equal(o.view(np.uint8), w.view(np.uint8))
    assert mb.BATCHER._depth == 0 and mb.BATCHER._pending == {}
    assert mb.BATCHER.queued_by_principal() == {}
    assert qos.GATE.depth() == 0 and qos.interactive_pending() == 0
