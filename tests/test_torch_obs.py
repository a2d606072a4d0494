"""The port's observability core against the JAX package's, on the CPU.

Each test runs the same script of calls through both packages' modules
and compares what they record:
- metrics: the same series and calls on a fresh registry of each give
  the same Prometheus and OpenMetrics text, the same JSON snapshot and
  the same cluster merge of two snapshots (exactly: both are text
  renderers over the same numbers). The runtime gauges are the one
  allowed difference: the port reads the card through torch and counts
  CUDA graph captures where the JAX package counts XLA compiles;
- spans and tracing: ring overflow (the dropped-span counter), parent
  and child links, a job's thread inheriting the trace, the recorder's
  retention rules and its segment round trip (a fresh recorder over the
  same directory reads the same traces back);
- the structured log: its records, their trace and span ids, `recent()`,
  the durable segments under the ice root;
- lockdep: an inversion raises in both, a trylock adds no order edge, a
  bounded acquire does; the same edges recorded;
- the hooks: a small GBM, GLM, parse and pager run in each package move
  the same counters by the same amounts and record the same span names
  and counts.
"""

import threading
import time

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu.analysis import lockdep as JL
from h2o3_tpu.obs import metrics as JM
from h2o3_tpu.obs import recorder as JR
from h2o3_tpu.obs import timeline as JT
from h2o3_tpu.obs import tracing as JTR
from h2o3_tpu.utils import log as JLOG
from h2o3_tpu_torch.analysis import lockdep as TL
from h2o3_tpu_torch.obs import metrics as TM
from h2o3_tpu_torch.obs import recorder as TR
from h2o3_tpu_torch.obs import timeline as TT
from h2o3_tpu_torch.obs import tracing as TTR
from h2o3_tpu_torch.utils import log as TLOG

PKGS = {"jax": (JM, JT, JTR, JR, JLOG, JL),
        "port": (TM, TT, TTR, TR, TLOG, TL)}


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# metrics
def _script(mod, case):
    """One registry driven through a script of calls; returns it."""
    reg = mod.MetricsRegistry()
    c = reg.counter("t_requests_total", 'requests "served"\nby route')
    g = reg.gauge("t_queue_depth", "queue depth")
    h = reg.histogram("t_latency_seconds", "latency",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    reg.gauge("t_callback", "a callback gauge",
              fn=lambda: [({"kind": "a"}, 3.0), ({"kind": "b"}, 0.25)])
    rng = np.random.default_rng(case)
    for i in range(20):
        c.inc(float(rng.integers(1, 4)), route=f"/r{i % 3}",
              code=str(200 + 100 * (i % 2)))
        g.set(float(rng.normal()), host=str(i % 2))
        h.observe(float(rng.exponential(0.05)), route=f"/r{i % 2}",
                  exemplar=f"trace-{i}" if case and i % 4 == 0 else None)
    if case == 2:
        c.remove(route="/r0", code="200")
        g.inc(2.5, host="0")
        g.remove(host="1")
    return reg


@pytest.mark.parametrize("case", [0, 1, 2])
def test_metrics_text_matches_jax(case, monkeypatch):
    """The same calls give the same Prometheus, OpenMetrics and JSON
    bodies (exemplar timestamps pinned)."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    j, t = _script(JM, case), _script(TM, case)
    assert t.prometheus_text() == j.prometheus_text()
    assert t.openmetrics_text() == j.openmetrics_text()
    assert t.openmetrics_text().endswith("# EOF\n")
    assert t.to_dict() == j.to_dict()
    hj = j.get("t_latency_seconds")
    ht = t.get("t_latency_seconds")
    assert ht.snapshot(route="/r0") == hj.snapshot(route="/r0")
    assert ht.series_snapshots() == hj.series_snapshots()


def test_cluster_merge_matches_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    snaps = {name: [(0, _script(mod, 1).to_dict()),
                    (3, _script(mod, 2).to_dict())]
             for name, mod in (("jax", JM), ("port", TM))}
    assert TM.merge_cluster_snapshots(snaps["port"]) == \
        JM.merge_cluster_snapshots(snaps["jax"])
    assert TM.cluster_prometheus_text(snaps["port"]) == \
        JM.cluster_prometheus_text(snaps["jax"])
    assert TM.cluster_openmetrics_text(snaps["port"]) == \
        JM.cluster_openmetrics_text(snaps["jax"])


def test_metric_kind_clash_and_dead_gauge_match_jax():
    for mod in (JM, TM):
        reg = mod.MetricsRegistry()
        reg.counter("t_x_total")
        with pytest.raises(TypeError):
            reg.gauge("t_x_total")
        with pytest.raises(ValueError):
            reg.counter("t_y_total").inc(-1)
    before = {n: m.COLLECT_ERRORS.value(metric="t_dead")
              for n, m in (("jax", JM), ("port", TM))}
    texts = {}
    for name, mod in (("jax", JM), ("port", TM)):
        reg = mod.MetricsRegistry()
        reg.gauge("t_dead", "raises", fn=lambda: 1 / 0)
        texts[name] = reg.prometheus_text()
        assert mod.COLLECT_ERRORS.value(metric="t_dead") == \
            before[name] + 1
    assert texts["port"] == texts["jax"]


def test_runtime_gauges_are_the_one_difference():
    """The port's runtime series: the device memory gauge (no series
    before CUDA is initialised), the build info with torch's labels, and
    the graph-capture counter in place of the XLA compile counters."""
    tm = TM.REGISTRY.to_dict()
    jm = JM.REGISTRY.to_dict()
    assert "h2o3_cuda_graph_captures_total" in tm
    assert "h2o3_cuda_graph_capture_seconds" in tm
    assert "h2o3_xla_compiles_total" in jm
    assert not any(n.startswith("h2o3_xla") for n in tm)
    for name in ("h2o3_device_memory_bytes", "h2o3_dkv_objects",
                 "h2o3_build_info", "h2o3_metric_collect_errors_total",
                 "h2o3_cluster_scrape_timeouts_total"):
        assert name in tm and tm[name]["kind"] == jm[name]["kind"]
    info = tm["h2o3_build_info"]["series"][0]["labels"]
    assert {"torch", "cuda", "device", "backend"} <= set(info)
    assert TM.graph_capture_count() >= 0


# ---------------------------------------------------------------------------
# spans and tracing
@pytest.mark.parametrize("capacity", [3, 5])
def test_span_ring_overflow_matches_jax(capacity):
    got = {}
    for name, (M, T, *_rest) in PKGS.items():
        tl = T.SpanTimeline(capacity=capacity)
        ctr = M.REGISTRY.get("h2o3_timeline_dropped_spans_total")
        d0 = ctr.value() if ctr is not None else 0.0
        for i in range(7):
            tl.end(tl.begin(f"s{i}", i=i))
        ctr = M.REGISTRY.get("h2o3_timeline_dropped_spans_total")
        got[name] = ([s["name"] for s in tl.snapshot()],
                     ctr.value() - d0, [s["name"] for s in
                                        tl.snapshot(limit=2)])
    assert got["port"] == got["jax"]
    assert got["port"][1] == 7 - capacity


def _tree_shape(spans):
    """(name, parent's name) of each span: the links without the ids."""
    by_id = {s["id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent"], None)) for s in spans)


def test_span_parents_and_trace_tags_match_jax():
    got = {}
    for name, (_M, T, TR_, *_r) in PKGS.items():
        tl = T.SpanTimeline(capacity=64)
        with TR_.trace("trace-a"):
            a = tl.begin("outer", k=1)
            b = tl.begin("mid")
            c = tl.begin("inner")
            c.event("fault", chunk="c1")
            tl.end(c)
            tl.end(b)
            tl.end(a)
        d = tl.begin("untraced")
        tl.end(d)
        spans = tl.snapshot()
        got[name] = (_tree_shape(spans),
                     [s["trace"] for s in spans],
                     [len(tl.trace_snapshot("trace-a"))],
                     [e["name"] for e in spans[0]["attrs"]["events"]])
    assert got["port"] == got["jax"]


def test_job_thread_inherits_the_trace_and_principal(port_cpu):
    """A job started under a trace and a principal runs its work under
    both, inside a `job.run` span of that trace (as the JAX job does)."""
    from h2o3_tpu.core.jobs import Job as JJob
    from h2o3_tpu_torch.core.jobs import Job as TJob
    got = {}
    for name, job_cls, tr, tl in (("jax", JJob, JTR, JT),
                                  ("port", TJob, TTR, TT)):
        seen = {}

        def work(job, tr=tr, seen=seen):
            seen["trace"] = tr.current()
            seen["principal"] = tr.principal()
            seen["thread"] = threading.current_thread().name
            return None
        with tr.trace(f"job-trace-{name}"), \
                tr.request_context("alice"):
            job = job_cls(description="t")
            job.start(work, background=True)
            job.join()
        spans = tl.SPANS.trace_snapshot(f"job-trace-{name}")
        got[name] = (seen["trace"] == f"job-trace-{name}",
                     seen["principal"], seen["thread"].startswith("job-"),
                     [s["name"] for s in spans])
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (True, "alice", True)


RECORDER_SCRIPT = [
    # an error trace, a slow one, a sampled one, a fast OK one (dropped),
    # a fast OK one later marked errored by a log record (healed), and a
    # pinned one
    ("t-err", [("child", 0, 1.0, {}), ("root", None, 2.0, {"error": "x"})]),
    ("t-slow", [("child", 0, 5000.0, {}), ("root", None, 5001.0, {})]),
    ("t-samp", [("root", None, 1.0, {"sampled": True})]),
    ("t-fast", [("child", 0, 1.0, {}), ("root", None, 2.0, {})]),
    ("t-heal", [("root", None, 1.0, {"status": 200})]),
    ("t-pin", [("root", None, 1.0, {})]),
    ("t-5xx", [("root", None, 1.0, {"status": 503})]),
]


def test_recorder_retention_and_segments_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("H2O3_OBS_SAMPLE", "0.0")
    monkeypatch.setenv("H2O3_OBS_SLOW_MS", "1000")
    got = {}
    for name, (M, T, _TR, R, *_r) in PKGS.items():
        root = str(tmp_path / name)
        rec = R.FlightRecorder(root=root)
        c0 = {d: R.SPANS_SEEN.value(disposition=d)
              for d in ("retained", "downsampled", "healed")}
        rec.pin("t-pin")
        for tid, rows in RECORDER_SCRIPT:
            # children first, root last (a root closes its trace)
            spans = []
            for nm, parent, ms, attrs in rows:
                sp = T.Span(name=nm, t_start=1000.0,
                            span_id=900 if parent is None else 901,
                            parent_id=0 if parent is None else 900,
                            attrs=dict(attrs), trace=tid)
                sp.t_end = 1000.0 + ms / 1e3
                spans.append(sp)
            for sp in spans:
                rec.on_span_end(sp)
        rec.mark_error("t-heal")
        rec.flush()
        fresh = R.FlightRecorder(root=root)
        kept = sorted(t for t, _ in RECORDER_SCRIPT
                      if fresh.load_trace(t))
        counts = {d: R.SPANS_SEEN.value(disposition=d) - c0[d]
                  for d in c0}
        found = sorted(s["trace"] for s in fresh.search(limit=50))
        errs = sorted(s["trace"] for s in fresh.search(status="error"))
        got[name] = (kept, counts, found, errs)
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["t-5xx", "t-err", "t-heal", "t-pin",
                              "t-samp", "t-slow"]


def test_recorder_overflow_fragment_is_kept(tmp_path, monkeypatch):
    """A trace past H2O3_OBS_TRACE_MAX_SPANS finalizes early as a
    fragment and is retained (its outcome is unknowable), in both."""
    monkeypatch.setenv("H2O3_OBS_SAMPLE", "0.0")
    monkeypatch.setenv("H2O3_OBS_TRACE_MAX_SPANS", "4")
    got = {}
    for name, (_M, T, _TR, R, *_r) in PKGS.items():
        rec = R.FlightRecorder(root=str(tmp_path / name))
        for i in range(6):
            sp = T.Span(name=f"c{i}", t_start=1.0, span_id=i + 10,
                        parent_id=1, trace="t-big")
            sp.t_end = 1.001
            rec.on_span_end(sp)
        rec.flush()
        got[name] = [s["name"] for s in rec.load_trace("t-big")]
    assert sorted(got["port"]) == ["c0", "c1", "c2", "c3"]
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# the structured log
def test_log_records_and_segments_match_jax(tmp_path, port_cpu):
    from h2o3_tpu.io import spill as JS
    from h2o3_tpu_torch.io import spill as TS
    got = {}
    for name, (_M, T, TR_, _R, LOG, _L), spill in (
            ("jax", PKGS["jax"], JS), ("port", PKGS["port"], TS)):
        old = spill.get_ice_root()
        spill.set_ice_root(str(tmp_path / name))
        try:
            with TR_.trace(f"log-{name}"):
                LOG.info("plain %s", 1)
                with T.span("logged.span"):
                    LOG.warn("inside a span")
            LOG.debug("below the level")
            LOG.flush()
            recs = LOG.search(trace=f"log-{name}", limit=10)
            files = LOG.list_files()
            body = LOG.read_file("default") or ""
            lines = LOG.recent(3)
        finally:
            spill.set_ice_root(old)
        got[name] = (
            sorted((r["level"], r["msg"], "span" in r) for r in recs),
            len(files) >= 1,
            sum(1 for ln in body.splitlines() if f"log-{name}" in ln),
            [ln.split(": ", 1)[-1] for ln in lines][-2:],
            LOG.search(grep="below the level", limit=5) == [])
    assert got["port"] == got["jax"]
    assert got["port"][0] == [("INFO", "plain 1", False),
                              ("WARNING", "inside a span", True)]


def test_error_log_marks_the_trace_for_retention(tmp_path, monkeypatch):
    monkeypatch.setenv("H2O3_OBS_SAMPLE", "0.0")
    got = {}
    for name, (_M, T, TR_, R, LOG, _L) in PKGS.items():
        R.RECORDER.set_root(str(tmp_path / name))
        try:
            with TR_.trace(f"err-{name}"):
                with T.span("quick"):
                    LOG.err("it failed")
            R.RECORDER.flush()
            got[name] = [s["name"] for s in
                         R.RECORDER.load_trace(f"err-{name}")]
        finally:
            R.RECORDER.set_root(None)
    assert got["port"] == got["jax"] == ["quick"]


# ---------------------------------------------------------------------------
# lockdep
def _lockdep_script(L):
    L.reset()
    L.enable("raise")
    try:
        a, b, c = L.make_lock("t.a"), L.make_lock("t.b"), L.make_rlock("t.c")
        d = L.make_lock("t.d")
        with a:
            with b:
                pass
        with c:
            with c:             # re-entry: no edge
                with a:
                    pass
        # a trylock records no edge and never raises
        with b:
            assert a.acquire(blocking=False)
            a.release()
        # a bounded acquire records the order
        with a:
            if d.acquire(timeout=1.0):
                d.release()
        inversion = None
        try:
            with b:
                with a:
                    pass
        except L.LockOrderInversion as e:
            inversion = str(e).split(" at ")[0]
        edges = sorted((e, site.split(":")[-1])
                       for e, site in L.edges().items())
        return edges, inversion, L.counts()
    finally:
        L.disable()
        L.reset()


def test_lockdep_rules_match_jax():
    j = _lockdep_script(JL)
    t = _lockdep_script(TL)
    assert t == j
    assert [e for e, _site in t[0]] == [("t.a", "t.b"), ("t.a", "t.d"),
                                        ("t.c", "t.a")]
    assert t[1].startswith("lock-order inversion: acquiring 't.a' while "
                           "holding 't.b'")


def test_lockdep_log_mode_counts_without_raising():
    for L in (JL, TL):
        L.reset()
        L.enable("log")
        try:
            a, b = L.make_lock("u.a"), L.make_lock("u.b")
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
            assert L.counts() == {"edges": 1, "inversions": 1}
        finally:
            L.disable()
            L.reset()


def test_port_locks_have_the_jax_lock_classes():
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.core.tiering import PAGER
    assert DKV._mutex.name == "dkv"
    assert PAGER._lock.name == "tiering.residency"
    assert TM.REGISTRY._lock.name == "metrics.registry"


# ---------------------------------------------------------------------------
# the hooks of the training, ingest and paging paths
def _hook_cols(n=400, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, n))
    y = (x[0] - x[1] + rng.normal(0, 0.5, n)) > 0
    return {"x0": x[0], "x1": x[1], "x2": x[2],
            "g": 2 * x[0] + rng.normal(0, 0.1, n),
            "y": np.array(["n", "p"], object)[y.astype(int)]}


def _counter(M, name, **labels):
    m = M.REGISTRY.get(name)
    return m.value(**labels) if m is not None else 0.0


def _names(T, tid):
    out = {}
    for s in T.SPANS.trace_snapshot(tid):
        out[s["name"]] = out.get(s["name"], 0) + 1
    return out


def _run_models(pkg, cols, tid):
    """A binned GBM (2 chunks of trees), an adaptive GBM and a gaussian
    GLM in package `pkg`, under trace `tid`; the counter deltas and the
    span counts they left."""
    if pkg == "jax":
        from h2o3_tpu.core.frame import Frame
        from h2o3_tpu import models as est
        M, T, TR_ = JM, JT, JTR
    else:
        from h2o3_tpu_torch.core.frame import Frame
        est = h2o3_tpu_torch
        M, T, TR_ = TM, TT, TTR
    fr = Frame.from_dict(cols)
    c0 = {"binned": _counter(M, "h2o3_gbm_row_trees_total",
                             engine="binned"),
          "adaptive": _counter(M, "h2o3_gbm_row_trees_total",
                               engine="adaptive"),
          "irlsm": _counter(M, "h2o3_glm_irlsm_iterations_total")}
    with TR_.trace(tid):
        est.H2OGradientBoostingEstimator(
            ntrees=4, max_depth=3, score_tree_interval=2, seed=1).train(
            x=["x0", "x1", "x2"], y="y", training_frame=fr)
        est.H2OGradientBoostingEstimator(
            ntrees=2, max_depth=3, histogram_type="UniformAdaptive",
            seed=1).train(x=["x0", "x1", "x2"], y="y", training_frame=fr)
        est.H2OGeneralizedLinearEstimator(
            family="gaussian", lambda_=0.0).train(
            x=["x0", "x1", "x2"], y="g", training_frame=fr)
    deltas = {"binned": _counter(M, "h2o3_gbm_row_trees_total",
                                 engine="binned") - c0["binned"],
              "adaptive": _counter(M, "h2o3_gbm_row_trees_total",
                                   engine="adaptive") - c0["adaptive"],
              "irlsm": _counter(M, "h2o3_glm_irlsm_iterations_total")
              - c0["irlsm"]}
    chunks = [s["attrs"]["trees"] for s in T.SPANS.trace_snapshot(tid)
              if s["name"] == "gbm.chunk"]
    return deltas, _names(T, tid), chunks


def test_training_hooks_match_jax(port_cpu):
    cols = _hook_cols()
    j = _run_models("jax", cols, "hooks-jax")
    t = _run_models("port", cols, "hooks-port")
    # the JAX adaptive engine counts its padded rows (the mesh's row
    # granule); the port pads no rows (ROADMAP.md §3)
    from h2o3_tpu.parallel import mesh as jmesh
    assert j[0]["adaptive"] == 2 * jmesh.cloud().padded_rows(400)
    assert t[0] == dict(j[0], adaptive=400 * 2)
    assert t[0]["binned"] == 400 * 4
    assert t[2] == j[2] == [2, 2]
    want = ("job.run", "gbm.chunk", "tree.grow", "tree.level",
            "tree.gamma", "glm.irlsm")
    assert {k: t[1].get(k, 0) for k in want} == \
        {k: j[1].get(k, 0) for k in want}
    assert t[1]["job.run"] == 3


def test_parse_hooks_match_jax(tmp_path, port_cpu):
    """The parse counters move by the file's bytes and rows in both
    packages; both record parse.setup, parse.file and parse.tokenize once
    and the port's native path packs in parse.pack."""
    from h2o3_tpu.io import parser as JP
    from h2o3_tpu_torch.io import parser as TP
    cols = _hook_cols(300)
    path = tmp_path / "hooks.csv"
    with open(path, "w") as f:
        f.write("x0,x1,x2,g,y\n")
        for i in range(300):
            f.write(f"{cols['x0'][i]:.9g},{cols['x1'][i]:.9g},"
                    f"{cols['x2'][i]:.9g},{cols['g'][i]:.9g},"
                    f"{cols['y'][i]}\n")
    got = {}
    for name, P, M, T, TR_ in (("jax", JP, JM, JT, JTR),
                               ("port", TP, TM, TT, TTR)):
        b0 = _counter(M, "h2o3_parse_bytes_total", type="CSV")
        r0 = _counter(M, "h2o3_parse_rows_total")
        with TR_.trace(f"parse-{name}"), T.span("parse.request"):
            fr = P.parse(str(path))
        got[name] = (_counter(M, "h2o3_parse_bytes_total", type="CSV") - b0,
                     _counter(M, "h2o3_parse_rows_total") - r0, fr.nrows,
                     _names(T, f"parse-{name}"))
    assert got["port"][:3] == got["jax"][:3] == \
        (float(path.stat().st_size), 300.0, 300)
    for stage in ("parse.setup", "parse.file", "parse.tokenize"):
        assert got["port"][3][stage] == got["jax"][3][stage] == 1
    assert got["port"][3]["parse.pack"] == 1


def test_pager_hooks_match_jax(port_cpu):
    """Demotions and faults of one column's chunk count alike in both
    pagers' series and mark the open span with the same events."""
    from h2o3_tpu.core import tiering as JTI
    from h2o3_tpu.core.frame import Frame as JF
    from h2o3_tpu_torch.core import tiering as TTI
    from h2o3_tpu_torch.core.frame import Frame as TF
    cols = {"a": np.arange(512, dtype=np.float64) * 0.5}
    got = {}
    for name, F, TI, M, T, TR_ in (("jax", JF, JTI, JM, JT, JTR),
                                   ("port", TF, TTI, TM, TT, TTR)):
        ch = F.from_dict(cols).vec("a")._chunk
        f0 = {t: _counter(M, "h2o3_dkv_tier_faults_total", tier=t)
              for t in ("host", "disk")}
        e0 = {t: _counter(M, "h2o3_dkv_tier_evictions_total", tier=t)
              for t in ("host", "disk")}
        with TR_.trace(f"pager-{name}"), T.span("paging") as sp:
            TI.PAGER.demote(ch, TI.TIER_HOST)
            TI.PAGER.fault(ch)
            TI.PAGER.demote(ch, TI.TIER_DISK)
            TI.PAGER.fault(ch)
            events = [e["name"] for e in sp.attrs.get("events", [])]
        got[name] = (
            {t: _counter(M, "h2o3_dkv_tier_faults_total", tier=t) - f0[t]
             for t in f0},
            {t: _counter(M, "h2o3_dkv_tier_evictions_total", tier=t)
             - e0[t] for t in e0}, events)
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"host": 1.0, "disk": 1.0}
