"""The port's REST server (api/server.py) against the JAX package's, on
the CPU: the JAX `H2OServer(port=0)` and the port's, after
`h2o3_tpu_torch.init(device="cpu")`, run in this one process and get the
same requests over loopback HTTP.

The data: a CSV made from a seed with numpy, 2,000 rows of six numeric
columns, one categorical of four levels and a binary response.

- ParseSetup: names and types equal; Parse + /3/Frames: rows, types and
  rollups within 1e-6 relative to the column's scale (the larger of
  |min| and |max|: a mean near 0 sums in f32 in both packages);
- a GBM built over REST (5 trees, depth 5, min_rows 100, seed 42: the
  near-tie hazard of ROADMAP.md asks for min_rows 100): training AUC and
  logloss within 1e-5, the predictions frame within 1e-5; the port's REST
  model equals `train()` with the same keyword arguments bit for bit;
- a binomial GLM: predictions within 1e-3 (the port's reduced one-hot
  design is a deliberate difference);
- /3/Predictions/models/{m} rows within 1e-5; a JAX-trained GBM carried
  into the port's store through convert.py, scored by both: 1e-5;
- /99/Rapids expressions equal (1e-6 relative for floats); jobs, DELETE;
- the route table: the (pattern, method) pairs equal exactly, and so do
  /3/Metadata/endpoints and /3/ModelBuilders;
- auth: 401 with WWW-Authenticate, no QoS counter moved by it;
- 429 (rate), 503 (queue) and 504 (deadline) with Retry-After under the
  same QoS settings; Server-Timing stage names; the trace-id echo.
"""

import gc
import http.client
import json
import re
import time
import urllib.parse

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.api import server as JS
from h2o3_tpu.serving import microbatch as JMB
from h2o3_tpu.serving import qos as JQ
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.api import server as TS
from h2o3_tpu_torch.obs import metrics as TM
from h2o3_tpu_torch.obs import watchdog as TWD
from h2o3_tpu_torch.serving import microbatch as TMB
from h2o3_tpu_torch.serving import qos as TQ

N = 2000
GBM = dict(ntrees=5, max_depth=5, min_rows=100, seed=42)
ROWS = [{"x0": 0.1, "x1": -0.4, "x2": 1.2, "x3": 0.3, "x4": -1.0,
         "x5": 0.0, "color": "blue"},
        {"x0": -1.1, "x1": 0.7, "x2": -0.2, "x3": 2.0, "x4": 0.5,
         "x5": 1.5, "color": "teal"},
        {"x0": 2.0, "x1": 0.0, "x2": 0.0, "x3": -0.5, "x4": 0.1,
         "x5": -0.3, "color": "red"}]


def req(port, method, path, data=None, headers=None, body=None):
    """(status, lower-cased headers, JSON body) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    hdrs = dict(headers or {})
    if data is not None:
        body = urllib.parse.urlencode(
            {k: (json.dumps(v) if isinstance(v, (list, dict)) else v)
             for k, v in data.items()}).encode()
        hdrs["Content-Type"] = "application/x-www-form-urlencoded"
    elif isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
        hdrs["Content-Type"] = "application/json"
    conn.request(method, path, body=body, headers=hdrs)
    r = conn.getresponse()
    raw = r.read()
    h = {k.lower(): v for k, v in r.getheaders()}
    conn.close()
    try:
        js = json.loads(raw) if raw else None
    except ValueError:
        js = raw
    return r.status, h, js


def wait_job(port, key, timeout=300):
    t0 = time.time()
    while time.time() - t0 < timeout:
        _, _, js = req(port, "GET", f"/3/Jobs/{key}")
        j = js["jobs"][0]
        if j["status"] in ("DONE", "FAILED", "CANCELLED"):
            return j
        time.sleep(0.05)
    raise TimeoutError(key)


def write_csv(path, n=N, seed=5):
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, 6)), 4)
    cat = rng.choice(["red", "green", "blue", "teal"], n)
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
             + np.where(cat == "blue", 1.0, 0.0))
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    with open(path, "w") as f:
        f.write("x0,x1,x2,x3,x4,x5,color,y\n")
        for i in range(n):
            f.write(",".join([repr(float(v)) for v in X[i]]
                             + [cat[i], "yes" if y[i] else "no"]) + "\n")
    return str(path)


def jax_extension_parts():
    """The routes and algos that tests of the JAX package register through
    its extension SPI in this process (pattern strings and method, algo
    names): not part of either package's own surface."""
    from h2o3_tpu import ext as JEXT
    routes = {(pat, m) for e in JEXT.extensions() for pat, m, _ in e.routes}
    algos = {a for e in JEXT.extensions() for a in e.estimators}
    return routes, algos


def both(ctx, method, path, **kw):
    """The same request to the JAX server and the port's."""
    return (req(ctx["j"], method, path, **kw),
            req(ctx["t"], method, path, **kw))


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    h2o3_tpu_torch.init(device="cpu")
    j_before = set(h2o3_tpu.ls())
    csv = write_csv(tmp_path_factory.mktemp("rest") / "train.csv")
    js = JS.H2OServer(port=0).start()
    ts = TS.H2OServer(port=0).start()
    c = {"j": js.port, "t": ts.port, "csv": csv}
    for port in (js.port, ts.port):
        _, _, p = req(port, "POST", "/3/Parse",
                      data={"source_frames": csv,
                            "destination_frame": "train.hex"})
        assert wait_job(port, p["job"]["key"])["status"] == "DONE"
        _, _, b = req(port, "POST", "/3/ModelBuilders/gbm",
                      data=dict(GBM, training_frame="train.hex",
                                response_column="y", model_id="gbm_rest"))
        j = wait_job(port, b["job"]["key"])
        assert j["status"] == "DONE", j
    yield c
    js.stop()
    ts.stop()
    TWD.reset()
    h2o3_tpu_torch.shutdown()
    for k in set(h2o3_tpu.ls()) - j_before:
        h2o3_tpu.remove(k)
    gc.collect()


# ---------------------------------------------------------------------------
def test_parse_setup_names_and_types(ctx):
    (sj, _, a), (st, _, b) = both(ctx, "POST", "/3/ParseSetup",
                                  data={"source_frames": ctx["csv"]})
    assert sj == st == 200
    for k in ("column_names", "column_types", "separator", "check_header",
              "parse_type", "destination_frame"):
        assert a[k] == b[k], k


def test_parsed_frame_rows_types_rollups(ctx):
    (_, _, a), (_, _, b) = both(ctx, "GET", "/3/Frames/train.hex")
    fa, fb = a["frames"][0], b["frames"][0]
    assert fa["rows"] == fb["rows"] == N
    assert fa["column_count"] == fb["column_count"]
    for ca, cb in zip(fa["columns"], fb["columns"]):
        assert (ca["label"], ca["type"], ca["missing_count"],
                ca["domain"]) == (cb["label"], cb["type"],
                                  cb["missing_count"], cb["domain"])
    assert fa["summary"].keys() == fb["summary"].keys()
    for col, sa in fa["summary"].items():
        sb = fb["summary"][col]
        assert sa.keys() == sb.keys()
        scale = max(abs(sa.get("min") or 0.0), abs(sa.get("max") or 0.0),
                    1.0)
        for k, va in sa.items():
            if isinstance(va, float):
                assert abs(va - sb[k]) <= 1e-6 * scale, (col, k, va, sb[k])
            else:
                assert va == sb[k], (col, k)


def test_rest_gbm_matches_jax_and_train(ctx):
    (_, _, a), (_, _, b) = both(ctx, "GET", "/3/Models/gbm_rest")
    ma, mb = a["models"][0], b["models"][0]
    for k in ("auc", "logloss"):
        assert ma["training_metrics"][k] == pytest.approx(
            mb["training_metrics"][k], abs=1e-5), k
    # the REST coercion builds the model train() builds: trees bit for bit
    tm = h2o3_tpu_torch.get_model("gbm_rest")
    ref = h2o3_tpu_torch.H2OGradientBoostingEstimator(**GBM)
    ref.train(y="y", training_frame=h2o3_tpu_torch.get_frame("train.hex"))
    for f in ("col", "thr", "na_left", "value"):
        assert np.array_equal(getattr(tm._trees, f).numpy(),
                              getattr(ref._trees, f).numpy(),
                              equal_nan=True), f
    assert dict(tm.params, model_id=None) == ref.params
    h2o3_tpu_torch.remove(ref.key)


def test_rest_gbm_predictions_frame(ctx):
    (sj, _, a), (st, _, b) = both(
        ctx, "POST", "/3/Predictions/models/gbm_rest/frames/train.hex",
        data={"predictions_frame": "gbm_preds"})
    assert sj == st == 200
    assert a["predictions_frame"] == b["predictions_frame"]
    pa = h2o3_tpu.get_frame("gbm_preds").to_numpy()[:N]
    pb = h2o3_tpu_torch.get_frame("gbm_preds").to_numpy()
    assert pa.shape == pb.shape
    np.testing.assert_allclose(pa[:, 1:].astype(float), pb[:, 1:],
                               atol=1e-5)
    assert a["model_metrics"][0]["auc"] == pytest.approx(
        b["model_metrics"][0]["auc"], abs=1e-5)


def test_rest_glm_predictions(ctx):
    for port in (ctx["j"], ctx["t"]):
        _, _, r = req(port, "POST", "/3/ModelBuilders/glm",
                      data={"training_frame": "train.hex",
                            "response_column": "y", "family": "binomial",
                            "model_id": "glm_rest", "lambda_": 0})
        assert wait_job(port, r["job"]["key"])["status"] == "DONE"
        st, _, _ = req(port, "POST",
                       "/3/Predictions/models/glm_rest/frames/train.hex",
                       data={"predictions_frame": "glm_preds"})
        assert st == 200
    pa = h2o3_tpu.get_frame("glm_preds").to_numpy()[:N]
    pb = h2o3_tpu_torch.get_frame("glm_preds").to_numpy()
    # the port's reduced one-hot design: 1e-3 (a deliberate difference)
    np.testing.assert_allclose(pa[:, 1:].astype(float), pb[:, 1:],
                               atol=1e-3)


def _rows_pred(port, model, headers=None):
    st, h, js = req(port, "POST", f"/3/Predictions/models/{model}",
                    body={"rows": ROWS}, headers=headers)
    assert st == 200, js
    assert js["row_count"] == len(ROWS)
    return h, js["predictions"]


def test_predict_rows(ctx):
    _, pa = _rows_pred(ctx["j"], "gbm_rest")
    _, pb = _rows_pred(ctx["t"], "gbm_rest")
    for ra, rb in zip(pa, pb):
        assert ra.keys() == rb.keys()
        assert ra["predict"] == rb["predict"]
        for k in ("pno", "pyes"):
            assert ra[k] == pytest.approx(rb[k], abs=1e-5)


def test_jax_gbm_carried_into_the_port_scores_the_same(ctx):
    jm = h2o3_tpu.get_model("gbm_rest")
    ta, di = jm._trees, jm._dinfo
    carried = convert.gbm_from_arrays(
        col=np.asarray(ta.col), thr=np.asarray(ta.thr),
        na_left=np.asarray(ta.na_left), value=np.asarray(ta.value),
        catbits=(None if ta.catbits is None else np.asarray(ta.catbits)),
        col_is_cat=(None if ta.col_is_cat is None
                    else np.asarray(ta.col_is_cat)),
        depth=ta.depth, f0=jm._f0, distribution="bernoulli",
        learn_rate=jm.params["learn_rate"], predictors=di.predictors,
        domains=di.domains, response_name=di.response_name,
        response_domain=di.response_domain, model_id="gbm_carried")
    h2o3_tpu_torch.DKV.put("gbm_carried", carried)
    _, pa = _rows_pred(ctx["j"], "gbm_rest")
    _, pb = _rows_pred(ctx["t"], "gbm_carried")
    for ra, rb in zip(pa, pb):
        assert ra["predict"] == rb["predict"]
        assert ra["pyes"] == pytest.approx(rb["pyes"], abs=1e-5)
    (_, _, a), (_, _, b) = (
        req(ctx["j"], "POST",
            "/3/Predictions/models/gbm_rest/frames/train.hex", data={}),
        req(ctx["t"], "POST",
            "/3/Predictions/models/gbm_carried/frames/train.hex", data={}))
    pa = h2o3_tpu.get_frame(a["predictions_frame"]["name"]).to_numpy()[:N]
    pb = h2o3_tpu_torch.get_frame(b["predictions_frame"]["name"]).to_numpy()
    np.testing.assert_allclose(pa[:, 1:].astype(float), pb[:, 1:],
                               atol=1e-5)


@pytest.mark.parametrize("ast", [
    "(nrow train.hex)",
    "(mean (cols train.hex [0]) 1 0)",
    "(tmp= rx_f (rows train.hex (> (cols train.hex [0]) 0.5)))",
    "(tmp= rx_g (GB train.hex [6] mean 0 \"all\" nrow 0 \"all\"))",
    "(colnames train.hex)",
])
def test_rapids_equal(ctx, ast):
    (sj, _, a), (st, _, b) = both(ctx, "POST", "/99/Rapids",
                                  data={"ast": ast})
    assert sj == st == 200, (a, b)
    assert a["__meta"] == b["__meta"]
    if "key" in a:
        assert (a["num_rows"], a["num_cols"]) == (b["num_rows"],
                                                  b["num_cols"])
        fa = h2o3_tpu.get_frame(a["key"]["name"])
        fb = h2o3_tpu_torch.get_frame(b["key"]["name"])
        assert fa.names == fb.names
        xa = fa.to_numpy()[:fa.nrows].astype(float)
        np.testing.assert_allclose(xa, fb.to_numpy().astype(float),
                                   rtol=1e-6)
    elif "scalar" in a:
        assert a["scalar"] == pytest.approx(b["scalar"], rel=1e-6)
    else:
        assert a["string"] == b["string"]


def test_jobs_and_delete(ctx):
    (_, _, a), (_, _, b) = both(ctx, "GET", "/3/Jobs")
    da = sorted(j["description"] for j in a["jobs"])
    db = sorted(j["description"] for j in b["jobs"])
    assert {"Parse " + ctx["csv"], "gbm model build"} <= set(da) & set(db)
    for port in (ctx["j"], ctx["t"]):
        req(port, "POST", "/99/Rapids",
            data={"ast": "(tmp= del_me (cols train.hex [0 1]))"})
        assert req(port, "GET", "/3/Frames/del_me")[0] == 200
        assert req(port, "DELETE", "/3/Frames/del_me")[0] == 200
        assert req(port, "GET", "/3/Frames/del_me")[0] == 404
        assert req(port, "GET", "/3/Jobs/no_such_job")[0] == 404


def test_route_table_equal(ctx):
    ext_routes, ext_algos = jax_extension_parts()
    jroutes = [r for r in JS.ROUTES if (r[0].pattern, r[1]) not in ext_routes]
    jr = {(p.pattern, m) for p, m, _ in jroutes}
    tr = {(p.pattern, m) for p, m, _ in TS.ROUTES}
    assert jr == tr
    assert len(jroutes) == len(TS.ROUTES)
    (_, _, a), (_, _, b) = both(ctx, "GET", "/3/Metadata/endpoints")
    a["routes"] = [r for r in a["routes"]
                   if (r["url_pattern"], r["http_method"]) not in ext_routes]
    assert len(a["routes"]) == b["num_routes"]
    # every row equal; the summary too, but of the three handlers whose
    # JAX summary names the TPU's mesh or MXU (a deliberate difference)
    differs = {"_h_compute_gram", "_h_network_test", "_h_cloud_lock"}
    for ra, rb in zip(a["routes"], b["routes"]):
        if ra["handler_method"] in differs:
            ra, rb = dict(ra, summary=""), dict(rb, summary="")
        assert ra == rb
    (_, _, a), (_, _, b) = both(ctx, "GET", "/3/ModelBuilders")
    for algo in ext_algos:
        a["model_builders"].pop(algo, None)
    assert a == b


def _qos_lines():
    return sorted(ln for ln in TM.REGISTRY.prometheus_text().splitlines()
                  if ln.startswith("h2o3_qos_"))


@pytest.fixture
def auth_servers():
    users = {"gold": "g1", "flood": "f1"}
    js = JS.H2OServer(port=0, auth=users).start()
    ts = TS.H2OServer(port=0, auth=users).start()
    yield js.port, ts.port
    js.stop()
    ts.stop()


def _basic(user, pwd):
    import base64
    return {"Authorization": "Basic " + base64.b64encode(
        f"{user}:{pwd}".encode()).decode()}


def test_auth_401_spends_no_tokens(ctx, auth_servers, monkeypatch):
    monkeypatch.setenv("H2O3_QOS_RATES", "flood:2")
    monkeypatch.setenv("H2O3_QOS_BURST", "1")
    TQ.reset()
    JQ.reset()
    before = _qos_lines()
    for port in auth_servers:
        for hdr in (None, _basic("flood", "wrong"),
                    {"Authorization": "Basic !!notb64"}):
            st, h, _ = req(port, "POST", "/3/Predictions/models/gbm_rest",
                           body={"rows": ROWS}, headers=hdr)
            assert st == 401
            assert h["www-authenticate"].startswith("Basic realm=")
    assert _qos_lines() == before
    for port in auth_servers:
        st, _, js = req(port, "POST", "/3/Predictions/models/gbm_rest",
                        body={"rows": ROWS}, headers=_basic("gold", "g1"))
        assert st == 200, js
    TQ.reset()
    JQ.reset()


def test_qos_codes_429_503_504(ctx, auth_servers, monkeypatch):
    monkeypatch.setenv("H2O3_QOS_RATES", "flood:0.5")
    monkeypatch.setenv("H2O3_QOS_BURST", "1")
    TQ.reset()
    JQ.reset()
    out = []
    for port, mb in zip(auth_servers, (JMB, TMB)):
        got = []
        flood = _basic("flood", "f1")
        for _ in range(2):      # the second is over the rate
            st, h, _ = req(port, "POST", "/3/Predictions/models/gbm_rest",
                           body={"rows": ROWS}, headers=flood)
            got.append((st, h.get("retry-after")))
        st, h, _ = req(port, "POST", "/3/Predictions/models/gbm_rest",
                       body={"rows": ROWS},
                       headers=dict(_basic("gold", "g1"),
                                    **{"X-H2O3-Deadline-Ms": "0"}))
        got.append((st, h.get("retry-after")))
        monkeypatch.setattr(mb.BATCHER, "_depth", 10 ** 6)
        st, h, _ = req(port, "POST", "/3/Predictions/models/gbm_rest",
                       body={"rows": ROWS}, headers=_basic("gold", "g1"))
        got.append((st, h.get("retry-after")))
        monkeypatch.setattr(mb.BATCHER, "_depth", 0)
        out.append(got)
    assert [s for s, _ in out[0]] == [200, 429, 504, 503]
    assert out[0] == out[1]
    TQ.reset()
    JQ.reset()


def test_server_timing_and_trace_echo(ctx):
    names = []
    for port, model in ((ctx["j"], "gbm_rest"), (ctx["t"], "gbm_rest")):
        h, _ = _rows_pred(port, model,
                          headers={"X-H2O3-Trace-Id": "rest-parity-7"})
        assert h["x-h2o3-trace-id"] == "rest-parity-7"
        names.append([re.sub(r";.*", "", s.strip())
                      for s in h["server-timing"].split(",")])
        st, h, _ = req(port, "GET", "/3/Cloud",
                       headers={"X-H2O3-Trace-Id": 'bad"id'})
        assert st == 200 and h["x-h2o3-trace-id"] != 'bad"id'
    assert names[0] == names[1]
    assert "edge" in names[0] and "app" in names[0]
    # the request's root span closes after its answer is written, so the
    # trace may lag the answer by a moment: read it until the span is in
    deadline = time.monotonic() + 10.0
    while True:
        st, _, tr = req(ctx["t"], "GET", "/3/Trace/rest-parity-7")
        assert st == 200 and tr["__meta"]["schema_type"] == "TraceV3", tr
        if any(s["name"] == "rest.request" for s in tr["spans"]) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert any(s["name"] == "rest.request" for s in tr["spans"])


def test_an_early_answer_drains_the_body(ctx):
    """A 401 answered before the request's body is read still reaches the
    client: the port's server drains the unread body before the socket
    closes (closing over unread bytes resets the connection, which the
    JAX server does now and then; a client then sees an error, not the
    401)."""
    users = {"u": "p"}
    s = TS.H2OServer(port=0, auth=users).start()
    body = {"rows": [{f"x{j}": 0.5 for j in range(28)}] * 2000}
    try:
        codes = [req(s.port, "POST", "/3/Predictions/models/m",
                     body=body)[0] for _ in range(50)]
    finally:
        s.stop()
    assert codes == [401] * 50


def test_a_huge_declared_body_gets_a_prompt_401():
    """An unauthenticated request that declares a 10 GB body and sends 100
    bytes of it gets its 401 at once, and the server neither allocates
    the declared size nor waits for the rest: it drains at most
    _DRAIN_CAP bytes, no chunk waiting over _DRAIN_WAIT_S, then closes the
    connection. The server answers the next request as before."""
    import socket
    s = TS.H2OServer(port=0, auth={"u": "p"}).start()
    try:
        t0 = time.monotonic()
        with socket.create_connection(("127.0.0.1", s.port),
                                      timeout=30) as c:
            c.sendall(b"POST /3/Predictions/models/m HTTP/1.1\r\n"
                      b"Host: x\r\nContent-Type: application/json\r\n"
                      b"Content-Length: 10000000000\r\n\r\n" + b"{" * 100)
            head = b""
            while b"\r\n\r\n" not in head:
                got = c.recv(4096)
                assert got, head
                head += got
            t_answer = time.monotonic() - t0
            # the server closes the connection within a drain wait or so
            while c.recv(4096):
                pass
            t_closed = time.monotonic() - t0
        assert head.startswith(b"HTTP/1.0 401"), head
        assert b"WWW-Authenticate" in head
        assert t_answer < 5.0
        assert t_closed < TS._DRAIN_WAIT_S + 5.0
        assert req(s.port, "GET", "/3/Cloud")[0] == 401
        auth = {"Authorization": "Basic dTpw"}
        assert req(s.port, "GET", "/3/Cloud", headers=auth)[0] == 200
    finally:
        s.stop()


def test_handler_threads_score_without_autograd(ctx, monkeypatch):
    """Each request runs on a fresh thread, where torch's grad mode is on
    by default: the scoring and metrics paths must switch it off
    themselves. Every scorer call under a handler thread (row payloads,
    a predictions frame with its metrics) runs with grad mode off, for a
    GBM, a GLM and a net whose parameters require grad."""
    import torch
    from h2o3_tpu_torch.serving import scorer_cache as SC
    seen = []
    orig = SC._Program._fn

    def fn(self, params, raw_dev):
        seen.append(torch.is_grad_enabled())
        return orig(self, params, raw_dev)
    monkeypatch.setattr(SC._Program, "_fn", fn)
    train = h2o3_tpu_torch.get_frame("train.hex")
    glm = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(
        family="binomial", lambda_=0, model_id="glm_grad")
    glm.train(y="y", training_frame=train)
    dl = h2o3_tpu_torch.H2ODeepLearningEstimator(hidden=[8], epochs=1,
                                                 seed=1, model_id="dl_grad")
    dl.train(y="y", training_frame=train)
    dl._net.requires_grad_(True)
    SC.CACHE.clear()
    for model in ("gbm_rest", "glm_grad", "dl_grad"):
        _rows_pred(ctx["t"], model)
        st, _, js = req(ctx["t"], "POST",
                        f"/3/Predictions/models/{model}/frames/train.hex",
                        data={})
        assert st == 200, js
        assert js["model_metrics"][0]["auc"] > 0.5
    assert seen and not any(seen)
    h2o3_tpu_torch.remove("glm_grad")
    h2o3_tpu_torch.remove("dl_grad")
