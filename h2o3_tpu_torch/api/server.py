"""REST API server of the port (h2o3_tpu/api/server.py) — water/api/
RequestServer.java rebuilt on stdlib http.

Reference: RequestServer.java:56 (route tree, ~150 routes :75-80), versioned
Schema system (water/api/Schema.java, schemas3/*), handlers (ParseHandler,
ModelBuilderHandler, FramesHandler, RapidsHandler, JobsHandler…), served by
Jetty through h2o-webserver-iface. Clients (h2o-py/h2o-r/Flow) are pure REST
consumers — this surface is the compatibility seam.

Design: one controller process serves the API (every H2O node serves
it; here the controller IS the cluster, on one device). Threaded stdlib
HTTPServer, no Jetty; routes mirror the /3 and /99 paths and schema field
names the clients expect. Model builds run as background Jobs, polled via
/3/Jobs like the reference.

Each request runs on a fresh thread. The scoring and metrics paths switch
autograd off themselves (the scorer cache scores under no_grad), and
request threads enter the process-wide sanitizers
(`sanitizers.thread_scope`), since torch keeps its dispatch modes per
thread.

In a cloud of several processes (deploy/multihost) the coordinator's
server carries a broadcaster: each request but the static, observability,
PostFile and ParseDistributed ones is replayed to every worker before the
local handler runs (`_dispatch_routed`, under the collective guard's
dispatch order, parallel/compat.py), the observability routes fan out
over its collect ops, and `/3/Cloud/drain` drains a worker. The
divergence sanitizer digests each replayed request's mutations, and a
scoring route's answer, against the workers'.
"""

from __future__ import annotations

import contextlib
import json
import re
import threading
import time as _time_mod
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

import h2o3_tpu_torch
from h2o3_tpu_torch.analysis import divergence as _dvg
from h2o3_tpu_torch.analysis import leaktrack as _ltk
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.jobs import Job, jobs_list
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.io import parser as io_parser
from h2o3_tpu_torch.obs import metrics as _obs_metrics
from h2o3_tpu_torch.obs import tracing as _tracing
from h2o3_tpu_torch.obs import usage as _usage
from h2o3_tpu_torch.obs.timeline import span as _span
from h2o3_tpu_torch.parallel import compat as _compat
from h2o3_tpu_torch.rapids import rapids_exec, Session
from h2o3_tpu_torch.utils import env as _env

# per-request REST latency, labeled by ROUTE PATTERN (bounded cardinality),
# method and status — the ROADMAP observability gap this closes
REQUEST_SECONDS = _obs_metrics.histogram(
    "h2o3_rest_request_seconds",
    "REST request wall time by route pattern, method and status")


def _kernel_launches():
    from h2o3_tpu_torch.ops import hist_cuda as _hc
    return [({"kernel": k}, float(v)) for k, v in _hc.LAUNCHES.items()]


def _world_stat(table, what):
    from h2o3_tpu_torch.parallel import mrtask as _mr
    return float(getattr(_mr, table)[what])


# the card's work and the world's reductions of this process, read per
# host through `/metrics?scope=cluster` (a cloud of several ranks)
_obs_metrics.gauge(
    "h2o3_hist_kernel_launches",
    "hist.cu kernel launches by this process, by kernel (each wrapper "
    "counts where it launches; ops/hist_cuda.LAUNCHES)",
    fn=_kernel_launches)
# literal names, one call each, so that the metric census lists them
_obs_metrics.gauge(
    "h2o3_allreduce_bytes",
    "bytes of this rank's all-reduces over its world (parallel/mrtask)",
    fn=lambda: _world_stat("ALLREDUCE", "bytes"))
_obs_metrics.gauge(
    "h2o3_allreduce_seconds",
    "host seconds this rank spent in all-reduces over its world, waiting "
    "for the other ranks included",
    fn=lambda: _world_stat("ALLREDUCE", "seconds"))
_obs_metrics.gauge(
    "h2o3_allreduce_calls",
    "all-reduces this rank issued over its world",
    fn=lambda: _world_stat("ALLREDUCE", "calls"))
_obs_metrics.gauge(
    "h2o3_gather_bytes",
    "bytes of this rank's row gathers over its world (parallel/mrtask)",
    fn=lambda: _world_stat("GATHER", "bytes"))
_obs_metrics.gauge(
    "h2o3_gather_seconds",
    "host seconds this rank spent in row gathers over its world, waiting "
    "for the other ranks included",
    fn=lambda: _world_stat("GATHER", "seconds"))
_obs_metrics.gauge(
    "h2o3_gather_calls",
    "row gathers this rank issued over its world",
    fn=lambda: _world_stat("GATHER", "calls"))


def _frame_schema(f: Frame, with_summary=False) -> dict:
    d = {
        "frame_id": {"name": f.key},
        "rows": f.nrows, "column_count": f.ncols,
        "columns": [{"label": n, "type": v.type,
                     "missing_count": (v.na_cnt() if v.type != "str" else 0),
                     "domain": v.levels()}
                    for n, v in zip(f.names, f.vecs)],
    }
    if with_summary:
        d["summary"] = f.summary()
    return d


def _model_schema(m) -> dict:
    return m.to_dict()


# the unread body of an early answer (a 401, 429 or 504 before the params
# were read) is drained up to this many bytes, in chunks, each read waiting
# at most _DRAIN_WAIT_S; past either the connection is closed instead
_DRAIN_CAP = 1 << 20
_DRAIN_CHUNK = 1 << 16
_DRAIN_WAIT_S = 1.0


class _BodyReader:
    """A request's rfile that counts the body bytes handlers read."""

    def __init__(self, raw):
        self.raw = raw
        self.n = 0

    def read(self, size=-1):
        data = self.raw.read(size)
        self.n += len(data)
        return data


class _Handler(BaseHTTPRequestHandler):
    server_version = "h2o3-tpu-torch/0.1"

    def send_response(self, code, message=None):
        # remember the status for the request-latency histogram labels
        self._status = code
        super().send_response(code, message)

    def end_headers(self):
        # echo the request's trace id on EVERY response path (JSON,
        # errors, auth challenges, byte downloads) — the client-side
        # handle for GET /3/Trace/{id}
        tid = getattr(self, "_trace_id", None)
        if tid:
            self.send_header("X-H2O3-Trace-Id", tid)
        super().end_headers()

    # ---- security (water/H2OSecurityManager.java + webserver auth) ------
    def _check_auth(self):
        """HTTP Basic credentials checked against the configured
        authenticator (utils/auth: basic file, LDAP simple bind, custom
        LoginModule — the -basic_auth/-ldap_login surface).

        Returns the authenticated USER NAME (the QoS principal seed) on
        success, "" on an unauthenticated server (every caller lands in
        the stable `anonymous` principal — the QoS path never branches
        on auth mode), or None after answering 401. This runs BEFORE
        any QoS admission or queue accounting: an unauthenticated flood
        burns nothing but the 401 itself."""
        authn = getattr(self.server, "authenticator", None)
        if authn is None:
            return ""
        import base64
        hdr = self.headers.get("Authorization", "")
        if hdr.startswith("Basic "):
            try:
                got = base64.b64decode(hdr[6:]).decode()
            except Exception:
                got = ""
            user, _, pwd = got.partition(":")
            try:
                # a crafted pre-auth header must yield 401, never a
                # handler crash — custom LoginModules may raise
                if authn.authenticate(user, pwd):
                    return user
            except Exception:
                pass
        self.send_response(401)
        self.send_header("WWW-Authenticate",
                         'Basic realm="h2o3-tpu"')
        self.send_header("Content-Length", "0")
        self.end_headers()
        return None

    # ---- plumbing -------------------------------------------------------
    def _send(self, obj, code=200, extra_headers=None):
        if getattr(self, "_div_answer", False):
            _dvg.note_answer(obj)
        body = json.dumps(obj, default=_json_default).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        # per-request latency decomposition: close the stage recorder
        # against the route's wall clock (the remainder becomes `app`,
        # so the emitted stages always sum to the measured wall) and
        # hand the waterfall back as a standard Server-Timing header
        t0 = getattr(self, "_route_t0", None)
        timings = _usage.finish_request(
            _time_mod.perf_counter() - t0 if t0 is not None else None)
        if timings:
            self._timings = timings     # → rest.request span attrs
            self.send_header("Server-Timing",
                             _usage.server_timing(timings))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if getattr(self, "command", "") != "HEAD":   # RFC 9110: no body
            self.wfile.write(body)

    def _error(self, msg, code=400):
        self._send({"__meta": {"schema_type": "H2OError"},
                    "msg": str(msg), "http_status": code}, code)

    def _unavailable(self, qf):
        """503 + Retry-After for micro-batch queue-depth backpressure:
        well-behaved clients (and load balancers) back off instead of
        re-queueing onto a stalled accelerator."""
        self._send({"__meta": {"schema_type": "H2OError"},
                    "msg": str(qf), "http_status": 503}, 503,
                   extra_headers={"Retry-After":
                                  str(getattr(qf, "retry_after_s", 1))})

    def _rate_limited(self, ex):
        """429 + Retry-After: the CALLER is over its configured rate or
        quota (serving/qos token buckets / job quotas) — deliberately
        distinct from 503, where the server is out of capacity."""
        self._send({"__meta": {"schema_type": "H2OError"},
                    "msg": str(ex), "http_status": 429}, 429,
                   extra_headers={"Retry-After":
                                  str(getattr(ex, "retry_after_s", 1))})

    def _deadline_exceeded(self, ex):
        """504: the request's X-H2O3-Deadline-Ms budget elapsed before
        the work would have run — shed instead of computing an answer
        nobody is waiting for (counted in h2o3_qos_shed_total)."""
        self._send({"__meta": {"schema_type": "H2OError"},
                    "msg": str(ex), "http_status": 504}, 504)

    def _params(self) -> dict:
        cached = getattr(self, "_cached_params", None)
        if cached is not None:   # body already consumed by the broadcaster
            return dict(cached)
        parsed = urllib.parse.urlparse(self.path)
        q = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        ln = int(self.headers.get("Content-Length") or 0)
        if ln:
            # errors="replace": a stray binary body must yield a clean
            # 4xx from the route, not an escaping UnicodeDecodeError
            body = self.rfile.read(ln).decode(errors="replace")
            ctype = self.headers.get("Content-Type", "")
            if "json" in ctype:
                q.update(json.loads(body))
            else:
                q.update({k: v[0] for k, v in
                          urllib.parse.parse_qs(body).items()})
        return q

    def log_message(self, fmt, *args):
        pass  # quiet; Log module handles observability

    # ---- routing --------------------------------------------------------
    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")

    def do_HEAD(self):
        # HEAD mirrors GET headers with the body suppressed in _send;
        # paths with only a GET route still resolve
        path = urllib.parse.urlparse(self.path).path
        if any(m == "HEAD" and pat.fullmatch(path)
               for pat, m, fn in ROUTES):
            self._route("HEAD")
        else:
            self._route("GET")

    def _route(self, method):
        t0 = _time_mod.perf_counter()
        self._status = 0
        self._route_label = "unmatched"
        # latency decomposition: open the per-thread stage recorder (the
        # serving path feeds it; _send closes it into Server-Timing).
        # The route t0 anchors the `app` remainder computation.
        self._route_t0 = t0
        self._timings = None
        _usage.begin_request()
        # distributed tracing: honor the caller's X-H2O3-Trace-Id, mint
        # one otherwise; current for the whole dispatch so every span the
        # request opens (and every job/broadcast it starts) carries it
        tid = None
        if _tracing.enabled():
            tid = _tracing.sanitize(self.headers.get("X-H2O3-Trace-Id")) \
                or _tracing.new_trace_id()
        self._trace_id = tid
        prev_trace = _tracing.set_current(tid)
        # stall sentinel: a handler wedged past H2O3_WATCHDOG_STALL_S
        # (a collective-rendezvous deadlock under a dispatch, a replay
        # barrier that never acks) trips a pinned diagnostic trace with
        # a cluster JStack instead of hanging silently
        from h2o3_tpu_torch.analysis import sanitizers as _san
        from h2o3_tpu_torch.obs import watchdog as _wd
        body = self.rfile = _BodyReader(self.rfile)
        try:
            with _san.thread_scope(), \
                    _wd.watch("rest", desc=f"{method} {self.path}", trace=tid):
                self._route_traced(method, tid, prev_trace, t0)
        finally:
            # the body a handler left unread (a 401, 429 or 504 answered
            # before the params were read) is drained: closing a socket
            # with unread bytes resets the connection, and the client
            # sees the reset in place of the answer (the JAX server does)
            self.rfile = body.raw
            self._drain(body)
            # leaktrack sweep: the one instant every request-scoped pair
            # this thread opened MUST be closed again. It has to sit
            # OUTSIDE the watchdog watch — the watch is itself a tracked
            # scoped pair and is legitimately still open anywhere inside
            # the with block, so an inner sweep reports a false leak on
            # every request
            if _ltk.active():
                _ltk.sweep_request()

    def _drain(self, body):
        """Reads and drops the body bytes the handler left unread, at most
        _DRAIN_CAP of them and none slower than _DRAIN_WAIT_S a chunk, so
        that an unauthenticated client declaring a huge body, or trickling
        it, holds neither memory nor the thread. When the body is not
        drained whole, the connection closes after this request."""
        try:
            left = int(self.headers.get("Content-Length") or 0) - body.n
        except ValueError:
            self.close_connection = True
            return
        if left <= 0:
            return
        if left > _DRAIN_CAP:
            self.close_connection = True
            left = _DRAIN_CAP
        try:
            self.connection.settimeout(_DRAIN_WAIT_S)
            while left > 0:
                got = body.raw.read1(min(left, _DRAIN_CHUNK))
                if not got:
                    break
                left -= len(got)
            self.connection.settimeout(self.timeout)
        except OSError:
            left = 1
        if left > 0:
            self.close_connection = True

    def _route_traced(self, method, tid, prev_trace, t0):
        try:
            if tid is not None:
                with _span("rest.request", method=method) as sp:
                    # X-H2O3-Sample: 1 pins this trace through the flight
                    # recorder's tail sampler regardless of outcome — both
                    # via the root attr (read at trace completion) and via
                    # pin() at ENTRY, so a fragment finalized while the
                    # root is still open (linger expiry, span-count
                    # overflow) is retained too
                    if self.headers.get("X-H2O3-Sample") == "1":
                        sp.attrs["sampled"] = 1
                        from h2o3_tpu_torch.obs import recorder as _obs_rec
                        _obs_rec.RECORDER.pin(tid)
                    self._route_inner(method)
                    sp.attrs["route"] = self._route_label
                    sp.attrs["status"] = self._status or 0
                    # the response's Server-Timing breakdown rides the
                    # root span too, so a stored trace explains its
                    # own latency without the caller keeping the header
                    if getattr(self, "_timings", None):
                        sp.attrs["stages"] = {
                            k: round(v, 6)
                            for k, v in self._timings.items()}
            else:
                self._route_inner(method)
        finally:
            _usage.clear_request()   # 401s/handler crashes: no leak into
            _tracing.set_current(prev_trace)  # the next keep-alive request
            # the trace id rides the histogram as an OpenMetrics exemplar:
            # a Grafana latency spike clicks through to GET /3/Trace/{id}
            dt = _time_mod.perf_counter() - t0
            REQUEST_SECONDS.observe(
                dt, exemplar=tid,
                route=self._route_label, method=method,
                status=str(self._status or 0))
            # per-tenant SLI: scoring requests also land in the
            # principal-labeled histogram the per-tenant SLO specs
            # (obs/slo.py `principal` filter) burn against. Keyed on the
            # matched handler's @scores mark (stashed by _route_inner
            # before the entry-deadline shed, so edge 504s still count)
            # — one registration-site source of truth, not a parallel
            # path-prefix list that drifts when a scoring route is added.
            if getattr(self, "_principal", None) \
                    and getattr(self, "_scores_route", False):
                from h2o3_tpu_torch.serving import qos as _qos
                _qos.observe_request(
                    dt, exemplar=tid, principal=self._principal,
                    status=str(self._status or 0))

    def _route_inner(self, method):
        # ORDER MATTERS: authentication runs before any QoS admission or
        # queue accounting, so an unauthenticated flood is rejected at
        # 401 without consuming queue depth, tokens or principal state.
        edge_t0 = _time_mod.perf_counter()
        user = self._check_auth()
        if user is None:
            self._route_label = "auth"
            return
        from h2o3_tpu_torch.serving import qos as _qos
        # multi-tenant QoS context: the principal (authenticated user,
        # else the stable `anonymous` bucket) and the caller's optional
        # deadline budget ride the obs TLS alongside the trace id —
        # admission, the micro-batcher and Job quotas all read them
        # from there
        principal = _qos.resolve_principal(user)
        self._principal = principal
        deadline = None
        hdr = self.headers.get("X-H2O3-Deadline-Ms")
        if hdr:
            try:
                ms = float(hdr)
            except ValueError:
                ms = None       # a junk header is "no deadline", not 400
            if ms is not None:
                deadline = _time_mod.monotonic() + ms / 1e3
        # one route match per request: the edge QoS marks, the
        # route label and the dispatch below all reuse this result
        path = urllib.parse.urlparse(self.path).path
        self._req_path = path
        pat, fn, groups = _match_route(method, path)
        # the per-tenant SLI emit in _route's finally keys on this:
        # matched BEFORE the entry shed, so an edge 504 still counts
        self._scores_route = fn is not None and \
            getattr(fn, "_scores", False)
        with _tracing.request_context(principal, deadline):
            try:
                # leaktrack (raise mode): a token that died unreleased
                # since the last dispatch fails THIS request — loud and
                # attributable, where the GC-thread finalizer is neither
                if _ltk.active():
                    _ltk.raise_if_pending()
                # a budget that arrived already spent is shed at the
                # edge — before params parse or handler work
                if _qos.enabled():
                    _qos.check_deadline("entry")
                    # rejections before any handler work (the JAX
                    # server's pre-broadcast charge). Job-starting
                    # handlers (marked @starts_job) charge the
                    # concurrent-job quota here; scoring handlers
                    # (marked @scores) pay deadline + token admission
                    # here (the in-pipeline admit() sees the TLS flag
                    # and skips the double charge).
                    if method != "GET" and fn is not None:
                        if getattr(fn, "_starts_job", False):
                            _qos.prepay_job_slot()
                        if getattr(fn, "_scores", False):
                            _qos.edge_admit()
                # everything up to here — auth, principal resolve, route
                # match, deadline parse, edge QoS admission —
                # is the request's edge-admission stage
                _usage.add_stage(
                    "edge", _time_mod.perf_counter() - edge_t0)
                self._dispatch_routed(method, path, pat, fn, groups)
            except _qos.RateLimited as ex:
                self._rate_limited(ex)
            except _qos.QuotaExceeded as ex:
                self._rate_limited(ex)
            except _qos.DeadlineExceeded as ex:
                self._deadline_exceeded(ex)
            finally:
                # clear the edge-admission flag and return a prepaid
                # charge no Job adopted (the handler 4xx'd first); the
                # leaktrack sweep runs further out, in _route, once the
                # watchdog watch (itself a tracked pair) has closed
                _qos.end_request()

    def _dispatch_routed(self, method, path, pat, fn, groups):
        # SPMD replay (deploy/multihost): requests broadcast to every
        # worker BEFORE local dispatch so all ranks issue the same
        # collectives (a lone rank in a collective would wedge). GETs are
        # included: a frame read may gather over the world. The broadcast
        # and the handler run under the collective guard's dispatch order,
        # so the handlers of the ranks take their collective tickets in
        # sequence order (parallel/compat.py); a `stateless` handler
        # (payload scoring: no collective) runs after the broadcast,
        # outside it, so that concurrent scoring requests batch together.
        bc = getattr(self.server, "broadcaster", None)
        replayed = bc is not None and not _is_static_path(path) \
            and not _is_obs_path(path) \
            and not path.startswith("/3/PostFile") \
            and not path.startswith("/3/ParseDistributed")
        free = replayed and getattr(fn, "_stateless", False)
        order = _compat.dispatch_order() if replayed \
            else contextlib.nullcontext()
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(order)
                if replayed:
                    # PostFile is excluded: its body is raw (often binary)
                    # bytes that neither parse as params nor replay through
                    # the channel. ParseDistributed is excluded because the
                    # workers participate through the parse fan-out collect
                    # ops instead. Inside the try: a wedged replay channel
                    # must answer a 500 H2OError, not drop the connection.
                    params = self._params()
                    self._cached_params = params
                    # the trace id rides the replay channel so every worker
                    # tags its replayed spans with the ORIGINATING
                    # request's trace
                    seq = bc.broadcast(method, path, params,
                                       trace=getattr(self, "_trace_id",
                                                     None),
                                       sampled=self.headers.get(
                                           "X-H2O3-Sample") == "1",
                                       log=not getattr(fn, "_stateless",
                                                       False))
                else:
                    seq = None
                if free:
                    stack.close()           # the dispatch order's lock
                    stack.enter_context(_compat.collective_free())
                if fn is not None:
                    self._route_label = pat.pattern
                    if seq is not None and _dvg.active():
                        # surface any mismatch a prior request's ack riders
                        # proved, then digest this handler's mutations (and
                        # a scoring route's answer) under the broadcast seq
                        _dvg.raise_if_pending()
                        _dvg.local_begin(seq, path)
                        self._div_answer = bool(getattr(fn, "_scores",
                                                        False))
                        try:
                            fn(self, *groups)
                        finally:
                            self._div_answer = False
                            _dvg.local_end()
                    else:
                        fn(self, *groups)
                    return
            self._error(f"no route {method} {path}", 404)
        except Exception as ex:  # noqa: BLE001 — handler errors → H2OError
            # QoS rejections raised inside handlers (rate limit at
            # admission, job quota at Job.start, deadline shed) are not
            # handler errors: let _route_inner map them to 429/504
            from h2o3_tpu_torch.serving import qos as _qos
            if isinstance(ex, (_qos.RateLimited, _qos.QuotaExceeded,
                               _qos.DeadlineExceeded)):
                raise
            self._error(repr(ex), 500)


def starts_job(fn):
    """Marks a handler that starts a background Job. The REST layer
    prepays the concurrent-job quota for marked handlers at the edge,
    before the handler runs (qos.prepay_job_slot) — a registration-site
    flag, so new job routes can't silently miss the charge the way a
    hand-kept path list would."""
    fn._starts_job = True
    return fn


def scores(fn):
    """Marks a scoring handler. The REST layer runs QoS admission
    (deadline shed + token charge) for marked handlers at the edge,
    before the handler runs (qos.edge_admit)."""
    fn._scores = True
    return fn


def stateless(fn):
    """Marks a handler that changes no replicated state (payload scoring):
    an elastic broadcaster keeps it out of the join-sync snapshot, which
    a replacement worker replays to converge."""
    fn._stateless = True
    return fn


def _match_route(method: str, path: str):
    """One ROUTES scan per request: (pattern, handler, match groups) for
    (method, path), or (None, None, None). The edge QoS marks
    (`_starts_job` / `_scores`), the route label and the dispatch all
    reuse this single result."""
    for pat, m, fn in ROUTES:
        if m != method:
            continue
        mm = pat.fullmatch(path)
        if mm:
            return pat, fn, mm.groups()
    return None, None, None


def _is_static_path(path: str) -> bool:
    """Static Flow-UI assets never touch device tensors — broadcasting
    them would serialize page loads behind the cluster replay barrier."""
    return path == "/" or path.startswith("/flow")


def _is_obs_path(path: str) -> bool:
    """Observability endpoints launch no device programs (registry reads +
    memory_stats are host-local), and /3/Timeline, /3/Trace and
    cluster-scope /metrics do their own explicit cloud-wide collects —
    replaying them would put every Prometheus scrape behind the replay
    barrier. /3/Profiler is deliberately host-local too: a capture
    profiles THIS node, and the profiler is process-global state the
    replay barrier must not serialize behind."""
    return path in ("/metrics", "/3/Timeline", "/3/WaterMeter",
                    "/3/Profiler", "/3/Traces", "/3/Alerts",
                    "/3/JStack", "/3/Usage", "/3/CloudHealth") \
        or path.startswith("/3/Logs") or path.startswith("/3/Trace/") \
        or path.startswith("/3/Cloud/") \
        or path.startswith("/3/ModelMonitor/")


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


# ---------------------------------------------------------------------------
# handlers
def _h_cloud(h: _Handler):
    """GET /3/Cloud — device census plus the elastic-membership view:
    the cloud EPOCH, per-worker states, and the DKV re-home status.
    `locked` is the reference's Paxos.lockCloud flag — false whenever an
    elastic broadcaster can still admit joiners."""
    from h2o3_tpu_torch.core.kvstore import DKV as _dkv
    from h2o3_tpu_torch.deploy.membership import MEMBERSHIP as _mb
    info = h2o3_tpu_torch.cluster_info()
    # getattr chain: worker-side replays dispatch through _ReplayHandler,
    # which carries no HTTP server object
    bc = getattr(getattr(h, "server", None), "broadcaster", None)
    elastic = bc is not None and hasattr(bc, "drain")
    workers = _mb.nodes()
    # healthy = no UNRESOLVED death: a worker dead at the CURRENT epoch
    # is a live incident; once a later membership change (replacement
    # join, drain) moves the epoch past it, the death is history and the
    # cloud reports healthy again
    healthy = not any(w["state"] == "dead" and w["epoch"] == _mb.epoch
                      for w in workers)
    h._send({"__meta": {"schema_type": "CloudV3"},
             "cloud_name": info["cloud_name"],
             "cloud_size": info["cloud_size"],
             "cloud_healthy": healthy,
             "consensus": True, "locked": not elastic,
             "epoch": _mb.epoch,
             "workers": workers,
             "rehome": _dkv.rehome_status(),
             "version": h2o3_tpu_torch.__version__,
             "nodes": [{"h2o": d, "healthy": True}
                       for d in info["devices"]]})


# h2o3-ok: R018 coordinator-owned membership control surface
def _h_cloud_drain(h: _Handler):
    """POST /3/Cloud/drain?node=N — graceful worker departure: finish
    in-flight jobs and micro-batches (bounded by H2O3_DRAIN_TIMEOUT_S),
    send the worker a clean leave, bump the epoch. Coordinator-control
    only: never broadcast (workers hold no broadcaster)."""
    bc = getattr(h.server, "broadcaster", None)
    if bc is None or not hasattr(bc, "drain"):
        return h._error("drain requires an elastic multi-host cloud", 400)
    p = h._params()
    try:
        node = int(p.get("node", ""))
    except ValueError:
        return h._error("node must be a worker id", 400)
    try:
        out = bc.drain(node)
    except ValueError as ex:
        return h._error(str(ex), 404)
    h._send({"__meta": {"schema_type": "CloudDrainV3"}, **out})


def _h_import(h: _Handler):
    p = h._params()
    path = p.get("path")
    h._send({"__meta": {"schema_type": "ImportFilesV3"},
             "files": [path], "destination_frames": [path], "fails": []})


def _h_parse_setup(h: _Handler):
    p = h._params()
    src = p.get("source_frames")
    if isinstance(src, str):
        src = json.loads(src) if src.startswith("[") else [src]
    path = src[0].strip('"')
    # PostFile-staged uploads: the h2o-py upload flow calls ParseSetup on
    # the pseudo-key returned by /3/PostFile before /3/Parse
    from h2o3_tpu_torch.api import routes_ext3 as _up
    staged = _up.staged_upload_path(path)
    probe = staged or path
    s = io_parser.parse_setup(probe)
    h._send({"__meta": {"schema_type": "ParseSetupV3"},
             "source_frames": src,
             "separator": ord(s.separator), "check_header": 1 if s.header else -1,
             "column_names": s.column_names, "column_types": s.column_types,
             "parse_type": s.parse_type,
             "destination_frame": path.split("/")[-1] + ".hex"})


def _canon_col_types(ct: dict) -> dict:
    """Map ParseV3 type names (Vec.java TYPE_STR values) to internal codes."""
    alias = {"numeric": "num", "real": "num", "int": "num", "float": "num",
             "enum": "enum", "categorical": "enum", "factor": "enum",
             "string": "str", "str": "str", "time": "time",
             "uuid": "uuid", "num": "num"}
    return {k: alias.get(str(v).lower(), v) for k, v in ct.items()}


@starts_job
def _h_parse(h: _Handler):
    p = h._params()
    src = p.get("source_frames")
    if isinstance(src, str):
        src = json.loads(src) if src.startswith("[") else [src]
    path = src[0].strip('"')
    # PostFile-staged uploads resolve their pseudo-key to the temp file,
    # consumed (deleted) once the parse finishes
    from h2o3_tpu_torch.api import routes_ext3 as _up
    upload_key = None
    staged = _up.staged_upload_path(path)
    if staged:
        upload_key, path = path, staged
    dest = p.get("destination_frame") or None
    # ParseV3 column_types: either a dict {name: type} or the reference's
    # list aligned with ParseSetup's column order
    ctypes = p.get("column_types")
    if isinstance(ctypes, str) and ctypes:
        ctypes = json.loads(ctypes)
    if isinstance(ctypes, list):
        names = p.get("column_names")
        if isinstance(names, str) and names:
            names = json.loads(names)
        if not names:
            names = io_parser.parse_setup(path).column_names
        ctypes = {n: t for n, t in zip(names, ctypes) if t}
    ctypes = _canon_col_types(ctypes) if ctypes else None
    job = Job(description=f"Parse {path}", dest=dest or "parsed")

    def work(job):
        try:
            f = io_parser.import_file(path, destination_frame=dest,
                                      col_types=ctypes)
        finally:
            if upload_key is not None:
                _up.consume_upload(upload_key)
        job.dest = f.key
        return f

    job.start(work)
    h._send({"__meta": {"schema_type": "ParseV3"},
             "job": job.to_dict(), "destination_frame": {"name": dest}})


@starts_job
# the job record is coordinator-owned control state (a local job key, so
# the replicated key counter stays in step); the FRAME planes workers
# produce ship back over the parse: fan-out and land under the
# coordinator's dest key, not via replay
# h2o3-ok: R018 coordinator-owned job record; frames ship via fan-out
def _h_parse_distributed(h: _Handler):
    """POST /3/ParseDistributed — the cloud-wide chunked parse: the
    coordinator plans byte ranges and fans shares out over the replay
    channel (io/dparse `parse:` collect op); each host tokenizes its
    consistent-hash share and ships codec-byte planes back. NOT
    broadcast-replayed (see _dispatch_routed): the workers participate
    through the fan-out, so replaying the request would have every host
    also parse the whole file. On a single-host cloud this is simply
    the local pipelined parse.

    Topology contract: the merged frame lives in the COORDINATOR's DKV,
    whole — frames destined for training over the world go through the
    broadcast-replayed /3/Parse or /3/Frames/load instead (every rank
    holds its own row block)."""
    p = h._params()
    src = p.get("source_frames")
    if isinstance(src, str):
        src = json.loads(src) if src.startswith("[") else [src]
    paths = [s.strip('"') for s in src]
    dest = p.get("destination_frame") or None
    bc = getattr(h.server, "broadcaster", None)
    job = Job(description=f"ParseDistributed {paths[0]}",
              dest=dest or "parsed", local=bc is not None)

    def work(job):
        from h2o3_tpu_torch.io import dparse
        f = dparse.parse_files(paths, destination_frame=dest,
                               broadcaster=bc)
        job.dest = f.key
        return f

    job.start(work, collective=False)
    h._send({"__meta": {"schema_type": "ParseV3"},
             "job": job.to_dict(), "destination_frame": {"name": dest}})


def _h_frames(h: _Handler):
    frames = [DKV.get(k) for k in DKV.keys()]
    frames = [f for f in frames if isinstance(f, Frame)]
    h._send({"__meta": {"schema_type": "FramesV3"},
             "frames": [_frame_schema(f) for f in frames]})


def _h_frame(h: _Handler, fid):
    f = DKV.get(fid)
    if not isinstance(f, Frame):
        return h._error(f"frame {fid} not found", 404)
    h._send({"__meta": {"schema_type": "FramesV3"},
             "frames": [_frame_schema(f, with_summary=True)]})


def _h_frame_delete(h: _Handler, fid):
    DKV.remove(fid)
    h._send({"__meta": {"schema_type": "FramesV3"}})


def _h_model_builders(h: _Handler):
    from h2o3_tpu_torch.models import ESTIMATORS
    h._send({"__meta": {"schema_type": "ModelBuildersV3"},
             "model_builders": {k: {"algo": k, "visibility": "Stable"}
                                for k in ESTIMATORS}})


@starts_job
def _h_build_model(h: _Handler, algo):
    from h2o3_tpu_torch.models import ESTIMATORS
    cls = ESTIMATORS.get(algo)
    if cls is None:
        return h._error(f"unknown algo {algo}", 404)
    p = h._params()
    tf = DKV.get(p.pop("training_frame", None))
    vf = DKV.get(p.pop("validation_frame", None)) if p.get(
        "validation_frame") else None
    y = p.pop("response_column", None)
    x = p.pop("x", None)
    if isinstance(x, str):
        x = json.loads(x)
    p.pop("_rest_version", None)
    params = {}
    for k, v in p.items():
        if k in cls._COMMON or k in cls._defaults:
            params[k] = _coerce_param(v)
    est = cls(**params)
    job = Job(description=f"{algo} model build",
              dest=params.get("model_id") or DKV.make_key(algo))

    def work(job):
        est.train(x=x, y=y, training_frame=tf, validation_frame=vf)
        job.dest = est.key
        return est

    job.start(work)
    h._send({"__meta": {"schema_type": "ModelBuilderJobV3"},
             "job": job.to_dict()})


def _coerce_param(v):
    if isinstance(v, str):
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        if v.startswith("["):
            return json.loads(v)
        try:
            fv = float(v)
            return int(fv) if fv.is_integer() and "." not in v else fv
        except ValueError:
            return v
    return v


def _h_models(h: _Handler):
    from h2o3_tpu_torch.models.model import ModelBase
    ms = [DKV.get(k) for k in DKV.keys()]
    ms = [m for m in ms if isinstance(m, ModelBase)]
    h._send({"__meta": {"schema_type": "ModelsV3"},
             "models": [_model_schema(m) for m in ms]})


def _h_model(h: _Handler, mid):
    m = DKV.get(mid)
    if m is None:
        return h._error(f"model {mid} not found", 404)
    h._send({"__meta": {"schema_type": "ModelsV3"},
             "models": [_model_schema(m)]})


def _h_model_delete(h: _Handler, mid):
    DKV.remove(mid)
    # drop the serving cache's compiled programs so their closures stop
    # pinning the deleted model (and its device arrays)
    from h2o3_tpu_torch import serving
    serving.CACHE.invalidate_key(mid)
    h._send({"__meta": {"schema_type": "ModelsV3"}})


@scores
def _h_predict(h: _Handler, mid, fid):
    m = DKV.get(mid)
    f = DKV.get(fid)
    if m is None or f is None:
        return h._error("model or frame not found", 404)
    p = h._params()
    dest = p.get("predictions_frame")
    # micro-batched serving fast path: concurrent predictions against the
    # same model coalesce into one padded device dispatch per bucket
    from h2o3_tpu_torch import serving
    try:
        pred = serving.predict_via_rest(m, f)
    except serving.QueueFull as qf:
        return h._unavailable(qf)
    # each rank of a cloud scores its own rows of the frame
    pred.shard = f.shard
    if dest:
        DKV.remove(pred.key)
        pred.key = dest
        DKV.put(dest, pred)
    # metrics alongside the predictions when the frame carries the response
    # (hex/Model.java:2077 BigScore + ModelMetricsHandler). Metric errors
    # surface in the response rather than being swallowed.
    mm_json = []
    resp = (m._dinfo.response_name if getattr(m, "_dinfo", None) else None)
    if resp and resp in f.names:
        try:
            perf = m.model_performance(f)
            if perf is not None and hasattr(perf, "to_dict"):
                mm_json = [dict(perf.to_dict(),
                                frame={"name": f.key},
                                model={"name": m.key})]
        except Exception as ex:      # noqa: BLE001
            mm_json = [{"error": repr(ex)}]
    h._send({"__meta": {"schema_type": "ModelMetricsListSchemaV3"},
             "predictions_frame": {"name": pred.key},
             "model_metrics": mm_json})


@scores
@stateless
def _h_predict_rows(h: _Handler, mid):
    """POST /3/Predictions/models/{m} — lightweight row-payload scoring:
    JSON rows in, per-row predictions out, no DKV frame round-trip.
    Body: {"rows": [[..] | {col: val}, ...], "columns": [names]?}.
    Rides the micro-batch queue, so concurrent callers share one padded
    device dispatch per bucket."""
    m = DKV.get(mid)
    if m is None or getattr(m, "_dinfo", None) is None:
        return h._error(f"model {mid} not found", 404)
    p = h._params()
    rows = p.get("rows")
    if isinstance(rows, str):
        rows = json.loads(rows) if rows else []
    if not isinstance(rows, list):
        return h._error("rows must be a JSON list", 400)
    cols = p.get("columns")
    if isinstance(cols, str) and cols:
        cols = json.loads(cols)
    from h2o3_tpu_torch import serving
    try:
        preds = serving.score_payload(m, rows, cols)
    except serving.QueueFull as qf:
        return h._unavailable(qf)
    h._send({"__meta": {"schema_type": "PredictionsRowsV3"},
             "model": {"name": mid}, "predictions": preds,
             "row_count": len(preds)})


def _h_jobs(h: _Handler):
    h._send({"__meta": {"schema_type": "JobsV3"}, "jobs": jobs_list()})


def _h_job(h: _Handler, jid):
    j = DKV.get(jid)
    if not isinstance(j, Job):
        return h._error(f"job {jid} not found", 404)
    h._send({"__meta": {"schema_type": "JobsV3"}, "jobs": [j.to_dict()]})


_sessions: dict = {}


def _h_rapids(h: _Handler):
    p = h._params()
    ast = p.get("ast")
    sid = p.get("session_id", "default")
    sess = _sessions.setdefault(sid, Session(sid))
    val = rapids_exec(ast, sess)
    if isinstance(val, Frame):
        h._send({"__meta": {"schema_type": "RapidsFrameV3"},
                 "key": {"name": val.key}, "num_rows": val.nrows,
                 "num_cols": val.ncols})
    elif isinstance(val, (int, float)):
        h._send({"__meta": {"schema_type": "RapidsNumberV3"},
                 "scalar": val})
    elif isinstance(val, list):
        h._send({"__meta": {"schema_type": "RapidsStringsV3"},
                 "string": [str(s) for s in val]})
    else:
        h._send({"__meta": {"schema_type": "RapidsStringV3"},
                 "string": str(val)})


def _h_init_session(h: _Handler):
    sid = DKV.make_key("session")
    _sessions[sid] = Session(sid)
    h._send({"__meta": {"schema_type": "InitIDV3"}, "session_key": sid})


def _h_end_session(h: _Handler):
    p = h._params()
    sid = p.get("session_id", "default")
    s = _sessions.pop(sid, None)
    if s:
        s.end()
    h._send({"__meta": {"schema_type": "InitIDV3"}, "session_key": sid})


def _h_shutdown(h: _Handler):
    h._send({"__meta": {"schema_type": "ShutdownV3"}})
    threading.Thread(target=h.server.shutdown, daemon=True).start()


def _h_about(h: _Handler):
    # "torch/cuda" on the card, where the JAX server says "jax/tpu", and
    # the device's name
    backend = f"torch/{h2o3_tpu_torch.cloud().device.type}"
    h._send({"__meta": {"schema_type": "AboutV3"},
             "entries": [{"name": "Build version",
                          "value": h2o3_tpu_torch.__version__},
                         {"name": "Backend", "value": backend},
                         {"name": "Device", "value":
                          h2o3_tpu_torch.cluster_info()["devices"][0]}]})


def _h_model_metrics(h: _Handler, mid, fid=None):
    """/3/ModelMetrics/models/{m}[/frames/{f}] — ModelMetricsHandler."""
    m = DKV.get(mid)
    if m is None:
        return h._error("model not found", 404)
    if fid is not None:
        f = DKV.get(fid)
        if f is None:
            return h._error("frame not found", 404)
        perf = m.model_performance(f)
    else:
        perf = m.model_performance()
    mm = [dict(perf.to_dict(), model={"name": mid})] \
        if perf is not None and hasattr(perf, "to_dict") else []
    h._send({"__meta": {"schema_type": "ModelMetricsListSchemaV3"},
             "model_metrics": mm})


def _h_grids(h: _Handler):
    grids = [k for k in DKV.keys()
             if getattr(DKV.get(k), "grid_id", None) == k]
    h._send({"__meta": {"schema_type": "GridsV99"},
             "grids": [{"grid_id": {"name": g}} for g in grids]})


def _h_grid(h: _Handler, gid):
    g = DKV.get(gid)
    if g is None or not hasattr(g, "models"):
        return h._error("grid not found", 404)
    h._send({"__meta": {"schema_type": "GridSchemaV99"},
             "grid_id": {"name": gid},
             "model_ids": [{"name": m.key} for m in g.models],
             "hyper_names": list(getattr(g, "hyper_params", {}).keys())})


@starts_job
def _h_automl_build(h: _Handler):
    """POST /99/AutoMLBuilder — AutoMLBuilderHandler analog."""
    from h2o3_tpu_torch.automl.automl import H2OAutoML
    p = h._params()
    spec = p.get("build_control", {})
    if isinstance(spec, str):
        spec = json.loads(spec)
    inp = p.get("input_spec", {})
    if isinstance(inp, str):
        inp = json.loads(inp)
    stop = spec.get("stopping_criteria", {})

    def _get_tf(d):
        v = d.get("training_frame", "")
        return v.get("name") if isinstance(v, dict) else v

    train = DKV.get(p.get("training_frame") or _get_tf(inp) or "")
    if train is None:
        return h._error("training_frame not found", 404)
    y = p.get("response_column") or inp.get("response_column")
    if isinstance(y, dict):
        y = y.get("column_name")
    aml = H2OAutoML(
        max_models=int(p.get("max_models") or stop.get("max_models") or 5),
        seed=int(p.get("seed") or stop.get("seed") or 42),
        project_name=p.get("project_name") or spec.get("project_name"))
    from h2o3_tpu_torch.core.jobs import Job
    job = Job(description="AutoML build", dest=aml.project_name)
    job.start(lambda j: aml.train(y=y, training_frame=train))
    job.join()
    h._send({"__meta": {"schema_type": "AutoMLBuilderV99"},
             "job": {"key": {"name": job.key}},
             "automl_id": {"name": aml.project_name}})


def _h_automl(h: _Handler, pid):
    aml = DKV.get(pid)
    if aml is None or not hasattr(aml, "leaderboard_obj"):
        return h._error("automl not found", 404)
    lb = aml.leaderboard_obj
    rows = lb.rows if lb is not None and hasattr(lb, "rows") else []
    h._send({"__meta": {"schema_type": "AutoMLV99"},
             "automl_id": {"name": pid},
             "leaderboard_table": {"rows": rows},
             "leader": rows[0] if rows else None})


def _h_logs_download(h: _Handler):
    """GET /3/Logs/download — the legacy one-shot dump: this host's
    recent formatted log lines (water/util/GetLogsFromNode analog)."""
    from h2o3_tpu_torch.utils import log as _log
    h._send({"__meta": {"schema_type": "LogsV3"},
             "log": "\n".join(_log.recent(500))})


def _h_logs_search(h: _Handler):
    """GET /3/Logs?level=&since=&trace=&grep=&limit= — structured log
    search over ring + durable segments, CLUSTER-scoped: the same
    filters fan out to every worker over the `logs:` collect op and the
    records merge time-sorted (newest first) with host labels already on
    each record. A lagging host is flagged, never waited on."""
    import json as _json
    from h2o3_tpu_torch.obs import timeline as _obs_tl
    from h2o3_tpu_torch.utils import log as _log
    p = h._params()
    try:
        since = float(p["since"]) if p.get("since") else None
        limit = int(p.get("limit") or 200)
    except ValueError:
        return h._error("since/limit must be numeric", 400)
    filters = {"level": p.get("level") or None, "since": since,
               "trace": p.get("trace") or None,
               "grep": p.get("grep") or None, "limit": limit}
    recs = _log.search(**filters)
    hosts = [{"host": _obs_tl.host_id(), "n_records": len(recs),
              "files": [f["name"] for f in _log.list_files()]}]
    bc = getattr(h.server, "broadcaster", None)
    if bc is not None and str(p.get("scope", "")).lower() != "local":
        op = "logs:search:" + _json.dumps(filters)
        seen = {(r.get("host"), r.get("id")) for r in recs}
        for i, remote in enumerate(bc.collect(op,
                                              timeout=_collect_timeout())):
            if isinstance(remote, dict):
                rr = [r for r in remote.get("records", [])
                      if (r.get("host"), r.get("id")) not in seen]
                seen.update((r.get("host"), r.get("id")) for r in rr)
                recs.extend(rr)
                hosts.append({"host": remote.get("host", i + 1),
                              "n_records": len(rr),
                              "files": remote.get("files", [])})
            else:
                hosts.append({"host": i + 1, "n_records": None,
                              "lagging": True})
    recs.sort(key=lambda r: r.get("t") or 0.0, reverse=True)
    h._send({"__meta": {"schema_type": "LogsV3"},
             "records": recs[:limit], "n_records": min(len(recs), limit),
             "hosts": hosts})


def _h_logs_node_file(h: _Handler, node, name):
    """GET /3/Logs/nodes/{node}/files/{name} — the named NODE's durable
    log file content (GetLogsFromNode routed over the replay channel),
    not the coordinator's ring. `node` is a host rank or "self"; `name`
    a file basename from GET /3/Logs hosts[].files, or "default" for
    the node's newest file."""
    from h2o3_tpu_torch.obs import timeline as _obs_tl
    from h2o3_tpu_torch.utils import log as _log
    local = _obs_tl.host_id()
    if node in ("self", "-1", str(local)):
        content = _log.read_file(name)
        if content is None:
            return h._error(f"log file {name!r} not found on node "
                            f"{local}", 404)
        return h._send({"__meta": {"schema_type": "LogsV3"},
                        "node": local, "name": name, "log": content})
    bc = getattr(h.server, "broadcaster", None)
    if bc is None:
        return h._error(f"unknown node {node!r} (single-host cloud)", 404)
    for remote in bc.collect(f"logs:file:{node}:{name}",
                             timeout=_collect_timeout()):
        if isinstance(remote, dict) and remote.get("log") is not None:
            return h._send({"__meta": {"schema_type": "LogsV3"},
                            "node": remote.get("host"),
                            "name": remote.get("name", name),
                            "log": remote["log"]})
    return h._error(f"log file {name!r} not found on node {node!r} "
                    "(host absent, lagging, or no such file)", 404)


def _h_jstack(h: _Handler):
    """GET /3/JStack — all-thread stack dumps per node with a cluster
    merge (water/api/JStackHandler analog): this host's threads plus
    every worker's over the `jstack` collect op, and the watchdog's
    currently-stalled operations so a live hang is visible in the same
    response that shows the threads stuck in it."""
    from h2o3_tpu_torch.obs import timeline as _obs_tl
    from h2o3_tpu_torch.obs import watchdog as _wd
    traces = [{"node": f"h2o3-{_obs_tl.host_id()}",
               "host": _obs_tl.host_id(),
               "thread_traces": _wd.thread_dump()}]
    lagging = []
    bc = getattr(h.server, "broadcaster", None)
    if bc is not None:
        for i, remote in enumerate(bc.collect("jstack",
                                              timeout=_collect_timeout())):
            if isinstance(remote, dict):
                traces.append({"node": f"h2o3-{remote.get('host', i + 1)}",
                               "host": remote.get("host", i + 1),
                               "thread_traces": remote.get("threads", [])})
            else:
                lagging.append(i + 1)
    h._send({"__meta": {"schema_type": "JStackV3"},
             "traces": traces, "lagging_hosts": lagging,
             "stalled": _wd.WATCHDOG.stalled(),
             "trips": _wd.WATCHDOG.trips()})


def _collect_timeout() -> float:
    """Per-host deadline for cluster-wide observability collects
    (timeline/trace/metrics). The discipline: every wait the
    coordinator performs while holding the broadcast lock is bounded —
    a stalled worker costs one deadline, never a frozen scrape."""
    return _env.env_float("H2O3_OBS_COLLECT_TIMEOUT_S", 2.0)


def _h_timeline(h: _Handler):
    """GET /3/Timeline — the TimelineSnapshot analog: this host's span
    ring plus every worker's, collected through the multihost replay
    channel so the response covers the whole cloud."""
    import time as _time
    from h2o3_tpu_torch.obs import timeline as _obs_tl
    spans = _obs_tl.SPANS.snapshot(limit=512)
    hosts = [{"host": _obs_tl.host_id(), "n_spans": len(spans)}]
    bc = getattr(h.server, "broadcaster", None)
    if bc is not None:
        # one flat merged list; hosts[] summarizes who answered (a None
        # entry is a worker that outwaited the collect timeout)
        for i, remote in enumerate(bc.collect("timeline",
                                              timeout=_collect_timeout())):
            if isinstance(remote, dict):
                rs = remote.get("spans", [])
                spans.extend(rs)
                hosts.append({"host": remote.get("host", i + 1),
                              "n_spans": len(rs)})
            else:
                hosts.append({"host": i + 1, "n_spans": None,
                              "lagging": True})
        spans.sort(key=lambda s: s.get("start") or 0.0)
    # legacy dispatch-event ring (utils/timeline) rides along
    from h2o3_tpu_torch.utils.timeline import TIMELINE
    try:
        events = TIMELINE.snapshot()
    except Exception:
        events = []
    h._send({"__meta": {"schema_type": "TimelineV3"},
             "now": _time.time(), "spans": spans, "hosts": hosts,
             "events": events[-512:]})


def _h_trace(h: _Handler, tid):
    """GET /3/Trace/{id} — the Dapper-style stitched view of one request,
    read through ring → disk → cluster: this host's timeline ring, then
    the flight recorder's durable segments (so a trace evicted from the
    ring — or recorded by a PREVIOUS process over the same ice_root — is
    still answerable), then every worker's fragments over the replay
    channel. Correlated structured LOG records (utils/log, matched by
    trace id cluster-wide) interleave into the view as a time-sorted
    `logs` array. Bounded by the same collect deadline as /3/Timeline."""
    from h2o3_tpu_torch.obs import recorder as _obs_rec
    from h2o3_tpu_torch.obs import timeline as _obs_tl
    from h2o3_tpu_torch.utils import log as _log
    spans, disk = _obs_rec.RECORDER.read_through(
        tid, _obs_tl.SPANS.trace_snapshot(tid))
    seen = {(s.get("host"), s.get("id")) for s in spans}
    logs = _log.trace_records(tid)
    seen_logs = {(r.get("host"), r.get("id")) for r in logs}
    hosts = [{"host": _obs_tl.host_id(), "n_spans": len(spans),
              "from_disk": disk}]
    bc = getattr(h.server, "broadcaster", None)
    if bc is not None:
        for i, remote in enumerate(bc.collect(f"trace:{tid}",
                                              timeout=_collect_timeout())):
            if isinstance(remote, dict):
                # dedup against what the shared-ice_root disk read already
                # loaded: a worker's collect reply re-reads the same
                # segments its own recorder wrote
                rs = [s for s in remote.get("spans", [])
                      if (s.get("host"), s.get("id")) not in seen]
                seen.update((s.get("host"), s.get("id")) for s in rs)
                spans.extend(rs)
                rl = [r for r in remote.get("logs", [])
                      if (r.get("host"), r.get("id")) not in seen_logs]
                seen_logs.update((r.get("host"), r.get("id")) for r in rl)
                logs.extend(rl)
                hosts.append({"host": remote.get("host", i + 1),
                              "n_spans": len(rs)})
            else:
                hosts.append({"host": i + 1, "n_spans": None,
                              "lagging": True})
    spans.sort(key=lambda s: s.get("start") or 0.0)
    logs.sort(key=lambda r: r.get("t") or 0.0)
    h._send({"__meta": {"schema_type": "TraceV3"},
             "trace_id": tid, "spans": spans, "hosts": hosts,
             "n_spans": len(spans), "logs": logs, "n_logs": len(logs)})


def _h_traces(h: _Handler):
    """GET /3/Traces — flight-recorder trace search: the timeline ring
    plus the durable segments under ice_root, grouped into per-trace
    summaries. Filters: route= (substring of the rest.request route),
    name= (substring of any span name), status= ("error", a code, or
    "all"), min_ms= (min span duration), since=/until= (unix seconds on
    trace start), limit= (default 50)."""
    from h2o3_tpu_torch.obs import recorder as _obs_rec
    from h2o3_tpu_torch.obs import timeline as _obs_tl
    p = h._params()

    def _f(key):
        v = p.get(key)
        return float(v) if v not in (None, "") else None

    try:
        min_ms, since, until = _f("min_ms"), _f("since"), _f("until")
        limit = int(p.get("limit") or 50)
    except ValueError:
        # a client typo is a 400, never a 5xx: a 500 here would itself be
        # tail-retained as an error trace and burn the availability SLO
        return h._error("min_ms/since/until/limit must be numeric", 400)
    out = _obs_rec.RECORDER.search(
        name=p.get("name") or None, route=p.get("route") or None,
        status=p.get("status") or None, min_ms=min_ms,
        since=since, until=until, limit=limit,
        extra_spans=_obs_tl.SPANS.snapshot())
    h._send({"__meta": {"schema_type": "TracesV3"},
             "traces": out, "n_traces": len(out),
             "recorder_bytes": _obs_rec.RECORDER.disk_bytes()})


def _h_alerts(h: _Handler):
    """GET /3/Alerts — the SLO engine's live view: declared specs, fresh
    burn rates (an evaluate() runs on every call, so the response never
    trails the background period), and per-SLO alert states with the
    episode trace id each firing recorded."""
    from h2o3_tpu_torch.obs import slo as _slo
    alerts = _slo.ENGINE.evaluate()
    h._send({"__meta": {"schema_type": "AlertsV3"},
             "slos": [s.to_dict() for s in _slo.ENGINE.specs()],
             "alerts": alerts,
             "firing": [a["slo"] for a in alerts if a.get("firing")]})


def _h_usage(h: _Handler):
    """GET /3/Usage — the per-tenant/per-model cost table: device-second
    attribution from the dispatch-funnel ledger plus HBM occupancy
    (ParamStore placements, tier-pager budgets), merged cluster-wide over
    the `usage` collect op with the same lagging-host absorption as the
    federated /metrics scrape."""
    from h2o3_tpu_torch.obs import usage as _us
    snaps = [_us.usage_snapshot()]
    lagging = []
    bc = getattr(h.server, "broadcaster", None)
    if bc is not None:
        for i, remote in enumerate(bc.collect("usage",
                                              timeout=_collect_timeout())):
            if isinstance(remote, dict):
                snaps.append(remote)
            else:
                lagging.append(i + 1)
    body = _us.merge_usage(snaps)
    body["__meta"] = {"schema_type": "UsageV3"}
    body["lagging_hosts"] = lagging
    h._send(body)


def _h_cloudhealth(h: _Handler):
    """GET /3/CloudHealth — one synthesized pressure document for the
    cloud (HPA external-metric shape: every dimension normalized so 1.0
    means saturated, merged as a max across hosts). A fresh evaluation
    runs on every call — the response never trails a background period —
    and refreshes the h2o3_pressure{dimension} gauges as a side effect."""
    from h2o3_tpu_torch.obs import usage as _us
    snaps = [_us.evaluate_pressure()]
    lagging = []
    bc = getattr(h.server, "broadcaster", None)
    if bc is not None:
        for i, remote in enumerate(
                bc.collect("cloudhealth", timeout=_collect_timeout())):
            if isinstance(remote, dict):
                snaps.append(remote)
            else:
                lagging.append(i + 1)
    body = _us.merge_cloudhealth(snaps)
    body["__meta"] = {"schema_type": "CloudHealthV3"}
    body["lagging_hosts"] = lagging
    h._send(body)


def _h_model_monitor(h: _Handler, mid):
    """GET /3/ModelMonitor/{model} — baseline-vs-live distribution
    profiles and drift scores for one monitored model, merged
    cluster-wide over the `modelmon:` collect op: every host ships its
    integer count sketches, the coordinator folds them and scores ONCE
    over the sums, so host count and merge order never change a drift
    score bit-for-bit. Lagging workers are absorbed within the collect
    deadline like every other obs merge."""
    from h2o3_tpu_torch.obs import modelmon as _mm
    snaps = [_mm.snapshot(mid)]
    lagging = []
    bc = getattr(h.server, "broadcaster", None)
    if bc is not None:
        for i, remote in enumerate(
                bc.collect(f"modelmon:{mid}",
                           timeout=_collect_timeout())):
            if isinstance(remote, dict):
                snaps.append(remote)
            elif remote is None:
                lagging.append(i + 1)
    body = _mm.merged_report(mid, [s for s in snaps if s is not None])
    if not body.get("monitored"):
        from h2o3_tpu_torch.core.kvstore import DKV
        if DKV.get(mid) is None:
            return h._error(f"model {mid} not found", 404)
    body["__meta"] = {"schema_type": "ModelMonitorV3"}
    body["lagging_hosts"] = lagging
    h._send(body)


def _cluster_metric_snapshots(h: _Handler):
    """[(host, registry-snapshot)] for every answering host, local first.
    A lagging worker is absorbed within the collect deadline: its slot is
    skipped, counted in h2o3_cluster_scrape_timeouts_total and reported
    in the second return value."""
    from h2o3_tpu_torch.obs import metrics as _obs_m
    from h2o3_tpu_torch.obs import timeline as _obs_tl
    snaps = [(_obs_tl.host_id(), _obs_m.REGISTRY.to_dict())]
    lagging = []
    bc = getattr(h.server, "broadcaster", None)
    if bc is not None:
        for i, remote in enumerate(bc.collect("metrics",
                                              timeout=_collect_timeout())):
            if isinstance(remote, dict) \
                    and isinstance(remote.get("metrics"), dict):
                snaps.append((remote.get("host", i + 1), remote["metrics"]))
            else:
                _obs_m.CLUSTER_SCRAPE_TIMEOUTS.inc()
                lagging.append(i + 1)
    return snaps, lagging


def _h_metrics(h: _Handler):
    """GET /metrics — Prometheus text exposition of the process registry.
    `?scope=cluster` federates: every host's snapshot is collected over
    the replay channel and merged under a per-host host= label (counters/
    histograms stay summable; gauges stay per-host). When the scraper
    negotiates OpenMetrics (Accept: application/openmetrics-text, or
    ?format=openmetrics), the body carries histogram EXEMPLARS — the
    trace ids latency observations recorded — which Prometheus stores
    under --enable-feature=exemplar-storage."""
    from h2o3_tpu_torch.obs import metrics as _obs_m
    _obs_m.install_runtime_gauges()
    p = h._params()
    ctype = "text/plain; version=0.0.4; charset=utf-8"
    openmetrics = "openmetrics" in (h.headers.get("Accept") or "") \
        or p.get("format") == "openmetrics"
    if p.get("scope") == "cluster":
        snaps, _ = _cluster_metric_snapshots(h)
        if openmetrics:
            body = _obs_m.cluster_openmetrics_text(snaps).encode()
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8")
        else:
            body = _obs_m.cluster_prometheus_text(snaps).encode()
    elif openmetrics:
        body = _obs_m.REGISTRY.openmetrics_text().encode()
        ctype = "application/openmetrics-text; version=1.0.0; charset=utf-8"
    else:
        body = _obs_m.REGISTRY.prometheus_text().encode()
    h.send_response(200)
    h.send_header("Content-Type", ctype)
    h.send_header("Content-Length", str(len(body)))
    h.end_headers()
    if getattr(h, "command", "") != "HEAD":
        h.wfile.write(body)


def _h_watermeter(h: _Handler):
    """GET /3/WaterMeter — the registry as JSON (WaterMeterCpuTicks/
    WaterMeterIo's REST shape, generalized to the whole registry).
    `?cluster=1` answers for the whole cloud: per-host snapshots merged
    with host= labels, lagging hosts listed instead of waited on."""
    from h2o3_tpu_torch.obs import metrics as _obs_m
    _obs_m.install_runtime_gauges()
    p = h._params()
    if str(p.get("cluster", "")).lower() in ("1", "true", "yes"):
        snaps, lagging = _cluster_metric_snapshots(h)
        h._send({"__meta": {"schema_type": "WaterMeterV3"},
                 "metrics": _obs_m.merge_cluster_snapshots(snaps),
                 "hosts": [hst for hst, _ in snaps],
                 "lagging_hosts": lagging})
        return
    h._send({"__meta": {"schema_type": "WaterMeterV3"},
             "metrics": _obs_m.REGISTRY.to_dict()})


def _h_profiler(h: _Handler):
    """POST /3/Profiler — on-demand profiling (ProfilerHandler analog):
    action=start [kind=auto|torch|sampling] [trace_dir=...] starts a
    capture (torch.profiler's CPU and CUDA trace, or the pure-Python
    stack sampler); action=stop ends it and returns the artifact dir.
    One session at a time — a concurrent start answers 409.

    `cluster=1` fans the action out over the replay channel: every
    worker starts/stops its OWN session, stop gathers each host's
    sampling flamegraph within the collect deadline (a stalled host is
    listed in lagging_hosts, never waited on), and the collapsed stacks
    merge into ONE host-prefixed pyprof.merged.collapsed under the
    coordinator's artifact dir (the local raw capture stays intact)."""
    from h2o3_tpu_torch.obs import profiler as _prof
    from h2o3_tpu_torch.obs import timeline as _obs_tl
    p = h._params()
    action = str(p.get("action") or "").lower()
    kind = str(p.get("kind") or "auto")
    cluster = str(p.get("cluster", "")).lower() in ("1", "true", "yes")
    bc = getattr(h.server, "broadcaster", None)
    try:
        if action == "start":
            out = _prof.PROFILER.start(trace_dir=p.get("trace_dir") or None,
                                       kind=kind)
        elif action == "stop":
            out = _prof.PROFILER.stop()
        else:
            return h._error("action must be start|stop", 400)
    except _prof.ProfilerBusy as ex:
        return h._error(str(ex), 409)
    except _prof.ProfilerIdle as ex:
        if not (cluster and bc is not None and action == "stop"):
            return h._error(str(ex), 400)
        # a locally-dead session (out-of-band stop, coordinator restart)
        # must not strand the workers' sessions sampling forever — fan
        # the stop out anyway and answer with their artifacts
        out = {"status": "idle", "error": str(ex)}
    except ValueError as ex:
        return h._error(str(ex), 400)
    if cluster and bc is not None:
        op = f"profiler:start:{kind}" if action == "start" \
            else "profiler:stop"
        hosts = [{"host": _obs_tl.host_id(), **out}]
        lagging = []
        parts = []      # (host, collapsed_text) for the merged flamegraph
        if action == "stop" and out.get("artifact"):
            parts.append((_obs_tl.host_id(),
                          _prof.read_collapsed(out["artifact"])))
        for i, remote in enumerate(bc.collect(op,
                                              timeout=_collect_timeout())):
            if isinstance(remote, dict):
                if remote.get("collapsed"):
                    parts.append((remote.get("host", i + 1),
                                  remote["collapsed"]))
                hosts.append({k: v for k, v in remote.items()
                              if k != "collapsed"})
            else:
                lagging.append(i + 1)
        out = dict(out, hosts=hosts, lagging_hosts=lagging)
        if action == "stop" and parts:
            dest = out.get("dir")
            if not dest:        # local session was idle: workers' artifacts
                import tempfile  # still need a home for the merge
                dest = out["dir"] = tempfile.mkdtemp(prefix="h2o3-profile-")
            merged = _prof.merge_collapsed(parts, dest)
            if merged:
                out["merged_flamegraph"] = merged
    h._send({"__meta": {"schema_type": "ProfilerV3"}, **out})


# (GET /3/Profiler lives in routes_ext4: the legacy JProfile one-shot
# stack sample, now merged with PROFILER.status() so the same GET reports
# whether an on-demand session is running.)


def _h_metadata_endpoints(h: _Handler):
    """/3/Metadata/endpoints — SchemaServer.java analog: live route
    metadata that client-bindings codegen consumes."""
    routes = []
    for pat, m, fn in ROUTES:
        routes.append({
            "url_pattern": pat.pattern,
            "http_method": m,
            "handler_method": fn.__name__,
            "summary": (fn.__doc__ or "").strip().split("\n")[0],
        })
    h._send({"__meta": {"schema_type": "EndpointsListV3"},
             "routes": routes, "num_routes": len(routes)})


ROUTES = [
    (re.compile(r"/3/Cloud"), "GET", _h_cloud),
    (re.compile(r"/3/Cloud/drain"), "POST", _h_cloud_drain),
    (re.compile(r"/3/About"), "GET", _h_about),
    (re.compile(r"/3/ImportFiles"), "GET", _h_import),
    (re.compile(r"/3/ParseSetup"), "POST", _h_parse_setup),
    (re.compile(r"/3/Parse"), "POST", _h_parse),
    (re.compile(r"/3/ParseDistributed"), "POST", _h_parse_distributed),
    (re.compile(r"/3/Frames"), "GET", _h_frames),
    (re.compile(r"/3/Frames/([^/]+)"), "GET", _h_frame),
    (re.compile(r"/3/Frames/([^/]+)"), "DELETE", _h_frame_delete),
    (re.compile(r"/3/ModelBuilders"), "GET", _h_model_builders),
    (re.compile(r"/3/ModelBuilders/([^/]+)"), "POST", _h_build_model),
    (re.compile(r"/99/ModelBuilders/([^/]+)"), "POST", _h_build_model),
    (re.compile(r"/3/Models"), "GET", _h_models),
    (re.compile(r"/3/Models/([^/]+)"), "GET", _h_model),
    (re.compile(r"/3/Models/([^/]+)"), "DELETE", _h_model_delete),
    (re.compile(r"/3/Predictions/models/([^/]+)/frames/([^/]+)"), "POST",
     _h_predict),
    (re.compile(r"/3/Predictions/models/([^/]+)"), "POST", _h_predict_rows),
    (re.compile(r"/3/Jobs"), "GET", _h_jobs),
    (re.compile(r"/3/Jobs/([^/]+)"), "GET", _h_job),
    (re.compile(r"/99/Rapids"), "POST", _h_rapids),
    (re.compile(r"/3/ModelMetrics/models/([^/]+)/frames/([^/]+)"), "POST",
     _h_model_metrics),
    (re.compile(r"/3/ModelMetrics/models/([^/]+)/frames/([^/]+)"), "GET",
     _h_model_metrics),
    (re.compile(r"/3/ModelMetrics/models/([^/]+)"), "GET", _h_model_metrics),
    (re.compile(r"/99/Grids"), "GET", _h_grids),
    (re.compile(r"/99/Grids/([^/]+)"), "GET", _h_grid),
    (re.compile(r"/99/AutoMLBuilder"), "POST", _h_automl_build),
    (re.compile(r"/99/AutoML/([^/]+)"), "GET", _h_automl),
    (re.compile(r"/3/Logs"), "GET", _h_logs_search),
    (re.compile(r"/3/Logs/download"), "GET", _h_logs_download),
    (re.compile(r"/3/Logs/nodes/([^/]+)/files/([^/]+)"), "GET",
     _h_logs_node_file),
    (re.compile(r"/3/JStack"), "GET", _h_jstack),
    (re.compile(r"/3/Timeline"), "GET", _h_timeline),
    (re.compile(r"/3/Trace/([^/]+)"), "GET", _h_trace),
    (re.compile(r"/3/Traces"), "GET", _h_traces),
    (re.compile(r"/3/Alerts"), "GET", _h_alerts),
    (re.compile(r"/3/Usage"), "GET", _h_usage),
    (re.compile(r"/3/CloudHealth"), "GET", _h_cloudhealth),
    (re.compile(r"/3/ModelMonitor/([^/]+)"), "GET", _h_model_monitor),
    (re.compile(r"/metrics"), "GET", _h_metrics),
    (re.compile(r"/3/WaterMeter"), "GET", _h_watermeter),
    (re.compile(r"/3/Profiler"), "POST", _h_profiler),
    (re.compile(r"/3/Metadata/endpoints"), "GET", _h_metadata_endpoints),
    (re.compile(r"/3/InitID"), "GET", _h_init_session),
    (re.compile(r"/3/InitID"), "DELETE", _h_end_session),
    (re.compile(r"/3/Shutdown"), "POST", _h_shutdown),
]

# extended surface (frame munging, diagnostics, artifacts, validation —
# RequestServer.java:76 registers ~150 routes; the long tail lives there)
from h2o3_tpu_torch.api import routes_ext as _ext  # noqa: E402

ROUTES += _ext.build_routes()

from h2o3_tpu_torch.api import routes_ext2 as _ext2  # noqa: E402

ROUTES += _ext2.build_routes()

from h2o3_tpu_torch.api import routes_ext3 as _ext3  # noqa: E402

ROUTES += _ext3.build_routes()

from h2o3_tpu_torch.api import routes_ext4 as _ext4  # noqa: E402

ROUTES += _ext4.build_routes()

# Flow-lite UI (h2o-web analog) at / and /flow/index.html
from h2o3_tpu_torch.api import flow as _flow  # noqa: E402

ROUTES += [
    (re.compile(r"/"), "GET", _flow.h_flow),
    (re.compile(r"/flow/index\.html"), "GET", _flow.h_flow),
    (re.compile(r"/flow/notebook\.html"), "GET", _flow.h_notebook),
]


class _HTTPServer(ThreadingHTTPServer):
    """A thread a request, as the JAX server; a listen backlog of 128
    where the stdlib's is 5, which resets the connections of a burst of
    concurrent clients beyond the fifth (the JAX server keeps 5)."""
    request_queue_size = 128
    daemon_threads = True


class H2OServer:
    """Controller-side API server (h2o.init() + jetty in one).

    Security (H2OSecurityManager / h2o-security analog for a
    single-controller runtime):
      * auth: {user: password} dict or a "user:password"-lines file path
        (-basic_auth / realm.properties) — enforced on every route with a
        constant-time compare.
      * ssl_cert/ssl_key: PEM pair → serve HTTPS (-jks/-ssl internode;
        the replay channel between the processes of a cloud is
        HMAC-authenticated, not encrypted — TLS terminates at the one
        REST boundary).
    Config-file equivalents: ai.h2o.api.auth_file / ssl_cert / ssl_key
    via utils/config properties.
    """

    def __init__(self, port: int = 54321, auth=None, ssl_cert=None,
                 ssl_key=None, host: str | None = None):
        from h2o3_tpu_torch.utils import config as _cfg
        # loopback by default (local dev); deployments bind all interfaces
        # (deploy/multihost serve + ai.h2o.api.bind_all property)
        if host is None:
            host = "0.0.0.0" if _cfg.get_bool("api.bind_all") \
                else "127.0.0.1"
        if host not in ("127.0.0.1", "localhost", "::1"):
            # binding beyond loopback without credentials exposes the
            # whole modeling surface; require auth unless explicitly
            # waived (the reference's -hash_login posture)
            has_auth = (auth
                        or _cfg.get_property("api.auth_file", None)
                        or str(_cfg.get_property("api.auth_method", "")
                               or "").lower() in ("ldap", "custom"))
            if not has_auth and \
                    not _env.env_bool("H2O3_INSECURE_BIND_ALL", False):
                raise RuntimeError(
                    f"refusing to bind {host} without authentication: "
                    "configure -basic_auth/ai.h2o.api.auth_file, "
                    "api.auth_method=ldap|custom, or set "
                    "H2O3_INSECURE_BIND_ALL=1 to waive")
        self.httpd = _HTTPServer((host, port), _Handler)
        auth = auth if auth is not None else \
            _cfg.get_property("api.auth_file", None)
        if isinstance(auth, str):
            creds = {}
            with open(auth) as fh:
                for line in fh:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        u, _, p = line.partition(":")
                        creds[u] = p
            auth = creds
        from h2o3_tpu_torch.utils import auth as _auth
        if auth:
            # explicit caller credentials win over the configured method
            self.httpd.authenticator = _auth.BasicAuthenticator(auth)
        else:
            self.httpd.authenticator = _auth.resolve_authenticator(None)
        ssl_cert = ssl_cert or _cfg.get_property("api.ssl_cert", None)
        ssl_key = ssl_key or _cfg.get_property("api.ssl_key", None)
        if ssl_cert and ssl_key:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(ssl_cert, ssl_key)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket,
                                                server_side=True)
        self.port = self.httpd.server_address[1]
        self.thread: threading.Thread | None = None

    def start(self, background=True):
        h2o3_tpu_torch.cloud()  # form the cloud (the card) before serving
        from h2o3_tpu_torch.obs import metrics as _obs_m
        _obs_m.install_runtime_gauges()
        # env-gated runtime sanitizers (H2O3_DEBUG_NANS,
        # H2O3_TRANSFER_GUARD, lockdep, divergence, leaktrack) — no-op
        # unless a deployment flips them
        from h2o3_tpu_torch.analysis import sanitizers as _san
        _san.install_from_env()
        # SLO engine: load H2O3_SLO_FILE specs and start the background
        # burn-rate evaluator (idle when the env is unset)
        from h2o3_tpu_torch.obs import slo as _slo
        _slo.install_from_env()
        # stall watchdog: start the sentinel and hand it the cluster
        # fan-out (read dynamically — the multihost bootstrap and the
        # test harness both attach the broadcaster around start())
        from h2o3_tpu_torch.obs import watchdog as _wd
        _wd.WATCHDOG.start()

        def _wd_collect(op, timeout):
            bc = getattr(self.httpd, "broadcaster", None)
            return bc.collect(op, timeout=timeout) if bc is not None \
                else []

        _wd.WATCHDOG.set_collector(_wd_collect)
        if background:
            self.thread = threading.Thread(target=self.httpd.serve_forever,
                                           daemon=True, name="h2o3-rest")
            self.thread.start()
        else:
            self.httpd.serve_forever()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def start_server(port: int = 54321) -> H2OServer:
    return H2OServer(port).start()


if __name__ == "__main__":
    import sys
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 54321
    from h2o3_tpu_torch.utils import log as _ulog
    _ulog.info("h2o3-tpu-torch REST server on :%s", port)
    H2OServer(port).start(background=False)
