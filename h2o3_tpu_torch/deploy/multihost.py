"""The multi-process cloud of the port (h2o3_tpu/deploy/multihost.py) —
the h2o-k8s/H2OCluster + hadoop driver analog.

The reference forms a multi-node cloud via UDP gossip. The JAX package
wires its hosts into one runtime with `jax.distributed.initialize`. The
port forms a world of processes, one rank each, with
`torch.distributed.init_process_group("gloo")` over a TCP store at the
coordinator's address; every rank holds its own contiguous block of each
frame's rows, and the binned GBM reduces its level histograms over the
world (models/tree/binned.py).

Env (k8s manifests set these from the StatefulSet; a local cloud exports
them per process):
  H2O3_COORDINATOR_ADDRESS   host:port of rank 0's TCP store
  H2O3_NUM_PROCESSES         world size
  H2O3_PROCESS_ID            this process' rank
  H2O3_CLUSTER_SECRET        the replay channel's HMAC secret
  H2O3_CLOUD_FORM_TIMEOUT_S  bound on forming the world and on the
                             coordinator's wait for its workers (600)
  H2O3_COLLECTIVE_TIMEOUT_S  bound on one collective (600)

Call `bootstrap()` first thing on every process of a multi-process
deployment; without a coordinator address it forms a world of one. A
process given a coordinator address that cannot form the world raises
within H2O3_CLOUD_FORM_TIMEOUT_S: it never carries on as a world of one.

Differences from the JAX package: no TPU-environment autodetection
(MEGASCALE / TPU_WORKER_* variables are not read); the collectives run
over gloo, whose all-reduce and broadcast take the card's tensors and
whose gathers go through the host (parallel/mrtask.py); the ranks of one
machine may share one card.
"""

from __future__ import annotations

import io
import os

from h2o3_tpu_torch.utils.env import (env_bool, env_float, env_int, env_str,
                                      is_set, process_id)


# True in a process that replays the coordinator's requests (a worker of a
# cloud, or a replacement that joined one): its copies of the replicated
# state are the coordinator's, and the artifacts a request writes (a saved
# frame, a saved model) are the coordinator's to write
_REPLICA = [False]


def replica() -> bool:
    """True in a worker process (it replays the coordinator's requests)."""
    return _REPLICA[0]


def writes_artifacts() -> bool:
    """Whether a request handled here writes its files: on the
    coordinator (or a process outside any cloud), never on a worker."""
    return not _REPLICA[0]


def _coordinator_address() -> str:
    """host:port of rank 0's TCP store ("" when unset: a world of one).
    The one H2O3_COORDINATOR_ADDRESS declaration site."""
    return env_str("H2O3_COORDINATOR_ADDRESS", "")


def _num_processes() -> int:
    """World size for explicit multi-process wiring. 0 = unset:
    bootstrap() raises rather than silently forming a 1-process cloud with
    a coordinator address configured."""
    return env_int("H2O3_NUM_PROCESSES", 0)


def is_multihost() -> bool:
    """True when a multi-process launch environment is configured (an
    explicit coordinator address)."""
    return bool(_coordinator_address())


def assisted_clustering_env() -> dict:
    """h2o-k8s assisted clustering analog (H2OAssistedClusteringEndpoint):
    inside a k8s StatefulSet, derive the coordinator address, world size
    and this pod's rank from the headless-service DNS convention instead
    of requiring the manifest to wire H2O3_* explicitly.

    Uses the downward-API hostname `<set>-<ordinal>` plus
    H2O3_K8S_SERVICE (headless service name) and H2O3_K8S_REPLICAS:
    coordinator = <set>-0.<service>:8476, process_id = <ordinal>.
    Returns {} when not running under that convention."""
    svc = env_str("H2O3_K8S_SERVICE", "")
    replicas = env_str("H2O3_K8S_REPLICAS", "").strip()
    host = os.environ.get("HOSTNAME", "")
    if not (svc and replicas.isdigit() and "-" in host):
        return {}
    base, _, ordinal = host.rpartition("-")
    if not ordinal.isdigit():
        return {}
    # 8476 matches the StatefulSet/Service declared coordinator port
    port = env_str("H2O3_COORDINATOR_PORT", "8476")
    ns = env_str("H2O3_K8S_NAMESPACE", "")
    fqdn = f"{base}-0.{svc}" + (f".{ns}.svc.cluster.local" if ns else "")
    return {"H2O3_COORDINATOR_ADDRESS": f"{fqdn}:{port}",
            "H2O3_NUM_PROCESSES": replicas,
            "H2O3_PROCESS_ID": ordinal}


def _collective_timeout_s() -> float:
    """Bound on one collective: a peer that stopped issuing its half
    surfaces as an error, not a rank parked forever."""
    return env_float("H2O3_COLLECTIVE_TIMEOUT_S", 600.0)


def bootstrap(n_rows_shards=None, n_model_shards: int = 1, device=None):
    """Form the world (when a coordinator address is configured) and the
    cloud over it: rank 0 hosts the TCP store at H2O3_COORDINATOR_ADDRESS,
    the others connect to it, all within H2O3_CLOUD_FORM_TIMEOUT_S.
    `n_rows_shards` must be the world size when given (each rank holds one
    row block); `n_model_shards` other than 1 raises ValueError (the port
    has no model axis). `device`: the rank's device (default cuda:0; the
    ranks of one machine may share it)."""
    import datetime

    if int(n_model_shards or 1) != 1:
        raise ValueError("the port's cloud has no model axis: "
                         "-n_model_shards must be 1")
    # assisted clustering: fill the H2O3_* wiring from StatefulSet DNS
    # when the manifest didn't set it explicitly
    if not _coordinator_address():
        # plain assignment: a present-but-EMPTY manual override means
        # "use assisted mode", and setdefault would leave it empty
        for k, v in assisted_clustering_env().items():
            os.environ[k] = v

    import h2o3_tpu_torch
    if not is_multihost():
        if (n_rows_shards or 1) != 1:
            raise ValueError("a world of one process holds one row shard: "
                             "-n_rows_shards needs H2O3_COORDINATOR_ADDRESS")
        return h2o3_tpu_torch.init(device)
    addr = _coordinator_address()
    nproc = _num_processes()
    if nproc <= 0:
        raise RuntimeError(
            "H2O3_COORDINATOR_ADDRESS is set but "
            "H2O3_NUM_PROCESSES is not — explicit multi-host "
            "wiring needs the world size")
    if not is_set("H2O3_PROCESS_ID"):
        # keep the old KeyError's loudness: four pods all
        # defaulting to rank 0 fail far from the root cause
        raise RuntimeError(
            "H2O3_COORDINATOR_ADDRESS is set but "
            "H2O3_PROCESS_ID is not — every pod of an explicit "
            "multi-host wiring must declare its rank")
    if n_rows_shards is not None and int(n_rows_shards) != nproc:
        raise ValueError(f"-n_rows_shards {n_rows_shards}: the world of "
                         f"{nproc} processes holds {nproc} row shards")
    rank = process_id()
    host, _, port = addr.rpartition(":")
    import torch.distributed as dist
    form = datetime.timedelta(seconds=_form_timeout_s())
    try:
        store = dist.TCPStore(host or "127.0.0.1", int(port), nproc,
                              is_master=rank == 0, timeout=form,
                              wait_for_workers=True)
        dist.init_process_group(
            "gloo", store=store, world_size=nproc, rank=rank,
            timeout=datetime.timedelta(seconds=_collective_timeout_s()))
    except Exception as ex:   # noqa: BLE001 — one loud formation error
        raise RuntimeError(
            f"rank {rank} could not form the world of {nproc} at {addr} "
            f"within {_form_timeout_s():g}s (H2O3_CLOUD_FORM_TIMEOUT_S): "
            f"{ex}") from ex
    return h2o3_tpu_torch.init(device, rank=rank, world=nproc,
                               group=dist.group.WORLD)


# ---------------------------------------------------------------------------
# SPMD request replay. Every rank must issue the same collectives in the
# same order — a worker that idles would wedge the first collective rank 0
# issues. So process 0
# broadcasts each mutating REST request (path, method, params) to the
# workers BEFORE handling it locally, and each worker replays the identical
# request against the same route table. Identical requests → identical API
# calls → identical collectives in the same order (parallel/compat.py
# orders them within a rank). (The reference
# has no analog: its nodes exchange data via RPC; SPMD replicates control.)
# Requests replay serially in arrival order; concurrent builds are
# serialized by the broadcast lock.
#
# Channel security: frames are JSON (never pickle — a spoofed peer must not
# get arbitrary-object deserialization) authenticated with HMAC-SHA256 under
# a shared secret (H2O3_CLUSTER_SECRET, injected by the StatefulSet secret).
# Connection setup is a mutual challenge-response — the coordinator proves
# freshness to the worker and vice versa — and subsequent frames are keyed
# by a per-session key derived from both nonces with a monotone sequence
# number, so neither a rogue pod that races a worker's slot nor a replayed
# capture of an earlier session is accepted.
_BCAST_PORT_OFFSET = 2
_MAX_FRAME = 64 * 1024 * 1024


def _ack_timeout() -> float:
    """Upper bound (seconds) on any single wait the Broadcaster performs
    under its lock. The broadcast ack barrier is intentionally lockstep —
    but an UNBOUNDED lockstep wait means one wedged worker freezes every
    REST thread behind the broadcast lock forever (the R008 class the
    static analyzer flags). Bounded, the failure is a loud RuntimeError
    after this deadline instead of a silent server freeze."""
    return env_float("H2O3_REPLAY_ACK_TIMEOUT_S", 120.0)


def _ack_timeouts_counter():
    from h2o3_tpu_torch.obs import metrics as _om
    return _om.counter("h2o3_replay_ack_timeouts_total",
                       "replay-channel ack waits that hit the "
                       "H2O3_REPLAY_ACK_TIMEOUT_S deadline (a worker "
                       "stopped acking: SPMD replay is wedged)")


def _cluster_secret() -> bytes:
    s = env_str("H2O3_CLUSTER_SECRET", "")
    if not s:
        raise RuntimeError(
            "H2O3_CLUSTER_SECRET is required for the multi-host replay "
            "channel (the k8s chart injects it from a Secret; for local "
            "clouds export any shared random string)")
    return s.encode()


def _send_frame(sock, key: bytes, obj, timeout=None) -> None:
    """Send one HMAC frame. `timeout` bounds the send: a peer that
    stopped reading (full TCP window) raises socket.timeout instead of
    blocking the caller — required wherever the caller holds a lock."""
    import hashlib
    import hmac
    import json
    import struct
    payload = json.dumps(obj).encode()
    tag = hmac.new(key, payload, hashlib.sha256).digest()
    if timeout is not None:
        sock.settimeout(timeout)
    try:
        sock.sendall(struct.pack("!I", len(payload)) + tag + payload)
    finally:
        if timeout is not None:
            sock.settimeout(None)


def _decode_frame(buf: bytes, key: bytes):
    """Decode one length-prefixed HMAC frame from `buf`. Returns
    (message, remaining_bytes) once a whole frame is present, None while
    more bytes are needed — the single source of truth for the wire
    format, shared by the blocking and buffered/resumable readers."""
    import hashlib
    import hmac
    import json
    import struct
    if len(buf) < 4:
        return None
    (ln,) = struct.unpack("!I", buf[:4])
    if ln > _MAX_FRAME:
        raise RuntimeError(f"replay channel: oversized frame ({ln} bytes)")
    need = 4 + 32 + ln
    if len(buf) < need:
        return None
    tag, payload = buf[4:36], buf[36:need]
    want = hmac.new(key, payload, hashlib.sha256).digest()
    if not hmac.compare_digest(tag, want):
        raise RuntimeError("replay channel: HMAC mismatch (untrusted peer?)")
    return json.loads(payload), buf[need:]


def _recv_frame(sock, key: bytes):
    buf = b""
    while True:
        out = _decode_frame(buf, key)
        if out is not None:
            return out[0]
        part = sock.recv(65536)
        if not part:
            return None       # EOF (possibly mid-frame)
        buf += part


def _session_key(secret: bytes, nonce_c: str, nonce_w: str) -> bytes:
    import hashlib
    import hmac
    return hmac.new(secret, f"{nonce_c}:{nonce_w}".encode(),
                    hashlib.sha256).digest()


def _form_timeout_s() -> float:
    """Bound on the coordinator's initial cloud-formation accept loop —
    a missing worker pod must surface as a loud error, not an accept()
    parked forever (the R013 unbounded-network-wait class)."""
    return env_float("H2O3_CLOUD_FORM_TIMEOUT_S", 600.0)


def _reconnect_window_s() -> float:
    """How long a worker whose coordinator socket dropped keeps retrying
    the handshake before exiting nonzero. 0 disables reconnection (the
    pre-elastic behavior: an orphaned worker exits its loop cleanly).
    The old read had two defaults (unset → 60, empty → 0); the typed
    accessor collapses both to the documented 60."""
    return env_float("H2O3_REPLAY_RECONNECT_S", 60.0)


def _challenge_peer(conn, secret: bytes):
    """Coordinator side of the mutual challenge-response on one fresh
    connection (no welcome — the caller validates the peer id and sends
    it under the session key). Returns (hello, session_key)."""
    import secrets as _secrets
    conn.settimeout(10.0)
    nonce_c = _secrets.token_hex(16)
    _send_frame(conn, secret, {"challenge": nonce_c})
    hello = _recv_frame(conn, secret)
    if (not hello or hello.get("echo") != nonce_c
            or not isinstance(hello.get("hello"), int)):
        raise RuntimeError("bad hello")
    key = _session_key(secret, nonce_c, str(hello.get("nonce", "")))
    return hello, key


class _ReplayHandler:
    """Duck-typed stand-in for the HTTP handler. Routes need
    _params/_send/_error; byte-streaming routes (DownloadDataset, mojo /
    POJO downloads) additionally drive the raw http.server surface, so
    those are no-ops writing to a sink — on workers the device readback
    is the collective part, the bytes only matter on process 0."""

    server = None          # workers hold no HTTP server / broadcaster:
    #                        handlers must getattr their way to both

    def __init__(self, params):
        self._p = dict(params)
        self.out = None
        self.wfile = io.BytesIO()
        self.headers: dict = {}

    def _params(self):
        return dict(self._p)

    def _send(self, obj, code=200, extra_headers=None):
        if getattr(self, "_div_answer", False):
            # a scoring route's answer joins the divergence digest, as on
            # the coordinator (analysis/divergence.note_answer)
            from h2o3_tpu_torch.analysis import divergence as _dvg
            _dvg.note_answer(obj)
        self.out = obj

    def _error(self, msg, code=400):
        self.out = {"error": str(msg), "code": code}

    def _unavailable(self, qf):
        self.out = {"error": str(qf), "code": 503}

    def send_response(self, code):
        pass

    def send_header(self, k, v):
        pass

    def end_headers(self):
        pass


def replay_request(method: str, path: str, params: dict):
    """Execute a REST request against the local route table (worker side)."""
    from h2o3_tpu_torch.api import server as _srv
    h = _ReplayHandler(params)
    for pat, m, fn in _srv.ROUTES:
        if m != method:
            continue
        mm = pat.fullmatch(path)
        if mm:
            h._div_answer = bool(getattr(fn, "_scores", False))
            fn(h, *mm.groups())
            return h.out
    return {"error": f"no route {method} {path}"}


class Broadcaster:
    """Process-0 side: fan each request out to every worker and wait for
    receipt acks (ordering barrier) before local dispatch. Accepts only
    peers that pass the mutual challenge-response under the cluster
    secret; unauthenticated connections are dropped and the slot re-armed."""

    def __init__(self, n_workers: int, port: int, keep_listener=False):
        import socket
        import time as _time
        from h2o3_tpu_torch.analysis.lockdep import make_lock
        secret = _cluster_secret()
        self._secret = secret
        self._lock = make_lock("replay_channel")
        self._conns = []          # [(sock, session_key)]
        self._owed: list = []     # per-conn acks abandoned by a timed-out
        self._bufs: list = []     # collect; drained before the next send
        self._dead: list = []     # peers that errored: excluded from
        self._pids: list = []     # worker process ids, by slot
        self._seq = 0             # collects (broadcast still fails loudly)
        self._closed = False
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", port))
        srv.listen(max(n_workers, 1))
        # polling accept with an overall formation deadline: a worker pod
        # that never comes up is a loud error within
        # H2O3_CLOUD_FORM_TIMEOUT_S, not an accept() parked forever
        srv.settimeout(1.0)
        form_deadline = _time.monotonic() + _form_timeout_s()
        seen = set()
        while len(self._conns) < n_workers:
            if _time.monotonic() > form_deadline:
                srv.close()
                raise RuntimeError(
                    f"replay channel: only {len(self._conns)} of "
                    f"{n_workers} workers joined within "
                    f"{_form_timeout_s():g}s (H2O3_CLOUD_FORM_TIMEOUT_S)")
            try:
                conn, addr = srv.accept()
            except socket.timeout:
                continue
            try:
                hello, key = _challenge_peer(conn, secret)
                if hello["hello"] in seen:
                    raise RuntimeError(f"bad hello from {addr}")
                _send_frame(conn, key, {"welcome": hello["hello"]})
                conn.settimeout(None)
                seen.add(hello["hello"])
                self._conns.append((conn, key))
                self._owed.append(0)
                self._bufs.append(b"")
                self._dead.append(False)
                self._pids.append(hello["hello"])
            except Exception as ex:  # noqa: BLE001 — drop peer, re-arm slot
                from h2o3_tpu_torch.utils import log as _ulog
                _ulog.warn("replay channel: rejected peer %s: %s",
                           addr, ex)
                conn.close()
        # elastic membership (deploy/membership.ElasticBroadcaster) keeps
        # the listener open to admit joining/replacement workers; the
        # fixed-membership base closes it — the reference's
        # Paxos.lockCloud() moment
        if keep_listener:
            self._srv = srv
        else:
            srv.close()
            self._srv = None

    def live_pids(self) -> list:
        """Process ids of workers still in the broadcast set — the
        candidate share-holders for a distributed-parse fan-out."""
        with self._lock:
            return [p for i, p in enumerate(self._pids)
                    if not self._dead[i]]

    def _recv_frame_at(self, i: int, timeout=None):
        """Like _recv_frame but RESUMABLE: bytes consumed before a timeout
        stay in the per-conn buffer, so abandoning a slow ack mid-frame
        never desyncs the stream (a later drain re-enters and finishes
        the same frame). `timeout` is a whole-frame DEADLINE, not a
        per-recv idle limit — a worker trickling a large frame cannot
        hold the caller past it. Raises socket.timeout on expiry."""
        import socket as _socket
        import time as _time
        c, key = self._conns[i]
        deadline = None if timeout is None else _time.monotonic() + timeout
        try:
            while True:
                out = _decode_frame(self._bufs[i], key)
                if out is not None:
                    msg, self._bufs[i] = out
                    if isinstance(msg, dict) and "div" in msg:
                        # divergence-sanitizer digests riding the ack
                        # (analysis/divergence): peel off and compare —
                        # never let a sanitizer fault break the channel
                        try:
                            from h2o3_tpu_torch.analysis import \
                                divergence as _dvg
                            pid = self._pids[i] \
                                if i < len(self._pids) else i
                            _dvg.note_remote(pid, msg.get("div"))
                        except Exception:   # noqa: BLE001
                            pass
                    return msg
                if deadline is not None:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        raise _socket.timeout("collect deadline")
                    c.settimeout(remaining)
                part = c.recv(65536)
                if not part:
                    return None           # peer gone
                self._bufs[i] = self._bufs[i] + part
        finally:
            c.settimeout(None)

    def _drain_owed(self, i: int, deadline: float):
        """Consume acks a timed-out collect left in flight, so the next
        broadcast's ack barrier lines up with its own sequence number.
        Used by the (intentionally lockstep) broadcast path only; collect
        absorbs stale acks inside its own bounded recv loop. `deadline`
        (monotonic) bounds the whole drain: the caller holds the
        broadcast lock, so spinning past it would wedge every thread."""
        import time as _time
        while self._owed[i] > 0:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                self._raise_wedged(i, "owed-ack drain")
            if self._recv_frame_at(i, timeout=remaining) is None:
                break                            # peer gone: stop spinning
            # h2o3-ok: R003 only reachable from broadcast(), which holds self._lock for the whole send+drain sequence
            self._owed[i] -= 1

    def _raise_wedged(self, i: int, what: str):
        """A worker blew the ack deadline while the broadcast lock is
        held: count it and fail LOUDLY. SPMD replay cannot continue with
        a desynced worker, and an unbounded wait here would freeze every
        REST thread — a RuntimeError surfaces as a 500 on this request
        while /metrics keeps answering."""
        _ack_timeouts_counter().inc()
        raise RuntimeError(
            f"replay channel: worker {i} unresponsive for "
            f"{_ack_timeout():g}s during {what} — SPMD replay is wedged "
            "(H2O3_REPLAY_ACK_TIMEOUT_S bounds this wait)")

    def broadcast(self, method: str, path: str, params: dict, trace=None,
                  sampled=False, log=True):
        del log                   # the fixed membership keeps no snapshot
        import socket as _socket
        import time as _time
        # watchdog: the ack barrier is the classic wedge point — a worker
        # that stopped acking stalls every REST thread behind this lock.
        # The watch deadline must undercut H2O3_REPLAY_ACK_TIMEOUT_S (the
        # wait's own bound, after which the context EXITS): at half the
        # ack timeout the sentinel captures the cluster JStack while the
        # barrier is still stuck, not after it already raised
        from h2o3_tpu_torch.obs import watchdog as _wd
        with _wd.watch("replay", desc=f"broadcast {method} {path}",
                       deadline_s=min(_ack_timeout() / 2,
                                      _wd._stall_s()),
                       trace=trace), \
                self._lock:
            self._seq += 1
            deadline = _time.monotonic() + _ack_timeout()
            msg = {"seq": self._seq, "method": method, "path": path,
                   "params": params}
            if trace:
                # originating request's trace id: workers replay under it
                # so their spans stitch into GET /3/Trace/{id}
                msg["trace"] = trace
            if sampled:
                # X-H2O3-Sample pin travels too: each worker's flight
                # recorder retains its fragment of the pinned trace
                msg["sampled"] = 1
            try:
                for i, (c, key) in enumerate(self._conns):
                    self._drain_owed(i, deadline)
                    # deduct from the SHARED deadline: N workers each
                    # granted a fresh full timeout would stretch the
                    # lock-hold bound to N×timeout
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        self._raise_wedged(i, "broadcast send")
                    _send_frame(c, key, msg, timeout=remaining)
                for i in range(len(self._conns)):
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        self._raise_wedged(i, "broadcast ack barrier")
                    # receipt ack: order barrier. Explicit check, not an
                    # assert: a peer dying mid-broadcast (EOF → None) or
                    # answering the wrong seq must fail identically under
                    # python -O, and desynced replay may not continue
                    ack = self._recv_frame_at(i, timeout=remaining)
                    if not ack or ack.get("ack") != self._seq:
                        raise RuntimeError(
                            f"replay channel: bad broadcast ack from "
                            f"worker {i} (got {ack!r}, want seq "
                            f"{self._seq}) — SPMD replay is desynced")
            except (_socket.timeout, TimeoutError):
                _ack_timeouts_counter().inc()
                raise RuntimeError(
                    f"replay channel: broadcast seq {self._seq} not "
                    f"acked within {_ack_timeout():g}s — SPMD replay is "
                    "wedged (H2O3_REPLAY_ACK_TIMEOUT_S bounds this "
                    "wait)") from None
            # the seq identifies this request to the divergence
            # sanitizer: the dispatcher scopes the local execution under
            # it and workers stamp their replay digests with it
            return self._seq

    def collect(self, op: str, timeout: float = 2.0) -> list:
        """Gather per-worker observability state (TimelineSnapshot's
        cloud-wide assembly): a collect frame replaces the request replay
        and the worker answers its ack WITH the data — same socket, same
        sequence numbers, so ordering against replayed requests holds.

        Bounded wait: a worker stuck inside a long request replay won't
        read the collect frame until it finishes, and /3/Timeline is
        exactly the endpoint needed while something is slow — so each
        worker gets `timeout` seconds, after which its slot returns None
        and its still-owed ack is drained before the next send. A peer
        that errors (EOF, HMAC, bad seq) is marked dead and excluded from
        future collects WITHOUT touching the other workers' ack
        accounting — one broken worker plus a scrape must not poison the
        replay channel for the healthy ones."""
        import socket as _socket
        import time as _time
        with self._lock:
            self._seq += 1
            msg = {"seq": self._seq, "op": op}
            sent = [False] * len(self._conns)
            for i, (c, key) in enumerate(self._conns):
                if self._dead[i]:
                    continue
                # ALWAYS send to live peers — a skipped send would leave a
                # hole in that worker's sequence stream and kill it on the
                # next frame ("bad seq"). Stale owed acks from earlier
                # timed-out collects are absorbed in the recv phase below,
                # inside this round's deadline.
                try:
                    # bounded send: a peer that stopped reading must not
                    # block the scrape (we hold the broadcast lock here)
                    _send_frame(c, key, msg, timeout=timeout)
                    sent[i] = True
                except Exception:   # noqa: BLE001 — peer broken, isolate it
                    self._dead[i] = True
            out = []
            for i in range(len(self._conns)):
                if not sent[i]:
                    out.append(None)
                    continue
                deadline = _time.monotonic() + timeout
                try:
                    while True:
                        remaining = deadline - _time.monotonic()
                        if remaining <= 0:
                            raise _socket.timeout("collect deadline")
                        ack = self._recv_frame_at(i, timeout=remaining)
                        if ack and self._owed[i] > 0 \
                                and ack.get("ack") != self._seq:
                            # stale ack from an earlier timed-out collect:
                            # retire the debt, keep waiting for ours
                            self._owed[i] -= 1
                            continue
                        break
                    if not ack or ack.get("ack") != self._seq:
                        raise RuntimeError(
                            f"replay channel: bad collect ack from {i}")
                    out.append(ack.get("data"))
                except (_socket.timeout, TimeoutError):
                    self._owed[i] += 1    # lagging worker: ack still due
                    out.append(None)
                except Exception:   # noqa: BLE001 — dead peer: isolate, keep going
                    self._dead[i] = True
                    out.append(None)
            return out


def _collect_local(op: str):
    """Worker-side observability snapshot for Broadcaster.collect."""
    try:
        if op == "ping":
            # membership heartbeat: liveness + this worker's view of the
            # cloud epoch (deploy/membership heartbeat loop)
            from h2o3_tpu_torch.deploy import membership as _mb
            from h2o3_tpu_torch.obs import timeline as _tl
            return {"host": _tl.host_id(), "ok": True,
                    "epoch": _mb.MEMBERSHIP.epoch}
        if op == "timeline":
            from h2o3_tpu_torch.obs import timeline as _tl
            return {"host": _tl.host_id(),
                    "spans": _tl.SPANS.snapshot(limit=512)}
        if op == "metrics":
            from h2o3_tpu_torch.obs import metrics as _m
            from h2o3_tpu_torch.obs import timeline as _tl
            return {"host": _tl.host_id(),
                    "metrics": _m.REGISTRY.to_dict()}
        if op == "usage":
            # GET /3/Usage cluster merge: this host's attribution ledger
            # + HBM occupancy (the snapshot carries its own host id)
            from h2o3_tpu_torch.obs import usage as _us
            return _us.usage_snapshot()
        if op == "cloudhealth":
            # GET /3/CloudHealth cluster merge: a FRESH local pressure
            # evaluation per collect, so the merged document never
            # reports a stale worker dimension
            from h2o3_tpu_torch.obs import usage as _us
            return _us.evaluate_pressure()
        if op.startswith("trace:"):
            # GET /3/Trace/{id} read-through: this host's ring spans for
            # ONE trace plus whatever its flight recorder retained, plus
            # the trace-correlated structured log records (the
            # interleaved `logs` view on the coordinator)
            from h2o3_tpu_torch.obs import recorder as _rec
            from h2o3_tpu_torch.obs import timeline as _tl
            from h2o3_tpu_torch.utils import log as _ulog
            tid = op[len("trace:"):]
            spans, _n = _rec.RECORDER.read_through(
                tid, _tl.SPANS.trace_snapshot(tid, limit=512), limit=512)
            return {"host": _tl.host_id(), "spans": spans,
                    "logs": _ulog.trace_records(tid, limit=256)}
        if op == "jstack":
            # GET /3/JStack cluster merge + the watchdog's cluster
            # capture: this host's all-thread dump
            from h2o3_tpu_torch.obs import timeline as _tl
            from h2o3_tpu_torch.obs import watchdog as _wd
            return {"host": _tl.host_id(), "threads": _wd.thread_dump()}
        if op.startswith("logs:search:"):
            # GET /3/Logs cluster search: same filters, this host's
            # ring + durable segments
            import json as _json
            from h2o3_tpu_torch.obs import timeline as _tl
            from h2o3_tpu_torch.utils import log as _ulog
            filters = _json.loads(op[len("logs:search:"):])
            return {"host": _tl.host_id(),
                    "records": _ulog.search(**filters),
                    "files": [f["name"] for f in _ulog.list_files()]}
        if op.startswith("logs:file:"):
            # GET /3/Logs/nodes/{node}/files/{name}: only the NAMED node
            # ships content; everyone else acks with a bare host marker
            from h2o3_tpu_torch.obs import timeline as _tl
            from h2o3_tpu_torch.utils import log as _ulog
            node, _, name = op[len("logs:file:"):].partition(":")
            me = _tl.host_id()
            if node not in (str(me), "any"):
                return {"host": me}
            return {"host": me, "name": name,
                    "log": _ulog.read_file(name)}
        if op.startswith("parse:"):
            # distributed-ingest fan-out (io/dparse): tokenize THIS
            # host's chunk share and ack with compact codec-byte planes
            # (the re-home wire format) — phase B of the cloud-wide
            # parse runs as pure host work on every member
            import json as _json
            from h2o3_tpu_torch.io import dparse as _dp
            from h2o3_tpu_torch.obs import timeline as _tl
            spec = _json.loads(op[len("parse:"):])
            share = (spec.get("shares") or {}).get(str(_tl.host_id()))
            return {"host": _tl.host_id(),
                    "parse": _dp.worker_parse_chunks(
                        {"sep": spec.get("sep", ","),
                         "header": spec.get("header", True),
                         "chunks": share})}
        if op.startswith("profiler:"):
            # cluster-wide capture fan-out (POST /3/Profiler?cluster=1):
            # start/stop this host's profiler session; a sampling stop
            # ships the collapsed flamegraph text back in the ack
            from h2o3_tpu_torch.obs import profiler as _prof
            from h2o3_tpu_torch.obs import timeline as _tl
            return {"host": _tl.host_id(), **(_prof.collect_op(op) or {})}
        if op.startswith("modelmon:"):
            # GET /3/ModelMonitor/{model} cluster merge: this host's
            # live drift sketches for ONE model (integer counts — the
            # coordinator's fold is order-independent). A host that
            # does not monitor the model answers a bare marker so it
            # is never mistaken for a lagging worker.
            from h2o3_tpu_torch.obs import modelmon as _mm
            from h2o3_tpu_torch.obs import timeline as _tl
            mid = op[len("modelmon:"):]
            return _mm.snapshot(mid) or {"host": _tl.host_id(),
                                         "model": mid, "live": None}
    except Exception:   # noqa: BLE001 — a worker probe error must not kill the loop
        import traceback
        traceback.print_exc()
    return None


def _worker_connect(coordinator_host: str, port: int, pid: int,
                    secret: bytes, join=False, connect_wait_s=120.0):
    """Worker side of one connection: reach the coordinator (bounded by
    `connect_wait_s`), run the mutual challenge-response, return
    (sock, key, welcome). `join=True` marks the hello as an elastic
    (re)join so the coordinator's acceptor syncs epoch + snapshot."""
    import secrets as _secrets
    import socket
    import time as _time
    deadline = _time.monotonic() + connect_wait_s
    while True:                           # wait for process 0 to listen
        try:
            sock = socket.create_connection((coordinator_host, port),
                                            timeout=10.0)
            break
        except OSError:
            if _time.monotonic() >= deadline:
                raise RuntimeError("broadcast coordinator unreachable") \
                    from None
            _time.sleep(0.5)
    sock.settimeout(30.0)                 # handshake is bounded; replay
    #                                       waits below are not (heartbeat
    #                                       pings arrive as collect ops)
    try:
        chal = _recv_frame(sock, secret)
        if not chal or "challenge" not in chal:
            raise RuntimeError(
                "replay channel: no challenge from coordinator")
        nonce_w = _secrets.token_hex(16)
        hello = {"hello": pid, "echo": chal["challenge"], "nonce": nonce_w}
        if join:
            hello["join"] = 1
        _send_frame(sock, secret, hello)
        key = _session_key(secret, chal["challenge"], nonce_w)
        welcome = _recv_frame(sock, key)  # proves coordinator freshness too
        if not welcome or welcome.get("welcome") != pid:
            raise RuntimeError("replay channel: coordinator failed "
                               "handshake")
    except Exception:
        sock.close()
        raise
    sock.settimeout(None)
    return sock, key, welcome


def _observe_epoch(e):
    """Track the coordinator's cloud epoch on this worker (rides every
    elastic broadcast frame + the join welcome)."""
    if e is None:
        return
    from h2o3_tpu_torch.deploy import membership as _mb
    _mb.MEMBERSHIP.observe_epoch(int(e))


def _rejoin(coordinator_host, port, pid, secret, window: float, what: str):
    """Retry the handshake as a (re-)join with bounded backoff for `window`
    seconds, logging a structured WARN per attempt; raise after it."""
    import time as _time
    from h2o3_tpu_torch.utils import log as _ulog
    give_up = _time.monotonic() + window
    attempt = 0
    while True:
        attempt += 1
        try:
            return _worker_connect(coordinator_host, port, pid, secret,
                                   join=True,
                                   connect_wait_s=min(5.0, window))
        except (OSError, RuntimeError) as ex:
            remaining = give_up - _time.monotonic()
            _ulog.warn("replay channel: %s attempt %s failed: %r (giving "
                       "up in %.0fs)", what, attempt, ex,
                       max(remaining, 0.0))
            if remaining <= 0:
                raise RuntimeError(
                    f"replay channel: {what} failed for {window:g}s "
                    "(H2O3_REPLAY_RECONNECT_S)") from ex
            _time.sleep(min(0.2 * 2 ** (attempt - 1), 2.0))


def worker_loop(coordinator_host: str, port: int, pid=None, join=False):
    """Worker side: authenticate the coordinator, then block on the
    broadcast socket and replay each request in sequence order.

    Elastic additions: a dropped coordinator socket no longer orphans
    the worker permanently — it retries the handshake (as a re-join,
    syncing the current epoch + replayed-state snapshot) with bounded
    backoff for H2O3_REPLAY_RECONNECT_S before raising, logging a
    structured WARN per attempt. A `leave` op (coordinator-driven
    drain) exits cleanly. A joiner the coordinator refuses (its id is
    still live: a replacement started before its predecessor was cut
    out) retries the same way until admitted — the JAX package's joiner
    fails at once."""
    secret = _cluster_secret()
    _REPLICA[0] = True
    if pid is None:
        from h2o3_tpu_torch.parallel import mesh as _mesh
        pid = _mesh.cloud().rank
    try:
        sock, key, welcome = _worker_connect(coordinator_host, port, pid,
                                             secret, join=join)
    except RuntimeError:
        if not join or _reconnect_window_s() <= 0:
            raise
        sock, key, welcome = _rejoin(coordinator_host, port, pid, secret,
                                     _reconnect_window_s(), "join")
    try:
        while True:
            reason = _replay_session(sock, key, welcome)
            if reason == "leave":
                return
            window = _reconnect_window_s()
            if window <= 0:
                return                    # legacy: orphaned worker exits
            sock, key, welcome = _rejoin(coordinator_host, port, pid,
                                         secret, window, "reconnect")
    finally:
        _close_free_pool()


def _join_started_job(out):
    """Wait for the job a replayed request's answer names, if any."""
    job = out.get("job") if isinstance(out, dict) else None
    key = job.get("key") if isinstance(job, dict) else None
    if not key:
        return
    from h2o3_tpu_torch.core.kvstore import DKV
    j = DKV.get(key)
    if j is not None and hasattr(j, "join"):
        j.join()


def _replay_one(msg):
    """Replay one broadcast request (its divergence digest queued for the
    next ack's riders). A failure is logged and printed: process 0 owns
    the error reporting to the client."""
    from h2o3_tpu_torch.analysis import divergence as _dvg
    _dvg.replay_begin(msg["seq"], msg["path"])
    try:
        # replay under the ORIGINATING request's trace id (when the
        # coordinator attached one): every span this replay opens —
        # mrtask map/reduce phases, job phases, host fetches — tags
        # itself with it, so GET /3/Trace/{id} on process 0 stitches
        # this host's fragment in
        from h2o3_tpu_torch.obs import tracing as _tr
        from h2o3_tpu_torch.obs.timeline import span as _span
        from h2o3_tpu_torch.utils import log as _ulog
        with _tr.trace(msg.get("trace")), \
                _span("replay.request", path=msg["path"],
                      method=msg["method"]) as _sp:
            if msg.get("sampled"):
                # attr marks the fragment root; pin() covers pieces
                # finalized before it closes (linger, span overflow)
                _sp.attrs["sampled"] = 1
                from h2o3_tpu_torch.obs import recorder as _rec
                _rec.RECORDER.pin(msg.get("trace"))
            # structured + trace-correlated: this record is what the
            # coordinator's GET /3/Trace/{id} interleaves for the
            # worker's fragment, and what GET /3/Logs?trace= finds
            _ulog.info("replay %s %s seq=%s", msg["method"],
                       msg["path"], msg["seq"])
            try:
                replay_request(msg["method"], msg["path"],
                               msg["params"])
            except Exception as e:
                # the error attr makes THIS host's recorder retain
                # its fragment of the failed trace — the 5xx status
                # lives only on the coordinator's root span; the
                # ERROR record marks the trace for retention too
                _sp.attrs["error"] = repr(e)
                _ulog.err("replay %s %s failed: %r", msg["method"],
                          msg["path"], e)
                raise
    except Exception:                 # keep replaying; process 0 owns
        import traceback              # error reporting to the client
        traceback.print_exc()
    finally:
        _dvg.replay_end()             # queue this replay's digest


def _stateless_route(method: str, path: str) -> bool:
    """Whether the request's handler is marked `stateless` in api/server.py
    (payload scoring: no replicated state, no collective)."""
    from h2o3_tpu_torch.api import server as _srv
    fn = _srv._match_route(method, path)[1]
    return bool(getattr(fn, "_stateless", False))


# a worker replays a `stateless` request (payload scoring) on a thread of
# its own, as the coordinator runs it outside the dispatch order, so that
# concurrent scoring requests batch together on every rank and the next
# frame's ack does not wait for it; any other frame first waits for the
# stateless replays before it. Only the replay loop's thread touches these.
_STATELESS_THREADS = 16
_FREE_POOL: list = []           # the pool, made at the first such replay
_FREE_PENDING: list = []        # its replays not yet waited for


def _replay_free(msg):
    if not _FREE_POOL:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(_STATELESS_THREADS,
                                  thread_name_prefix="replay-free")
        _FREE_POOL.append(pool)
    _FREE_PENDING.append(_FREE_POOL[0].submit(_replay_one, msg))


def _wait_free():
    while _FREE_PENDING:
        _FREE_PENDING.pop(0).result()


def _close_free_pool():
    """Retire the stateless replays' pool when the replay loop ends: its
    replays finish (each logs its own failure) and its threads exit."""
    while _FREE_POOL:
        pool = _FREE_POOL.pop()
        pool.shutdown(wait=True)
    _FREE_PENDING.clear()


def _replay_session(sock, key, welcome) -> str:
    """Drive one authenticated replay connection until it ends. Returns
    "leave" (clean coordinator-driven exit) or "eof" (socket dropped —
    the caller decides whether to re-join)."""
    from h2o3_tpu_torch.deploy import chaos as _chaos
    _observe_epoch(welcome.get("epoch"))
    # join-sync: replay the coordinator's state snapshot (its bounded
    # log of already-broadcast mutating requests) BEFORE entering the
    # live stream, so a replacement worker converges on the same DKV /
    # model state the survivors hold
    if welcome.get("snapshot_truncated"):
        from h2o3_tpu_torch.utils import log as _ulog
        _ulog.err("join-sync snapshot TRUNCATED (coordinator's request "
                  "log overflowed H2O3_REPLAY_LOG_MAX): replayed state "
                  "may trail the survivors — this worker serves, but "
                  "/3/Cloud marks it unsynced")
    for req in welcome.get("snapshot") or []:
        try:
            out = replay_request(req["method"], req["path"], req["params"])
            # a job the request started (a model build) finishes before
            # the next request and the live stream: what follows reads
            # its result
            _join_started_job(out)
        except Exception as ex:  # noqa: BLE001 — snapshot best-effort
            from h2o3_tpu_torch.utils import log as _ulog
            _ulog.warn("join-sync replay %s %s failed: %r",
                       req.get("method"), req.get("path"), ex)
    if welcome.get("snapshot") is not None:
        # replacement-worker warm start (H2O3_SCORER_PREWARM=1): the
        # joiner just converged on the survivors' model state — place
        # each model's params and capture the smallest row bucket's graph
        # NOW, in the background, so its first live request warm-hits
        # instead of paying placement + capture
        from h2o3_tpu_torch import serving as _serving
        if _serving.prewarm_enabled():
            n = _serving.prewarm_all()
            if n:
                from h2o3_tpu_torch.utils import log as _ulog
                _ulog.info("join-sync: pre-warming %d model scorers", n)
    expect = int(welcome.get("seq", 1))
    while True:
        try:
            msg = _recv_frame(sock, key)
        except OSError:
            return "eof"
        if msg is None:
            return "eof"
        if msg.get("op") == "leave":      # drain completed: clean exit.
            # OUT-OF-BAND control frame (seq -1, checked BEFORE the
            # continuity guard): it goes only to the drained worker, so
            # consuming a shared sequence number here would leave a hole
            # that kills every SURVIVOR on its next frame
            _wait_free()
            try:
                _send_frame(sock, key, {"ack": msg.get("seq", -1)})
            except OSError:
                pass
            return "leave"
        if msg.get("seq") != expect:      # replayed/reordered frame
            raise RuntimeError(f"replay channel: bad seq {msg.get('seq')}"
                               f" (expected {expect})")
        expect += 1
        _observe_epoch(msg.get("epoch"))
        if "op" in msg:                   # observability collect: the data
            # chaos: a delayed/dropped collect ack at a seeded point (the
            # lagging-worker shape membership detection must absorb)
            act = _chaos.at("collect.ack")
            if act is not None and act["action"] == "drop":
                continue
            _wait_free()
            try:
                from h2o3_tpu_torch.analysis import divergence as _dvg
                _send_frame(sock, key,    # rides the ack, no route replay
                            _dvg.attach_riders(
                                {"ack": msg["seq"],
                                 "data": _collect_local(msg["op"])}))
            except OSError:
                return "eof"
            continue
        # chaos: kill the worker process at a seeded replay point — the
        # "lost pod" the membership layer must excise and replace
        _chaos.maybe_raise("worker.replay")
        try:
            # ack, then execute; digests from ALREADY-replayed requests
            # ride out here (this request's own digest rides the next
            # frame — the sanitizer stashes whichever side arrives first)
            from h2o3_tpu_torch.analysis import divergence as _dvg
            _send_frame(sock, key,
                        _dvg.attach_riders({"ack": msg["seq"]}))
        except OSError:
            return "eof"
        if _stateless_route(msg["method"], msg["path"]):
            _replay_free(msg)
            continue
        _wait_free()
        _replay_one(msg)


def serve(port: int = 54321, n_rows_shards=None, n_model_shards: int = 1,
          device=None, host=None):
    """Container entrypoint: bootstrap the cloud; rank 0 serves REST and
    broadcasts each request, the other ranks replay them so every rank
    issues the same collectives.

    H2O3_ELASTIC (default on) runs the replay channel under the
    deploy/membership epoch state machine: a dead worker is excised
    instead of wedging the cloud, and replacements may join."""
    from h2o3_tpu_torch.deploy import chaos as _chaos
    cloud = bootstrap(n_rows_shards=n_rows_shards,
                      n_model_shards=n_model_shards, device=device)
    _chaos.install_from_env()
    nproc = cloud.world
    bport = port + _BCAST_PORT_OFFSET
    if cloud.rank == 0:
        from h2o3_tpu_torch.api.server import H2OServer
        from h2o3_tpu_torch.utils import config as _cfg
        if nproc > 1:
            # workers on other machines reach the replay channel, and the
            # REST port with it; H2OServer enforces the
            # bind-all-requires-auth posture itself
            _cfg.set_property("api.bind_all", True)
        srv = H2OServer(port, host=host)
        if nproc > 1:
            if env_bool("H2O3_ELASTIC", True):
                from h2o3_tpu_torch.deploy.membership import \
                    ElasticBroadcaster
                srv.httpd.broadcaster = ElasticBroadcaster(nproc - 1, bport)
            else:
                srv.httpd.broadcaster = Broadcaster(nproc - 1, bport)
        from h2o3_tpu_torch.utils import log as _ulog
        _ulog.info("h2o3-tpu-torch cloud: %s ranks on %s; REST on :%s",
                   nproc, cloud.device, srv.port)
        # h2o3-ok: R012 the cloud CLI's ready banner on stdout, as __main__.py prints it for a world of one (serve() is `python -m h2o3_tpu_torch`'s entry for a cloud); the line above logs it
        print(f"h2o3-tpu-torch cloud up: {nproc} rank(s) on "
              f"{cloud.device}; REST + Flow on :{srv.port}", flush=True)
        try:
            srv.start(background=False)
        except KeyboardInterrupt:
            pass
    else:
        # the env-gated sanitizers (divergence digests, lockdep, ...) the
        # coordinator's server installs at its start
        from h2o3_tpu_torch.analysis import sanitizers as _san
        _san.install_from_env()
        host = (_coordinator_address() or "127.0.0.1:0").split(":")[0]
        worker_loop(host, bport)


def join_cloud(coordinator_host: str, rest_port: int, pid: int,
               device=None):
    """Replacement-worker entrypoint: a world of one on this process'
    device (the process group the cloud was formed with cannot take a new
    rank), joined to the REPLAY CHANNEL as an elastic member — handshake,
    sync the current epoch + replayed-state snapshot (every frame load and
    model build replayed here on all the rows: the binned GBM's trees of
    a world of one are the world's bit for bit), then serve replays."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.deploy import chaos as _chaos
    from h2o3_tpu_torch.analysis import sanitizers as _san
    h2o3_tpu_torch.init(device)
    _chaos.install_from_env()
    _san.install_from_env()
    worker_loop(coordinator_host, rest_port + _BCAST_PORT_OFFSET,
                pid=pid, join=True)


if __name__ == "__main__":
    import sys
    serve(int(sys.argv[1]) if len(sys.argv) > 1 else 54321)
