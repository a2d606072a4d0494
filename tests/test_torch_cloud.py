"""The port's replay channel, elastic membership, DKV re-home, divergence
sanitizer and parse fan-out against the JAX package's (h2o3_tpu_torch/
deploy/multihost.py, deploy/membership.py, core/kvstore.py,
analysis/divergence.py, io/dparse.py).

- the channel: a frame the port writes is byte for byte the JAX
  package's under the same key, a session key from the same nonces is
  the same, and each package's coordinator forms a cloud with the other
  package's worker and replays a request to it;
- the cases of tests/test_multihost_channel.py, tests/test_membership.py
  (the fake-worker harness against the port's ElasticBroadcaster:
  excision, the epoch bump, the snapshot welcome, drain, the ring's
  bounded key movement with bit-exact planes) and tests/test_divergence.py
  (a real worker loop replaying through the route table; a seeded
  host-divergent handler trips the sanitizer) run with their module
  globals bound to the port's modules;
- the parse fan-out: a cloud of protocol-faithful workers that tokenize
  their shares through `dparse.worker_parse_chunks` gives the sequential
  parse's frame bit for bit at every chunk geometry of
  tests/test_dparse.py.
"""

import inspect
import json
import re
import socket
import threading
import time

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu_torch.analysis import divergence as TDIV
from h2o3_tpu_torch.core import kvstore as TKV
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.deploy import chaos as TCHAOS
from h2o3_tpu_torch.deploy import membership as TMB
from h2o3_tpu_torch.deploy import multihost as TMH
from h2o3_tpu_torch.io import dparse as TDP
from h2o3_tpu_torch.obs import metrics as TOM

import test_divergence as JTD
import test_membership as JTM
import test_multihost_channel as JTC
from h2o3_tpu.deploy import multihost as JMH

SECRET = b"port-cloud-secret"


@pytest.fixture(autouse=True)
def _cpu_cloud():
    h2o3_tpu_torch.init(device="cpu")
    yield
    TMH._REPLICA[0] = False
    h2o3_tpu_torch.init(device="cpu")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


# ---------------------------------------------------------------------------
# the wire: byte for byte the JAX package's, both ways
class _Sink:
    def __init__(self):
        self.buf = b""

    def sendall(self, b):
        self.buf += b

    def settimeout(self, t):
        pass


@pytest.mark.parametrize("obj", [
    {"seq": 1, "method": "POST", "path": "/3/Frames/load",
     "params": {"dir": "/d", "frame_id": "f"}, "epoch": 2},
    {"ack": 7, "data": {"host": 1, "spans": [{"a": 1.5}]},
     "div": [{"seq": 6, "h": "ab", "n": 1, "e": ["put|k|t:Frame"]}]},
    {"challenge": "00ff" * 8}, {"seq": -1, "op": "leave"}])
def test_frames_are_the_jax_bytes_both_ways(obj):
    key = TMH._session_key(SECRET, "aa" * 16, "bb" * 16)
    assert key == JMH._session_key(SECRET, "aa" * 16, "bb" * 16)
    a, b = _Sink(), _Sink()
    TMH._send_frame(a, key, obj)
    JMH._send_frame(b, key, obj)
    assert a.buf == b.buf
    assert TMH._decode_frame(b.buf, key) == (obj, b"")
    assert JMH._decode_frame(a.buf, key) == (obj, b"")
    with pytest.raises(RuntimeError, match="HMAC"):
        TMH._decode_frame(b.buf, key[::-1])


@pytest.mark.parametrize("coord,worker", [(TMH, JMH), (JMH, TMH)],
                         ids=["port-coordinator", "jax-coordinator"])
def test_handshake_and_replay_across_packages(monkeypatch, coord, worker):
    monkeypatch.setenv("H2O3_CLUSTER_SECRET", SECRET.decode())
    port = _free_port()
    out = {}

    def _mk():
        out["bc"] = coord.Broadcaster(1, port)
        out["seq"] = out["bc"].broadcast("POST", "/3/Parse",
                                         {"f": "a.csv"})
        out["col"] = out["bc"].collect("ping", timeout=5.0)

    t = threading.Thread(target=_mk, daemon=True)
    t.start()
    sock, key, welcome = worker._worker_connect("127.0.0.1", port, 4,
                                                SECRET, connect_wait_s=10)
    assert welcome == {"welcome": 4}
    msg = worker._recv_frame(sock, key)
    assert msg == {"seq": 1, "method": "POST", "path": "/3/Parse",
                   "params": {"f": "a.csv"}}
    worker._send_frame(sock, key, {"ack": 1})
    msg = worker._recv_frame(sock, key)
    assert msg == {"seq": 2, "op": "ping"}
    worker._send_frame(sock, key, {"ack": 2, "data": {"host": 4}})
    t.join(timeout=15)
    assert out["seq"] == 1 and out["col"] == [{"host": 4}]
    sock.close()


# ---------------------------------------------------------------------------
# the JAX package's channel, membership and divergence cases on the port
_PORT_GLOBALS = {"MH": TMH, "MB": TMB, "DKV": TKV.DKV,
                 "HashRing": TKV.HashRing, "chaos": TCHAOS, "om": TOM,
                 "Frame": Frame, "divergence": TDIV}


def _bind(monkeypatch, mod):
    for k, v in _PORT_GLOBALS.items():
        if hasattr(mod, k):
            monkeypatch.setattr(mod, k, v)


def _port_cloud_env(monkeypatch, secret="membership-test-secret"):
    monkeypatch.setenv("H2O3_CLUSTER_SECRET", secret)
    monkeypatch.setenv("H2O3_HEARTBEAT_S", "0")
    monkeypatch.setenv("H2O3_REPLAY_ACK_TIMEOUT_S", "1")
    TMB.MEMBERSHIP.reset()
    TCHAOS.reset()


def _port_cloud_teardown():
    TMB.MEMBERSHIP.reset()
    TCHAOS.reset()
    TKV.DKV.set_membership([0], epoch=1)
    deadline = time.monotonic() + 5
    while TKV.DKV.rehome_status()["pending"] and \
            time.monotonic() < deadline:
        time.sleep(0.02)


CHANNEL_CASES = sorted(n for n in dir(JTC) if n.startswith("test_"))


@pytest.mark.parametrize("name", CHANNEL_CASES)
def test_channel_case_on_port(name, monkeypatch):
    _bind(monkeypatch, JTC)
    fn = getattr(JTC, name)
    args = {}
    for p in inspect.signature(fn).parameters:
        if p == "secret_env":
            monkeypatch.setenv("H2O3_CLUSTER_SECRET", "test-cluster-secret")
            args[p] = b"test-cluster-secret"
        elif p == "monkeypatch":
            args[p] = monkeypatch
    fn(**args)
    if name == "test_assisted_clustering_env":
        # the JAX case imports its own function; hold the port's to it
        monkeypatch.setenv("HOSTNAME", "h2o3-tpu-3")
        monkeypatch.setenv("H2O3_K8S_SERVICE", "h2o3-headless")
        monkeypatch.setenv("H2O3_K8S_REPLICAS", "4")
        monkeypatch.delenv("H2O3_K8S_NAMESPACE", raising=False)
        assert TMH.assisted_clustering_env() == \
            JMH.assisted_clustering_env()


MEMBERSHIP_CASES = [
    "test_hash_ring_deterministic_and_bounded_movement",
    "test_rehome_bit_exact_and_read_through",
    "test_retry_once_semantics",
    "test_excision_on_ack_timeout_resumes_over_survivors",
    "test_excision_on_severed_socket_via_chaos",
    "test_join_syncs_epoch_and_snapshot",
    "test_heartbeat_excises_idle_dead_worker",
    "test_worker_reconnects_after_coordinator_drop",
    "test_worker_gives_up_after_reconnect_window",
    "test_drain_leaves_no_seq_hole_for_survivors",
    "test_wedged_worker_does_not_cascade_excisions",
    "test_truncated_snapshot_marks_joiner_unsynced",
    "test_cloud_schema_shows_epoch_and_workers",
    "test_drain_finishes_inflight_and_leaves_cleanly",
]


@pytest.mark.parametrize("name", MEMBERSHIP_CASES)
def test_membership_case_on_port(name, monkeypatch):
    _bind(monkeypatch, JTM)
    _port_cloud_env(monkeypatch)
    fn = getattr(JTM, name)
    srv = bc = None
    try:
        args = {}
        for p in inspect.signature(fn).parameters:
            if p == "monkeypatch":
                args[p] = monkeypatch
            elif p == "cloud_env":
                args[p] = None
            elif p == "elastic_server":
                from h2o3_tpu_torch.api.server import H2OServer
                bc, workers = JTM._start_elastic(2, _free_port())
                srv = H2OServer(port=0).start()
                srv.httpd.broadcaster = bc
                args[p] = (srv, bc, workers)
        fn(**args)
    finally:
        if srv is not None:
            srv.stop()
            bc.close()
        _port_cloud_teardown()


def test_epoch_bump_breaks_a_world_of_several():
    """An excision past formation leaves the world's process group short
    of a rank: the cloud records it and a collective raises WorldBroken
    instead of waiting on the dead peer."""
    from h2o3_tpu_torch.parallel import mesh, mrtask
    import torch
    c = mesh.init(device="cpu", rank=0, world=2, group=object())
    try:
        assert c.row_block(11) == (0, 6)
        assert c.row_block(11, rank=1) == (6, 11)
        TMB._mesh_epoch_listener(2, [])
        c2 = mesh.cloud()
        assert c2.epoch == 2 and "changed membership" in c2.broken
        with pytest.raises(mesh.WorldBroken):
            mrtask.shard_sum(torch.ones(3))
        from h2o3_tpu_torch.serving import qos
        assert qos.single_controller() is False
    finally:
        mesh.init(device="cpu")
        TMB.MEMBERSHIP.reset()


def test_stateless_handlers_run_outside_the_dispatch_order(monkeypatch):
    """Payload scoring runs outside the collective guard's dispatch order
    (api/server.py `stateless`; the worker replays it on a pool): a
    ticket taken there raises instead of pairing a collective out of
    order; outside it, tickets are taken as before."""
    from h2o3_tpu_torch.api import server as S
    from h2o3_tpu_torch.parallel import compat
    monkeypatch.setenv("H2O3_HOST_SERIALIZE", "1")
    assert S._h_predict_rows._stateless
    assert TMH._stateless_route("POST", "/3/Predictions/models/m1")
    assert not TMH._stateless_route("POST", "/3/Predictions/models/m1/"
                                    "frames/f1")
    with compat.collective_free():
        with pytest.raises(RuntimeError, match="dispatch order"):
            compat.reserve()
        with pytest.raises(RuntimeError, match="dispatch order"):
            with compat.region():
                pass
    t = compat.reserve()
    assert t is not None
    compat.release(t)


# ---------------------------------------------------------------------------
# divergence: a real worker loop replaying through the port's route table
@pytest.fixture()
def port_div_cloud(monkeypatch):
    from h2o3_tpu_torch.api import server as S
    _bind(monkeypatch, JTD)
    monkeypatch.setenv("H2O3_CLUSTER_SECRET", "divergence-test-secret")
    monkeypatch.setenv("H2O3_HEARTBEAT_S", "0")
    monkeypatch.setenv("H2O3_REPLAY_ACK_TIMEOUT_S", "5")
    monkeypatch.setenv("H2O3_REPLAY_RECONNECT_S", "0")
    monkeypatch.setenv("H2O3_DIVERGENCE", "1")

    def _temp_route(pattern, method, fn):
        row = (re.compile(pattern), method, fn)
        S.ROUTES.append(row)
        return row

    monkeypatch.setattr(JTD, "_temp_route", _temp_route)
    monkeypatch.setattr(JTD, "_drop_route", lambda row: S.ROUTES.remove(row))
    TMB.MEMBERSHIP.reset()
    TCHAOS.reset()
    port = _free_port()
    out = {}

    def _mk():
        out["bc"] = TMB.ElasticBroadcaster(1, port)

    t = threading.Thread(target=_mk, daemon=True)
    t.start()
    wt = threading.Thread(target=TMH.worker_loop, args=("127.0.0.1", port),
                          kwargs={"pid": 1}, daemon=True)
    wt.start()
    t.join(timeout=15)
    assert not t.is_alive() and "bc" in out
    srv = S.H2OServer(port=0).start()
    assert TDIV.active()
    srv.httpd.broadcaster = out["bc"]
    yield srv, out["bc"]
    srv.stop()
    out["bc"].close()
    wt.join(timeout=5)
    TDIV.disable()
    TMH._REPLICA[0] = False
    _port_cloud_teardown()


@pytest.mark.parametrize("name", [
    "test_deterministic_handlers_race_with_zero_mismatches",
    "test_seeded_host_divergent_write_is_caught_and_named",
    "test_log_mode_counts_but_does_not_fail_requests"])
def test_divergence_case_on_port(name, port_div_cloud, monkeypatch):
    fn = getattr(JTD, name)
    args = {"div_cloud": port_div_cloud}
    if "monkeypatch" in inspect.signature(fn).parameters:
        args["monkeypatch"] = monkeypatch
    fn(**args)


def test_divergence_riders_and_answers_on_port():
    """The rider protocol (JAX case) and the port's answer digest: the
    same scoring answer on both sides is one check, a different one a
    mismatch."""
    TDIV.enable("raise")
    try:
        checks, mism = TDIV._counters()
        c0, m0 = checks.value(), mism.value()
        for seq, worker_answer in ((11, [0.25, 0.75]), (12, [0.25, 0.7])):
            TDIV.replay_begin(seq, "/3/Predictions/models/m")
            TDIV.note_answer({"predictions": worker_answer})
            TDIV.replay_end()
            frame = TDIV.attach_riders({"ack": seq})
            TDIV.local_begin(seq, "/3/Predictions/models/m")
            TDIV.note_answer({"predictions": [0.25, 0.75]})
            TDIV.local_end()
            TDIV.note_remote(1, frame["div"])
        assert checks.value() == c0 + 2 and mism.value() == m0 + 1
        with pytest.raises(TDIV.DivergenceError, match="answer"):
            TDIV.raise_if_pending()
    finally:
        TDIV.disable()


# ---------------------------------------------------------------------------
# the parse fan-out
class _ParseWorker(JTM.FakeWorker):
    """A fake worker that serves the `parse:` collect op through the
    port's worker-side pipeline, as a live worker's _collect_local does."""

    def __init__(self, port, pid):
        self.served = 0
        super().__init__(port, pid)

    def _answer(self, msg):
        op = msg.get("op")
        if isinstance(op, str) and op.startswith("parse:"):
            spec = json.loads(op[len("parse:"):])
            share = (spec.get("shares") or {}).get(str(self.pid))
            res = TDP.worker_parse_chunks(
                {"sep": spec.get("sep", ","),
                 "header": spec.get("header", True), "chunks": share})
            self.served += len(res["chunks"])
            return {"host": self.pid, "parse": res}
        return super()._answer(msg)


def _mixed_csv(path, n, seed):
    rng = np.random.default_rng(seed)
    cats = np.array(["red", "green", "blue", "NA", "-0", "0"])
    with open(path, "w") as f:
        f.write("a,b,c,d\n")
        for i in range(n):
            f.write(f"{rng.normal():.6g},{cats[rng.integers(6)]},"
                    f"{int(rng.integers(-50, 50))},"
                    + ("" if i % 11 == 0 else f"{rng.uniform():.9g}")
                    + "\n")


def _same(a, b):
    assert a.names == b.names and a.nrows == b.nrows
    for va, vb in zip(a.vecs, b.vecs):
        assert va.type == vb.type and va.levels() == vb.levels()
        assert np.array_equal(va.as_f32().numpy().view(np.int32),
                              vb.as_f32().numpy().view(np.int32))


@pytest.mark.parametrize("chunk_bytes", [64, 1 << 10, 2048, 1 << 20])
def test_fanout_parse_equals_sequential(tmp_path, monkeypatch, chunk_bytes):
    _bind(monkeypatch, JTM)
    _port_cloud_env(monkeypatch, "ingest-test-secret")
    monkeypatch.setenv("H2O3_REPLAY_ACK_TIMEOUT_S", "5")
    p = str(tmp_path / "fan.csv")
    _mixed_csv(p, n=700, seed=21)
    local = TDP.parse_files([p], chunk_bytes=chunk_bytes)
    port = _free_port()
    out = {}
    t = threading.Thread(
        target=lambda: out.update(bc=TMB.ElasticBroadcaster(2, port)),
        daemon=True)
    t.start()
    workers = [_ParseWorker(port, pid) for pid in (1, 2)]
    t.join(timeout=15)
    bc = out["bc"]
    try:
        fanned = TDP.parse_files([p], chunk_bytes=chunk_bytes,
                                 broadcaster=bc)
        _same(local, fanned)
        plan = TDP.plan_chunks([p], chunk_bytes)
        if len(set(TDP._assign_chunks(plan, [0, 1, 2]) or [0])) > 1:
            assert sum(w.served for w in workers) > 0
        TKV.DKV.remove(fanned.key)
    finally:
        bc.close()
        for w in workers:
            w.kill()
        TKV.DKV.remove(local.key)
        _port_cloud_teardown()


def test_fanout_worker_timeout_falls_back_local(tmp_path, monkeypatch):
    """A worker that never answers its share forfeits the wave; the
    coordinator parses those chunks itself and the frame stays equal."""
    _bind(monkeypatch, JTM)
    _port_cloud_env(monkeypatch, "ingest-test-secret")
    monkeypatch.setenv("H2O3_PARSE_FANOUT_TIMEOUT_S", "1")
    p = str(tmp_path / "mute.csv")
    _mixed_csv(p, n=400, seed=8)
    local = TDP.parse_files([p], chunk_bytes=1024)
    port = _free_port()
    out = {}
    t = threading.Thread(
        target=lambda: out.update(bc=TMB.ElasticBroadcaster(2, port)),
        daemon=True)
    t.start()
    workers = [_ParseWorker(port, 1), JTM.FakeWorker(port, 2)]
    t.join(timeout=15)
    workers[1].muted = True
    bc = out["bc"]
    try:
        fanned = TDP.parse_files([p], chunk_bytes=1024, broadcaster=bc)
        _same(local, fanned)
        TKV.DKV.remove(fanned.key)
    finally:
        bc.close()
        for w in workers:
            w.kill()
        TKV.DKV.remove(local.key)
        _port_cloud_teardown()


def test_wire_codec_roundtrip_matches_jax():
    """The parse wire form is the JAX package's, bit exact both ways; a
    numeric column with -0.0 ships raw doubles without the integer
    codec's bias (the JAX packer keeps the bias there, and its restore
    shifts every value by it)."""
    from h2o3_tpu.io import dparse as JDP
    rng = np.random.default_rng(1)
    for num in (rng.normal(size=257), np.arange(100, dtype=np.float64),
                np.arange(0, 30000, 7, dtype=np.float64),
                np.full(64, np.nan), np.array([1e18, -1e18, 0.5, np.nan]),
                np.where(np.arange(90) % 7 == 0, np.nan,
                         np.arange(90, dtype=np.float64))):
        smap = {3: "abc", 17: "zw"} if len(num) > 17 else {}
        w = TDP._wire_pack_col(num, smap)
        assert json.dumps(w, sort_keys=True) == \
            json.dumps(JDP._wire_pack_col(num, smap), sort_keys=True)
        num2, smap2 = TDP._wire_restore_col(w)
        assert np.array_equal(num.view(np.int64), num2.view(np.int64))
        assert smap2 == smap
        jnum, jsmap = JDP._wire_restore_col(w)
        assert np.array_equal(jnum.view(np.int64), num2.view(np.int64))
    nz = np.array([-0.0, 0.0, 3.0])
    num2, _ = TDP._wire_restore_col(TDP._wire_pack_col(nz, {}))
    assert np.array_equal(nz.view(np.int64), num2.view(np.int64))
    jnum, _ = JDP._wire_restore_col(JDP._wire_pack_col(nz, {}))
    assert not np.array_equal(nz, jnum)
