"""The port's front-end modules against the JAX package's, on the CPU:
the estimator registry and its generated docs (models/param_docs.py),
auth (utils/auth.py), the sanitizers (analysis/sanitizers.py,
leaktrack.py, divergence.py), the on-demand profiler (obs/profiler.py),
`python -m h2o3_tpu_torch` (__main__.py) and the extension SPI (ext.py).

- ESTIMATORS: the same 21 keys; each class's generated Parameters
  section of `__doc__` equal to the JAX one's, character for character;
- auth: a basic file, LDAP simple bind against a local socket peer (the
  fake server of tests/test_auth.py) and a custom module answer the same
  (user, password) table as the JAX authenticators; a port server with a
  basic file answers 401 and WWW-Authenticate, then 200;
- sanitizers: `debug_nans` raises FloatingPointError naming the op on a
  NaN (on the CPU), also on a request thread once install_from_env armed
  it; `install_from_env` returns the JAX one's dict for the same
  variables; an unknown transfer-guard level raises;
- leaktrack: a leaked gate token is reported with its acquisition site,
  as the JAX one reports it, and a REST request leaves nothing open;
- divergence: the digests of the same DKV mutations equal the JAX ones;
- profiler: sampling writes its collapsed stacks, `auto` on the CPU takes
  torch.profiler (kind "torch", a Chrome trace), "jax" is refused, a
  second session is busy;
- __main__: the same options as the JAX CLI; H2O3_COORDINATOR_ADDRESS
  without H2O3_NUM_PROCESSES raises; without a card it raises rather
  than serving on the CPU;
- the extension SPI: an extension's estimator, route and prim are live.
"""

import gc
import json
import sys
import threading
import time
import types
import urllib.request

import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
import h2o3_tpu_torch.models as TMODELS
from h2o3_tpu import __main__ as JMAIN
from h2o3_tpu.analysis import divergence as JDIV
from h2o3_tpu.analysis import leaktrack as JLTK
from h2o3_tpu.analysis import lockdep as JLOCKDEP
from h2o3_tpu.analysis import sanitizers as JSAN
from h2o3_tpu.core.kvstore import DKV as JDKV
from h2o3_tpu.serving import qos as JQ
from h2o3_tpu.utils import auth as JA
from h2o3_tpu_torch import __main__ as TMAIN
from h2o3_tpu_torch.analysis import divergence as TDIV
from h2o3_tpu_torch.analysis import leaktrack as TLTK
from h2o3_tpu_torch.analysis import lockdep as TLOCKDEP
from h2o3_tpu_torch.analysis import sanitizers as TSAN
from h2o3_tpu_torch.core.kvstore import DKV as TDKV
from h2o3_tpu_torch.obs import profiler as TPROF
from h2o3_tpu_torch.obs import watchdog as TWD
from h2o3_tpu_torch.serving import qos as TQ
from h2o3_tpu_torch.utils import auth as TA

from test_auth import FakeLdap
from test_torch_rest import jax_extension_parts


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    TWD.reset()
    h2o3_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
def _params_section(doc):
    return doc[doc.index("\nParameters\n"):] if doc else doc


def test_estimators_registry_and_docs_match_jax():
    _, ext_algos = jax_extension_parts()
    jest = {a: c for a, c in JMODELS.ESTIMATORS.items()
            if a not in ext_algos}
    assert sorted(TMODELS.ESTIMATORS) == sorted(jest)
    assert len(TMODELS.ESTIMATORS) == 21
    for algo, jcls in jest.items():
        tcls = TMODELS.ESTIMATORS[algo]
        assert tcls.__name__ == jcls.__name__
        assert _params_section(tcls.__doc__) == \
            _params_section(jcls.__doc__), algo


# ---------------------------------------------------------------------------
CREDS = [("alice", "s3cret"), ("alice", "wrong"), ("bob", "s3cret"),
         ("alice", ""), ("", ""), ("u2", "p2"), ("u2", "p1")]


def test_basic_and_custom_authenticators_match_jax():
    table = {"u1": "p1", "u2": "p2", "alice": "s3cret"}
    for a, b in ((JA.BasicAuthenticator(table),
                  TA.BasicAuthenticator(table)),):
        assert [a.authenticate(u, p) for u, p in CREDS] == \
            [b.authenticate(u, p) for u, p in CREDS]
    mod = types.ModuleType("front_auth_mod")
    mod.authenticate = lambda u, p: u == "svc" and p == "tok"
    sys.modules["front_auth_mod"] = mod
    try:
        ja = JA.CustomAuthenticator("front_auth_mod")
        ta = TA.CustomAuthenticator("front_auth_mod")
        creds = CREDS + [("svc", "tok"), ("svc", "no")]
        assert [ja.authenticate(u, p) for u, p in creds] == \
            [ta.authenticate(u, p) for u, p in creds]
    finally:
        del sys.modules["front_auth_mod"]


def test_ldap_bind_against_a_local_peer_matches_jax():
    srv = FakeLdap("uid=alice,ou=people,dc=ex,dc=com", "s3cret")
    try:
        tmpl = "uid={user},ou=people,dc=ex,dc=com"
        ja = JA.LdapAuthenticator("127.0.0.1", srv.port, bind_template=tmpl)
        ta = TA.LdapAuthenticator("127.0.0.1", srv.port, bind_template=tmpl)
        got = [ta.authenticate(u, p) for u, p in CREDS]
        assert got == [ja.authenticate(u, p) for u, p in CREDS]
        assert got[0] and not any(got[1:])
    finally:
        srv.close()
    assert not TA.LdapAuthenticator("127.0.0.1", 1,
                                    timeout=0.3).authenticate("a", "b")


def test_resolve_authenticator_rejects_as_jax(monkeypatch):
    for method in ("kerberos", "pam", "spnego", "nope"):
        monkeypatch.setenv("H2O3_TPU_API_AUTH_METHOD", method)
        errs = []
        for mod in (JA, TA):
            with pytest.raises((NotImplementedError, ValueError)) as ei:
                mod.resolve_authenticator()
            errs.append(type(ei.value))
        assert errs[0] is errs[1], method


def test_server_basic_auth_file(port_cpu, tmp_path):
    from h2o3_tpu_torch.api.server import H2OServer
    f = tmp_path / "realm.properties"
    f.write_text("# users\ngold:g1\nsilver:s1\n")
    s = H2OServer(port=0, auth=str(f)).start()
    try:
        url = f"http://127.0.0.1:{s.port}/3/Cloud"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=30)
        assert ei.value.code == 401
        assert ei.value.headers["WWW-Authenticate"].startswith("Basic")
        import base64
        r = urllib.request.Request(url, headers={
            "Authorization": "Basic " + base64.b64encode(b"silver:s1")
            .decode()})
        with urllib.request.urlopen(r, timeout=30) as resp:
            assert resp.status == 200
    finally:
        s.stop()


def test_bind_beyond_loopback_needs_auth(port_cpu, monkeypatch):
    from h2o3_tpu_torch.api.server import H2OServer
    monkeypatch.delenv("H2O3_INSECURE_BIND_ALL", raising=False)
    with pytest.raises(RuntimeError, match="without authentication"):
        H2OServer(port=0, host="0.0.0.0")


# ---------------------------------------------------------------------------
def test_debug_nans_raises_naming_the_op():
    x = torch.tensor([1.0, -1.0])
    with TSAN.debug_nans():
        torch.sqrt(x.abs())                     # no NaN: no raise
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(x)
    assert torch.isnan(torch.sqrt(x)).any()     # off again outside
    with TSAN.debug_nans(False):
        torch.sqrt(x)


def test_transfer_guard_levels():
    for level in ("disallow", "log", "allow"):
        with TSAN.transfer_guard(level):
            torch.ones(2).sum().item()          # no card: nothing guarded
    with pytest.raises(ValueError, match="transfer guard"):
        with TSAN.transfer_guard("disallow_explicit"):
            pass


SAN_ENV = {"H2O3_LOCKDEP": "log", "H2O3_DIVERGENCE": "log",
           "H2O3_LEAKTRACK": "log", "H2O3_DEBUG_NANS": "1",
           "H2O3_TRANSFER_GUARD": "log"}


def test_install_from_env_matches_jax(monkeypatch):
    import jax
    prev = (jax.config.jax_debug_nans, jax.config.jax_transfer_guard)
    for k, v in SAN_ENV.items():
        monkeypatch.setenv(k, v)
    try:
        jd = JSAN.install_from_env()
        td = TSAN.install_from_env()
        assert td == jd
        assert TSAN._process_nans
        # request and job threads enter thread_scope(): debug_nans holds
        # there too, although torch keeps its modes per thread
        out = {}

        def work():
            with TSAN.thread_scope():
                try:
                    torch.log(torch.tensor([-1.0]))
                except FloatingPointError as ex:
                    out["err"] = str(ex)
        t = threading.Thread(target=work)
        t.start()
        t.join()
        assert "log" in out["err"]
        from h2o3_tpu_torch.core.jobs import FAILED, Job
        job = Job("nan job").start(
            lambda j: torch.log(torch.tensor([-1.0])))
        job._done.wait(30)
        assert job.status == FAILED
        assert isinstance(job.exception, FloatingPointError)
    finally:
        TSAN._process_nans = False
        jax.config.update("jax_debug_nans", prev[0])
        jax.config.update("jax_transfer_guard", prev[1])
        for mod in (JLOCKDEP, TLOCKDEP, JDIV, TDIV, JLTK, TLTK):
            mod.disable()
    for k in SAN_ENV:
        monkeypatch.delenv(k)
    assert JSAN.install_from_env() == TSAN.install_from_env() == {}


# ---------------------------------------------------------------------------
def test_leaked_gate_token_reported_with_its_site():
    reps = []
    for ltk, qos in ((JLTK, JQ), (TLTK, TQ)):
        ltk.enable("raise")
        try:
            took = qos.GATE.acquire("lt_front", 1)
            assert took
            site = took.site
            assert ltk.open_counts().get("qos.gate") == 1
            del took                            # dies unreleased
            gc.collect()
            assert ltk.reports()[-1] == ("qos.gate", site)
            assert __file__ in site             # names the caller
            with pytest.raises(ltk.LeakError, match="qos.gate"):
                ltk.raise_if_pending()
            ltk.raise_if_pending()              # consumed
            qos.GATE.release(True)              # the real slot
            reps.append(ltk.reports()[-1][0])
        finally:
            ltk.disable()
    assert reps == ["qos.gate", "qos.gate"]


def test_rest_requests_leave_no_leak(port_cpu):
    from h2o3_tpu_torch.api.server import H2OServer
    TLTK.enable("raise")
    s = H2OServer(port=0).start()
    try:
        for path in ("/3/Cloud", "/3/Jobs", "/metrics"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{s.port}{path}", timeout=30) as r:
                assert r.status == 200
        deadline = time.monotonic() + 5.0
        while TLTK.open_counts() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert TLTK.open_counts() == {}
        assert TLTK.reports() == []
    finally:
        s.stop()
        TLTK.disable()


# ---------------------------------------------------------------------------
def _mutate(dkv):
    dkv.put("_div_front_a", 3.0)
    dkv.put("_div_front_b", {"x": [1, 2], "y": "s"})
    dkv.put("_div_front_a", 4.0)
    dkv.remove("_div_front_b")
    dkv.put("_div_front_c", "text")


def test_divergence_digests_match_jax():
    summaries = []
    for div, dkv in ((JDIV, JDKV), (TDIV, TDKV)):
        div.enable("log")
        try:
            div._record("put", "k", 1)          # no scope: ignored
            div.local_begin(11, "/3/Front")
            _mutate(dkv)
            div.local_end()
            summaries.append(dict(div._local[11]))
        finally:
            div.disable()
            for k in ("_div_front_a", "_div_front_c"):
                dkv.remove(k)
    assert summaries[0] == summaries[1]
    assert summaries[1]["n"] == 5
    from h2o3_tpu_torch.core import kvstore
    assert kvstore._div_hook is None


# ---------------------------------------------------------------------------
def test_profiler_sampling(tmp_path):
    out = TPROF.PROFILER.start(trace_dir=str(tmp_path / "s"),
                               kind="sampling")
    assert out["kind"] == "sampling"
    time.sleep(0.1)
    st = TPROF.PROFILER.stop()
    assert st["kind"] == "sampling" and st["samples"] > 0
    text = open(st["artifact"]).read()
    assert text.strip() and text.split("\n")[0].rsplit(" ", 1)[1].isdigit()


def test_profiler_auto_on_the_cpu_takes_torch(tmp_path):
    with pytest.raises(ValueError, match="auto|torch|sampling"):
        TPROF.PROFILER.start(kind="jax")
    out = TPROF.PROFILER.start(trace_dir=str(tmp_path / "a"))
    try:
        assert out["kind"] == "torch"
        with pytest.raises(TPROF.ProfilerBusy):
            TPROF.PROFILER.start(kind="sampling")
        assert TPROF.PROFILER.status()["active"]
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    finally:
        st = TPROF.PROFILER.stop()
    assert st["kind"] == "torch" and "error" not in st
    trace = json.load(open(st["trace"]))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("matmul" in n or "mm" in n for n in names)
    with pytest.raises(TPROF.ProfilerIdle):
        TPROF.PROFILER.stop()


# ---------------------------------------------------------------------------
def _options(parser):
    return sorted((tuple(a.option_strings), a.default)
                  for a in parser._actions if a.option_strings)


def test_main_options_match_jax():
    assert _options(TMAIN.build_parser()) == _options(JMAIN.build_parser())


def test_main_multihost_raises(monkeypatch):
    """A coordinator address without the world's size raises: a process
    asked for a cloud never carries on as a cloud of one."""
    monkeypatch.setenv("H2O3_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.delenv("H2O3_NUM_PROCESSES", raising=False)
    with pytest.raises(RuntimeError, match="H2O3_NUM_PROCESSES"):
        TMAIN.main(["-port", "0"])


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("H2O3_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMAIN.main(["-port", "0"])
    with pytest.raises(ValueError, match="one device"):
        TMAIN.main(["-port", "0", "-n_rows_shards", "8"])
    h2o3_tpu_torch.init(device="cpu")


# ---------------------------------------------------------------------------
def test_extension_spi(port_cpu):
    from h2o3_tpu_torch import ext as EXT
    from h2o3_tpu_torch.api import server as S
    from h2o3_tpu_torch.models.glm import H2OGeneralizedLinearEstimator
    from h2o3_tpu_torch.rapids.rapids import PRIMS, rapids_exec
    from h2o3_tpu_torch.utils import config as _cfg

    class MyGLM(H2OGeneralizedLinearEstimator):
        algo = "myglm"

    def _h_hello(h):
        h._send({"__meta": {"schema_type": "HelloV99"}, "hello": "cuda"})

    inited = {}
    mod = types.ModuleType("front_ext_mod")
    sys.modules["front_ext_mod"] = mod
    mod.EXT = EXT.register_extension(EXT.H2OExtension(
        name="front-ext", estimators={"myglm": MyGLM},
        routes=[(r"/99/FrontHello", "GET", _h_hello)],
        rapids={"front_answer": lambda *a: 42.0},
        init=lambda cloud: inited.setdefault("cloud", cloud)))
    _cfg.set_property("extensions", "front_ext_mod")
    s = None
    try:
        assert any(e.name == "front-ext" for e in EXT.extensions())
        assert TMODELS.ESTIMATORS["myglm"] is MyGLM
        assert rapids_exec("(front_answer)") == 42.0
        c = h2o3_tpu_torch.init(device="cpu")     # fires the init hook
        assert inited["cloud"] is c
        s = S.H2OServer(port=0).start()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{s.port}/99/FrontHello") as r:
            assert json.loads(r.read())["hello"] == "cuda"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{s.port}/3/ModelBuilders") as r:
            assert "myglm" in json.loads(r.read())["model_builders"]
    finally:
        if s is not None:
            s.stop()
        _cfg.set_property("extensions", "")
        del sys.modules["front_ext_mod"]
        TMODELS.ESTIMATORS.pop("myglm", None)
        PRIMS.pop("front_answer", None)
        S.ROUTES[:] = [r for r in S.ROUTES if r[2] is not _h_hello]
        EXT._EXTENSIONS.pop("front-ext", None)
