"""The port's static analyzer (h2o3_tpu_torch/analysis/) on the CPU.

(a) Every rule the two packages share (R003, R005-R013, R015-R024) finds
    the same (rule, file, line, waived) set in both engines, on the
    seeded-defect and clean sources of the JAX analyzer's tests
    (tests/torch_analysis_cases.py), their `h2o3_tpu` paths mapped to
    `h2o3_tpu_torch`. Three of those sources seed a JAX device sync
    (`jax.device_get`, `block_until_ready`), a word the port's sync
    vocabulary does not hold: (b) seeds their torch counterparts.
(b) The five ids the port redefines (R001, R002, R004, R014, R025) and
    the torch syncs of R008/R015, seeded and clean.
(c) The port's gate: the CLI exits 0 with no unsuppressed finding over
    the package and tests/test_torch_*.py, with no baseline; the four
    censuses are committed and current, and `--check-census` exits 1 on
    a stale copy.
(d) The names in each census equal the JAX package's, but for the
    differences listed in CENSUS_DIFFERENCES.
Then the repairs (dparse's ingest counters and spans, the re-home gauge)
against the JAX package, and a test for each finding the triage fixed.
"""

import collections
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu.analysis import engine as JE
from h2o3_tpu_torch.analysis import engine as TE
from torch_analysis_cases import CASES

REPO = TE.repo_root()
SHARED = {"R003"} | {f"R{n:03d}" for n in range(5, 14)} | \
    {f"R{n:03d}" for n in range(15, 25)}
# JAX sources whose defect is a JAX device sync (no torch meaning)
VOCABULARY = {
    "analysis_v2.test_r015_detects_sync_hidden_behind_helper_in_span.1",
    "analysis_v2.test_r015_suppression_and_test_relaxation.1",
    "concurrency_analysis.test_r008_detects_device_sync_under_lock.1",
}


def _port(s: str) -> str:
    return re.sub(r"\bh2o3_tpu\b(?!_)", "h2o3_tpu_torch", s)


# ---------------------------------------------------------------------------
# (a) parity of every shared rule
@pytest.mark.parametrize("srcs", [c[1] for c in CASES
                                  if c[0] not in VOCABULARY],
                         ids=[c[0] for c in CASES if c[0] not in VOCABULARY])
def test_shared_rule_parity(srcs):
    want = {(f.rule, _port(f.file), f.line, f.suppressed)
            for f in JE.analyze_sources(srcs) if f.rule in SHARED}
    got = {(f.rule, f.file, f.line, f.suppressed)
           for f in TE.analyze_sources(
               {_port(k): _port(v) for k, v in srcs.items()})
           if f.rule in SHARED}
    assert got == want


def test_parity_cases_cover_every_shared_rule():
    hit = {f.rule for _, srcs in CASES
           for f in JE.analyze_sources(srcs) if f.rule in SHARED}
    assert hit == SHARED
    assert len(CASES) - len(VOCABULARY) >= 100
    assert VOCABULARY <= {c[0] for c in CASES}


# ---------------------------------------------------------------------------
# (b) the torch rules: (id, file, source, rule, {expected lines})
SCORER = "h2o3_tpu_torch/models/fx_scorer.py"
TORCH_CASES = [
    # R001: a program built per call
    ("r001_graph_outside_cache", "h2o3_tpu_torch/models/fx.py",
     "import torch\n"
     "def score(x):\n"
     "    g = torch.cuda.CUDAGraph()\n"
     "    with torch.cuda.graph(g):\n"
     "        pass\n", "R001", {3, 4}),
    ("r001_graph_in_scorer_cache_clean",
     "h2o3_tpu_torch/serving/scorer_cache.py",
     "import torch\n"
     "class _Program:\n"
     "    def _capture(self):\n"
     "        self._graph = torch.cuda.CUDAGraph()\n", "R001", set()),
    ("r001_compile_in_body", "h2o3_tpu_torch/models/fx.py",
     "import torch\n"
     "def f(x):\n"
     "    return x + 1\n"
     "def hot(x):\n"
     "    return torch.compile(f)(x)\n", "R001", {5}),
    ("r001_compile_at_module_level_clean", "h2o3_tpu_torch/models/fx.py",
     "import torch\n"
     "def f(x):\n"
     "    return x + 1\n"
     "F = torch.compile(f)\n", "R001", set()),
    ("r001_cdll_outside_build", "h2o3_tpu_torch/io/fx.py",
     "import ctypes\n"
     "def load(p):\n"
     "    return ctypes.CDLL(p)\n", "R001", {3}),
    ("r001_cdll_in_build_clean", "h2o3_tpu_torch/ops/_build.py",
     "import ctypes\n"
     "def load(p):\n"
     "    return ctypes.CDLL(p)\n", "R001", set()),
    # R002: host syncs in the capture scope and in span blocks
    ("r002_syncs_in_scorer", SCORER,
     "import numpy as np\n"
     "import torch\n"
     "class M:\n"
     "    def _score_matrix(self, X):\n"
     "        n = X.sum().item()\n"
     "        h = X.cpu()\n"
     "        a = np.asarray(torch.exp(X))\n"
     "        torch.cuda.synchronize()\n"
     "        return X * float(torch.max(X))\n", "R002", {5, 6, 7, 8, 9}),
    ("r002_nested_def_in_scope", SCORER,
     "class M:\n"
     "    def _score_with_params(self, params, X):\n"
     "        def inner(a):\n"
     "            return a.tolist()\n"
     "        return inner(X)\n", "R002", {4}),
    ("r002_host_copy_of_unplaced_attr", SCORER,
     "import torch\n"
     "class M:\n"
     "    _serving_param_attrs = ('_beta',)\n"
     "    def _score_matrix(self, X):\n"
     "        b = torch.as_tensor(self._beta, device=X.device)\n"
     "        B = torch.as_tensor(self._B, device=X.device)\n"
     "        c = torch.tensor([1.0], device=X.device)\n"
     "        return X @ b + B.sum() + c\n", "R002", {6, 7}),
    ("r002_outside_scope_clean", SCORER,
     "import torch\n"
     "class M:\n"
     "    def predict(self, X):\n"
     "        return self._score_matrix(X).cpu().numpy()\n"
     "    def _score_matrix(self, X):\n"
     "        return torch.sigmoid(X)\n", "R002", set()),
    ("r002_capture_body", "h2o3_tpu_torch/serving/scorer_cache.py",
     "import torch\n"
     "def capture(g, fn, x):\n"
     "    g.capture_begin()\n"
     "    try:\n"
     "        out = fn(x).item()\n"
     "    finally:\n"
     "        g.capture_end()\n"
     "    y = out.cpu()\n"
     "    with torch.cuda.graph(g):\n"
     "        z = x.numpy()\n"
     "    return y, z\n", "R002", {5, 10}),
    ("r002_barriers_in_span", "h2o3_tpu_torch/models/fx.py",
     "import torch\n"
     "from h2o3_tpu_torch.obs.timeline import span\n"
     "from h2o3_tpu_torch.parallel.mrtask import host_fetch\n"
     "def hot(x, ev):\n"
     "    with span('fx.phase'):\n"
     "        torch.cuda.synchronize()\n"
     "        ev.synchronize()\n"
     "        n = int(torch.sum(x))\n"
     "        return host_fetch(x), n\n", "R002", {6, 7, 8, 9}),
    # R004: impure under capture
    ("r004_impure_in_scorer", SCORER,
     "import random\n"
     "import time\n"
     "import torch\n"
     "STATE = 0\n"
     "class M:\n"
     "    def _score_matrix(self, X, gen=None):\n"
     "        global STATE\n"
     "        t = time.time()\n"
     "        r = random.random()\n"
     "        noise = torch.rand(X.shape)\n"
     "        fine = torch.randn(X.shape, generator=gen)\n"
     "        return X + t + r + noise + fine\n", "R004", {7, 8, 9, 10}),
    ("r004_outside_scope_clean", SCORER,
     "import time\n"
     "import torch\n"
     "def fit(X):\n"
     "    t0 = time.time()\n"
     "    return torch.rand(X.shape), t0\n", "R004", set()),
    # R014: collectives outside the guard
    ("r014_unguarded", "h2o3_tpu_torch/models/fx.py",
     "import torch.distributed as dist\n"
     "def reduce(t):\n"
     "    dist.all_reduce(t)\n"
     "    dist.barrier()\n"
     "    dist.broadcast_object_list([t])\n", "R014", {3, 4, 5}),
    ("r014_guarded_shapes_clean", "h2o3_tpu_torch/parallel/fx.py",
     "import torch\n"
     "import torch.distributed as dist\n"
     "from h2o3_tpu_torch.parallel import compat\n"
     "def _guarded():\n"
     "    return compat.host_collective_guard()\n"
     "def a(t):\n"
     "    with compat.host_collective_guard():\n"
     "        dist.all_reduce(t)\n"
     "def b(t):\n"
     "    with _guarded():\n"
     "        dist.all_gather([t], t)\n"
     "@compat.guard_collective\n"
     "def c(t):\n"
     "    torch.distributed.barrier()\n"
     "def d(t, ticket):\n"
     "    with compat.train_guard(ticket):\n"
     "        dist.gather(t)\n"
     "    with compat.region():\n"
     "        dist.scatter(t)\n", "R014", set()),
    ("r014_compat_exempt", "h2o3_tpu_torch/parallel/compat.py",
     "import torch.distributed as dist\n"
     "def f(t):\n"
     "    dist.all_reduce(t)\n", "R014", set()),
    ("r014_init_process_group_in_multihost", "h2o3_tpu_torch/deploy/"
     "multihost.py",
     "import torch.distributed as dist\n"
     "def boot():\n"
     "    dist.init_process_group('gloo')\n"
     "    dist.barrier()\n", "R014", {4}),
    ("r014_init_process_group_elsewhere", "h2o3_tpu_torch/deploy/fx.py",
     "from torch.distributed import init_process_group\n"
     "def boot():\n"
     "    init_process_group('gloo')\n", "R014", {3}),
    ("r014_tests_out_of_scope", "tests/test_torch_fx.py",
     "import torch.distributed as dist\n"
     "def test_x(t):\n"
     "    dist.all_reduce(t)\n", "R014", set()),
    # R025: the capture contract over the scorer family
    ("r025_module_tensor_and_branches", SCORER,
     "import torch\n"
     "SCALE = torch.ones(3)\n"
     "class M:\n"
     "    def _score_matrix(self, X):\n"
     "        if X.sum():\n"
     "            X = X * 2\n"
     "        k = float(X)\n"
     "        return _helper(X) * k\n"
     "def _helper(Z):\n"
     "    if bool(Z):\n"
     "        return Z\n"
     "    return Z * SCALE\n", "R025", {5, 7, 10, 12}),
    ("r025_static_dispatch_clean", SCORER,
     "import torch\n"
     "class M:\n"
     "    def _score_with_params(self, params, X, link='logit',\n"
     "                           offset=None):\n"
     "        if X.shape[0] == 0:\n"
     "            return X\n"
     "        if X.dtype == torch.float64:\n"
     "            X = X.float()\n"
     "        if link == 'logit':\n"
     "            X = torch.sigmoid(X)\n"
     "        if offset is None:\n"
     "            return X\n"
     "        return X + offset\n", "R025", set()),
    # R008 / R015: the torch syncs, interprocedural
    ("r008_device_sync_under_lock", "h2o3_tpu_torch/fix_d.py",
     "import threading\n"
     "import torch\n"
     "class S:\n"
     "    def __init__(self):\n"
     "        self._lock = threading.Lock()\n"
     "    def bad(self, ev):\n"
     "        with self._lock:\n"
     "            torch.cuda.synchronize()\n"
     "            ev.synchronize()\n"
     "    def ok(self, x):\n"
     "        with self._lock:\n"
     "            return x.cpu()\n", "R008", {8, 9}),
    ("r015_sync_behind_helper_in_span", "h2o3_tpu_torch/fx_r015.py",
     "import torch\n"
     "from h2o3_tpu_torch.obs.timeline import span\n"
     "def _readback(x):\n"
     "    return x.sum().item()\n"
     "def hot(x):\n"
     "    with span('fx.dispatch'):\n"
     "        return _readback(x)\n", "R015", {7}),
    ("r015_serving_path_explicit_staging", "h2o3_tpu_torch/serving/fx.py",
     "def _stage(x):\n"
     "    return x.cpu().numpy()\n"
     "def _peek(x):\n"
     "    return x.max().item()\n"
     "def dispatch(x):\n"
     "    a = _stage(x)\n"
     "    return a, _peek(x)\n", "R015", {7}),
    ("r015_waived", "h2o3_tpu_torch/fx_r015c.py",
     "from h2o3_tpu_torch.obs.timeline import span\n"
     "def _readback(x):\n"
     "    return x.tolist()\n"
     "def hot(x):\n"
     "    with span('fx.dispatch'):\n"
     "        # h2o3-ok: R015 the readback IS the work here\n"
     "        return _readback(x)\n", "R015", set()),
]


@pytest.mark.parametrize("fname,src,rule,lines",
                         [c[1:] for c in TORCH_CASES],
                         ids=[c[0] for c in TORCH_CASES])
def test_torch_rule(fname, src, rule, lines):
    found = [f for f in TE.analyze_sources({fname: src})
             if f.rule == rule and not f.suppressed]
    assert {f.line for f in found} == lines, [str(f) for f in found]


def test_torch_rules_relaxed_in_tests():
    src = ("import torch\n"
           "def test_x(x):\n"
           "    return torch.compile(lambda a: a)(x)\n")
    assert not [f for f in TE.analyze_source(src, "tests/test_torch_fx.py")
                if f.rule in ("R001", "R004")]
    assert [f for f in TE.analyze_source(src, "h2o3_tpu_torch/fx.py")
            if f.rule == "R001"]


def test_capture_verdicts_of_the_scorer_families():
    """GLRM's program strikes (its archetypes are a host array copied per
    call, and its batched solve synchronises): one waived R002 finding in
    the capture scope; GBM, GLM, DL and KMeans have none, so their
    programs must capture (tests/test_torch_gpu.py, chip_smoke.py's run
    (bi) hold both against the card)."""
    from h2o3_tpu_torch.analysis import rules_torch
    v = rules_torch.capture_verdicts(
        TE.run([TE.package_root()], rules=["R002", "R025"]))
    assert set(v) == {"gbm", "glm", "deeplearning", "kmeans", "glrm"}
    assert not any(v[f] for f in ("gbm", "glm", "deeplearning", "kmeans"))
    assert [(d["rule"], d["file"], d["suppressed"]) for d in v["glrm"]] == \
        [("R002", "h2o3_tpu_torch/models/glrm.py", True)]
    # a span barrier is no capture finding
    assert not rules_torch.is_capture_finding(
        "R002", "torch.cuda.synchronize() inside a timeline.span block")


def test_walks_take_only_the_ports_tests_and_no_build_output(tmp_path):
    mods = TE.load_modules([TE.tests_root()])
    names = {os.path.basename(m.path) for m in mods}
    assert names and all(n.startswith("test_torch_") for n in names)
    assert "test_torch_analysis.py" in names
    (tmp_path / "ops" / "build" / "tree").mkdir(parents=True)
    (tmp_path / "ops" / "build" / "tree" / "copy.py").write_text("x = 1\n")
    (tmp_path / "ops" / "kept.py").write_text("y = 2\n")
    assert [os.path.basename(m.path) for m in TE.load_modules(
        [str(tmp_path)])] == ["kept.py"]


# ---------------------------------------------------------------------------
# (c) the port's gate and its censuses
@pytest.fixture(scope="module")
def cli_run():
    out = subprocess.run(
        [sys.executable, "-m", "h2o3_tpu_torch.analysis",
         TE.package_root(), TE.tests_root(), "--json", "--check-census"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    return out


def test_cli_gate_zero_unsuppressed(cli_run):
    assert cli_run.returncode == 0, cli_run.stdout[-4000:] + cli_run.stderr
    payload = json.loads(cli_run.stdout)
    assert payload["unsuppressed"] == 0
    assert payload["files_analyzed"] > 150
    assert not os.path.exists(os.path.join(TE.package_root(),
                                           "analysis_baseline.json"))


CENSUSES = (("obs", "METRICS.md"), ("obs", "SPANS.md"),
            ("analysis", "ENV.md"), ("deploy", "PROTOCOL.md"))


def _census_bodies(root):
    from h2o3_tpu_torch.analysis import rules_env, rules_metrics, \
        rules_protocol, rules_spans
    mods = TE.load_modules([root])
    return [rules_metrics.census_markdown(mods),
            rules_spans.census_markdown(mods),
            rules_env.census_markdown(mods),
            rules_protocol.census_markdown(mods)]


def test_censuses_committed_and_current():
    for (d, name), body in zip(CENSUSES, _census_bodies(TE.package_root())):
        path = os.path.join(TE.package_root(), d, name)
        with open(path, encoding="utf-8") as fh:
            assert fh.read() == body, \
                f"stale {name}: python -m h2o3_tpu_torch.analysis " \
                "--write-census"


@pytest.mark.parametrize("census", [c[1] for c in CENSUSES])
def test_check_census_exits_1_on_stale_copy(census, tmp_path,
                                            monkeypatch):
    from h2o3_tpu_torch.analysis import __main__ as cli
    pkg = tmp_path / "h2o3_tpu_torch"
    shutil.copytree(TE.package_root(), pkg, ignore=shutil.ignore_patterns(
        "build", "__pycache__", "csrc", "*.so"))
    shutil.copy(os.path.join(REPO, "README.md"), tmp_path / "README.md")
    monkeypatch.setattr(TE, "package_root", lambda: str(pkg))
    assert cli.main(["--check-census", "--rules", "R017"]) == 0
    d = dict((n, d) for d, n in CENSUSES)[census]
    with open(pkg / d / census, "a", encoding="utf-8") as fh:
        fh.write("\nstale marker\n")
    assert cli.main(["--check-census", "--rules", "R017"]) == 1


REDEFINED = {"R001", "R002", "R004", "R014", "R025"}


def test_sarif_matches_the_jax_emitter():
    """The same findings give the same SARIF results; the catalog has
    every rule, with the JAX text for each shared one."""
    from h2o3_tpu.analysis import sarif as JS
    from h2o3_tpu_torch.analysis import sarif as TS
    made = []
    for E in (JE, TE):
        f1 = E.Finding("R019", "deploy/fx.py", 12, "seeded message one")
        f1.snippet = "self._state['k'] = os.getpid()"
        f2 = E.Finding("R021", "io/fx.py", 30, "seeded message two",
                       suppressed=True)
        f2.snippet = "z['extra']"
        f3 = E.Finding("R005", "obs/fx.py", 7, "seeded message three")
        f3.snippet = "counter(name)"
        f3.baselined = True
        made.append([f1, f2, f3])
    j, t = JS.to_sarif(made[0]), TS.to_sarif(made[1])
    assert t["runs"][0]["results"] == j["runs"][0]["results"]
    assert set(TS.RULE_SUMMARIES) == {f"R{i:03d}" for i in range(1, 26)}
    for rule, text in JS.RULE_SUMMARIES.items():
        assert (TS.RULE_SUMMARIES[rule] == text) == (rule not in REDEFINED)


def test_cli_exit_1_and_sarif_on_a_seeded_defect(tmp_path):
    from h2o3_tpu_torch.analysis import __main__ as cli
    seed = tmp_path / "fx_sarif.py"
    seed.write_text(
        "import numpy as np\n"
        "def save(p, d):\n"
        "    np.savez(p, data=d)\n"
        "def load(p):\n"
        "    z = np.load(p)\n"
        "    return z['other']\n")
    out_path = tmp_path / "out.sarif"
    assert cli.main([str(seed), "--rules", "R021", "--sarif",
                     str(out_path)]) == 1
    log = json.loads(out_path.read_text())
    assert log["version"] == "2.1.0"
    assert {r["ruleId"] for r in log["runs"][0]["results"]} == {"R021"}


def test_cli_baseline_round_trip(tmp_path):
    """--write-baseline grandfathers a finding; --baseline then exits 0;
    without it the finding fails the run again."""
    from h2o3_tpu_torch.analysis import __main__ as cli
    seed = tmp_path / "fx_base.py"
    seed.write_text("import threading\n"
                    "def leak():\n"
                    "    threading.Thread(target=print).start()\n")
    base = tmp_path / "baseline.json"
    args = [str(seed), "--rules", "R010"]
    assert cli.main(args + ["--baseline", str(base),
                            "--write-baseline"]) == 0
    assert len(json.loads(base.read_text())["findings"]) == 1
    assert cli.main(args + ["--baseline", str(base)]) == 0
    assert cli.main(args) == 1


# ---------------------------------------------------------------------------
# (d) census parity with the JAX package
CENSUS_DIFFERENCES = {
    # the port captures CUDA graphs where the JAX package compiles XLA
    "METRICS.md": ({"h2o3_xla_compiles_total",
                    "h2o3_xla_compile_seconds_total",
                    "h2o3_xla_compile_cache_hits_total",
                    "h2o3_xla_compile_cache_misses_total"},
                   {"h2o3_cuda_graph_captures_total",
                    "h2o3_cuda_graph_capture_seconds",
                    # the hist.cu kernels' launch counts
                    "h2o3_hist_kernel_launches",
                    # the gloo world's all-reduces and row gathers
                    "h2o3_allreduce_bytes", "h2o3_allreduce_seconds",
                    "h2o3_allreduce_calls", "h2o3_gather_bytes",
                    "h2o3_gather_seconds", "h2o3_gather_calls"}),
    "SPANS.md": (set(), set()),
    # the port builds no native/ directory's libraries from a path, and
    # chooses its device, its replacement rank and its gloo timeout
    "ENV.md": ({"H2O3_NATIVE_DIR"},
               {"H2O3_DEVICE", "H2O3_JOIN_CLOUD",
                "H2O3_COLLECTIVE_TIMEOUT_S"}),
    "PROTOCOL.md": (set(), set()),
}


def _census_names(path):
    out = set()
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            m = re.match(r"^\| `([^`]+)`", line)
            if m:
                out.add(m.group(1))
    return out


@pytest.mark.parametrize("d,census", CENSUSES)
def test_census_names_match_the_jax_package(d, census):
    jax_names = _census_names(os.path.join(REPO, "h2o3_tpu", d, census))
    port_names = _census_names(os.path.join(TE.package_root(), d, census))
    jax_only, port_only = CENSUS_DIFFERENCES[census]
    assert jax_names - port_names == jax_only
    assert port_names - jax_names == port_only
    assert len(port_names) > 5


def test_readme_port_section_names_no_port_only_variable():
    """The JAX analyzer holds every H2O3_* token of the README against
    the JAX package: the port's section names only shared variables."""
    from h2o3_tpu_torch.analysis import rules_env
    toks = {t for t, _ in rules_env._readme_tokens()}
    jax_env = _census_names(os.path.join(REPO, "h2o3_tpu", "analysis",
                                         "ENV.md"))
    port_env = _census_names(os.path.join(TE.package_root(), "analysis",
                                          "ENV.md"))
    assert toks and toks <= (jax_env & port_env) | {"H2O3_TPU"}


# ---------------------------------------------------------------------------
# repairs: dparse's ingest counters and spans, the re-home gauge
@pytest.fixture
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


STAGES = ("read", "decompress", "wire", "tokenize", "pack")


def _value(M, name, **labels):
    m = M.REGISTRY.get(name)
    return m.value(**labels) if m is not None else 0.0


def _ingest(D, M, T, TR_, KV, path, tid):
    b0 = {s: _value(M, "h2o3_ingest_bytes_total", stage=s) for s in STAGES}
    r0 = _value(M, "h2o3_ingest_rows_total")
    with TR_.trace(tid):
        fr = D.parse_files([path])
    names = collections.Counter(s["name"]
                                for s in T.SPANS.trace_snapshot(tid))
    KV.DKV.remove(fr.key)           # each store keeps no frame of the test
    return ({s: _value(M, "h2o3_ingest_bytes_total", stage=s) - b0[s]
             for s in STAGES},
            _value(M, "h2o3_ingest_rows_total") - r0, names, fr.nrows)


@pytest.mark.parametrize("source", ["csv", "gzip", "http"])
def test_ingest_counters_and_spans_match_jax(source, tmp_path, port_cpu):
    """512 rows: neither package pads them (tests/test_torch_tiering.py),
    so the packed bytes are equal too."""
    from h2o3_tpu.core import kvstore as JKV
    from h2o3_tpu.io import dparse as JD
    from h2o3_tpu.obs import metrics as JM
    from h2o3_tpu.obs import timeline as JT
    from h2o3_tpu.obs import tracing as JTR
    from h2o3_tpu_torch.core import kvstore as TKV
    from h2o3_tpu_torch.io import dparse as TD
    from h2o3_tpu_torch.obs import metrics as TM
    from h2o3_tpu_torch.obs import timeline as TT
    from h2o3_tpu_torch.obs import tracing as TTR
    from test_torch_ingest import _serve
    rng = np.random.default_rng(23)
    p = tmp_path / "ingest.csv"
    with open(p, "w") as fh:
        fh.write("a,b,c\n")
        for i in range(512):
            fh.write(f"{rng.normal():.9g},{i % 7},{'xyz'[i % 3]}\n")
    path, httpd = str(p), None
    if source == "gzip":
        with open(p, "rb") as fi, gzip.open(str(p) + ".gz", "wb") as fo:
            shutil.copyfileobj(fi, fo)
        path = str(p) + ".gz"
    elif source == "http":
        httpd = _serve(str(tmp_path))
        path = f"http://127.0.0.1:{httpd.server_address[1]}/ingest.csv"
    try:
        j = _ingest(JD, JM, JT, JTR, JKV, path, f"ingest-jax-{source}")
        t = _ingest(TD, TM, TT, TTR, TKV, path, f"ingest-port-{source}")
    finally:
        if httpd is not None:
            httpd.shutdown()
    assert t == j
    assert t[1] == t[3] == 512
    stage = {"csv": "tokenize", "gzip": "decompress", "http": "read"}
    assert t[0][stage[source]] > 0
    span = {"csv": "parse.tokenize", "gzip": "parse.decompress",
            "http": "parse.read"}
    assert t[2][span[source]] >= 1


def test_rehome_pending_gauge(port_cpu):
    from h2o3_tpu_torch.core.frame import Frame
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.obs import metrics as TM
    g = TM.REGISTRY.get("h2o3_dkv_rehome_pending")
    f = Frame.from_dict({"a": np.arange(64, dtype=np.float64)})
    paused, release = threading.Event(), threading.Event()

    def _pause(key):
        if key == f.key:
            paused.set()
            assert release.wait(10)

    DKV._rehome_hook = _pause
    try:
        moved = DKV.set_membership([0, 1, 2, 3], epoch=2)
        if f.key not in moved:
            moved += DKV.set_membership([5, 6], epoch=3)
        assert f.key in moved and paused.wait(10)
        assert g.value() == float(len(DKV._migrating)) >= 1.0
    finally:
        release.set()
        DKV._rehome_hook = None
    deadline = time.monotonic() + 10
    while DKV.rehome_status()["pending"] and time.monotonic() < deadline:
        time.sleep(0.02)
    assert g.value() == 0.0
    DKV.set_membership([0], epoch=1)
    deadline = time.monotonic() + 10
    while DKV.rehome_status()["pending"] and time.monotonic() < deadline:
        time.sleep(0.02)
    DKV.remove(f.key)


# ---------------------------------------------------------------------------
# the findings the triage fixed
def test_world_gauges_have_literal_names(port_cpu):
    """R005: the all-reduce and gather gauges, unrolled from an f-string
    loop, each read their own table and field."""
    from h2o3_tpu_torch.api import server  # noqa: F401 — registers them
    from h2o3_tpu_torch.obs import metrics as TM
    from h2o3_tpu_torch.parallel import mrtask
    saved = {t: dict(getattr(mrtask, t)) for t in ("ALLREDUCE", "GATHER")}
    try:
        mrtask.ALLREDUCE.update(calls=3, bytes=96, seconds=0.5)
        mrtask.GATHER.update(calls=2, bytes=40, seconds=0.25)
        got = {n: TM.REGISTRY.get(f"h2o3_{n}").value() for n in (
            "allreduce_bytes", "allreduce_seconds", "allreduce_calls",
            "gather_bytes", "gather_seconds", "gather_calls")}
    finally:
        for t, d in saved.items():
            getattr(mrtask, t).update(d)
    assert got == {"allreduce_bytes": 96.0, "allreduce_seconds": 0.5,
                   "allreduce_calls": 3.0, "gather_bytes": 40.0,
                   "gather_seconds": 0.25, "gather_calls": 2.0}


def test_replay_free_pool_is_retired(monkeypatch):
    """R010: the stateless replays' pool shuts down when the worker's
    replay loop ends, its replays finished first."""
    from h2o3_tpu_torch.deploy import multihost as TMH
    done = []
    monkeypatch.setattr(TMH, "_replay_one",
                        lambda msg: (time.sleep(0.05), done.append(msg)))
    TMH._replay_free({"seq": 1})
    TMH._replay_free({"seq": 2})
    assert TMH._FREE_POOL
    TMH._close_free_pool()
    assert not TMH._FREE_POOL and not TMH._FREE_PENDING
    assert sorted(m["seq"] for m in done) == [1, 2]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("replay-free")]


def test_worker_loop_retires_the_pool_when_it_ends(monkeypatch):
    from h2o3_tpu_torch.deploy import multihost as TMH
    closed = []
    monkeypatch.setattr(TMH, "_worker_connect",
                        lambda *a, **k: (None, b"k", {}))
    monkeypatch.setattr(TMH, "_replay_session", lambda *a: "leave")
    monkeypatch.setattr(TMH, "_close_free_pool", lambda: closed.append(1))
    monkeypatch.setattr(TMH, "_cluster_secret", lambda: b"s")
    monkeypatch.setattr(TMH, "_REPLICA", [False])
    TMH.worker_loop("127.0.0.1", 1, pid=1)
    assert closed == [1]


class _HungCompiler:
    """A compiler process that never finishes until it is killed."""

    def __init__(self):
        self.killed = False
        self.returncode = None

    def communicate(self, timeout=None):
        if not self.killed:
            assert timeout is not None
            raise subprocess.TimeoutExpired("nvcc", timeout)
        self.returncode = -9
        return "killed", None

    def kill(self):
        self.killed = True


def test_build_bounds_the_compiler_under_its_lock(tmp_path, monkeypatch):
    """R008: a compile that never returns raises BuildError after
    BUILD_TIMEOUT_S instead of holding _build._LOCK for ever."""
    from h2o3_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_TIMEOUT_S", 0.01)
    proc, tmp = _HungCompiler(), tmp_path / "lib.so.tmp"
    tmp.write_bytes(b"partial")
    with pytest.raises(_build.BuildError, match="took more than"):
        _build._finish("hist", tmp_path / "lib.so", (proc, tmp))
    assert proc.killed and not tmp.exists()
    assert not (tmp_path / "lib.so").exists()


def test_profiler_start_is_bounded(tmp_path, monkeypatch):
    """R008: a profiler session that never comes up raises after
    START_TIMEOUT_S instead of holding the manager's lock for ever."""
    from h2o3_tpu_torch.obs import profiler
    monkeypatch.setattr(profiler._TorchSession, "START_TIMEOUT_S", 0.05)
    monkeypatch.setattr(profiler._TorchSession, "_run",
                        lambda self: self._stop.wait(5))
    sess = profiler._TorchSession(str(tmp_path / "t.json"))
    with pytest.raises(RuntimeError, match="did not start"):
        sess.start()
    sess._thread.join(5)
    assert not sess._thread.is_alive()


def test_env_is_set_and_one_declaration_site(monkeypatch):
    """R017: H2O3_PROCESS_ID's presence check reads no value (utils/env
    declares it), and the watchdog's collect deadline is the server's."""
    from h2o3_tpu_torch.api.server import _collect_timeout
    from h2o3_tpu_torch.utils import env
    monkeypatch.delenv("H2O3_PROCESS_ID", raising=False)
    assert not env.is_set("H2O3_PROCESS_ID")
    monkeypatch.setenv("H2O3_PROCESS_ID", "  ")
    assert not env.is_set("H2O3_PROCESS_ID")
    monkeypatch.setenv("H2O3_PROCESS_ID", "2")
    assert env.is_set("H2O3_PROCESS_ID") and env.process_id() == 2
    monkeypatch.setenv("H2O3_OBS_COLLECT_TIMEOUT_S", "0.75")
    assert _collect_timeout() == 0.75
