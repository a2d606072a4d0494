"""The analysis engine of the port (h2o3_tpu/analysis/engine.py):
findings, suppressions, baseline, orchestration.

The analyzer is AST-based and zero-dependency (stdlib only): it must run
in CI images and pre-commit hooks without importing torch, jax or the
package under analysis. Every rule is derived from a defect class this repo
actually shipped (see rules_*.py docstrings); the engine is the part that
turns rule hits into actionable, machine-readable findings:

  * Finding — rule id, file:line, message, plus a line-content fingerprint
    so baselines survive unrelated edits shifting line numbers.
  * Inline suppression — a `# h2o3-ok: R003 <reason>` comment on the
    flagged line (or the line above, for multi-line statements) waives the
    listed rules at that site. The reason is mandatory by convention: a
    waiver without a why is a finding waiting to regress.
  * Baseline — grandfathered findings recorded in a JSON file
    (analysis_baseline.json); the tier-1 gate fails only on findings that
    are neither suppressed nor baselined, so new debt cannot land while
    old debt is paid down incrementally.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field


@dataclass
class Finding:
    rule: str                 # "R001".."R006"
    file: str                 # repo-relative path
    line: int
    message: str
    snippet: str = ""         # stripped source line (fingerprint input)
    suppressed: bool = False  # inline `# h2o3-ok:` waiver
    baselined: bool = False   # matched an analysis_baseline.json entry

    @property
    def fingerprint(self) -> str:
        """Stable identity across line-number drift: rule + file + the
        normalized content of the flagged line."""
        basis = f"{self.rule}:{self.file}:{' '.join(self.snippet.split())}"
        return hashlib.sha1(basis.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "fingerprint": self.fingerprint,
                "suppressed": self.suppressed, "baselined": self.baselined}

    def __str__(self):
        return f"{self.file}:{self.line}: {self.rule} {self.message}"


@dataclass
class Module:
    """One parsed source file handed to the rules.

    The parse happens once (load_modules); the two tree walks every rule
    used to redo — the child→parent map and the flat node list — are
    memoized here so N rules share one traversal instead of paying
    O(tree) each (the analyzer runs in pre-commit: wall-time is budget)."""
    path: str                 # absolute
    rel: str                  # repo-relative (finding/baseline identity)
    source: str
    tree: ast.AST
    lines: list = field(default_factory=list)
    _parents: dict = field(default=None, repr=False, compare=False)
    _nodes: list = field(default=None, repr=False, compare=False)

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def walk(self) -> list:
        """Flat ast.walk(tree) node list, computed once per module."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def parents(self) -> dict:
        """child node → parent node map, computed once per module."""
        if self._parents is None:
            self._parents = {c: p for p in self.walk()
                             for c in ast.iter_child_nodes(p)}
        return self._parents


_SUPPRESS_RE = re.compile(r"#\s*h2o3-ok:\s*([A-Z0-9,\s]+?)(?:\s+\S.*)?$")


def _suppressions(lines: list) -> dict:
    """{lineno: {rule, ...}} from `# h2o3-ok: R001[,R002] reason` comments.
    A waiver covers its own line and the line below it, so it can sit
    above a multi-line statement whose node starts on the next line."""
    out: dict = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        out.setdefault(i + 1, set()).update(rules)
    return out


def package_root() -> str:
    """The h2o3_tpu_torch package directory (default analysis target)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root() -> str:
    return os.path.dirname(package_root())


def tests_root() -> str:
    """The repo's tests/ directory (analyzed under the relaxed profile).
    It holds the tests of both packages; a walk of it takes only the
    port's, `test_torch_*.py`."""
    return os.path.join(repo_root(), "tests")


def _port_test_file(dirpath: str, name: str) -> bool:
    """False for a file of the tests root that is not the port's."""
    if os.path.abspath(dirpath) != tests_root():
        return True
    return name.startswith("test_torch_")


def _iter_py_files(paths) -> list:
    out = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                # build/: what the kernels' build writes (ops/build/),
                # not the package
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git", "build")]
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames) if f.endswith(".py")
                           and _port_test_file(dirpath, f))
    return sorted(set(out))


def load_modules(paths) -> list:
    root = repo_root()
    mods = []
    for path in _iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=path)
        except (OSError, SyntaxError) as ex:
            # an unparseable file is itself a finding-worthy defect, but
            # the compiler owns syntax errors; report and move on
            mods.append(Module(path, os.path.relpath(path, root),
                               "", ast.Module(body=[], type_ignores=[])))
            mods[-1].lines = [f"<unreadable: {ex}>"]
            continue
        m = Module(path, os.path.relpath(path, root), src, tree)
        m.lines = src.splitlines()
        mods.append(m)
    return mods


# Rules waived wholesale for test files: tests deliberately build
# programs per call, call time.time() in fixtures, and seed impurity to
# prove the runtime handles it — R001/R004 are perf rules for production paths, R011's
# span census is a production-vocabulary concern (throwaway fixture
# spans are the point of a tracing test), R012's logging discipline
# is for records an operator must find later (a test printing its
# diagnostics is fine), and R013's socket deadlines are a production
# liveness concern (test fixtures connect to loopback listeners they
# themselves bound, with their own bounded retries and suite timeouts).
# R015 (host-sync taint on instrumented hot paths) and R016
# (replay-determinism) are production-invariant rules — test fixtures
# host-sync inside spans to assert results and seed nondeterminism into
# fake Broadcasters on purpose; R017's env census covers the package's
# config surface, while tests poke os.environ directly by design
# (monkeypatch.setenv round-trips).
# Everything else (locks, metrics, routes, R007-R010 concurrency)
# applies to tests too: a racy test harness or a leaked test thread
# flakes the suite.
# R018–R021 (replicated-state integrity) are likewise production-
# invariant rules: test fixtures register throwaway routes that mutate
# fixture DKVs, seed host-divergent values to prove the runtime
# sanitizer fires, and spin one-sided protocol stubs (a FakeWorker with
# no _collect_local) on purpose.
TEST_RELAXED = {"R001", "R004", "R011", "R012", "R013",
                "R015", "R016", "R017",
                "R018", "R019", "R020", "R021",
                # lifecycle + export rules: tests seed deliberate leaks
                # (to prove the leaktrack sanitizer fires) and call the
                # pair surfaces in half-open shapes by design
                "R022", "R023", "R024", "R025"}


def _is_test_file(rel: str) -> bool:
    r = rel.replace("\\", "/")
    return r.startswith("tests/") or "/tests/" in r


# {rule-or-pass: seconds} for the LAST analyze_modules call — the
# analyzer runs in pre-commit under a wall-time budget, so --json
# reports where the time went. Keys are "+"-joined rule ids per check
# function; functions marked SELF_TIMED (the shared callgraph pass)
# record their own finer-grained entries instead.
RULE_TIMINGS: dict = {}


def analyze_modules(mods: list, rules=None, only_files=None) -> list:
    """Run every rule over the parsed modules; returns findings with
    inline suppressions already applied (but baseline NOT applied).

    `only_files` (a set of repo-relative paths) scopes the OUTPUT to
    those files — the --changed-only mode: per-file rules skip other
    modules entirely, project rules still see the whole module set (a
    call graph over a partial project would miss cross-file edges) but
    report only into the scoped files."""
    import time as _time

    from h2o3_tpu_torch.analysis import callgraph, rules_dist, rules_env, \
        rules_locks, rules_logging, rules_metrics, rules_protocol, \
        rules_routes, rules_sockets, rules_spans, rules_torch
    findings: list = []
    RULE_TIMINGS.clear()
    if only_files is not None and not only_files:
        return []    # nothing in scope changed: every finding would be
        #              filtered out below — skip the analysis entirely
    per_file = [rules_torch.check, rules_locks.check, rules_logging.check,
                rules_sockets.check, rules_dist.check]
    project = [rules_metrics.check, rules_routes.check, rules_spans.check,
               rules_env.check, rules_protocol.check, callgraph.check]
    if rules:
        wanted = set(rules)
        per_file = [f for f in per_file if f.RULES & wanted]
        project = [f for f in project if f.RULES & wanted]

    def _timed(rule_fn, arg):
        key = "+".join(sorted(rule_fn.RULES))
        t0 = _time.perf_counter()
        out = rule_fn(arg)
        if not getattr(rule_fn, "SELF_TIMED", False):
            RULE_TIMINGS[key] = RULE_TIMINGS.get(key, 0.0) + \
                (_time.perf_counter() - t0)
        return out

    for m in mods:
        if only_files is not None and m.rel not in only_files:
            continue
        for rule_fn in per_file:
            findings.extend(_timed(rule_fn, m))
    for rule_fn in project:
        findings.extend(_timed(rule_fn, mods))
    if rules:
        findings = [f for f in findings if f.rule in set(rules)]
    if only_files is not None:
        findings = [f for f in findings if f.file in only_files]
    findings = [f for f in findings
                if not (f.rule in TEST_RELAXED and _is_test_file(f.file))]
    # attach snippets + inline suppressions
    by_path = {m.rel: m for m in mods}
    sup_cache: dict = {}
    for f in findings:
        m = by_path.get(f.file)
        if m is None:
            continue
        f.snippet = f.snippet or m.snippet(f.line)
        if f.file not in sup_cache:
            sup_cache[f.file] = _suppressions(m.lines)
        if f.rule in sup_cache[f.file].get(f.line, ()):
            f.suppressed = True
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def analyze_paths(paths, rules=None) -> list:
    return analyze_modules(load_modules(paths), rules=rules)


def analyze_source(src: str, filename: str = "<fixture>",
                   rules=None) -> list:
    """Analyze a source string — the seeded-defect test entry point."""
    return analyze_sources({filename: src}, rules=rules)


def analyze_sources(sources: dict, rules=None) -> list:
    """Analyze {filename: source} strings as ONE project — the entry
    point for seeding cross-module defects (R007 lock-order cycles only
    exist in the composition of several files)."""
    mods = []
    for filename, src in sources.items():
        tree = ast.parse(src, filename=filename)
        m = Module(filename, filename, src, tree)
        m.lines = src.splitlines()
        mods.append(m)
    return analyze_modules(mods, rules=rules)


# ---------------------------------------------------------------------------
# baseline
def load_baseline(path: str) -> dict:
    """{fingerprint: note} from an analysis_baseline.json file."""
    if not path or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return {e["fingerprint"]: e.get("note", "")
            for e in data.get("findings", [])}


def apply_baseline(findings: list, baseline: dict) -> list:
    for f in findings:
        if not f.suppressed and f.fingerprint in baseline:
            f.baselined = True
    return findings


def write_baseline(findings: list, path: str):
    """Grandfather every currently-unsuppressed finding (the one-time
    bootstrap; new findings after this still fail the gate)."""
    entries = []
    seen = set()
    for f in findings:
        if f.suppressed or f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        entries.append({"rule": f.rule, "file": f.file,
                        "fingerprint": f.fingerprint,
                        "snippet": f.snippet, "note": ""})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "findings": entries}, fh, indent=2)
        fh.write("\n")


def unsuppressed(findings: list) -> list:
    return [f for f in findings if not f.suppressed and not f.baselined]


def run(paths=None, baseline_path=None, rules=None) -> list:
    """Full pipeline: parse, analyze, suppress, baseline. The tier-1 gate
    asserts `not unsuppressed(run(...))`."""
    if not paths:
        paths = [package_root()]
    findings = analyze_paths(paths, rules=rules)
    if baseline_path:
        apply_baseline(findings, load_baseline(baseline_path))
    return findings
