"""The effect-lattice rules of the port (h2o3_tpu/analysis/effects.py):
replicated-state integrity (R018/R019/R021).

The SPMD replay design (deploy/multihost) rests on one invariant: every
host that replays a broadcast request ends up with bit-identical
replicated state. This pass classifies every function's effect on
REPLICATED state — the DKV registry (put/remove/atomic/locks/clear),
cloud membership and ring placement — as opposed to HOST-LOCAL state
(metrics, timeline, flight recorder, logs, spill files, caches), and
closes the classification to a fixpoint over the callgraph.py call graph so
the obligation survives arbitrarily deep call chains and dynamic
dispatch.

  * R018 — coordinator-only mutation: a handler on a NON-broadcast route
    (the replay-exempt set: static Flow assets, the observability
    endpoints, /3/PostFile, /3/ParseDistributed — extracted from the
    server's own `_is_static_path`/`_is_obs_path`/`_dispatch_routed`
    predicates, never hand-listed here) that transitively mutates
    replicated state. The mutation lands only on the coordinator; every
    worker's replica silently diverges. Intentional coordinator-only
    control surfaces (cloud drain) carry a reasoned `# h2o3-ok: R018`.
  * R019 — host-divergence consumption: broadcast-replayed code that
    feeds a host-identity source (pid, hostname, platform, direct
    environ reads outside the R017 census accessors) into replicated
    state — generalizing R016's intraprocedural wall-clock rule to the
    full callgraph: a replayed function storing the RESULT of a helper
    that returns pid/uuid/wall-clock-derived values is flagged even
    though the source call is modules away. `utils/env.py` and
    `utils/config.py` are the censused config layer (deployment-uniform
    by the R017 contract) and are exempt as sources; writes inside
    host-local modules (obs/, utils/log, io/spill, analysis/) are
    host-local by classification and never flagged.
  * R021 — npz wire-format pairing: within a module that both writes
    (np.savez) and reads (np.load) npz payloads, every key a reader
    requires must be produced by some writer and every statically-known
    writer key must be consumed by some reader. Dict-literal key sets
    and `"k" in z.files` guards are understood; f-string/dynamic keys
    make a site open (satisfies/consumes everything). This is the
    static face of the chunk byte-plane contract (io/spill, the DKV
    re-home `_plane_payload`/`_plane_restore` pair, the dparse string
    planes).

All three run on the ONE `_Project` built by callgraph.check — the
analyzer's wall-time budget (it runs in the pre-commit hook)
cannot afford a second interprocedural index.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from h2o3_tpu_torch.analysis import callgraph as _cg
from h2o3_tpu_torch.analysis.engine import Finding

RULES = {"R018", "R019", "R021"}

# replicated-state mutation vocabulary: the DKV registry and the
# membership/ring state machine. Receiver-chain matching catches the
# call SITES (DKV.put, self.membership.leave, MEMBERSHIP.excise);
# resolved-callee matching catches calls that land ON those methods
# through aliases the chain text can't see.
_DKV_MUTATORS = {"put", "remove", "atomic", "write_lock", "unlock",
                 "clear", "set_membership"}
_MEMB_MUTATORS = {"register", "excise", "leave", "join", "start_drain",
                  "reset"}

# modules whose writes are HOST-LOCAL by effect classification —
# observability rings, log segments, spill files, the analyzer itself.
# A divergent value landing here is per-host telemetry, not a fork.
_HOST_LOCAL_PREFIXES = ("h2o3_tpu_torch/obs/", "h2o3_tpu_torch/utils/log",
                        "h2o3_tpu_torch/io/spill", "h2o3_tpu_torch/analysis/")

# the R017-censused config layer: env reads routed through these typed
# accessors are deployment-uniform by contract, so they are NOT
# host-divergence sources (a raw os.environ.get anywhere else is)
_UNIFORM_ENV_MODULES = ("utils/env.py", "utils/config.py")

# untyped-receiver seam for the broadcaster surface: `bc =
# getattr(self.server, "broadcaster", None); bc.drain(...)` — the names
# are public so the generic duck resolver punts, but a receiver SPELLED
# bc/broadcaster with one of these methods is the replay channel.
# `collect` is deliberately NOT a seam: it is the read side, and the
# dead-peer excision its failure detector may perform is the liveness
# protocol's own (coordinator-owned by design) — routing it into the
# closure would flag every observability handler that polls workers.
_BC_SEAM_METHODS = {"drain", "broadcast"}

# functions whose bodies define the replay-exempt route set
_EXEMPT_PREDICATE_FNS = {"_is_static_path", "_is_obs_path",
                         "_dispatch_routed"}

_REGEX_META = re.compile(r"[\\\[\](){}?*+|^$.]")


# ---------------------------------------------------------------------------
# effect edges: fi.calls plus function-local imports and the bc seam
def _effect_edges(proj) -> dict:
    """{qual: {(callee_qual, line)}} — the callgraph's resolved calls,
    augmented with (a) calls resolved through FUNCTION-LOCAL imports
    (the `def work(): from ... import dparse` closure shape nested in
    job-starting handlers) and (b) the broadcaster seam above. Nested
    function defs are attributed to their enclosing def: a handler that
    schedules `work` onto a Job owns work's effects."""
    edges: dict = {}
    for qual, fi in proj.fns.items():
        es = {(c, ln) for c, ln, _h, _b, _s in fi.calls}
        nodes = proj.fn_nodes(fi)
        local_imports: dict = {}
        for n in nodes:
            if isinstance(n, ast.Import):
                for a in n.names:
                    local_imports[a.asname or a.name.split(".")[0]] = \
                        (a.name, None)
            elif isinstance(n, ast.ImportFrom) and n.module \
                    and n.level == 0:
                for a in n.names:
                    local_imports[a.asname or a.name] = (n.module, a.name)
        if local_imports:
            mi2 = dataclasses.replace(
                fi.mod, imports={**fi.mod.imports, **local_imports})
            ltypes = _cg._local_ctor_types(fi, proj)
            for n in nodes:
                if isinstance(n, ast.Call):
                    for tgt in proj.resolve_calls(mi2, fi.cls, n, ltypes):
                        es.add((tgt, n.lineno))
        for n in nodes:
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _BC_SEAM_METHODS):
                continue
            recv = _cg._chain(n.func.value)
            root = recv.split(".", 1)[0] if recv else ""
            if root in ("bc", "broadcaster") or "broadcaster" in recv:
                for _cq, (ci, _mi) in proj.classes.items():
                    if "Broadcaster" in ci.name \
                            and n.func.attr in ci.methods:
                        es.add((ci.methods[n.func.attr], n.lineno))
        edges[qual] = es
    return edges


def _calls_by_line(edges: dict) -> dict:
    """{qual: {line: {callee}}} — taint passes resolve Call nodes by
    line instead of re-running symbol resolution per node."""
    out: dict = {}
    for qual, es in edges.items():
        by = out.setdefault(qual, {})
        for callee, ln in es:
            by.setdefault(ln, set()).add(callee)
    return out


# ---------------------------------------------------------------------------
# the replicated-effect closure
def _replicated_sites(fi, proj) -> list:
    """(desc, line) direct replicated-state mutation sites in this
    function, by receiver-chain vocabulary."""
    out = []
    for n in proj.fn_nodes(fi):
        if not (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)):
            continue
        recv = _cg._chain(n.func.value)
        if not recv:
            continue
        low = recv.lower()
        if n.func.attr in _DKV_MUTATORS and "dkv" in low:
            out.append((f"{recv}.{n.func.attr}()", n.lineno))
        elif n.func.attr in _MEMB_MUTATORS and "membership" in low:
            out.append((f"{recv}.{n.func.attr}()", n.lineno))
    return out


def _is_mutator_method(callee: str, proj) -> bool:
    """A resolved callee that IS a DKV/Membership mutator method — the
    leaf the chain vocabulary can't see (inside _DKV.put the receiver is
    `self._store`, not `DKV`)."""
    cf = proj.fns.get(callee)
    if cf is None or not cf.cls:
        return False
    meth = callee.rsplit(".", 1)[-1]
    return ("DKV" in cf.cls and meth in _DKV_MUTATORS) or \
        (cf.cls == "Membership" and meth in _MEMB_MUTATORS)


def effect_closure(proj, edges: dict) -> dict:
    """{qual: {(desc, rel, line)}} — every replicated-state mutation
    site reachable from each function (the effect lattice, closed to a
    fixpoint over the augmented callgraph)."""
    closure: dict = {}
    for qual, fi in proj.fns.items():
        rel = fi.mod.mod.rel
        sites = {(d, rel, ln) for d, ln in _replicated_sites(fi, proj)}
        for callee, ln in edges.get(qual, ()):
            if _is_mutator_method(callee, proj):
                cf = proj.fns[callee]
                sites.add((f"{cf.cls}.{callee.rsplit('.', 1)[-1]}()",
                           rel, ln))
        closure[qual] = sites
    changed, guard = True, 0
    while changed and guard < 50:
        changed = False
        guard += 1
        for qual, es in edges.items():
            cur = closure[qual]
            before = len(cur)
            for callee, _ln in es:
                cs = closure.get(callee)
                if cs:
                    cur |= cs
            if len(cur) != before:
                changed = True
    return closure


# ---------------------------------------------------------------------------
# R018: coordinator-only mutation through replay-exempt routes
def _route_rows(proj) -> list:
    """(pattern_literal, METHOD, handler_qual) for every route-table row
    — like callgraph._route_handlers but KEEPING the pattern literal and
    GET rows: in this repo GETs broadcast too, so the non-replayed set
    is purely the path-exempt one."""
    rows = []
    for mi in proj.mods:
        compile_aliases = {"compile"}
        for node in mi.mod.walk():
            if isinstance(node, ast.Assign) and \
                    _cg._chain(node.value) in ("re.compile", "compile"):
                compile_aliases.update(t.id for t in node.targets
                                       if isinstance(t, ast.Name))
        for node in mi.mod.walk():
            if not (isinstance(node, ast.Tuple) and len(node.elts) == 3):
                continue
            pat, meth, ref = node.elts
            if not (isinstance(pat, ast.Call)
                    and _cg._terminal(pat.func) in compile_aliases
                    and pat.args
                    and isinstance(pat.args[0], ast.Constant)
                    and isinstance(pat.args[0].value, str)):
                continue
            if not (isinstance(meth, ast.Constant)
                    and isinstance(meth.value, str)):
                continue
            t = _cg._terminal(ref)
            if t is None:
                continue
            qual = None
            if t in mi.defs:
                qual = mi.defs[t]
            else:
                for ci in mi.classes.values():
                    if t in ci.methods:
                        qual = ci.methods[t]
                        break
            if qual is not None:
                rows.append((pat.args[0].value, meth.value.upper(), qual))
    return rows


def _exempt_specs(proj):
    """(exact_paths, path_prefixes) recovered from the server's own
    predicate functions — `path == "..."`, `path in (...)` and
    `path.startswith("...")` shapes inside _is_static_path /
    _is_obs_path / _dispatch_routed. Extracting instead of hand-listing
    keeps the rule honest when the exempt set changes."""
    exact: set = set()
    prefixes: set = set()
    for fi in proj.fns.values():
        if getattr(fi.node, "name", "") not in _EXEMPT_PREDICATE_FNS:
            continue
        for n in proj.fn_nodes(fi):
            if isinstance(n, ast.Compare) and len(n.ops) == 1 \
                    and isinstance(n.left, ast.Name) \
                    and n.left.id == "path":
                cmp = n.comparators[0]
                if isinstance(n.ops[0], ast.Eq) \
                        and isinstance(cmp, ast.Constant) \
                        and isinstance(cmp.value, str):
                    exact.add(cmp.value)
                elif isinstance(n.ops[0], ast.In) \
                        and isinstance(cmp, (ast.Tuple, ast.List,
                                             ast.Set)):
                    exact.update(e.value for e in cmp.elts
                                 if isinstance(e, ast.Constant)
                                 and isinstance(e.value, str))
            elif isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "startswith" \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id == "path" and n.args:
                a = n.args[0]
                if isinstance(a, ast.Constant) and isinstance(a.value,
                                                              str):
                    prefixes.add(a.value)
                elif isinstance(a, ast.Tuple):
                    prefixes.update(e.value for e in a.elts
                                    if isinstance(e, ast.Constant)
                                    and isinstance(e.value, str))
    return exact, prefixes


def _literal_prefix(pattern: str):
    """(literal_prefix, is_fully_literal) of a route regex."""
    m = _REGEX_META.search(pattern)
    if m is None:
        return pattern, True
    return pattern[:m.start()], False


def _is_exempt_route(pattern: str, exact: set, prefixes: set) -> bool:
    lit, full = _literal_prefix(pattern)
    if full and lit in exact:
        return True
    return any(lit.startswith(p) for p in prefixes if p)


def _check_r018(proj, edges: dict, closure: dict) -> list:
    exact, prefixes = _exempt_specs(proj)
    if not exact and not prefixes:
        return []      # no replay layer in this project: nothing exempt
    findings = []
    seen: set = set()
    for patlit, method, qual in _route_rows(proj):
        if not _is_exempt_route(patlit, exact, prefixes):
            continue
        fi = proj.fns.get(qual)
        if fi is None or qual in seen:
            continue
        sites = closure.get(qual)
        if not sites:
            continue
        seen.add(qual)
        desc, orel, oline = sorted(sites)[0]
        findings.append(Finding(
            "R018", fi.mod.mod.rel, fi.node.lineno,
            f"{method} {patlit} is replay-EXEMPT (static/obs/"
            f"non-broadcast path) but its handler transitively mutates "
            f"replicated state via {desc} ({orel}:{oline}): the "
            "mutation lands only on the coordinator, silently forking "
            "every worker's replica — route it through a broadcast-"
            "replayed endpoint, or suppress with the reason the "
            "coordinator-only effect is the design"))
    return findings


# ---------------------------------------------------------------------------
# R019: host-divergence sources into replicated state (interprocedural)
_HOST_ID_CALLS = {
    "os.getpid", "os.getppid", "os.uname",
    "socket.gethostname", "socket.getfqdn", "socket.gethostbyname",
    "platform.node", "platform.uname", "platform.platform",
    "platform.machine", "platform.system", "platform.release",
}


def _div_desc(call: ast.Call):
    """Host-identity source vocabulary (the R019 direct sources).
    Wall-clock/random/uuid are R016's lexical vocabulary — R019 adds
    them only through the RETURN-propagation below, so one site is never
    double-flagged by both rules."""
    chain = _cg._chain(call.func)
    if chain in _HOST_ID_CALLS:
        return f"{chain}()"
    if chain.endswith("environ.get") or chain in ("os.getenv", "getenv"):
        return f"{chain}()"
    return None


def _div_or_nondet_desc(call: ast.Call):
    return _div_desc(call) or _cg._nondet_desc(call)


def _is_uniform_env_module(rel: str) -> bool:
    return rel.replace("\\", "/").endswith(_UNIFORM_ENV_MODULES)


def _divergent_returners(proj, by_line: dict) -> dict:
    """{qual: desc} for functions whose RETURN value derives from a
    host-divergence (or nondeterminism) source — directly or through a
    call to another marked function. The censused config accessors are
    exempt: their reads are deployment-uniform by the R017 contract."""
    marked: dict = {}

    def returns_divergent(fi, qual):
        nodes = proj.fn_nodes(fi)
        lines = by_line.get(qual, {})
        tainted: dict = {}

        def node_div(e):
            for sub in ast.walk(e):
                if isinstance(sub, ast.Call):
                    d = _div_or_nondet_desc(sub)
                    if d is not None:
                        return d
                    for tgt in lines.get(sub.lineno, ()):
                        if tgt in marked:
                            return f"{tgt}() [{marked[tgt]}]"
                elif isinstance(sub, ast.Name) \
                        and isinstance(sub.ctx, ast.Load) \
                        and sub.id in tainted:
                    return tainted[sub.id]
            return None

        assigns = [n for n in nodes
                   if isinstance(n, (ast.Assign, ast.AnnAssign))]
        for _ in range(4):
            changed = False
            for a in assigns:
                v = getattr(a, "value", None)
                if v is None:
                    continue
                d = node_div(v)
                if d is None:
                    continue
                tgts = a.targets if isinstance(a, ast.Assign) \
                    else [a.target]
                for t in tgts:
                    if isinstance(t, ast.Name) and t.id not in tainted:
                        tainted[t.id] = d
                        changed = True
            if not changed:
                break
        for n in nodes:
            if isinstance(n, ast.Return) and n.value is not None:
                d = node_div(n.value)
                if d is not None:
                    return d
        return None

    changed, guard = True, 0
    while changed and guard < 20:
        changed = False
        guard += 1
        for qual, fi in proj.fns.items():
            if qual in marked or _is_uniform_env_module(fi.mod.mod.rel):
                continue
            d = returns_divergent(fi, qual)
            if d is not None:
                marked[qual] = d
                changed = True
    return marked


def _replay_reach(proj, edges: dict) -> dict:
    """{qual: parent_or_None} BFS over the augmented edges from the
    replay roots (R016's root set) — parent pointers give the root
    attribution the finding message names."""
    roots = sorted(fi.qual for fi in proj.fns.values()
                   if _cg._is_replay_root(fi, proj))
    parent: dict = {}
    work = []
    for r in roots:
        if r not in parent:
            parent[r] = None
            work.append(r)
    while work:
        cur = work.pop()
        for callee, _ln in edges.get(cur, ()):
            if callee not in parent and callee in proj.fns:
                parent[callee] = cur
                work.append(callee)
    return parent


def _check_r019(proj, edges: dict, by_line: dict) -> list:
    marked = _divergent_returners(proj, by_line)
    parent = _replay_reach(proj, edges)
    findings = []
    seen: set = set()
    for qual in parent:
        fi = proj.fns.get(qual)
        if fi is None:
            continue
        rel = fi.mod.mod.rel.replace("\\", "/")
        if rel.startswith(_HOST_LOCAL_PREFIXES) \
                or _is_uniform_env_module(rel):
            continue
        lines = by_line.get(qual, {})

        def call_desc(call, _lines=lines):
            for tgt in _lines.get(call.lineno, ()):
                if tgt in marked:
                    return f"a value returned by {tgt}() [{marked[tgt]}]"
            return None

        sites = _cg._nondet_mutations(
            fi, proj.fn_nodes(fi), desc_fn=_div_desc,
            call_desc=call_desc, include_set_iteration=False)
        if not sites:
            continue
        root = qual
        while parent[root] is not None:
            root = parent[root]
        via = "" if root == qual else f", reachable from {root}()"
        for desc, line in sites:
            key = (fi.mod.mod.rel, line)
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                "R019", fi.mod.mod.rel, line,
                f"{desc} feeds replicated-state mutation in {qual}() — "
                f"broadcast-replayed code{via}: every cloud member "
                "replays this with its OWN host identity, silently "
                "forking the replicated state — derive the value from "
                "the replayed request, read config through the censused "
                "accessors, or compute once on the coordinator and ship "
                "the result"))
    return findings


# ---------------------------------------------------------------------------
# R021: npz wire-format pairing
class _NpzSite:
    __slots__ = ("line", "required", "optional", "dynamic")

    def __init__(self, line, required=(), optional=(), dynamic=False):
        self.line = line
        self.required = set(required)
        self.optional = set(optional)
        self.dynamic = dynamic

    @property
    def keys(self):
        return self.required | self.optional


_SAVEZ_CHAINS = {"np.savez", "np.savez_compressed", "numpy.savez",
                 "numpy.savez_compressed", "onp.savez",
                 "onp.savez_compressed"}
_LOAD_CHAINS = {"np.load", "numpy.load", "onp.load"}


def _npz_scope_sites(scope_nodes: list):
    """(writers, readers) for one function scope."""
    dict_static: dict = {}
    dict_opt: dict = {}
    dict_dyn: set = set()
    npz_vars: set = set()
    # pass 1: dict-literal tracking and np.load vars
    for n in scope_nodes:
        if isinstance(n, ast.Assign):
            v = n.value
            if isinstance(v, ast.Dict):
                keys, dyn = set(), False
                for k in v.keys:
                    if isinstance(k, ast.Constant) \
                            and isinstance(k.value, str):
                        keys.add(k.value)
                    else:
                        dyn = True
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        dict_static[t.id] = keys
                        if dyn:
                            dict_dyn.add(t.id)
            elif isinstance(v, (ast.DictComp,)):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        dict_static.setdefault(t.id, set())
                        dict_dyn.add(t.id)
            elif isinstance(v, ast.Call) \
                    and _cg._chain(v.func) in _LOAD_CHAINS:
                npz_vars.update(t.id for t in n.targets
                                if isinstance(t, ast.Name))
            # dict_var["k"] = ... — a conditionally-added (optional) key
            for t in n.targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in dict_static:
                    s = t.slice
                    if isinstance(s, ast.Constant) \
                            and isinstance(s.value, str):
                        dict_opt.setdefault(t.value.id, set()).add(s.value)
                    else:
                        dict_dyn.add(t.value.id)
        elif isinstance(n, ast.With):
            for item in n.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) \
                        and _cg._chain(ctx.func) in _LOAD_CHAINS \
                        and isinstance(item.optional_vars, ast.Name):
                    npz_vars.add(item.optional_vars.id)
    # pass 2: writer sites
    writers = []
    for n in scope_nodes:
        if not (isinstance(n, ast.Call)
                and _cg._chain(n.func) in _SAVEZ_CHAINS):
            continue
        site = _NpzSite(n.lineno)
        saw_keys = False
        for kw in n.keywords:
            if kw.arg is not None:
                site.required.add(kw.arg)
                saw_keys = True
            elif isinstance(kw.value, ast.Name) \
                    and kw.value.id in dict_static:
                site.required |= dict_static[kw.value.id]
                site.optional |= dict_opt.get(kw.value.id, set())
                if kw.value.id in dict_dyn:
                    site.dynamic = True
                saw_keys = True
            else:
                site.dynamic = True      # **<untracked> — open format
                saw_keys = True
        if not saw_keys:
            site.dynamic = True          # positional arrays → arr_0...
        writers.append(site)
    # pass 3: reader sites (one per np.load var in this scope)
    readers = []
    for var in sorted(npz_vars):
        site = None
        subs: set = set()
        opts: set = set()
        dynamic = False
        for n in scope_nodes:
            if isinstance(n, ast.Subscript) \
                    and isinstance(n.value, ast.Name) \
                    and n.value.id == var \
                    and isinstance(n.ctx, ast.Load):
                if site is None or n.lineno < site:
                    site = n.lineno
                s = n.slice
                if isinstance(s, ast.Constant) \
                        and isinstance(s.value, str):
                    subs.add(s.value)
                else:
                    dynamic = True
            elif isinstance(n, ast.Compare) and len(n.ops) == 1 \
                    and isinstance(n.ops[0], ast.In) \
                    and isinstance(n.left, ast.Constant) \
                    and isinstance(n.left.value, str):
                cmp = n.comparators[0]
                if isinstance(cmp, ast.Attribute) \
                        and cmp.attr == "files" \
                        and isinstance(cmp.value, ast.Name) \
                        and cmp.value.id == var:
                    opts.add(n.left.value)
            elif isinstance(n, ast.Attribute) and n.attr == "files" \
                    and isinstance(n.value, ast.Name) \
                    and n.value.id == var:
                # .files used outside a membership guard: iteration /
                # len() — the reader consumes whatever the writer wrote
                dynamic = True
        if site is None and not opts and not dynamic:
            continue
        # a guarded subscript (z["mask"] if "mask" in z.files ...) is
        # optional, not required — membership checks win
        membership_guarded = {o for o in opts}
        # an un-guarded .files sighting that ALSO appears as a guard is
        # not dynamic; re-check: Compare comparators were walked above as
        # plain Attributes too, so subtract guard sightings
        if dynamic and opts and not subs - opts:
            dynamic = len(opts) == 0
        readers.append(_NpzSite(site or 0,
                                required=subs - membership_guarded,
                                optional=opts, dynamic=dynamic))
    return writers, readers


def _check_r021(mods: list) -> list:
    findings = []
    for mod in mods:
        writers: list = []
        readers: list = []
        scopes = [n for n in mod.walk()
                  if isinstance(n, (ast.FunctionDef,
                                    ast.AsyncFunctionDef))]
        for fn in scopes:
            w, r = _npz_scope_sites(list(ast.walk(fn)))
            writers.extend(w)
            readers.extend(r)
        # dedupe (nested defs are walked by their parents too)
        writers = list({w.line: w for w in writers}.values())
        readers = list({r.line: r for r in readers}.values())
        if not writers or not readers:
            continue    # cross-module formats pair elsewhere: skip
        for r in readers:
            if r.dynamic:
                continue
            for k in sorted(r.required | r.optional):
                if any(w.dynamic or k in w.keys for w in writers):
                    continue
                what = "requires" if k in r.required else \
                    "probes optional"
                findings.append(Finding(
                    "R021", mod.rel, r.line,
                    f"npz reader {what} key {k!r} that no writer in "
                    "this module produces — wire-format drift: the "
                    "writer and reader of one payload format must agree "
                    "on the plane/key set (add the plane to the writer, "
                    "or drop the dead read)"))
        for w in writers:
            if w.dynamic:
                continue
            for k in sorted(w.keys):
                if any(r.dynamic or k in r.keys for r in readers):
                    continue
                findings.append(Finding(
                    "R021", mod.rel, w.line,
                    f"npz writer produces key {k!r} that no reader in "
                    "this module consumes — wire-format drift: either "
                    "the reader silently ignores a plane the writer "
                    "pays to serialize, or the matching read was lost"))
    return findings


# ---------------------------------------------------------------------------
def check_project(proj, mods: list, timings: dict = None) -> list:
    """Run R018/R019/R021 on the shared project. Called from
    callgraph.check so the interprocedural index is built ONCE."""
    import time as _time
    findings = []
    t0 = _time.perf_counter()
    edges = _effect_edges(proj)
    by_line = _calls_by_line(edges)
    closure = effect_closure(proj, edges)
    if timings is not None:
        timings["effects:closure"] = timings.get(
            "effects:closure", 0.0) + (_time.perf_counter() - t0)
    for rule, fn in (("R018", lambda: _check_r018(proj, edges, closure)),
                     ("R019", lambda: _check_r019(proj, edges, by_line)),
                     ("R021", lambda: _check_r021(mods))):
        t0 = _time.perf_counter()
        findings.extend(fn())
        if timings is not None:
            timings[rule] = timings.get(rule, 0.0) + \
                (_time.perf_counter() - t0)
    return findings
