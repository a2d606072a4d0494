"""The interprocedural rules of the port (h2o3_tpu/analysis/callgraph.py):
R007-R010 + R015/R016 over a project-wide call graph, lock-acquisition
graph and CLASS HIERARCHY.

The per-file rules catch the lock bugs a single screenful shows (R003
found the real Broadcaster._drain_owed case), but H2O-3's hardest
bugs were CROSS-file: the DKV, the replay channel and the scoring queues
nest each other's locks, and a lock-order cycle or a device wait under a
lock only exists in the composition. This module builds the composition:

  * a CALL GRAPH over every module handed to the analyzer — module-level
    functions, methods (`self.m()`, `Cls.m()`, same-module singleton
    `OBJ.m()`), and cross-module calls resolved through `import`/`from`
    aliases and module-level singletons (`DKV = _DKV()` makes `DKV.put`
    resolve to `_DKV.put` from any importer);
  * a CLASS HIERARCHY (v2): base classes resolve across modules
    (`class ElasticBroadcaster(_mh.Broadcaster)` links into multihost),
    and DYNAMIC DISPATCH is modeled by class-hierarchy analysis — a
    `self.m()` or receiver-typed `obj.m()` call resolves to the SET of
    possible overrides (the static type's method plus every subclass
    override), so a lock taken or a blocking wait performed inside an
    overridden method is visible from base-class call sites.  Known
    duck-typed seams (`model._score_with_params`, broadcaster handler
    methods, TierChunk hooks) resolve by method name when the name is
    private-or-whitelisted and every definition lives in ONE hierarchy —
    unrelated same-named methods never cross-wire;
  * a LOCK-ACQUISITION GRAPH: lock identities are class attributes
    assigned a Lock/RLock/Condition/Semaphore (or an analysis.lockdep
    make_lock/make_rlock/DepLock) — id `module.Class.attr`, resolved
    through cross-module base classes for inherited locks — and
    module-level lock globals — id `module.NAME`. `with <lock>:` blocks
    are tracked lexically; a `with` on something unresolvable holds
    nothing (conservative: silence over noise). Manual
    `<lock>.acquire()` / `<lock>.release()` pairs on resolvable locks
    are modeled linearly in statement order within a function body
    (try/finally shape handled); `acquire(blocking=False)` try-locks add
    held-ness but no order edge (a trylock cannot wait).

Per-function summaries (locks acquired, blocking ops, host syncs,
nondeterminism-fed state mutations, out-calls — each with the lexically
held lock set and span context) are closed over the widened call graph
to a fixpoint, then feed the rule families:

  R007 lock-order cycles  holding A while taking B (directly, or via any
                          call chain — including a subclass override —
                          that takes B) adds edge A→B; a cycle in the
                          global edge set is a deadlock schedule waiting
                          for its interleaving.
  R008 blocking-while-locked  a blocking operation reachable while a lock
                          is held: device syncs (torch.cuda.synchronize,
                          an event's or stream's .synchronize(),
                          host_fetch), socket/HTTP/subprocess,
                          timeout-less .wait()/.get()/.join()/.result().
                          `timeout=` kwarg calls are treated bounded.
  R009 use-after-donate   an argument buffer donated to a jitted call is
                          read after the call (tracks donating factories
                          through the scorer_cache _build → program
                          chain). Kept as the reference has it: the
                          port donates nothing today, so it holds a
                          jit-style donation should one appear.
  R010 thread/executor leaks  Thread without daemon/join, unmanaged
                          ThreadPoolExecutor, discarded futures.
  R015 host-sync taint    interprocedural extension of R002's span-block
                          check: a call made inside a `timeline.span`
                          block (or from the serving dispatch layer)
                          whose callee TRANSITIVELY performs a device→
                          host sync (host_fetch/.item()/.tolist()/
                          .cpu()/.numpy()/torch.cuda.synchronize()/
                          .synchronize()/float|int|bool(torch...))
                          hides a barrier on an instrumented hot path.
                          Plain np.asarray of host data is host-side
                          work and is NOT propagated; np.asarray over a
                          torch expression is.
  R016 replay-determinism broadcast-replayed code (Broadcaster/
                          ReplayHandler methods, mutating route
                          handlers, deploy/membership workers, DKV
                          re-home) reaching a nondeterminism source —
                          time.*, random/secrets/uuid/os.urandom, id(),
                          unordered-set iteration — that FEEDS state
                          mutation (self-attr writes, DKV.put,
                          global mutation). Every cloud member replays
                          the same request; divergent per-host values
                          silently fork the replicated state the
                          symmetric-peer design depends on.

Suppress a verified-safe site with `# h2o3-ok: R00n <why>` as usual.
"""

from __future__ import annotations

import ast
from collections import deque
from dataclasses import dataclass, field

from h2o3_tpu_torch.analysis.engine import Finding, Module

RULES = {"R007", "R008", "R009", "R010", "R015", "R016"}

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_LOCK_FACTORIES = {"make_lock", "make_rlock", "DepLock"}
_REENTRANT_CTORS = {"RLock", "make_rlock"}
_TIME_ROOTS = {"time", "_time", "_time_mod"}
_NP_ROOTS = {"np", "numpy", "_np", "onp"}

# ---- dynamic-dispatch duck seams ------------------------------------------
# A receiver we cannot type (`model`, `chunk`, a parameter) still resolves
# when the method NAME is distinctive: private (leading underscore, not
# dunder) or explicitly whitelisted, AND every project class defining it
# shares one hierarchy root. Public seam names that are part of the
# polymorphic serving/replay surface:
_DUCK_SEAMS = {"broadcast"}
# Private names too generic to duck-resolve even when currently unique:
_DUCK_BLACKLIST = {"_lock", "_init", "_close", "_reset"}

# external-module receiver roots that must never duck-resolve (gc.collect
# must not become Broadcaster.collect)
_EXTERNAL_ROOTS = {
    "torch", "jax", "jnp", "np", "numpy", "os", "sys", "io", "re", "json",
    "math",
    "time", "socket", "struct", "threading", "queue", "logging", "gc",
    "random", "secrets", "uuid", "subprocess", "shutil", "tempfile",
    "itertools", "functools", "collections", "weakref", "ctypes",
}


# ---------------------------------------------------------------------------
# small AST helpers
def _terminal(fn: ast.AST):
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _chain(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _mod_key(rel: str) -> str:
    """'h2o3_tpu_torch/core/kvstore.py' -> 'h2o3_tpu_torch.core.kvstore'."""
    r = rel.replace("\\", "/")
    if r.endswith(".py"):
        r = r[:-3]
    if r.endswith("/__init__"):
        r = r[: -len("/__init__")]
    return r.replace("/", ".")


def _has_bound(call: ast.Call) -> bool:
    """True when the call carries a non-None timeout/deadline kwarg —
    treated as a bounded wait (the sanctioned R008 fix shape)."""
    for kw in call.keywords:
        if kw.arg in ("timeout", "deadline", "timeout_s"):
            if isinstance(kw.value, ast.Constant) and kw.value.value is None:
                return False
            return True
    return False


def _contains_torch(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and \
                _chain(sub).startswith("torch."):
            return True
    return False


# ---------------------------------------------------------------------------
# project index: classes, functions, singletons, locks, imports
@dataclass
class _ClassInfo:
    name: str
    qual: str = ""                                  # module.Cls
    methods: dict = field(default_factory=dict)     # name -> qual
    lock_attrs: dict = field(default_factory=dict)  # attr -> (id, reentrant)
    base_exprs: list = field(default_factory=list)  # base AST nodes
    base_quals: list = field(default_factory=list)  # resolved project bases


@dataclass
class _ModInfo:
    key: str
    mod: Module
    defs: dict = field(default_factory=dict)        # fn name -> qual
    classes: dict = field(default_factory=dict)     # cls name -> _ClassInfo
    singletons: dict = field(default_factory=dict)  # var -> cls name
    locks: dict = field(default_factory=dict)       # var -> (id, reentrant)
    imports: dict = field(default_factory=dict)     # alias -> (modkey, sym)


@dataclass
class _FnInfo:
    qual: str
    mod: _ModInfo
    cls: str            # "" for module-level functions
    node: ast.AST
    # summaries (filled by _summarize)
    acquires: list = field(default_factory=list)   # (lock_id, line, held fs)
    calls: list = field(default_factory=list)      # (qual, line, held,
    #                                                 bound, in_span)
    blocking: list = field(default_factory=list)   # (desc, line, held)
    syncs: list = field(default_factory=list)      # (desc, line) host syncs
    nondet: list = field(default_factory=list)     # (desc, line) R016 sites
    # closures (filled by fixpoint)
    locks_in: set = field(default_factory=set)     # {(lock_id, rel, line)}
    blocks_in: set = field(default_factory=set)    # {(desc, rel, line)}
    syncs_in: set = field(default_factory=set)     # {(desc, rel, line)}


def _lock_ctor(value: ast.AST):
    """(is_lock, reentrant) for `threading.Lock()`-shaped values."""
    if isinstance(value, ast.Call):
        t = _terminal(value.func)
        if t in _LOCK_CTORS or t in _LOCK_FACTORIES:
            return True, t in _REENTRANT_CTORS
    return False, False


def _index_module(mod: Module) -> _ModInfo:
    mi = _ModInfo(key=_mod_key(mod.rel), mod=mod)
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mi.defs[node.name] = f"{mi.key}.{node.name}"
        elif isinstance(node, ast.ClassDef):
            ci = _ClassInfo(name=node.name, qual=f"{mi.key}.{node.name}")
            ci.base_exprs = list(node.bases)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    ci.methods[sub.name] = f"{mi.key}.{node.name}.{sub.name}"
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    is_lock, reent = _lock_ctor(sub.value)
                    if not is_lock:
                        continue
                    for t in sub.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            ci.lock_attrs[t.attr] = (
                                f"{mi.key}.{node.name}.{t.attr}", reent)
            mi.classes[node.name] = ci
        elif isinstance(node, ast.Assign):
            is_lock, reent = _lock_ctor(node.value)
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if is_lock:
                    mi.locks[t.id] = (f"{mi.key}.{t.id}", reent)
                elif isinstance(node.value, ast.Call):
                    ctor = _terminal(node.value.func)
                    if ctor in mi.classes:
                        mi.singletons[t.id] = ctor
        if isinstance(node, ast.Import):
            for a in node.names:
                mi.imports[a.asname or a.name.split(".")[0]] = (a.name, None)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                mi.imports[a.asname or a.name] = (node.module, a.name)
    return mi


class _Project:
    def __init__(self, mods: list):
        self.mods = [_index_module(m) for m in mods
                     if m.source]          # skip unreadable stubs
        self.by_key = {mi.key: mi for mi in self.mods}
        self.classes: dict = {}            # qual -> (_ClassInfo, _ModInfo)
        for mi in self.mods:
            for ci in mi.classes.values():
                self.classes[ci.qual] = (ci, mi)
        # resolve base classes ACROSS modules (class-hierarchy analysis)
        for mi in self.mods:
            for ci in mi.classes.values():
                for b in ci.base_exprs:
                    q = self._class_qual(mi, b)
                    if q is not None:
                        ci.base_quals.append(q)
        self.subs: dict = {}               # qual -> direct subclass quals
        for q, (ci, _mi) in self.classes.items():
            for bq in ci.base_quals:
                self.subs.setdefault(bq, set()).add(q)
        self._all_subs_memo: dict = {}
        self._ancestors_memo: dict = {}
        # method name -> defining class quals (the duck-seam index)
        self.method_defs: dict = {}
        for q, (ci, _mi) in self.classes.items():
            for mname in ci.methods:
                self.method_defs.setdefault(mname, set()).add(q)
        self.fns: dict = {}                # qual -> _FnInfo
        for mi in self.mods:
            for node in mi.mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = mi.defs[node.name]
                    self.fns[q] = _FnInfo(q, mi, "", node)
                elif isinstance(node, ast.ClassDef):
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            q = f"{mi.key}.{node.name}.{sub.name}"
                            self.fns[q] = _FnInfo(q, mi, node.name, sub)
        self.lock_reentrant: dict = {}     # lock_id -> bool
        for mi in self.mods:
            for lid, reent in mi.locks.values():
                self.lock_reentrant[lid] = reent
            for ci in mi.classes.values():
                for lid, reent in ci.lock_attrs.values():
                    self.lock_reentrant[lid] = reent
        self.replay_handlers = self._route_handlers()
        self._fn_nodes_memo: dict = {}

    def fn_nodes(self, fi: "_FnInfo") -> list:
        """Cached flat node list of one function body — several rules
        (R009's factory fixpoint, R016's taint passes) re-scan the same
        functions; one walk each."""
        got = self._fn_nodes_memo.get(fi.qual)
        if got is None:
            got = list(ast.walk(fi.node))
            self._fn_nodes_memo[fi.qual] = got
        return got

    # -- class hierarchy --------------------------------------------------
    def _class_qual(self, mi: _ModInfo, expr: ast.AST):
        """Project-class qual for a base-class expression, or None for
        external bases (object, Exception, third-party)."""
        if isinstance(expr, ast.Name):
            if expr.id in mi.classes:
                return mi.classes[expr.id].qual
            tgt, sym = self._import_target(mi, expr.id)
            if tgt is not None and sym in tgt.classes:
                return tgt.classes[sym].qual
            return None
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            tgt, sym = self._import_target(mi, expr.value.id)
            if tgt is not None and sym is None and expr.attr in tgt.classes:
                return tgt.classes[expr.attr].qual
        return None

    def all_subs(self, qual: str) -> set:
        """Transitive subclasses of `qual` (excluding itself)."""
        got = self._all_subs_memo.get(qual)
        if got is not None:
            return got
        out: set = set()
        work = deque(self.subs.get(qual, ()))
        while work:
            q = work.popleft()
            if q in out:
                continue
            out.add(q)
            work.extend(self.subs.get(q, ()))
        self._all_subs_memo[qual] = out
        return out

    def ancestors(self, qual: str) -> set:
        got = self._ancestors_memo.get(qual)
        if got is not None:
            return got
        out: set = set()
        work = deque([qual])
        seen = {qual}
        while work:
            q = work.popleft()
            ci_mi = self.classes.get(q)
            if ci_mi is None:
                continue
            for bq in ci_mi[0].base_quals:
                if bq not in seen:
                    seen.add(bq)
                    out.add(bq)
                    work.append(bq)
        self._ancestors_memo[qual] = out
        return out

    def mro_method(self, qual: str, name: str, _depth: int = 0):
        """The def that a call on an instance statically typed `qual`
        binds (own method, else nearest base's), or None."""
        if _depth > 8:
            return None
        got = self.classes.get(qual)
        if got is None:
            return None
        ci, _mi = got
        if name in ci.methods:
            return ci.methods[name]
        for bq in ci.base_quals:
            m = self.mro_method(bq, name, _depth + 1)
            if m is not None:
                return m
        return None

    def mro_lock(self, qual: str, attr: str, _depth: int = 0):
        """(lock_id, reentrant) for a `self.<attr>` lock, resolved
        through cross-module base classes (ElasticBroadcaster methods
        holding the base Broadcaster's _lock resolve to it)."""
        if _depth > 8:
            return None
        got = self.classes.get(qual)
        if got is None:
            return None
        ci, _mi = got
        if attr in ci.lock_attrs:
            return ci.lock_attrs[attr]
        for bq in ci.base_quals:
            m = self.mro_lock(bq, attr, _depth + 1)
            if m is not None:
                return m
        return None

    def virtual_targets(self, qual: str, name: str) -> set:
        """Class-hierarchy-analysis dispatch: the set of defs a virtual
        call `obj.name()` can bind when obj is statically `qual` — the
        static target plus every subclass override."""
        out: set = set()
        m = self.mro_method(qual, name)
        if m is not None:
            out.add(m)
        for sub in self.all_subs(qual):
            m = self.mro_method(sub, name)
            if m is not None:
                out.add(m)
        return out

    def duck_targets(self, name: str) -> set:
        """Resolve an untypable receiver's method call by NAME when the
        name is distinctive (private or a whitelisted seam) and every
        project class defining it shares one hierarchy — the
        `model._score_with_params` / TierChunk-hook seams. Unrelated
        same-named methods (or common names) resolve to nothing."""
        if name.startswith("__") or name in _DUCK_BLACKLIST:
            return set()
        if not (name.startswith("_") or name in _DUCK_SEAMS):
            return set()
        defs = self.method_defs.get(name)
        if not defs:
            return set()
        common = None
        for q in defs:
            fam = self.ancestors(q) | {q}
            common = fam if common is None else (common & fam)
        if not common:
            return set()          # multiple unrelated hierarchies: punt
        root = sorted(common)[0]
        return self.virtual_targets(root, name)

    # -- symbol resolution ------------------------------------------------
    def _import_target(self, mi: _ModInfo, alias: str):
        """(target_module_info, symbol_or_None) for an imported alias."""
        got = mi.imports.get(alias)
        if got is None:
            return None, None
        modkey, sym = got
        tgt = self.by_key.get(modkey)
        if sym is None:
            return tgt, None
        if tgt is None:
            # `from pkg import module` — the alias IS a module
            sub = self.by_key.get(f"{modkey}.{sym}")
            if sub is not None:
                return sub, None
            return None, None
        return tgt, sym

    def resolve_lock(self, mi: _ModInfo, cls: str, expr: ast.AST):
        """Lock id for a `with <expr>:` context, or None."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            recv, attr = expr.value.id, expr.attr
            if recv == "self" and cls:
                ci = mi.classes.get(cls)
                if ci is not None:
                    got = self.mro_lock(ci.qual, attr)
                    if got is not None:
                        return got[0]
                return None
            if recv in mi.singletons:
                ci = mi.classes.get(mi.singletons[recv])
                if ci is not None:
                    got = self.mro_lock(ci.qual, attr)
                    if got is not None:
                        return got[0]
                return None
            tgt, sym = self._import_target(mi, recv)
            if tgt is not None and sym is None and attr in tgt.locks:
                return tgt.locks[attr][0]
            if tgt is not None and sym is not None \
                    and sym in tgt.singletons:
                ci = tgt.classes.get(tgt.singletons[sym])
                if ci is not None:
                    got = self.mro_lock(ci.qual, attr)
                    if got is not None:
                        return got[0]
            return None
        if isinstance(expr, ast.Name):
            if expr.id in mi.locks:
                return mi.locks[expr.id][0]
            tgt, sym = self._import_target(mi, expr.id)
            if tgt is not None and sym is not None and sym in tgt.locks:
                return tgt.locks[sym][0]
        return None

    def resolve_calls(self, mi: _ModInfo, cls: str, call: ast.Call,
                      local_types: dict = None) -> set:
        """The SET of project defs this call can dispatch to (v2:
        virtual calls widen to every override; empty set = external or
        unresolvable)."""
        fn = call.func
        if isinstance(fn, ast.Name):
            if fn.id in mi.defs:
                return {mi.defs[fn.id]}
            if fn.id in mi.classes:          # constructor: exact type
                m = self.mro_method(mi.classes[fn.id].qual, "__init__")
                return {m} if m else set()
            tgt, sym = self._import_target(mi, fn.id)
            if tgt is not None and sym is not None:
                if sym in tgt.defs:
                    return {tgt.defs[sym]}
                if sym in tgt.classes:
                    m = self.mro_method(tgt.classes[sym].qual, "__init__")
                    return {m} if m else set()
            return set()
        if not isinstance(fn, ast.Attribute):
            return set()
        meth = fn.attr
        # super().m() — exact: the nearest base's def
        if isinstance(fn.value, ast.Call) and \
                _terminal(fn.value.func) == "super" and cls:
            ci = mi.classes.get(cls)
            if ci is not None:
                for bq in ci.base_quals:
                    m = self.mro_method(bq, meth)
                    if m is not None:
                        return {m}
            return set()
        if isinstance(fn.value, ast.Name):
            recv = fn.value.id
            if recv == "self" and cls:
                ci = mi.classes.get(cls)
                if ci is not None:
                    return self.virtual_targets(ci.qual, meth)
                return set()
            if local_types and recv in local_types:
                return self.virtual_targets(local_types[recv], meth)
            if recv in mi.classes:           # Cls.static(...): exact
                m = self.mro_method(mi.classes[recv].qual, meth)
                return {m} if m else set()
            if recv in mi.singletons:
                ci = mi.classes.get(mi.singletons[recv])
                if ci is not None:
                    return self.virtual_targets(ci.qual, meth)
                return set()
            tgt, sym = self._import_target(mi, recv)
            if tgt is not None:
                if sym is None:              # module alias: mod.f()
                    if meth in tgt.defs:
                        return {tgt.defs[meth]}
                    return set()
                if sym in tgt.singletons:    # from m import OBJ; OBJ.f()
                    ci = tgt.classes.get(tgt.singletons[sym])
                    if ci is not None:
                        return self.virtual_targets(ci.qual, meth)
                if sym in tgt.classes:
                    m = self.mro_method(tgt.classes[sym].qual, meth)
                    return {m} if m else set()
                return set()
            if recv in mi.imports:
                return set()    # external module: never duck-resolve
            return self.duck_targets(meth)
        # attribute-chain receiver (self.x.y.m(), h.server.broadcaster.m())
        chain = _chain(fn)
        root = chain.split(".", 1)[0] if chain else ""
        if root in mi.imports or root in _EXTERNAL_ROOTS:
            return set()
        return self.duck_targets(meth)

    # -- replay roots (R016) ----------------------------------------------
    def _route_handlers(self) -> set:
        """Defs registered as MUTATING route handlers: 3-tuples
        (re.compile(...), "<METHOD>", handler) in module-level route
        tables. Non-GET requests are broadcast-replayed on every worker
        (deploy/multihost.replay_request), so their handlers execute on
        every cloud member and carry the SPMD determinism obligation."""
        out: set = set()
        for mi in self.mods:
            # aliases of re.compile anywhere in the module (routes_ext's
            # local `R = re.compile` shorthand builds most of the table)
            compile_aliases = {"compile"}
            for node in mi.mod.walk():
                if isinstance(node, ast.Assign) and \
                        _chain(node.value) in ("re.compile", "compile"):
                    compile_aliases.update(
                        t.id for t in node.targets
                        if isinstance(t, ast.Name))
            for node in mi.mod.walk():
                if not (isinstance(node, ast.Tuple)
                        and len(node.elts) == 3):
                    continue
                pat, meth, ref = node.elts
                if not (isinstance(pat, ast.Call)
                        and _terminal(pat.func) in compile_aliases):
                    continue
                if not (isinstance(meth, ast.Constant)
                        and isinstance(meth.value, str)
                        and meth.value.upper() != "GET"):
                    continue
                t = _terminal(ref)
                if t is None:
                    continue
                if t in mi.defs:
                    out.add(mi.defs[t])
                    continue
                for ci in mi.classes.values():
                    if t in ci.methods:
                        out.add(ci.methods[t])
                        break
        return out


def _is_replay_root(fi: _FnInfo, proj: _Project) -> bool:
    """Functions that execute identically on every cloud member: the
    broadcast-replay surface (R016's root set)."""
    if fi.cls and ("Broadcaster" in fi.cls or "ReplayHandler" in fi.cls):
        return True
    rel = fi.mod.mod.rel.replace("\\", "/")
    if rel.endswith("deploy/membership.py"):
        return True
    name = getattr(fi.node, "name", "")
    if "rehome" in name or name == "replay_request":
        return True
    return fi.qual in proj.replay_handlers


# ---------------------------------------------------------------------------
# blocking-operation classification (R008)
def _blocking_desc(call: ast.Call):
    """Human-readable description when `call` is a potentially-unbounded
    blocking operation, else None."""
    fn = call.func
    bounded = _has_bound(call)
    term = _terminal(fn)
    chain = _chain(fn)
    root = chain.split(".", 1)[0] if chain else ""
    if isinstance(fn, ast.Attribute):
        if term in ("wait", "get", "join", "result") and not call.args \
                and not bounded:
            what = {"wait": "Event/Condition.wait",
                    "get": "queue.get", "join": "join",
                    "result": "future.result"}[term]
            return f".{term}() [{what} with no timeout]"
        if term in ("recv", "recv_into", "accept", "getresponse"):
            return f"socket .{term}()"
        if term in ("connect", "sendall") and root not in ("self",):
            return f"socket .{term}()"
        if term == "collect" and "broadcast" in chain.lower():
            return "replay-channel collect()"
        if term == "synchronize":
            return f"{chain or '.synchronize'}() (device barrier)"
        if term == "host_fetch":
            return "host_fetch (device→host sync)"
        if term == "sleep" and root in _TIME_ROOTS:
            return "time.sleep"
        if term == "urlopen":
            return "HTTP urlopen"
        if root in ("requests", "httpx") and \
                term in ("get", "post", "put", "delete", "request"):
            return f"HTTP {chain}"
        if root == "subprocess" and term in ("run", "check_call",
                                             "check_output", "call"):
            return f"subprocess.{term}"
        if term == "communicate" and not bounded:
            return "subprocess .communicate() with no timeout"
    elif isinstance(fn, ast.Name):
        if term == "host_fetch":
            return "host_fetch (device sync)"
        if term == "urlopen":
            return "HTTP urlopen"
        if term == "sleep":
            return "time.sleep"
        if term == "create_connection" and not bounded:
            return "socket create_connection with no timeout"
    return None


# ---------------------------------------------------------------------------
# host-sync classification (R015 — the R002 vocabulary, interprocedural)
def _sync_desc(call: ast.Call):
    fn = call.func
    term = _terminal(fn)
    if term == "host_fetch":
        return "host_fetch()"
    if isinstance(fn, ast.Attribute):
        if fn.attr in ("item", "tolist", "cpu", "numpy") \
                and not call.args and not call.keywords:
            return f".{fn.attr}()"
        if fn.attr == "synchronize":
            return f"{_chain(fn) or '.synchronize'}()"
        base = _chain(fn.value)
        if fn.attr in ("asarray", "array") and base in _NP_ROOTS \
                and call.args and _contains_torch(call.args[0]):
            return f"{base}.{fn.attr}(<torch>)"
    elif isinstance(fn, ast.Name) and term in ("float", "int", "bool") \
            and call.args and _contains_torch(call.args[0]):
        return f"{term}(<torch>)"
    return None


# ---------------------------------------------------------------------------
# nondeterminism classification (R016)
_NONDET_TIME = {"time", "time_ns", "monotonic", "monotonic_ns",
                "perf_counter", "perf_counter_ns", "process_time"}
_RANDOM_ROOTS = {"random", "_random", "secrets", "_secrets"}
_MUTATORS = {"append", "appendleft", "add", "insert", "extend", "update",
             "setdefault"}


def _nondet_desc(call: ast.Call):
    fn = call.func
    term = _terminal(fn)
    chain = _chain(fn)
    root = chain.split(".", 1)[0] if chain else ""
    if root in _TIME_ROOTS and term in _NONDET_TIME:
        return f"{chain}()"
    if root in _RANDOM_ROOTS and isinstance(fn, ast.Attribute):
        return f"{chain}()"
    if chain.startswith(("np.random.", "numpy.random.", "onp.random.")):
        return f"{chain}()"
    if root in ("uuid", "_uuid") and term in ("uuid1", "uuid4"):
        return f"{chain}()"
    if chain == "os.urandom":
        return "os.urandom()"
    if isinstance(fn, ast.Name):
        if term == "id" and call.args:
            return "id()"
        if term in ("token_hex", "token_bytes", "token_urlsafe"):
            return f"{term}()"
    return None


def _is_setish(expr: ast.AST, set_locals: set) -> bool:
    """Expression whose iteration order is Python-set order — which
    varies per process under hash randomization, so iterating it to
    mutate replicated state forks the cloud. sorted(...) is the fix."""
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call) and \
            _terminal(expr.func) in ("set", "frozenset"):
        return True
    if isinstance(expr, ast.Name) and expr.id in set_locals:
        return True
    return False


def _nondet_mutations(fi: _FnInfo, nodes: list = None, desc_fn=None,
                      call_desc=None,
                      include_set_iteration: bool = True) -> list:
    """(desc, line) sites in this function where a nondeterministic value
    (or unordered-set iteration) feeds replicated-state mutation:
    self-attribute writes, module-global container stores
    (SESSIONS[sid] = ..., OBJ.attr = ...), DKV.put, `global` rebinding.
    Local use of nondeterminism (jitter before a sleep, metrics timings
    passed to observe()) does not count — only values that LAND in
    state.

    The taint machinery is shared with R019 (effects.py), which swaps
    the source vocabulary: `desc_fn(call)` replaces _nondet_desc for the
    direct-source check, `call_desc(call)` (if given) additionally marks
    calls to interprocedurally-known divergent functions, and
    `include_set_iteration=False` drops the set-order pattern (R016
    already owns it — one site, one rule)."""
    if desc_fn is None:
        desc_fn = _nondet_desc
    node = fi.node
    if nodes is None:
        nodes = list(ast.walk(node))
    global_names: set = set()
    for n in nodes:
        if isinstance(n, ast.Global):
            global_names.update(n.names)
    # module-level names this module (or an import) binds — a subscript
    # or attribute store rooted at one mutates shared state even without
    # a `global` declaration. Plain-Name assignments in THIS function
    # shadow them (Python scoping), so those names drop out.
    mod_globals: set = set()
    mi = fi.mod
    for top in mi.mod.tree.body:
        if isinstance(top, ast.Assign):
            mod_globals.update(t.id for t in top.targets
                               if isinstance(t, ast.Name))
        elif isinstance(top, ast.AnnAssign) and \
                isinstance(top.target, ast.Name):
            mod_globals.add(top.target.id)
    mod_globals.update(mi.imports)
    # function-local module imports (`from h2o3_tpu_torch.api import server as
    # _srv` inside the handler) alias shared module state too — a store
    # through them is replicated-state mutation
    for n in nodes:
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            mod_globals.update(a.asname or a.name.split(".")[0]
                               for a in n.names)
    local_shadow: set = set()
    for n in nodes:
        if isinstance(n, ast.Assign):
            local_shadow.update(t.id for t in n.targets
                                if isinstance(t, ast.Name)
                                and t.id not in global_names)
    mod_globals -= local_shadow

    assigns = [n for n in nodes
               if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))]
    tainted: set = set()
    set_locals: set = set()

    def expr_taint(e: ast.AST):
        for sub in ast.walk(e):
            if isinstance(sub, ast.Call):
                d = desc_fn(sub)
                if d is None and call_desc is not None:
                    d = call_desc(sub)
                if d is not None:
                    return d
            elif isinstance(sub, ast.Name) and \
                    isinstance(sub.ctx, ast.Load) and sub.id in tainted:
                return f"a value derived from nondeterministic {sub.id!r}"
        return None

    changed, guard = True, 0
    while changed and guard < 6:
        changed = False
        guard += 1
        for a in assigns:
            v = getattr(a, "value", None)
            if v is None:
                continue
            tgts = a.targets if isinstance(a, ast.Assign) else [a.target]
            if expr_taint(v) is not None:
                for t in tgts:
                    if isinstance(t, ast.Name) and t.id not in tainted:
                        tainted.add(t.id)
                        changed = True
            if _is_setish(v, set_locals):
                for t in tgts:
                    if isinstance(t, ast.Name) and t.id not in set_locals:
                        set_locals.add(t.id)
                        changed = True

    def _is_state_target(t: ast.AST) -> bool:
        if isinstance(t, ast.Attribute):
            c = _chain(t)
        elif isinstance(t, ast.Subscript):
            c = _chain(t.value)
        elif isinstance(t, ast.Name):
            return t.id in global_names
        else:
            return False
        if not c:
            return False
        root = c.split(".", 1)[0]
        return root == "self" or root in mod_globals

    out: list = []
    for a in assigns:
        tgts = a.targets if isinstance(a, ast.Assign) else [a.target]
        if not any(_is_state_target(t) for t in tgts):
            continue
        d = None
        v = getattr(a, "value", None)
        if v is not None:
            d = expr_taint(v)
        if d is None:
            for t in tgts:
                if isinstance(t, ast.Subscript):
                    d = expr_taint(t.slice)
                    if d is not None:
                        break
        if d is not None:
            out.append((d, a.lineno))

    for n in nodes:
        if not (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)):
            continue
        recv_chain = _chain(n.func.value)
        root = recv_chain.split(".", 1)[0] if recv_chain else ""
        is_state = (root == "self" and n.func.attr in _MUTATORS) or \
            (root in mod_globals and n.func.attr in _MUTATORS) or \
            (n.func.attr == "put"
             and "dkv" in recv_chain.lower())
        if not is_state:
            continue
        for arg in list(n.args) + [kw.value for kw in n.keywords]:
            d = expr_taint(arg)
            if d is not None:
                out.append(
                    (f"{d} flowing into {recv_chain}.{n.func.attr}()",
                     n.lineno))
                break

    def _mutates_state(body: list) -> bool:
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.Assign, ast.AugAssign)):
                    tg = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    if any(_is_state_target(t) for t in tg):
                        return True
                elif isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute):
                    rc = _chain(sub.func.value)
                    rt = rc.split(".", 1)[0] if rc else ""
                    if ((rt == "self" or rt in mod_globals)
                            and sub.func.attr in _MUTATORS) or \
                            (sub.func.attr == "put"
                             and "dkv" in rc.lower()):
                        return True
        return False

    if include_set_iteration:
        for n in nodes:
            if isinstance(n, ast.For) and _is_setish(n.iter, set_locals) \
                    and _mutates_state(n.body):
                out.append(("iteration over an unordered set", n.lineno))
    return out


# ---------------------------------------------------------------------------
# per-function lexical summary
def _is_trylock(call: ast.Call) -> bool:
    """acquire(False) / acquire(blocking=False): cannot wait, so it adds
    held-ness but no order dependency (Linux lockdep's trylock rule)."""
    if call.args and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value is False:
        return True
    for kw in call.keywords:
        if kw.arg == "blocking" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    return False


def _local_ctor_types(fi: _FnInfo, proj: _Project) -> dict:
    """{local var: class qual} for `x = Cls(...)` assignments — lets
    `x.m()` dispatch through the hierarchy of the constructed type."""
    mi = fi.mod
    out: dict = {}
    for node in proj.fn_nodes(fi):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        f = node.value.func
        cq = None
        if isinstance(f, ast.Name):
            if f.id in mi.classes:
                cq = mi.classes[f.id].qual
            else:
                tgt, sym = proj._import_target(mi, f.id)
                if tgt is not None and sym in tgt.classes:
                    cq = tgt.classes[sym].qual
        elif isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name):
            tgt, sym = proj._import_target(mi, f.value.id)
            if tgt is not None and sym is None and f.attr in tgt.classes:
                cq = tgt.classes[f.attr].qual
        if cq is not None:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = cq
    return out


def _is_span_item(item: ast.withitem) -> bool:
    ctx = item.context_expr
    return isinstance(ctx, ast.Call) and \
        _terminal(ctx.func) in ("span", "_span")


def _summarize(fi: _FnInfo, proj: _Project):
    mi, cls = fi.mod, fi.cls
    local_types = _local_ctor_types(fi, proj)
    # locks held via manual .acquire()/.release(): tracked linearly in
    # statement order across the whole function body (the AST walk visits
    # try bodies before finally blocks, so the common acquire/try/finally-
    # release shape holds exactly the guarded statements)
    manual: list = []

    def held_set(held: tuple) -> frozenset:
        return frozenset(held) | frozenset(manual)

    def visit(node, held: tuple, in_span: bool):
        if isinstance(node, ast.With):
            ids = []
            span_here = in_span
            for item in node.items:
                lid = proj.resolve_lock(mi, cls, item.context_expr)
                if lid is not None:
                    fi.acquires.append((lid, node.lineno, held_set(held)))
                    ids.append(lid)
                if _is_span_item(item):
                    span_here = True
                visit(item.context_expr, held, in_span)
            inner = tuple(held) + tuple(i for i in ids if i not in held)
            for child in node.body:
                visit(child, inner, span_here)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return      # nested scope: summarized separately (module defs)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("acquire", "release"):
                lid = proj.resolve_lock(mi, cls, node.func.value)
                if lid is not None:
                    if node.func.attr == "acquire":
                        if not _is_trylock(node):
                            fi.acquires.append(
                                (lid, node.lineno, held_set(held)))
                        manual.append(lid)
                    elif lid in manual:
                        manual.remove(lid)
                    for child in ast.iter_child_nodes(node):
                        visit(child, held, in_span)
                    return
            desc = _blocking_desc(node)
            if desc is not None:
                fi.blocking.append((desc, node.lineno, held_set(held)))
            sdesc = _sync_desc(node)
            if sdesc is not None:
                fi.syncs.append((sdesc, node.lineno))
            for callee in proj.resolve_calls(mi, cls, node, local_types):
                if callee in proj.fns:
                    fi.calls.append((callee, node.lineno, held_set(held),
                                     _has_bound(node), in_span))
        for child in ast.iter_child_nodes(node):
            visit(child, held, in_span)

    body = fi.node.body if hasattr(fi.node, "body") else []
    for child in body:
        visit(child, (), False)
    fi.nondet = _nondet_mutations(fi, proj.fn_nodes(fi))


def _fixpoint(proj: _Project):
    """Close locks_in / blocks_in / syncs_in over the call graph.
    blocks_in does not propagate through bounded (timeout-kwarg) calls;
    locks_in and syncs_in always propagate (a bounded wait still nests
    the callee's locks, and a bounded call still pays its syncs)."""
    for fi in proj.fns.values():
        fi.locks_in = {(lid, fi.mod.mod.rel, ln)
                       for lid, ln, _ in fi.acquires}
        fi.blocks_in = {(d, fi.mod.mod.rel, ln)
                        for d, ln, _ in fi.blocking}
        fi.syncs_in = {(d, fi.mod.mod.rel, ln)
                       for d, ln in fi.syncs}
    changed = True
    guard = 0
    while changed and guard < 50:
        changed = False
        guard += 1
        for fi in proj.fns.values():
            for callee, _ln, _held, bound, _sp in fi.calls:
                cf = proj.fns.get(callee)
                if cf is None:
                    continue
                if not cf.locks_in <= fi.locks_in:
                    fi.locks_in |= cf.locks_in
                    changed = True
                if not cf.syncs_in <= fi.syncs_in:
                    fi.syncs_in |= cf.syncs_in
                    changed = True
                if not bound and not cf.blocks_in <= fi.blocks_in:
                    fi.blocks_in |= cf.blocks_in
                    changed = True


def build_project(mods: list) -> _Project:
    """Index + summarize + close: the shared analysis context every rule
    in this module (and the tests) runs against — built ONCE per
    analyzer invocation."""
    proj = _Project(mods)
    for fi in proj.fns.values():
        _summarize(fi, proj)
    _fixpoint(proj)
    return proj


# ---------------------------------------------------------------------------
# R007: lock-order cycles
def _lock_edges(proj: _Project):
    """{(a, b): (rel, line, note)} — first site seen for each order edge."""
    edges: dict = {}

    def add(a, b, rel, line, note):
        if a == b:
            return              # re-entry: handled by reentrancy, not order
        edges.setdefault((a, b), (rel, line, note))

    for fi in proj.fns.values():
        rel = fi.mod.mod.rel
        for lid, line, held in fi.acquires:
            for h in held:
                add(h, lid, rel, line, f"{_short(h)} → {_short(lid)}")
        for callee, line, held, _bound, _sp in fi.calls:
            if not held:
                continue
            cf = proj.fns.get(callee)
            if cf is None:
                continue
            for (lid, orel, oline) in cf.locks_in:
                for h in held:
                    add(h, lid, rel, line,
                        f"{_short(h)} → {_short(lid)} via {callee}() "
                        f"(acquired at {orel}:{oline})")
    return edges


def _short(lock_id: str) -> str:
    return lock_id.split(".", 2)[-1] if lock_id.count(".") > 2 else lock_id


def _find_cycles(edges: dict) -> list:
    """Minimal cycles as lists of (a, b) edges, one per cycle set."""
    succ: dict = {}
    for (a, b) in edges:
        succ.setdefault(a, set()).add(b)
    cycles = []
    seen_cycle_keys = set()
    for start in sorted(succ):
        # BFS back to start
        prev = {start: None}
        queue = [start]
        found = None
        while queue and found is None:
            cur = queue.pop(0)
            for nxt in sorted(succ.get(cur, ())):
                if nxt == start:
                    found = cur
                    break
                if nxt not in prev:
                    prev[nxt] = cur
                    queue.append(nxt)
        if found is None:
            continue
        path = [found]
        while prev[path[-1]] is not None:
            path.append(prev[path[-1]])
        path.reverse()              # start ... found
        nodes = [start] if path == [start] else path
        cyc = [(nodes[i], nodes[(i + 1) % len(nodes)])
               for i in range(len(nodes))]
        if len(nodes) == 1:
            continue
        key = frozenset(nodes)
        if key not in seen_cycle_keys:
            seen_cycle_keys.add(key)
            cycles.append(cyc)
    return cycles


def _check_r007(proj: _Project) -> list:
    findings = []
    edges = _lock_edges(proj)
    for cyc in _find_cycles(edges):
        sites = [edges[e] for e in cyc]
        rel, line, _ = sites[0]
        desc = " ; ".join(
            f"{_short(a)}→{_short(b)} ({edges[(a, b)][0]}:"
            f"{edges[(a, b)][1]})" for a, b in cyc)
        findings.append(Finding(
            "R007", rel, line,
            f"lock-order cycle: {desc} — two threads taking these locks "
            "in opposing order deadlock; pick one global order (or merge "
            "the critical sections)"))
    return findings


# ---------------------------------------------------------------------------
# R008: blocking while holding a lock
def _check_r008(proj: _Project) -> list:
    findings = []
    for fi in proj.fns.values():
        rel = fi.mod.mod.rel
        for desc, line, held in fi.blocking:
            if held:
                findings.append(Finding(
                    "R008", rel, line,
                    f"{desc} while holding {_short(sorted(held)[0])}: a "
                    "stall here wedges every thread touching the lock — "
                    "bound the wait (timeout=) or move it outside the "
                    "critical section"))
        for callee, line, held, bound, _sp in fi.calls:
            if not held or bound:
                continue
            cf = proj.fns.get(callee)
            if cf is None or not cf.blocks_in:
                continue
            desc, orel, oline = sorted(cf.blocks_in)[0]
            findings.append(Finding(
                "R008", rel, line,
                f"call into {callee}() while holding "
                f"{_short(sorted(held)[0])}: it reaches {desc} "
                f"({orel}:{oline}) — a stall there wedges the lock; "
                "bound the wait or hoist the call out of the critical "
                "section"))
    return findings


# ---------------------------------------------------------------------------
# R009: donated-buffer use-after-donate
def _donate_positions(call: ast.Call):
    """Donated arg positions of a jax.jit(...) call, or None if not a
    donating jit. Non-literal donate_argnums conservatively means 'all'."""
    if _terminal(call.func) not in ("jit", "pjit"):
        return None
    for kw in call.keywords:
        if kw.arg in ("donate_argnums", "donate_argnames"):
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return {v.value}
            if isinstance(v, (ast.Tuple, ast.List)):
                out = set()
                for e in v.elts:
                    if isinstance(e, ast.Constant) and \
                            isinstance(e.value, int):
                        out.add(e.value)
                return out if out else set()
            return None if isinstance(v, ast.Constant) and v.value is None \
                else {"*"}          # computed: any positional arg
    return None


def _resolved_positions(proj, fi, call, table):
    """Donate positions for an assignment RHS: a direct donating jit, or
    a call into a factory already known to `table` (any dispatch
    target)."""
    p = _donate_positions(call)
    if p:
        return p
    out = None
    for callee in proj.resolve_calls(fi.mod, fi.cls, call):
        got = table.get(callee)
        if got:
            out = (out or set()) | got
    return out


def _donating_factories(proj: _Project) -> dict:
    """{qual: positions} for functions that RETURN a donating jit —
    directly, via a local var, or via a call to another donating factory
    (fixpoint, so scorer_cache's _build → program chain resolves)."""
    out: dict = {}
    changed = True
    guard = 0
    while changed and guard < 10:
        changed = False
        guard += 1
        for fi in proj.fns.values():
            if fi.qual in out:
                continue
            # local name -> positions (assigned from jit or factory call)
            local: dict = {}
            pos = None
            for node in proj.fn_nodes(fi):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call):
                    p = _resolved_positions(proj, fi, node.value, out)
                    if p:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                local[t.id] = p
                if isinstance(node, ast.Return) and node.value is not None:
                    v = node.value
                    if isinstance(v, ast.Call):
                        p = _resolved_positions(proj, fi, v, out)
                        if p:
                            pos = (pos or set()) | p
                    elif isinstance(v, ast.Name) and v.id in local:
                        pos = (pos or set()) | local[v.id]
            if pos:
                out[fi.qual] = pos
                changed = True
    return out


def _check_r009(proj: _Project) -> list:
    findings = []
    factories = _donating_factories(proj)
    for fi in proj.fns.values():
        rel = fi.mod.mod.rel
        # donating callables visible in this function body: local vars
        donating: dict = {}        # var name -> positions
        calls = []                 # (lineno, donated arg Name -> str)
        for node in proj.fn_nodes(fi):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                p = _resolved_positions(proj, fi, node.value, factories)
                if p:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            donating[t.id] = p
        if not donating:
            continue
        for node in proj.fn_nodes(fi):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in donating:
                pos = donating[node.func.id]
                for i, arg in enumerate(node.args):
                    if isinstance(arg, ast.Name) and \
                            ("*" in pos or i in pos):
                        calls.append((node.lineno, arg.id, node.func.id))
        if not calls:
            continue
        stores: dict = {}          # name -> sorted store linenos after def
        loads: dict = {}
        for node in proj.fn_nodes(fi):
            if isinstance(node, ast.Name):
                d = stores if isinstance(node.ctx, ast.Store) else loads
                d.setdefault(node.id, []).append(node.lineno)
        for call_line, buf, fname in calls:
            rebinds = [ln for ln in stores.get(buf, []) if ln > call_line]
            kill = min(rebinds) if rebinds else None
            for ln in sorted(loads.get(buf, [])):
                if ln <= call_line:
                    continue
                if kill is not None and ln > kill:
                    break
                findings.append(Finding(
                    "R009", rel, ln,
                    f"{buf!r} is read after being donated to {fname}() at "
                    f"line {call_line}: donate_argnums lets XLA alias the "
                    "buffer, so this read returns garbage — copy before "
                    "the call or drop the donation"))
                break              # one finding per donated call is enough
    return findings


# ---------------------------------------------------------------------------
# R010: thread / executor leaks
def _check_r010_module(mod: Module) -> list:
    findings = []
    parents = mod.parents()
    src = mod.source

    def _kw(call, name):
        for kw in call.keywords:
            if kw.arg == name:
                return kw.value
        return None

    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        term = _terminal(node.func)
        chain = _chain(node.func)
        if term == "Thread" and (chain in ("Thread", "threading.Thread")
                                 or chain.endswith(".Thread")):
            d = _kw(node, "daemon")
            if isinstance(d, ast.Constant) and d.value:
                continue
            parent = parents.get(node)
            target = None
            if isinstance(parent, ast.Attribute) and parent.attr == "start":
                # Thread(...).start(): no handle survives to join
                findings.append(Finding(
                    "R010", mod.rel, node.lineno,
                    "Thread(...).start() without daemon=True and without "
                    "keeping a handle: the thread can never be joined, "
                    "and a non-daemon leak blocks interpreter exit"))
                continue
            if isinstance(parent, ast.Assign):
                for t in parent.targets:
                    if isinstance(t, ast.Name):
                        target = t.id
                    elif isinstance(t, ast.Attribute):
                        target = t.attr
            if target is None:
                continue            # handed elsewhere: give benefit of doubt
            if f"{target}.join" in src or f"{target}.daemon" in src:
                continue
            findings.append(Finding(
                "R010", mod.rel, node.lineno,
                f"thread {target!r} is started with neither daemon=True "
                "nor any .join() in this module: it leaks past its owner "
                "(failures vanish, exit hangs) — join it, or mark daemon "
                "with a reason"))
        elif term == "ThreadPoolExecutor":
            parent = parents.get(node)
            if isinstance(parent, ast.withitem):
                continue
            target = None
            if isinstance(parent, ast.Assign):
                for t in parent.targets:
                    if isinstance(t, ast.Name):
                        target = t.id
                    elif isinstance(t, ast.Attribute):
                        target = t.attr
            if target is not None and (f"{target}.shutdown" in src
                                       or f"with {target}" in src):
                continue
            findings.append(Finding(
                "R010", mod.rel, node.lineno,
                "ThreadPoolExecutor neither context-managed nor "
                ".shutdown(): worker threads outlive the work — use "
                "`with ThreadPoolExecutor(...) as pool:`"))
        elif term == "submit" and isinstance(node.func, ast.Attribute):
            parent = parents.get(node)
            if isinstance(parent, ast.Expr):
                findings.append(Finding(
                    "R010", mod.rel, node.lineno,
                    "executor .submit() with the future discarded: the "
                    "task's exception is silently lost — keep the future "
                    "and .result() it (or collect via as_completed)"))
    return findings


# ---------------------------------------------------------------------------
# R015: interprocedural host-sync taint
_DIRECT_SYNC_LEAVES = {"host_fetch", "synchronize"}


def _is_explicit_sync(desc: str) -> bool:
    """host_fetch, `.cpu()` and `.numpy()` are the SANCTIONED explicit-
    transfer spellings (the readback at the edge, as device_get is in
    the JAX package) — on the serving dispatch path they are staging,
    not a hidden barrier. Inside a span block even an explicit transfer
    distorts the measurement, so span roots keep the strict check."""
    return desc.startswith(("host_fetch", ".cpu()", ".numpy()"))


def _check_r015(proj: _Project) -> list:
    findings = []
    seen: set = set()
    for fi in proj.fns.values():
        rel = fi.mod.mod.rel.replace("\\", "/")
        serving_root = rel.startswith("h2o3_tpu_torch/serving/")
        for callee, line, _held, _bound, in_span in fi.calls:
            if not (in_span or serving_root):
                continue
            cf = proj.fns.get(callee)
            if cf is None or not cf.syncs_in:
                continue
            if callee.rsplit(".", 1)[-1] in _DIRECT_SYNC_LEAVES:
                continue    # the call IS the sync: R002 flags it lexically
            syncs = cf.syncs_in
            if not in_span:
                syncs = {s for s in syncs if not _is_explicit_sync(s[0])}
            if not syncs:
                continue
            key = (fi.mod.mod.rel, line)
            if key in seen:
                continue
            seen.add(key)
            desc, orel, oline = sorted(syncs)[0]
            where = "inside a timeline.span block" if in_span \
                else "on the serving dispatch path"
            findings.append(Finding(
                "R015", fi.mod.mod.rel, line,
                f"call into {callee}() {where} reaches {desc} "
                f"({orel}:{oline}): a hidden device→host sync on an "
                "instrumented hot path — the measurement includes the "
                "transfer, and the barrier serializes the pipeline; "
                "hoist the readback out (an explicit .cpu() at the "
                "edge), or suppress with the reason the sync IS the "
                "work"))
    return findings


# ---------------------------------------------------------------------------
# R016: replay determinism
def _check_r016(proj: _Project) -> list:
    roots = [fi.qual for fi in proj.fns.values()
             if _is_replay_root(fi, proj)]
    if not roots:
        return []
    parent: dict = {}
    work: deque = deque()
    for r in sorted(roots):
        if r not in parent:
            parent[r] = None
            work.append(r)
    while work:
        cur = work.popleft()
        cf = proj.fns.get(cur)
        if cf is None:
            continue
        for callee, _ln, _held, _bound, _sp in cf.calls:
            if callee not in parent:
                parent[callee] = cur
                work.append(callee)
    findings = []
    seen: set = set()
    for qual in parent:
        fi = proj.fns.get(qual)
        if fi is None or not fi.nondet:
            continue
        root = qual
        while parent[root] is not None:
            root = parent[root]
        via = "" if root == qual else f", reachable from {root}()"
        for desc, line in fi.nondet:
            key = (fi.mod.mod.rel, line)
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                "R016", fi.mod.mod.rel, line,
                f"{desc} feeds state mutation in {qual}() — broadcast-"
                f"replayed code{via}: every cloud member replays this "
                "with its OWN nondeterministic value, silently forking "
                "the replicated state the SPMD design depends on — "
                "derive the value from the replayed request, sort the "
                "iteration, or compute once on the coordinator and ship "
                "the result"))
    return findings


# ---------------------------------------------------------------------------
def check(mods: list) -> list:
    """R007–R010/R015/R016 plus the effect-lattice rules (R018/R019/
    R021, effects.py) and the flow-sensitive lifecycle rules (R022–
    R025, lifecycle.py) — all off ONE build_project() index: the
    interprocedural passes share the analyzer's single biggest cost.
    Per-rule wall time lands in engine.RULE_TIMINGS (SELF_TIMED: the
    engine's per-check timer can't see inside this shared pass)."""
    import time as _time

    from h2o3_tpu_torch.analysis import effects as _effects
    from h2o3_tpu_torch.analysis import engine as _engine
    timings = _engine.RULE_TIMINGS

    def _timed(key, fn, *a):
        t0 = _time.perf_counter()
        out = fn(*a)
        timings[key] = timings.get(key, 0.0) + (_time.perf_counter() - t0)
        return out

    t0 = _time.perf_counter()
    proj = build_project(mods)
    timings["callgraph:index"] = timings.get(
        "callgraph:index", 0.0) + (_time.perf_counter() - t0)
    findings = []
    findings.extend(_timed("R007", _check_r007, proj))
    findings.extend(_timed("R008", _check_r008, proj))
    findings.extend(_timed("R009", _check_r009, proj))
    t0 = _time.perf_counter()
    for mi in proj.mods:
        findings.extend(_check_r010_module(mi.mod))
    timings["R010"] = timings.get("R010", 0.0) + \
        (_time.perf_counter() - t0)
    findings.extend(_timed("R015", _check_r015, proj))
    findings.extend(_timed("R016", _check_r016, proj))
    findings.extend(_effects.check_project(proj, mods, timings))
    from h2o3_tpu_torch.analysis import lifecycle as _lifecycle
    findings.extend(_lifecycle.check_project(proj, mods, timings))
    return findings


check.RULES = RULES | {"R018", "R019", "R021"} \
    | {"R022", "R023", "R024", "R025"}
check.SELF_TIMED = True
