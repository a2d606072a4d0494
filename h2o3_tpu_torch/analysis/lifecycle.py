"""The lifecycle rules of the port (h2o3_tpu/analysis/lifecycle.py):
flow-sensitive (R022-R025) over the exception-edge CFG.

The serving and replay layers' leaks share one bug shape: a PAIRED
protocol — reserve→commit/rollback, slot acquire→release,
prepay→adopt/settle, refcount place→free, gauge register→remove —
whose closer is skipped on an exception or early-return path (the
FairGate slot leak, the ParamStore refs=1 permanent HBM leak, the ghost
gauge series, the admission double-count — every one hand-fixed).
R001-R021 are flow-insensitive and cannot see this class. These rules
run the cfg.py exception-edge graph over a declarative PAIR REGISTRY:

  * R022 paired-protocol leak — an opener whose matching closer is NOT
    reached on every CFG path (normal fall-through, early return, and
    the exception edge out of every call/attribute access). `with`
    items and try/finally closers prove closed by construction; a
    helper that closes on EVERY one of its own paths counts as a closer
    at its call sites (interprocedural closure over the dispatch-
    resolved callgraph); a helper that only conditionally closes does
    not — exactly the paths where it doesn't are the leak. Tokens that
    ESCAPE the function (returned, stored on self, captured by a
    closure, handed to a non-closer call) transfer ownership and are
    not flagged here — returns are R024's job, stored/captured tokens
    belong to an object lifecycle the runtime leaktrack sanitizer owns.
    Per-entity gauge series (`.set(..., label=)` with no `.remove(...)`
    anywhere in the module) are the registry's one flow-INsensitive
    pair: a ghost series outlives its entity no matter which path
    registered it.
  * R023 swallowed control-flow exception — a broad `except Exception`
    on a dispatch/serving/replay path whose body neither re-raises nor
    filters the typed control exceptions (RateLimited, QuotaExceeded,
    DeadlineExceeded, EpochChanged, DivergenceError) that MUST
    propagate to produce their status codes. Flagged only where one
    can actually ARRIVE: a call in the try body resolves (through the
    callgraph, transitively) into a function that raises one — a
    heartbeat loop swallowing socket errors owes nothing. A preceding
    typed handler arm counts as the filter.
  * R024 leaked-return protocol — a call to a function that RETURNS an
    open resource (the registry openers, plus any wrapper that returns
    one unclosed) whose result is discarded, or bound by a wrapper
    caller and never closed on some path.
  * R025 the CUDA-graph capture contract of the scorer family — the
    `_score_with_params` family and every function it reaches (and the
    scorer_cache `_build` closures) free of module-level device tensors
    captured by closure, and of float(x)/bool(x)/int(x)/`if x:` on a
    tensor argument (function parameters and what is computed from
    them; shape/ndim/dtype/len reads, `x is None` and string-constant
    config dispatch are static and exempt). A graph replays the
    pointers and the branches of its capture: a module-level tensor is
    one buffer every program shares, and a branch on a tensor syncs at
    capture (the capture fails) and is frozen in the graph.

All four ride the ONE build_project index (callgraph.check calls
check_project here, after effects.py) and build CFGs lazily, only for
functions that mention a registered opener or closer.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from h2o3_tpu_torch.analysis import callgraph as _cg
from h2o3_tpu_torch.analysis import cfg as _cfg
from h2o3_tpu_torch.analysis.engine import Finding

RULES = {"R022", "R023", "R024", "R025"}

# typed control exceptions that must propagate through dispatch layers
CONTROL_EXCEPTIONS = {"RateLimited", "QuotaExceeded", "DeadlineExceeded",
                      "EpochChanged", "DivergenceError"}

# module prefixes that constitute the dispatch/serving/replay surface
# (R023 scope; replay roots from the callgraph join regardless of path)
_R023_PREFIXES = ("h2o3_tpu_torch/api/", "h2o3_tpu_torch/serving/",
                  "h2o3_tpu_torch/deploy/")


# ---------------------------------------------------------------------------
# pair registry
@dataclass(frozen=True)
class Pair:
    """One paired protocol. Openers/closers match a call site when a
    dispatch-resolved callee qual ends with an entry in *_quals, or the
    textual receiver chain ends with an entry in *_chains (the chain
    fallback catches `_qos.GATE.acquire(...)` singleton sites the
    callgraph's import-alias resolution deliberately punts on)."""
    key: str
    desc: str
    opener_quals: tuple = ()
    opener_chains: tuple = ()
    closer_quals: tuple = ()
    closer_chains: tuple = ()
    token: bool = False        # opener returns a token worth tracking
    falsy_ok: bool = False     # falsy token == nothing acquired (guards
    #                            on the bare token var are acquire tests)
    scoped: bool = False       # request-scoped: the closer lives in the
    #                            request teardown frame — only path-check
    #                            functions that contain a closer themselves


PAIRS = (
    Pair("qos.gate", "FairGate dispatch slot",
         opener_quals=("FairGate.acquire",),
         opener_chains=("GATE.acquire",),
         closer_quals=("FairGate.release",),
         closer_chains=("GATE.release",),
         token=True, falsy_ok=True),
    Pair("qos.job_slot", "concurrent-job quota charge",
         opener_quals=(".acquire_job_slot",),
         opener_chains=(".acquire_job_slot", "acquire_job_slot"),
         closer_quals=(".release_job_slot",),
         closer_chains=(".release_job_slot", "release_job_slot"),
         token=True, falsy_ok=True),
    Pair("qos.prepaid", "prepaid job-slot charge",
         opener_quals=(".prepay_job_slot",),
         opener_chains=(".prepay_job_slot", "prepay_job_slot"),
         closer_quals=(".adopt_prepaid_job_slot",
                       ".settle_prepaid_job_slot"),
         closer_chains=(".adopt_prepaid_job_slot", "adopt_prepaid_job_slot",
                        ".settle_prepaid_job_slot",
                        "settle_prepaid_job_slot"),
         scoped=True),
    Pair("qos.edge_admit", "edge-admission flag",
         opener_quals=(".edge_admit",),
         opener_chains=(".edge_admit", "edge_admit"),
         closer_quals=(".end_request",),
         closer_chains=(".end_request", "end_request"),
         scoped=True),
    Pair("qos.lane", "interactive-lane counter",
         opener_quals=(".note_interactive_start",),
         opener_chains=(".note_interactive_start",
                        "note_interactive_start"),
         closer_quals=(".note_interactive_end",),
         closer_chains=(".note_interactive_end", "note_interactive_end"),
         scoped=True),
    Pair("tiering.reserve", "byte-budget reservation",
         opener_quals=("._try_reserve",),
         opener_chains=("._try_reserve",),
         closer_quals=("._release_reservation",),
         closer_chains=("._release_reservation",),
         token=True, falsy_ok=True),
    Pair("params.refcount", "model-param placement refcount",
         opener_quals=("ParamStore.acquire",),
         opener_chains=("PARAMS.acquire",),
         closer_quals=("ParamStore.release",),
         closer_chains=("PARAMS.release",),
         token=True),
    Pair("usage.request", "usage-attribution request record",
         opener_quals=(".begin_request",),
         opener_chains=(".begin_request", "begin_request"),
         closer_quals=(".finish_request", ".clear_request"),
         closer_chains=(".finish_request", "finish_request",
                        ".clear_request", "clear_request"),
         scoped=True),
)


def _suffix_terms(pair: Pair, closer: bool) -> frozenset:
    """Terminal attr names for the cheap candidate prefilter."""
    src = (pair.closer_quals + pair.closer_chains) if closer \
        else (pair.opener_quals + pair.opener_chains)
    return frozenset(s.rsplit(".", 1)[-1] for s in src)


_PAIR_OPENER_TERMS = {p.key: _suffix_terms(p, False) for p in PAIRS}
_PAIR_CLOSER_TERMS = {p.key: _suffix_terms(p, True) for p in PAIRS}


# ---------------------------------------------------------------------------
# one-pass call index: receiver chains are computed ONCE per call node
# (R022+R024 visits every call per pair, per fixpoint round — recomputing
# _chain dominated the first profile at 6x the whole analyzer budget)
class _Idx:
    def __init__(self, proj):
        self.chain: dict = {}     # call node -> receiver chain
        self.term: dict = {}      # call node -> terminal attr/name
        self.calls: dict = {}     # qual -> [call nodes]
        self.byline: dict = {}    # qual -> {line: {callee qual}}
        self.terms: dict = {}     # qual -> {call terminals}
        self.callees: dict = {}   # qual -> {resolved callee qual}
        for qual, fi in proj.fns.items():
            calls = [n for n in proj.fn_nodes(fi)
                     if isinstance(n, ast.Call)]
            self.calls[qual] = calls
            terms = set()
            for c in calls:
                ch = _cg._chain(c.func)
                self.chain[c] = ch
                t = ch.rsplit(".", 1)[-1] if ch \
                    else (_cg._terminal(c.func) or "")
                self.term[c] = t
                terms.add(t)
            self.terms[qual] = terms
            by: dict = {}
            for q, ln, _h, _b, _s in fi.calls:
                by.setdefault(ln, set()).add(q)
            self.byline[qual] = by
            self.callees[qual] = {c[0] for c in fi.calls}


def _match(idx: _Idx, qual: str, call: ast.Call, quals: tuple,
           chains: tuple) -> bool:
    chain = idx.chain.get(call)
    if chain is None:
        chain = _cg._chain(call.func)
    if chain and any(chain.endswith(c) for c in chains):
        return True
    for q in idx.byline.get(qual, {}).get(call.lineno, ()):
        if any(q.endswith(s) for s in quals):
            return True
    return False


def _stmt_exprs(stmt) -> list:
    """The expressions a CFG block for `stmt` actually EVALUATES — a
    compound statement's block is its header only (an If block must not
    claim the closers buried in its branches, or an else-path leak
    proves closed)."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, (ast.Try, ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    return [stmt]


def _calls_under(stmt) -> list:
    return [n for e in _stmt_exprs(stmt) for n in ast.walk(e)
            if isinstance(n, ast.Call)]


def _enclosing_stmt(mod, node):
    """Nearest ancestor that is a statement (the CFG's block unit)."""
    parents = mod.parents()
    cur = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = parents.get(cur)
    return cur


def _inside_withitem(mod, node) -> bool:
    parents = mod.parents()
    cur = node
    while cur is not None and not isinstance(cur, ast.stmt):
        parent = parents.get(cur)
        if isinstance(parent, ast.withitem) \
                and parent.context_expr is cur:
            return True
        cur = parent
    return False


# ---------------------------------------------------------------------------
# interprocedural closers: helpers that close on EVERY path
def _stmt_closes(idx, qual, stmt, pair: Pair, extra: set) -> bool:
    for c in _calls_under(stmt):
        if _match(idx, qual, c, pair.closer_quals, pair.closer_chains):
            return True
        for q in idx.byline.get(qual, {}).get(c.lineno, ()):
            if q in extra:
                return True
    return False


def _always_closers(proj, idx: _Idx, pair: Pair) -> set:
    """Quals of functions that reach a closer for `pair` on every path
    from entry to either exit — calling one IS closing (fixpoint, so a
    helper calling an always-closing helper qualifies too). A function
    that closes only on SOME paths never enters this set: at its call
    sites the pair stays open on exactly the paths it misses."""
    cterms = _PAIR_CLOSER_TERMS[pair.key]
    out: set = set()
    changed = True
    guard = 0
    while changed and guard < 6:
        changed = False
        guard += 1
        for qual, fi in proj.fns.items():
            if qual in out:
                continue
            if not (idx.terms.get(qual, frozenset()) & cterms
                    or idx.callees.get(qual, frozenset()) & out):
                continue
            g = _cfg.get(fi.mod.mod, fi.node)
            closing = {b.bid for b in g.blocks.values()
                       if b.stmt is not None
                       and _stmt_closes(idx, qual, b.stmt, pair, out)}
            if closing and g.escape_path([g.entry], closing) is None:
                out.add(qual)
                changed = True
    return out


# ---------------------------------------------------------------------------
# R022 core: per-site path proof
def _token_name(stmt):
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and isinstance(stmt.targets[0], ast.Name):
        return stmt.targets[0].id
    return None


def _token_escapes(fi, proj, idx, stmt, name: str, pair: Pair,
                   extra: set) -> str:
    """How the token leaves this function's custody, or "" when it
    stays local. Returned / stored / closure-captured / passed-to-a-
    non-closer tokens transfer ownership — the path proof would be
    meaningless here."""
    qual = fi.qual
    for n in proj.fn_nodes(fi):
        if isinstance(n, ast.Return) and n.value is not None:
            if any(isinstance(s, ast.Name) and s.id == name
                   for s in ast.walk(n.value)):
                return "returned"
        elif isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if n is stmt:
                continue
            tgts = n.targets if isinstance(n, ast.Assign) else [n.target]
            v = getattr(n, "value", None)
            if v is not None and any(
                    isinstance(s, ast.Name) and s.id == name
                    for s in ast.walk(v)):
                for t in tgts:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        return "stored"
        elif isinstance(n, ast.Call):
            if _match(idx, qual, n, pair.closer_quals, pair.closer_chains):
                continue
            if any(q in extra
                   for q in idx.byline.get(qual, {}).get(n.lineno, ())):
                continue
            args = list(n.args) + [kw.value for kw in n.keywords]
            if any(isinstance(a, ast.Name) and a.id == name
                   for a in args):
                return "passed on"
        elif isinstance(n, (ast.Yield, ast.YieldFrom)) \
                and getattr(n, "value", None) is not None:
            if any(isinstance(s, ast.Name) and s.id == name
                   for s in ast.walk(n.value)):
                return "yielded"
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)) and n is not fi.node:
            # captured by a nested closure (the Job worker-thread shape:
            # the closure releases on its own schedule)
            if any(isinstance(s, ast.Name) and s.id == name
                   and isinstance(s.ctx, ast.Load)
                   for s in ast.walk(n)):
                return "captured by a closure"
    return ""


def _acquired_branch_starts(g, stmt, call):
    """Branch-sensitive start set when the opener call sits in an If
    test: `if self._try_reserve(n):` opens the then-branch only,
    `if not self._try_reserve(n):` opens the else/fall-through."""
    bids = g.stmt_blocks.get(id(stmt), ())
    starts = []
    for bid in bids:
        norm = g.norm_succs(bid)
        if len(norm) < 2:
            starts.extend(norm)
            continue
        test = stmt.test
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
                and call in set(ast.walk(test.operand)):
            starts.append(norm[1])
        elif test is call:
            starts.append(norm[0])
        else:
            starts.extend(norm)      # composite test: both branches
    return starts


def _token_guard_skips(g, token: str) -> frozenset:
    """Edges to prune for falsy_ok tokens: at an If testing the bare
    token (`if tok:` / `if not tok:` / `is None` checks), the branch
    where nothing was acquired owes no closer."""
    skips = set()
    for b in g.blocks.values():
        if not isinstance(b.stmt, ast.If):
            continue
        t = b.stmt.test
        unacquired = None       # which norm succ index needs no closer
        if isinstance(t, ast.Name) and t.id == token:
            unacquired = 1
        elif isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not) \
                and isinstance(t.operand, ast.Name) \
                and t.operand.id == token:
            unacquired = 0
        elif isinstance(t, ast.Compare) and len(t.ops) == 1 \
                and isinstance(t.left, ast.Name) and t.left.id == token \
                and isinstance(t.comparators[0], ast.Constant) \
                and t.comparators[0].value is None:
            unacquired = 0 if isinstance(t.ops[0], ast.Is) else 1
        if unacquired is None:
            continue
        norm = g.norm_succs(b.bid)
        if len(norm) >= 2:
            skips.add((b.bid, norm[unacquired]))
    return frozenset(skips)


def _escape_with_skips(g, starts, closing, skips):
    if not skips:
        return g.escape_path(starts, closing)
    seen: set = set()
    work = [(b, 0) for b in starts]
    leak = None
    while work:
        bid, via = work.pop()
        if bid == _cfg.EXIT:
            if via == 0:
                return ("return", 0)
            leak = leak or ("return", via)
            continue
        if bid == _cfg.RAISE:
            leak = leak or ("raise", via)
            continue
        if bid in closing or bid in seen:
            continue
        seen.add(bid)
        blk = g.blocks[bid]
        for nxt, kind in blk.succs:
            if (bid, nxt) in skips:
                continue
            work.append((nxt, via if (kind == "norm" or via)
                         else blk.line))
    return leak


def _closing_bids(g, idx, qual, pair: Pair, extra: set) -> set:
    return {b.bid for b in g.blocks.values()
            if b.stmt is not None
            and _stmt_closes(idx, qual, b.stmt, pair, extra)}


def _class_sibling_closes(fi, proj, idx, pair: Pair) -> bool:
    """Opener in one method, closer in another of the same class — the
    __enter__/__exit__ lifecycle-class shape. The pairing is an object-
    lifetime property the runtime leaktrack sanitizer owns."""
    if not fi.cls:
        return False
    ci = fi.mod.classes.get(fi.cls)
    if ci is None:
        return False
    cterms = _PAIR_CLOSER_TERMS[pair.key]
    for mqual in ci.methods.values():
        if mqual == fi.qual:
            continue
        if not (idx.terms.get(mqual, frozenset()) & cterms):
            continue
        for n in idx.calls.get(mqual, ()):
            if _match(idx, mqual, n, pair.closer_quals,
                      pair.closer_chains):
                return True
    return False


def _check_r022_r024(proj, idx: _Idx) -> list:
    findings = []
    extra_closers = {p.key: _always_closers(proj, idx, p) for p in PAIRS}
    returners: dict = {}          # qual -> pair (functions returning an
    #                               open token)

    def opener_sites(fi):
        """[(pair, call, via_returner)]"""
        out = []
        terms = idx.terms.get(fi.qual, frozenset())
        for n in idx.calls.get(fi.qual, ()):
            hit = False
            for pair in PAIRS:
                if idx.term.get(n) not in _PAIR_OPENER_TERMS[pair.key]:
                    continue
                if _match(idx, fi.qual, n, pair.opener_quals,
                          pair.opener_chains):
                    out.append((pair, n, False))
                    hit = True
                    break
            if hit:
                continue
            for q in idx.byline.get(fi.qual, {}).get(n.lineno, ()):
                rp = returners.get(q)
                if rp is not None:
                    out.append((rp, n, True))
                    break
        del terms
        return out

    def check_site(fi, pair, call, via_returner):
        mod = fi.mod.mod
        stmt = _enclosing_stmt(mod, call)
        if stmt is None or _inside_withitem(mod, call):
            return None
        extra = extra_closers[pair.key]
        # discarded token: the closer can never be handed its token
        if pair.token and isinstance(stmt, ast.Expr):
            closer = pair.closer_quals[0].lstrip(".") \
                if pair.closer_quals else "the closer"
            return Finding(
                "R024", mod.rel, call.lineno,
                f"the {pair.desc} returned here is DISCARDED — "
                f"{closer}() can never be handed its token, so the "
                "resource leaks on every path; bind the result and "
                "close it in a finally (or a with block)")
        if pair.token and isinstance(stmt, ast.Return):
            # `return opener()` — ownership handed straight up, same as
            # bind-then-return: the function is a returner-wrapper and
            # its CALLERS owe the close (R024 at their sites)
            if not via_returner and fi.qual not in returners:
                returners[fi.qual] = pair
            return None
        token = _token_name(stmt) if pair.token else None
        if pair.token and token is None and not isinstance(stmt, ast.If):
            return None          # tuple-unpack / comprehension: punt
        if token is not None:
            how = _token_escapes(fi, proj, idx, stmt, token, pair, extra)
            if how == "returned":
                if not via_returner and fi.qual not in returners:
                    returners[fi.qual] = pair
                return None      # ownership transferred: R024 at callers
            if how:
                return None      # stored/captured/passed: object lifecycle
        if pair.scoped:
            # request-scoped pair: the closer legitimately lives in the
            # request-teardown frame; only path-check a function that
            # pairs opener AND closer itself
            has_closer = any(
                _match(idx, fi.qual, n, pair.closer_quals,
                       pair.closer_chains)
                for n in idx.calls.get(fi.qual, ()))
            if not has_closer:
                return None
        g = _cfg.get(mod, fi.node)
        closing = _closing_bids(g, idx, fi.qual, pair, extra)
        if not closing and _class_sibling_closes(fi, proj, idx, pair):
            return None
        if isinstance(stmt, ast.If):
            starts = _acquired_branch_starts(g, stmt, call)
        else:
            starts = []
            for bid in g.stmt_blocks.get(id(stmt), ()):
                starts.extend(g.norm_succs(bid))
        if not starts:
            return None
        skips = _token_guard_skips(g, token) \
            if (token and pair.falsy_ok) else frozenset()
        esc = _escape_with_skips(g, starts, closing, skips)
        if esc is None:
            return None
        kind, via = esc
        if kind == "raise" or via:
            caught = "propagates" if kind == "raise" else "is caught"
            where = (f"on the exception path out of line {via} "
                     f"(the error {caught} without the closer running)")
        else:
            where = ("on a normal path (early return or fall-through "
                     "skips the closer)")
        rule = "R024" if via_returner else "R022"
        closer = (pair.closer_quals[0].lstrip(".")
                  if pair.closer_quals else "the closer")
        return Finding(
            rule, mod.rel, call.lineno,
            f"{pair.desc} opened here is never closed {where}: "
            f"{closer}() must run on EVERY path — move it to a "
            "finally/with, or suppress with the reason the leak is "
            "impossible")

    # two rounds so wrappers discovered in round 1 get their callers
    # checked in round 2 (the R024 returner propagation)
    reported: set = set()
    for _round in range(2):
        for fi in proj.fns.values():
            for pair, call, via_ret in opener_sites(fi):
                key = (fi.qual, call.lineno, pair.key)
                if key in reported:
                    continue
                f = check_site(fi, pair, call, via_ret)
                if f is not None:
                    reported.add(key)
                    findings.append(f)
        if not returners:
            break
    findings.extend(_check_gauge_series(proj))
    return findings


# ---------------------------------------------------------------------------
# ghost gauge series (the flow-insensitive registry entry)
def _check_gauge_series(proj) -> list:
    findings = []
    for mi in proj.mods:
        mod = mi.mod
        gauges: dict = {}         # var -> assign line
        for node in mod.tree.body:
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            chain = _cg._chain(node.value.func)
            if not (chain == "gauge" or chain.endswith(".gauge")):
                continue
            if any(kw.arg == "fn" for kw in node.value.keywords):
                continue          # callback gauge: no set/remove cycle
            for t in node.targets:
                if isinstance(t, ast.Name):
                    gauges[t.id] = node.lineno
        if not gauges:
            continue
        first_labeled_set: dict = {}
        removed: set = set()
        for n in mod.walk():
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in gauges):
                continue
            var = n.func.value.id
            if n.func.attr in ("set", "inc") and n.keywords:
                if var not in first_labeled_set:
                    first_labeled_set[var] = n.lineno
            elif n.func.attr == "remove":
                removed.add(var)
        for var, line in sorted(first_labeled_set.items()):
            if var in removed:
                continue
            findings.append(Finding(
                "R022", mod.rel, line,
                f"per-entity gauge {var!r} registers labeled series "
                "here but nothing in this module ever .remove()s one — "
                "a deleted entity leaves a ghost series on /metrics "
                "forever (the ghost-series class); pair every labeled set "
                "with a remove in the entity's teardown, or suppress "
                "with the reason the label set is bounded"))
    return findings


# ---------------------------------------------------------------------------
# R023: swallowed control-flow exceptions
def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [getattr(e, "id", getattr(e, "attr", ""))
             for e in (t.elts if isinstance(t, ast.Tuple) else [t])]
    return any(n in ("Exception", "BaseException") for n in names)


def _handler_types(handler: ast.ExceptHandler) -> set:
    t = handler.type
    if t is None:
        return set()
    return {getattr(e, "id", getattr(e, "attr", ""))
            for e in (t.elts if isinstance(t, ast.Tuple) else [t])}


def _control_raisers(proj, idx: _Idx) -> set:
    """Functions that can (transitively) raise a typed control
    exception — the ONLY places where swallowing one is possible."""
    out: set = set()
    for qual, fi in proj.fns.items():
        for n in proj.fn_nodes(fi):
            if isinstance(n, ast.Raise) and n.exc is not None:
                e = n.exc
                t = _cg._terminal(e.func) if isinstance(e, ast.Call) \
                    else _cg._terminal(e)
                if t in CONTROL_EXCEPTIONS:
                    out.add(qual)
                    break
    changed = True
    guard = 0
    while changed and guard < 20:
        changed = False
        guard += 1
        for qual in proj.fns:
            if qual not in out and idx.callees.get(
                    qual, frozenset()) & out:
                out.add(qual)
                changed = True
    return out


def _control_can_arrive(fi, idx, try_node: ast.Try, raisers: set) -> bool:
    by = idx.byline.get(fi.qual, {})
    for b in try_node.body:
        for n in ast.walk(b):
            if isinstance(n, ast.Raise) and n.exc is not None:
                e = n.exc
                t = _cg._terminal(e.func) if isinstance(e, ast.Call) \
                    else _cg._terminal(e)
                if t in CONTROL_EXCEPTIONS:
                    return True
            elif isinstance(n, ast.Call):
                if any(q in raisers for q in by.get(n.lineno, ())):
                    return True
    return False


def _check_r023(proj, idx: _Idx) -> list:
    findings = []
    raisers = _control_raisers(proj, idx)
    seen: set = set()
    for fi in proj.fns.values():
        rel = fi.mod.mod.rel.replace("\\", "/")
        if not (rel.startswith(_R023_PREFIXES)
                or _cg._is_replay_root(fi, proj)):
            continue
        for n in proj.fn_nodes(fi):
            if not isinstance(n, ast.Try) or not n.handlers:
                continue
            filtered = False
            for h in n.handlers:
                if _handler_types(h) & CONTROL_EXCEPTIONS:
                    filtered = True    # a typed arm upstream sees them
                    continue
                if not _is_broad(h):
                    continue
                if filtered:
                    break
                if any(isinstance(s, ast.Raise)
                       for b in h.body for s in ast.walk(b)):
                    break               # re-raises (possibly filtered)
                if not _control_can_arrive(fi, idx, n, raisers):
                    break    # nothing below raises one: a loop
                    #          swallowing socket errors owes nothing
                key = (fi.mod.mod.rel, h.lineno)
                if key in seen:
                    break
                seen.add(key)
                findings.append(Finding(
                    "R023", fi.mod.mod.rel, h.lineno,
                    f"broad except on a dispatch/serving/replay path in "
                    f"{fi.qual}() swallows the typed control exceptions "
                    "(RateLimited/QuotaExceeded/DeadlineExceeded/"
                    "EpochChanged/DivergenceError) that its try body "
                    "can raise and that must propagate to produce "
                    "their status codes — re-raise them "
                    "(`if isinstance(e, (...)): raise`), add typed "
                    "arms above, or suppress with the reason the "
                    "swallow is intentional"))
                break
    return findings


# ---------------------------------------------------------------------------
# R025: the CUDA-graph capture contract of the scorer family
_R025_ROOT_NAMES = {"_score_with_params", "_score_matrix"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device"}
_TENSOR_CTORS = {"tensor", "as_tensor", "from_numpy", "zeros", "ones",
                 "empty", "full", "arange", "linspace", "eye", "rand",
                 "randn", "randint", "zeros_like", "ones_like",
                 "empty_like", "full_like", "stack", "cat"}


def _module_device_consts(mi) -> dict:
    """Module-level names bound to tensors (torch.* constructions, a
    `.cuda()`) — one buffer baked into every graph whose closure reads
    them."""
    out: dict = {}
    for node in mi.mod.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        is_dev = False
        for sub in ast.walk(v):
            if isinstance(sub, ast.Call):
                chain = _cg._chain(sub.func)
                term = _cg._terminal(sub.func)
                if (chain.startswith("torch.") and term in _TENSOR_CTORS) \
                        or (isinstance(sub.func, ast.Attribute)
                            and term == "cuda"):
                    is_dev = True
                    break
        if is_dev:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.lineno
    return out


def _static_config_test(test) -> bool:
    """`if link == "logit":` / `if dist in ("poisson", "gamma"):` —
    string-constant dispatch on a config argument, concrete under
    capture (a tensor never equals a string)."""
    if not isinstance(test, ast.Compare):
        return False
    consts = []
    for comp in test.comparators:
        for c in ast.walk(comp):
            if isinstance(c, ast.Constant):
                consts.append(c.value)
            elif not isinstance(c, (ast.Tuple, ast.List, ast.Set,
                                    ast.expr_context)):
                return False
    return bool(consts) and all(isinstance(v, str) for v in consts)


def _r025_scan(fn_node, mi, rel: str, qual: str, parents: dict,
               seen: set) -> list:
    findings = []
    dev_consts = _module_device_consts(mi)
    params = {a.arg for a in fn_node.args.args
              + fn_node.args.posonlyargs + fn_node.args.kwonlyargs} \
        - {"self", "cls"}
    nodes = list(ast.walk(fn_node))
    # taint: params plus locals assigned from tainted expressions
    tainted = set(params)
    assigns = [n for n in nodes if isinstance(n, ast.Assign)]

    def shielded(name_node) -> bool:
        """x.shape / x.ndim / x.dtype / len(x): static under capture."""
        p = parents.get(name_node)
        while p is not None:
            if isinstance(p, ast.Attribute) and p.attr in _STATIC_ATTRS:
                return True
            if isinstance(p, ast.Call) and _cg._terminal(p.func) == "len":
                return True
            if isinstance(p, ast.stmt):
                break
            p = parents.get(p)
        return False

    def expr_tainted(e) -> bool:
        for sub in ast.walk(e):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                    and sub.id in tainted and not shielded(sub):
                return True
        return False

    for _ in range(3):
        changed = False
        for a in assigns:
            if expr_tainted(a.value):
                for t in a.targets:
                    if isinstance(t, ast.Name) and t.id not in tainted:
                        tainted.add(t.id)
                        changed = True
        if not changed:
            break

    def emit(line, msg):
        key = (rel, line)
        if key not in seen:
            seen.add(key)
            findings.append(Finding("R025", rel, line, msg))

    for n in nodes:
        if isinstance(n, ast.Call):
            term = _cg._terminal(n.func)
            if isinstance(n.func, ast.Name) \
                    and term in ("float", "int", "bool") and n.args \
                    and expr_tainted(n.args[0]):
                emit(n.lineno,
                     f"{term}() of a tensor argument in {qual}: a "
                     "device→host sync that fails a CUDA graph's "
                     "capture (the program strikes and scores eagerly), "
                     "and its value would be frozen into the graph — "
                     "keep the computation in torch ops")
        elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                and n.id in dev_consts:
            emit(n.lineno,
                 f"module-level tensor {n.id!r} (defined at "
                 f"{rel}:{dev_consts[n.id]}) captured by the {qual} "
                 "scoring program: every graph replays that one buffer "
                 "on the device it was made on instead of receiving it "
                 "as a placed param — thread it through the serving "
                 "params")
        elif isinstance(n, (ast.If, ast.While)):
            t = n.test
            if isinstance(t, ast.Compare) and len(t.ops) == 1 \
                    and isinstance(t.ops[0], (ast.Is, ast.IsNot)):
                continue          # `x is None`: concrete at capture
            if _static_config_test(t):
                continue          # string-constant config dispatch
            if expr_tainted(t):
                emit(n.lineno,
                     f"Python branch on a tensor argument in {qual}: the "
                     "test syncs the device (the capture fails) and a "
                     "graph replays the one branch it captured — use "
                     "torch.where")
    return findings


def _check_r025(proj) -> list:
    findings = []
    seen: set = set()
    # roots: the _score_with_params family, closed over the callgraph
    work = [fi.qual for fi in proj.fns.values()
            if getattr(fi.node, "name", "") in _R025_ROOT_NAMES]
    reach: set = set()
    while work:
        q = work.pop()
        if q in reach:
            continue
        reach.add(q)
        fi = proj.fns.get(q)
        if fi is None:
            continue
        for callee, _ln, _h, _b, _s in fi.calls:
            if callee not in reach:
                work.append(callee)
    for q in sorted(reach):
        fi = proj.fns.get(q)
        if fi is None:
            continue
        parents = fi.mod.mod.parents()
        findings.extend(_r025_scan(fi.node, fi.mod, fi.mod.mod.rel,
                                   getattr(fi.node, "name", q), parents,
                                   seen))
    # the scorer_cache _build closures (nested defs are not
    # project functions; they ARE the program that gets exported)
    for fi in proj.fns.values():
        if getattr(fi.node, "name", "") != "_build" \
                or "scorer_cache" not in fi.mod.mod.rel:
            continue
        parents = fi.mod.mod.parents()
        for n in proj.fn_nodes(fi):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and n is not fi.node \
                    and n.name.startswith("_score"):
                findings.extend(_r025_scan(
                    n, fi.mod, fi.mod.mod.rel,
                    f"_build.{n.name}", parents, seen))
    return findings


# ---------------------------------------------------------------------------
def check_project(proj, mods: list, timings: dict = None) -> list:
    """Run R022-R025 on the shared project index — called from
    callgraph.check after effects.check_project, same single-index
    discipline."""
    import time as _time
    t0 = _time.perf_counter()
    idx = _Idx(proj)
    if timings is not None:
        timings["lifecycle:index"] = timings.get(
            "lifecycle:index", 0.0) + (_time.perf_counter() - t0)
    findings = []
    for rule, fn in (("R022+R024", lambda: _check_r022_r024(proj, idx)),
                     ("R023", lambda: _check_r023(proj, idx)),
                     ("R025", lambda: _check_r025(proj))):
        t0 = _time.perf_counter()
        findings.extend(fn())
        if timings is not None:
            timings[rule] = timings.get(rule, 0.0) + \
                (_time.perf_counter() - t0)
    return findings
