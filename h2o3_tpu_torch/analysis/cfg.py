"""The control-flow graph of the port (h2o3_tpu/analysis/cfg.py):
intraprocedural, with EXCEPTION edges (R022-R025).

Every prior rule generation is flow-insensitive: it sees which calls a
function makes, never which PATHS reach them. The paired-protocol leak
class (reserve without rollback, acquire without release on the
exception path) is invisible at that granularity — the closer is right
there in the function, just not on every path. This module supplies the
missing axis: a per-function CFG whose blocks are statements and whose
edges distinguish normal flow from exceptional flow:

  * every statement that contains a call, attribute access or subscript
    gets an EXCEPTION edge — to the enclosing try's handler dispatch
    when one exists, else to the synthetic RAISE exit (the implicit
    raise-to-caller path every Python statement carries);
  * `try`/`except`/`else`/`finally` lower faithfully: handler bodies,
    the else clause, and a `finally` body DUPLICATED onto every exit
    kind that crosses it (normal fall-through, return, break, continue,
    raise) — which is exactly why `finally: release()` proves closure on
    all paths without any special-casing in the rules;
  * `with` bodies propagate exceptions outward (a context manager's
    __exit__ is modeled by the RULES — a with-item opener is closed by
    construction — not by the graph);
  * loops carry back-edges, `break`/`continue` route through enclosing
    `finally` bodies, `while True:` has no fall-through exit.

Two synthetic exits terminate every path: EXIT (normal return or
fall-off-the-end) and RAISE (an exception escaping to the caller).  A
protocol is leak-free exactly when no path from an opener's NORMAL
successors reaches either exit without crossing a closer block.

Graphs are built lazily — only for functions a rule flags as candidates
(body mentions a registered opener) — and memoized on the engine.Module
cache, so the 25-rule run pays for CFGs on the handful of functions that
touch paired protocols, not the whole package.
"""

from __future__ import annotations

import ast

EXIT = -1      # normal return / fall off the end
RAISE = -2     # exception propagates to the caller


class Block:
    """One statement (or a synthetic dispatch point) in the graph."""

    __slots__ = ("bid", "stmt", "succs")

    def __init__(self, bid: int, stmt):
        self.bid = bid
        self.stmt = stmt          # ast stmt node, or None for synthetic
        self.succs = []           # [(block_id, "norm" | "exc")]

    @property
    def line(self) -> int:
        return getattr(self.stmt, "lineno", 0)


class CFG:
    def __init__(self, fn_node):
        self.fn = fn_node
        self.blocks: dict = {}         # bid -> Block
        self.entry = EXIT
        self.stmt_blocks: dict = {}    # id(stmt) -> [bid, ...] (finally
        #                                duplication makes this a list)

    def new(self, stmt=None) -> int:
        bid = len(self.blocks)
        self.blocks[bid] = Block(bid, stmt)
        if stmt is not None:
            self.stmt_blocks.setdefault(id(stmt), []).append(bid)
        return bid

    def edge(self, a: int, b: int, kind: str = "norm"):
        self.blocks[a].succs.append((b, kind))

    def escape_path(self, starts, closing_bids):
        """First escaping path from `starts` (block ids) to EXIT/RAISE
        that never enters a closing block — or None when every path is
        closed.  Returns (exit_kind, via) where exit_kind is "return" or
        "raise" and `via` is the line of the first exception edge taken
        (0 when the path is pure normal flow): the evidence the finding
        message names."""
        # pass 1: normal edges only — an early-return/fall-through leak
        # is the stronger evidence when both kinds exist
        seen: set = set()
        work = list(starts)
        while work:
            bid = work.pop()
            if bid == EXIT:
                return ("return", 0)
            if bid == RAISE or bid in closing_bids or bid in seen:
                continue
            seen.add(bid)
            work.extend(n for n, k in self.blocks[bid].succs
                        if k == "norm")
        # pass 2: all edges — the leak (if any) rides an exception edge;
        # `via` records the line of the first exception edge taken
        seen = set()
        work = [(b, 0) for b in starts]
        while work:
            bid, via = work.pop()
            if bid == EXIT:
                return ("return", via)
            if bid == RAISE:
                return ("raise", via)
            if bid in closing_bids or bid in seen:
                continue
            seen.add(bid)
            blk = self.blocks[bid]
            for nxt, kind in blk.succs:
                work.append((nxt, via if (kind == "norm" or via)
                             else blk.line))
        return None

    def reaches(self, starts, target_bids) -> bool:
        """Any path from `starts` into one of `target_bids`?"""
        seen: set = set()
        work = list(starts)
        while work:
            bid = work.pop()
            if bid in (EXIT, RAISE) or bid in seen:
                continue
            if bid in target_bids:
                return True
            seen.add(bid)
            work.extend(n for n, _k in self.blocks[bid].succs)
        return False

    def norm_succs(self, bid: int) -> list:
        return [n for n, k in self.blocks[bid].succs if k == "norm"]


# ---------------------------------------------------------------------------
# raising-statement classification
_RAISING = (ast.Call, ast.Attribute, ast.Subscript, ast.Await,
            ast.Yield, ast.YieldFrom)


def _expr_can_raise(expr) -> bool:
    if expr is None:
        return False
    return any(isinstance(n, _RAISING) for n in ast.walk(expr))


def _stmt_can_raise(st) -> bool:
    """Statement carries an implicit exception edge: it contains a call,
    attribute access or subscript (the lifecycle rules' vocabulary — plain
    name-to-name assignment cannot raise in any way worth an edge)."""
    if isinstance(st, (ast.Raise, ast.Assert)):
        return True
    if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef)):
        return False          # the def itself; the body is another scope
    if isinstance(st, ast.AnnAssign):
        # the annotation is never evaluated in a function body
        return _expr_can_raise(st.value) or _expr_can_raise(st.target)
    for n in ast.iter_child_nodes(st):
        if isinstance(n, _RAISING) or _expr_can_raise(n):
            return True
    return False


def _is_catch_all(handler_type) -> bool:
    """`except:` / `except BaseException` / `except Exception` stop
    propagation for the protocol exceptions the lifecycle rules care
    about (nothing in this codebase raises bare BaseException), so the
    residual raise-to-caller edge is dropped for them."""
    if handler_type is None:
        return True
    names = []
    if isinstance(handler_type, ast.Tuple):
        names = [getattr(e, "id", getattr(e, "attr", ""))
                 for e in handler_type.elts]
    else:
        names = [getattr(handler_type, "id",
                         getattr(handler_type, "attr", ""))]
    return any(n in ("BaseException", "Exception") for n in names)


def _const_true(expr) -> bool:
    return isinstance(expr, ast.Constant) and bool(expr.value) is True


# ---------------------------------------------------------------------------
# construction
class _Ctx:
    """Continuation targets for the statement being lowered. Each is a
    zero-arg thunk returning a block id, memoized so one `finally` body
    is duplicated at most once per exit KIND (linear in nesting depth,
    never exponential)."""

    __slots__ = ("exc", "ret", "brk", "cont")

    def __init__(self, exc, ret, brk=None, cont=None):
        self.exc = exc
        self.ret = ret
        self.brk = brk
        self.cont = cont


def _memo(fn):
    cell = []

    def thunk():
        if not cell:
            cell.append(fn())
        return cell[0]
    return thunk


def build(fn_node) -> CFG:
    """CFG for one FunctionDef/AsyncFunctionDef body."""
    g = CFG(fn_node)

    def lower_stmts(stmts, succ: int, ctx: _Ctx) -> int:
        entry = succ
        for st in reversed(stmts):
            entry = lower(st, entry, ctx)
        return entry

    def lower(st, succ: int, ctx: _Ctx) -> int:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            b = g.new(st)
            g.edge(b, succ)
            return b
        if isinstance(st, ast.Return):
            b = g.new(st)
            g.edge(b, ctx.ret())
            if _expr_can_raise(st.value):
                g.edge(b, ctx.exc(), "exc")
            return b
        if isinstance(st, ast.Raise):
            b = g.new(st)
            g.edge(b, ctx.exc(), "exc")
            return b
        if isinstance(st, ast.Break):
            b = g.new(st)
            g.edge(b, ctx.brk() if ctx.brk else EXIT)
            return b
        if isinstance(st, ast.Continue):
            b = g.new(st)
            g.edge(b, ctx.cont() if ctx.cont else EXIT)
            return b
        if isinstance(st, ast.If):
            b = g.new(st)
            g.edge(b, lower_stmts(st.body, succ, ctx))
            g.edge(b, lower_stmts(st.orelse, succ, ctx)
                   if st.orelse else succ)
            if _expr_can_raise(st.test):
                g.edge(b, ctx.exc(), "exc")
            return b
        if isinstance(st, ast.While):
            b = g.new(st)
            after = lower_stmts(st.orelse, succ, ctx) \
                if st.orelse else succ
            body_ctx = _Ctx(ctx.exc, ctx.ret,
                            brk=lambda: succ, cont=lambda: b)
            g.edge(b, lower_stmts(st.body, b, body_ctx))
            if not _const_true(st.test):
                g.edge(b, after)
            if _expr_can_raise(st.test):
                g.edge(b, ctx.exc(), "exc")
            return b
        if isinstance(st, (ast.For, ast.AsyncFor)):
            b = g.new(st)
            after = lower_stmts(st.orelse, succ, ctx) \
                if st.orelse else succ
            body_ctx = _Ctx(ctx.exc, ctx.ret,
                            brk=lambda: succ, cont=lambda: b)
            g.edge(b, lower_stmts(st.body, b, body_ctx))
            g.edge(b, after)
            g.edge(b, ctx.exc(), "exc")     # the iterator itself raises
            return b
        if isinstance(st, (ast.With, ast.AsyncWith)):
            b = g.new(st)
            g.edge(b, lower_stmts(st.body, succ, ctx))
            g.edge(b, ctx.exc(), "exc")     # ctx-expr / __enter__ raises
            return b
        if isinstance(st, ast.Try):
            return lower_try(st, succ, ctx)
        if isinstance(st, ast.Match):
            b = g.new(st)
            for case in st.cases:
                g.edge(b, lower_stmts(case.body, succ, ctx))
            g.edge(b, succ)                 # no case matched
            if _expr_can_raise(st.subject):
                g.edge(b, ctx.exc(), "exc")
            return b
        # simple statement
        b = g.new(st)
        g.edge(b, succ)
        if _stmt_can_raise(st):
            g.edge(b, ctx.exc(), "exc")
        return b

    def lower_try(st: ast.Try, succ: int, ctx: _Ctx) -> int:
        if st.finalbody:
            # every exit KIND that crosses the finally gets its own copy
            # of the finally body, continuing to the original target.
            # Exceptions raised inside the finally itself use the OUTER
            # context (they abandon the in-flight exit).
            fin_exc = _memo(lambda: lower_stmts(st.finalbody, ctx.exc(),
                                                ctx))
            fin_ret = _memo(lambda: lower_stmts(st.finalbody, ctx.ret(),
                                                ctx))
            fin_brk = _memo(lambda: lower_stmts(st.finalbody, ctx.brk(),
                                                ctx)) if ctx.brk else None
            fin_cont = _memo(lambda: lower_stmts(st.finalbody, ctx.cont(),
                                                 ctx)) if ctx.cont else None
            fin_norm = lower_stmts(st.finalbody, succ, ctx)
            inner = _Ctx(fin_exc, fin_ret, brk=fin_brk, cont=fin_cont)
            return lower_try_core(st, fin_norm, inner)
        return lower_try_core(st, succ, ctx)

    def lower_try_core(st: ast.Try, succ: int, ctx: _Ctx) -> int:
        if not st.handlers:
            return lower_stmts(st.body, succ, ctx)
        catch_all = any(_is_catch_all(h.type) for h in st.handlers)

        def make_dispatch():
            d = g.new()                     # synthetic handler dispatch
            for h in st.handlers:
                g.edge(d, lower_stmts(h.body, succ, ctx))
            if not catch_all:
                g.edge(d, ctx.exc(), "exc")  # unmatched type propagates
            return d

        dispatch = _memo(make_dispatch)
        body_ctx = _Ctx(dispatch, ctx.ret, brk=ctx.brk, cont=ctx.cont)
        after_body = lower_stmts(st.orelse, succ, ctx) \
            if st.orelse else succ
        return lower_stmts(st.body, after_body, body_ctx)

    base = _Ctx(exc=lambda: RAISE, ret=lambda: EXIT)
    body = getattr(fn_node, "body", [])
    g.entry = lower_stmts(body, EXIT, base)
    return g


def get(module, fn_node) -> CFG:
    """Build-or-fetch the CFG for `fn_node`, memoized on the Module the
    function was parsed from — candidate functions are re-queried by
    several rules (R022 openers, R024 caller checks) in one run."""
    cache = getattr(module, "_cfgs", None)
    if cache is None:
        cache = {}
        try:
            module._cfgs = cache
        except AttributeError:      # foreign module object: no memo
            return build(fn_node)
    got = cache.get(id(fn_node))
    if got is None:
        got = build(fn_node)
        cache[id(fn_node)] = got
    return got
