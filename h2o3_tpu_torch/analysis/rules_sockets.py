"""R013 of the port (h2o3_tpu/analysis/rules_sockets.py) — timeout-less
socket waits: recv/connect/accept with no bound.

The bug class the cloud layers keep meeting: a network wait with no deadline
turns a dead peer into a silently parked thread — the pre-elastic
Broadcaster's `srv.accept()` waited forever for a worker pod that would
never come, and a worker's `create_connection` retried into a void. The
membership layer's whole detection story rests on every wait being
bounded (ack deadlines, heartbeat, formation timeout), so the analyzer
now rejects regressions of the class.

R013 flags, per function scope:
  * `socket.create_connection(...)` without a `timeout=` kwarg;
  * `.recv(...)`, `.accept(...)` and `.connect(...)` calls on sockets
    CREATED IN THE SAME FUNCTION (`socket.socket(...)` or
    `socket.create_connection(...)`) when the function never calls
    `.settimeout(<non-None>)` on them.

Scope limits (documented, not accidental): a socket received as a
parameter or attribute is exempt — its creator owns the timeout
discipline (the framing helpers `_recv_frame(sock, ...)` would otherwise
all fire), and the interprocedural R008 already flags unbounded network
calls under locks. Waive true intentional unbounded waits with
`# h2o3-ok: R013 reason`.
"""

from __future__ import annotations

import ast

from h2o3_tpu_torch.analysis.engine import Finding, Module

RULES = {"R013"}

_WAIT_ATTRS = {"recv", "accept", "connect", "recv_into", "recvfrom"}


def _is_socket_ctor(call: ast.Call):
    """socket.socket(...) / socket.create_connection(...) — returns the
    ctor name or None."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "socket" \
            and fn.attr in ("socket", "create_connection"):
        return fn.attr
    if isinstance(fn, ast.Name) and fn.id == "create_connection":
        return "create_connection"
    return None


def _has_timeout_kwarg(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "timeout":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is None)
    # create_connection(addr, timeout) positional form
    return len(call.args) >= 2


def _scopes(tree: ast.AST, nodes=None):
    """Yield (scope_node, body_statements) for the module and every
    function — nested functions analyze as their own scope. `nodes` is
    the module's cached flat node list (Module.walk())."""
    yield tree, list(ast.iter_child_nodes(tree))
    for node in (nodes if nodes is not None else ast.walk(tree)):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.body


def _walk_scope(body):
    """Walk statements without descending into nested function defs
    (those are their own scope, yielded by _scopes separately)."""
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def check(mod: Module) -> list:
    findings = []
    for _scope, body in _scopes(mod.tree, mod.walk()):
        local_socks: set = set()       # names bound to sockets made here
        timed: set = set()             # names that got .settimeout(x)
        waits: list = []               # (name, attr, lineno)
        for node in _walk_scope(body):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                ctor = _is_socket_ctor(node.value)
                if ctor is not None:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            local_socks.add(tgt.id)
                            if ctor == "create_connection" \
                                    and _has_timeout_kwarg(node.value):
                                timed.add(tgt.id)
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            ctor = _is_socket_ctor(node)
            if ctor == "create_connection" \
                    and not _has_timeout_kwarg(node):
                findings.append(Finding(
                    "R013", mod.rel, node.lineno,
                    "socket.create_connection without timeout= — a dead "
                    "peer parks this thread forever; pass a deadline "
                    "(the membership layer's detection bound)"))
            if isinstance(fn, ast.Attribute) \
                    and isinstance(fn.value, ast.Name):
                if fn.attr == "settimeout" and node.args \
                        and not (isinstance(node.args[0], ast.Constant)
                                 and node.args[0].value is None):
                    timed.add(fn.value.id)
                elif fn.attr in _WAIT_ATTRS:
                    waits.append((fn.value.id, fn.attr, node.lineno))
        for name, attr, lineno in waits:
            if name in local_socks and name not in timed:
                findings.append(Finding(
                    "R013", mod.rel, lineno,
                    f"timeout-less .{attr}() on a socket created in this "
                    "function with no settimeout — an unresponsive peer "
                    "turns this into an unbounded wait; set a deadline "
                    "or settimeout before waiting"))
    return findings


check.RULES = RULES
