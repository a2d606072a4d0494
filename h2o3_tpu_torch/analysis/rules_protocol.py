"""R020 of the port (h2o3_tpu/analysis/rules_protocol.py): the replay-
channel protocol census + the generated PROTOCOL.md.

The coordinator⇄worker wire protocol has two op namespaces riding the
same frame stream as broadcasts: COLLECT ops (`bc.collect("metrics")` →
worker `_collect_local(op)` → data in the ack) and CONTROL frames
(`{"seq": -1, "op": "leave"}` — the drain handshake). Both sides are
plain string matching in separate files (`deploy/multihost.py` sends
and handles, `deploy/membership.py` extends both) — exactly the drift
shape R006 already gates for REST routes: an op renamed on one side
compiles fine and fails at runtime as a timeout or an
`{"error": "unknown op"}` ack.

R020 therefore enforces, project-wide:

  * every op NAME the coordinator sends — a string literal (or literal
    prefix of an f-string/concat, for the parameterized `trace:<id>` /
    `logs:search:<q>` families) reaching `X.collect(...)`, or the
    literal `"op"` value of a control-frame dict that also carries a
    `"seq"` key — must have a worker-side match: an `op == "..."` /
    `op in (...)` / `op.startswith("...")` arm inside a
    `_collect_local` body, or a `msg.get("op") == "..."` /
    `msg["op"] == "..."` dispatch test anywhere;
  * and vice versa: a handler arm whose op no coordinator ever sends is
    dead protocol — either the send was renamed (the live bug) or the
    arm should be deleted.

Ops with computed names (a variable reaching collect()) are
passthroughs, not declarations, and are skipped. The census of the
matched protocol is committed as `h2o3_tpu_torch/deploy/PROTOCOL.md`
(`python -m h2o3_tpu_torch.analysis --write-census`) and freshness-gated in
pre-commit/tier-1 exactly like the metric/span/env censuses.
"""

from __future__ import annotations

import ast

from h2o3_tpu_torch.analysis import callgraph as _cg
from h2o3_tpu_torch.analysis.engine import Finding

RULES = {"R020"}

_HANDLER_FNS = {"_collect_local"}


def _enclosing_fn(mod, node) -> str:
    parents = mod.parents()
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur.name
        cur = parents.get(cur)
    return "<module>"


def _op_literals(node: ast.AST) -> list:
    """[(text, kind)] for an op-name expression: a full literal is
    exact; an f-string or `"p:" + x` concat with a literal head declares
    the prefix family; a conditional contributes both branches. Anything
    else is a computed passthrough → empty."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [(node.value, "exact")]
    if isinstance(node, ast.JoinedStr) and node.values \
            and isinstance(node.values[0], ast.Constant) \
            and isinstance(node.values[0].value, str) \
            and node.values[0].value:
        return [(node.values[0].value, "prefix")]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add) \
            and isinstance(node.left, ast.Constant) \
            and isinstance(node.left.value, str):
        return [(node.left.value, "prefix")]
    if isinstance(node, ast.IfExp):
        return _op_literals(node.body) + _op_literals(node.orelse)
    return []


def _name_op_literals(mod, call, name: str) -> list:
    """Resolve `op = "logs:search:" + q; bc.collect(op)` — the repo's
    idiomatic send shape: union every literal-able assignment to `name`
    in the ENCLOSING function scope of the collect call."""
    parents = mod.parents()
    scope = parents.get(call)
    while scope is not None and not isinstance(
            scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        scope = parents.get(scope)
    if scope is None:
        return []
    out = []
    for n in ast.walk(scope):
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in n.targets):
            out.extend(_op_literals(n.value))
    return out


def _msg_op_expr(node: ast.AST) -> bool:
    """msg.get("op") / msg["op"] — the control-dispatch accessor."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and node.args[0].value == "op":
        return True
    if isinstance(node, ast.Subscript) \
            and isinstance(node.slice, ast.Constant) \
            and node.slice.value == "op":
        return True
    return False


def collect(mods: list):
    """(sent, handled): lists of {op, kind, file, line, fn} entries.
    kind is exact|prefix for collect ops, control for control frames."""
    sent: list = []
    handled: list = []
    for mod in mods:
        handler_fns = [n for n in mod.walk()
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and n.name in _HANDLER_FNS]
        handler_nodes = {id(sub) for fn in handler_fns
                         for sub in ast.walk(fn)}
        for node in mod.walk():
            # ---- coordinator sends ---------------------------------------
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "collect" and node.args:
                recv = _cg._chain(node.func.value)
                root = recv.split(".", 1)[0] if recv else ""
                if root and root not in _cg._EXTERNAL_ROOTS:
                    arg = node.args[0]
                    lits = _op_literals(arg)
                    if not lits and isinstance(arg, ast.Name):
                        lits = _name_op_literals(mod, node, arg.id)
                    sent.extend({"op": op, "kind": kind,
                                 "file": mod.rel, "line": node.lineno,
                                 "fn": _enclosing_fn(mod, node)}
                                for op, kind in lits)
            if isinstance(node, ast.Dict):
                keys = {k.value for k in node.keys
                        if isinstance(k, ast.Constant)}
                if "seq" in keys and "op" in keys:
                    for k, v in zip(node.keys, node.values):
                        if isinstance(k, ast.Constant) \
                                and k.value == "op" \
                                and isinstance(v, ast.Constant) \
                                and isinstance(v.value, str):
                            sent.append({"op": v.value, "kind": "control",
                                         "file": mod.rel,
                                         "line": node.lineno,
                                         "fn": _enclosing_fn(mod, node)})
            # ---- worker handlers -----------------------------------------
            in_handler = id(node) in handler_nodes
            if isinstance(node, ast.Compare) and len(node.ops) == 1:
                left, cmp = node.left, node.comparators[0]
                is_op_name = isinstance(left, ast.Name) \
                    and left.id == "op" and in_handler
                if is_op_name or _msg_op_expr(left):
                    if isinstance(node.ops[0], ast.Eq) \
                            and isinstance(cmp, ast.Constant) \
                            and isinstance(cmp.value, str):
                        handled.append(
                            {"op": cmp.value, "kind": "exact",
                             "file": mod.rel, "line": node.lineno,
                             "fn": _enclosing_fn(mod, node)})
                    elif isinstance(node.ops[0], ast.In) \
                            and isinstance(cmp, (ast.Tuple, ast.List,
                                                 ast.Set)):
                        handled.extend(
                            {"op": e.value, "kind": "exact",
                             "file": mod.rel, "line": node.lineno,
                             "fn": _enclosing_fn(mod, node)}
                            for e in cmp.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "startswith" and node.args \
                    and in_handler \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "op":
                a = node.args[0]
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    handled.append({"op": a.value, "kind": "prefix",
                                    "file": mod.rel, "line": node.lineno,
                                    "fn": _enclosing_fn(mod, node)})
                elif isinstance(a, ast.Tuple):
                    handled.extend({"op": e.value, "kind": "prefix",
                                    "file": mod.rel, "line": node.lineno,
                                    "fn": _enclosing_fn(mod, node)}
                                   for e in a.elts
                                   if isinstance(e, ast.Constant)
                                   and isinstance(e.value, str))
    return sent, handled


def _send_matched(s: dict, handled: list) -> bool:
    for h in handled:
        if h["kind"] == "exact":
            if s["kind"] in ("exact", "control") and s["op"] == h["op"]:
                return True
            if s["kind"] == "prefix" and h["op"].startswith(s["op"]):
                return True
        else:                                       # handled prefix
            if s["op"].startswith(h["op"]) or h["op"].startswith(s["op"]):
                return True
    return False


def _handler_matched(h: dict, sent: list) -> bool:
    for s in sent:
        if h["kind"] == "exact":
            if s["kind"] in ("exact", "control") and s["op"] == h["op"]:
                return True
            if s["kind"] == "prefix" and h["op"].startswith(s["op"]):
                return True
        else:
            if s["op"].startswith(h["op"]) or h["op"].startswith(s["op"]):
                return True
    return False


def _is_protocol_project(mods: list) -> bool:
    """Pairing needs both endpoints in the analyzed set — a scoped run
    over one file must not call every send unhandled."""
    sent, handled = collect(mods)
    return bool(sent) and bool(handled)


def check(mods: list) -> list:
    sent, handled = collect(mods)
    if not sent or not handled:
        return []           # one endpoint out of scope: cannot pair
    findings = []
    seen: set = set()
    for s in sent:
        if _send_matched(s, handled):
            continue
        key = (s["file"], s["line"], s["op"])
        if key in seen:
            continue
        seen.add(key)
        findings.append(Finding(
            "R020", s["file"], s["line"],
            f"replay-channel {s['kind']} op {s['op']!r} sent by "
            f"{s['fn']}() has no worker-side handler arm "
            "(_collect_local / control dispatch): protocol drift — the "
            "worker acks an error or times out at runtime; add the "
            "handler arm or fix the renamed op"))
    for h in handled:
        if _handler_matched(h, sent):
            continue
        key = (h["file"], h["line"], h["op"])
        if key in seen:
            continue
        seen.add(key)
        findings.append(Finding(
            "R020", h["file"], h["line"],
            f"worker-side handler arm for {h['kind']} op {h['op']!r} "
            f"in {h['fn']}() that no coordinator code ever sends: dead "
            "protocol — the send was renamed out from under it, or the "
            "arm should be deleted"))
    return findings


check.RULES = RULES


def census_markdown(mods: list) -> str:
    """The committed h2o3_tpu_torch/deploy/PROTOCOL.md body. Sites are
    `file (function)` — content-addressed, no line numbers, so pure
    line-shift edits leave the census byte-identical."""
    sent, handled = collect(mods)
    ops: dict = {}
    for s in sent:
        e = ops.setdefault((s["op"], s["kind"]),
                           {"sent": set(), "handled": set()})
        e["sent"].add(f"{s['file']} ({s['fn']})")
    for h in handled:
        # fold a handler into every sent family it serves; standalone
        # handlers (none today — they'd be R020 findings) get own rows
        matched = False
        for (op, kind), e in ops.items():
            fake = {"op": op, "kind": kind}
            if _send_matched(fake, [h]):
                e["handled"].add(f"{h['file']} ({h['fn']})")
                matched = True
        if not matched:
            e = ops.setdefault((h["op"], h["kind"]),
                               {"sent": set(), "handled": set()})
            e["handled"].add(f"{h['file']} ({h['fn']})")
    lines = [
        "# Replay-channel protocol census — generated, do not edit",
        "",
        "Generated by `python -m h2o3_tpu_torch.analysis --write-census`; the",
        "R020 rule keeps this honest (every op the coordinator sends has",
        "a worker-side handler arm and vice versa). `prefix` ops are",
        "parameterized families (`trace:<id>`). Regenerate after adding,",
        "renaming or retiring an op.",
        "",
        "| op | kind | sent from | handled in |",
        "|---|---|---|---|",
    ]
    for (op, kind) in sorted(ops):
        e = ops[(op, kind)]
        lines.append(
            f"| `{op}` | {kind} | "
            f"{'; '.join(sorted(e['sent'])) or '—'} | "
            f"{'; '.join(sorted(e['handled'])) or '—'} |")
    lines.append("")
    lines.append(f"{len(ops)} ops.")
    return "\n".join(lines) + "\n"
