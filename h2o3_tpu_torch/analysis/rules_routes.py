"""R006 of the port (h2o3_tpu/analysis/rules_routes.py) — route/handler
drift: REST route patterns vs handler signatures.

The route surface is spread over api/server.py's literal ROUTES table,
four routes_ext*.py build_routes() functions and the flow module — ~150
(regex, method, handler) rows. Nothing ties a pattern's capture groups to
its handler's positional parameters: add a group without a parameter and
every request to that route 500s with a TypeError; the reverse 500s at
dispatch. The reference ships findbugs/error-prone gates for exactly this
shape-vs-signature class; here the analyzer closes it statically.

Checks, with no imports of the API package (pure AST + re.compile of the
literal pattern strings):
  * group count: handler must accept the pattern's capture groups —
    required positionals (after `h`) ≤ groups ≤ total positionals (or
    *args);
  * resolvable handler: a route row naming an undefined function is dead
    on arrival;
  * duplicate (pattern, method) rows: the route loop dispatches first
    match, so the second row is unreachable (a shadowed handler).
"""

from __future__ import annotations

import ast
import re

from h2o3_tpu_torch.analysis.engine import Finding, Module

RULES = {"R006"}


def _is_route_module(mod: Module) -> bool:
    rel = mod.rel.replace("\\", "/")
    return "/api/" in rel or rel.startswith("api/")


def _pattern_literal(node: ast.AST):
    """The pattern string of re.compile("..."), R("..."), including
    implicit adjacent-literal concatenation (handled by ast.Constant)."""
    if isinstance(node, ast.Call) and node.args:
        callee = node.func
        name = callee.attr if isinstance(callee, ast.Attribute) \
            else (callee.id if isinstance(callee, ast.Name) else None)
        if name in ("compile", "R"):
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return a.value
            if isinstance(a, ast.BinOp):   # "a" + variable — not literal
                return None
    return None


def _route_rows(mod: Module):
    """Yield (pattern_str, method, handler_node, lineno) for every tuple
    literal shaped like a route row anywhere in the module."""
    for node in mod.walk():
        if not isinstance(node, ast.Tuple) or len(node.elts) != 3:
            continue
        pat = _pattern_literal(node.elts[0])
        meth = node.elts[1]
        if pat is None or not (isinstance(meth, ast.Constant)
                               and isinstance(meth.value, str)):
            continue
        if meth.value not in ("GET", "POST", "PUT", "DELETE", "HEAD",
                              "PATCH"):
            continue
        yield pat, meth.value, node.elts[2], node.lineno


def _module_defs(mod: Module) -> dict:
    out = {}
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


def _import_aliases(mod: Module) -> dict:
    """{alias: module_basename} from `from h2o3_tpu_torch.api import flow as
    _flow` style imports — enough to resolve `_flow.h_flow`."""
    out = {}
    for node in mod.walk():
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = alias.name
    return out


def _sig_bounds(fn: ast.AST):
    """(required, maximum) positional group-args after the handler `h`.
    maximum is None for *args."""
    a = fn.args
    pos = a.posonlyargs + a.args
    n_defaults = len(a.defaults)
    required = max(0, len(pos) - n_defaults - 1)   # minus `h`
    maximum = None if a.vararg is not None else max(0, len(pos) - 1)
    return required, maximum


def check(mods: list) -> list:
    findings: list = []
    api_mods = [m for m in mods if _is_route_module(m)]
    if not api_mods:
        return findings
    by_base = {m.rel.rsplit("/", 1)[-1][:-3]: m for m in api_mods}
    seen: dict = {}            # (pattern, method) -> (file, line)
    for mod in api_mods:
        defs = _module_defs(mod)
        aliases = _import_aliases(mod)
        for pat, method, handler, lineno in _route_rows(mod):
            try:
                ngroups = re.compile(pat).groups
            except re.error as ex:
                findings.append(Finding(
                    "R006", mod.rel, lineno,
                    f"route pattern {pat!r} does not compile: {ex}"))
                continue
            key = (pat, method)
            if key in seen:
                f0, l0 = seen[key]
                findings.append(Finding(
                    "R006", mod.rel, lineno,
                    f"duplicate route ({method} {pat!r}) also registered "
                    f"at {f0}:{l0}: first match wins, this row is "
                    "unreachable"))
            else:
                seen[key] = (mod.rel, lineno)
            # resolve the handler to a def we can check
            fn = None
            hname = None
            if isinstance(handler, ast.Name):
                hname = handler.id
                fn = defs.get(hname)
                if fn is None:
                    findings.append(Finding(
                        "R006", mod.rel, lineno,
                        f"route handler {hname!r} is not defined at "
                        "module level: the row dispatches to a missing "
                        "function"))
                    continue
            elif isinstance(handler, ast.Attribute) and \
                    isinstance(handler.value, ast.Name):
                target_mod = by_base.get(
                    aliases.get(handler.value.id, "").rsplit(".", 1)[-1])
                if target_mod is not None:
                    hname = f"{handler.value.id}.{handler.attr}"
                    fn = _module_defs(target_mod).get(handler.attr)
                    if fn is None:
                        findings.append(Finding(
                            "R006", mod.rel, lineno,
                            f"route handler {hname} not found in "
                            f"{target_mod.rel}"))
                        continue
            if fn is None:
                continue       # dynamic handler (factory call) — unchecked
            required, maximum = _sig_bounds(fn)
            if ngroups < required or \
                    (maximum is not None and ngroups > maximum):
                want = f"{required}" if maximum == required else \
                    f"{required}..{'*' if maximum is None else maximum}"
                findings.append(Finding(
                    "R006", mod.rel, lineno,
                    f"route {method} {pat!r} captures {ngroups} group(s) "
                    f"but handler {hname}() takes {want} after `h`: "
                    "dispatch raises TypeError on every request"))
    return findings


check.RULES = RULES
