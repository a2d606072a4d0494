"""R014 of the port (h2o3_tpu/analysis/rules_pjit.py): a torch.distributed
collective outside the collective guard.

The port's cloud is a world of processes joined by a gloo process group,
and gloo pairs the collectives of the ranks by their ORDER: two request
threads of one rank that interleave their collectives pair them with the
wrong calls of the other rank, which hangs or hands one call another's
data. `parallel/compat.py` owns the fix — every program that issues a
collective runs as one guarded region, admitted in ticket order
(`region`, `host_collective_guard`, `train_guard`, or a function
decorated with `guard_collective`).

R014 flags, in the package, every call of a `torch.distributed`
collective — `all_reduce`, `all_gather`, `gather`, `broadcast`,
`reduce`, `scatter`, `barrier`, their `*_object` forms and the other
collectives of the module — that is not lexically inside a guard:

  * a `with` block whose context manager is a call of one of the guards,
    or of a function of the same module that returns one (a one-line
    helper such as `def _guarded(): return compat.host_collective_guard()`);
  * the body of a function decorated with `guard_collective`.

`parallel/compat.py` is exempt (it defines the guard), and so is the
world's one `init_process_group` in `deploy/multihost.py`, which forms
the group before any request runs. Waive a collective that is ordered by
other means with `# h2o3-ok: R014 reason`.
"""

from __future__ import annotations

import ast

from h2o3_tpu_torch.analysis.engine import Finding, Module

RULES = {"R014"}

_SCOPED_PREFIX = "h2o3_tpu_torch/"
_EXEMPT = ("h2o3_tpu_torch/parallel/compat.py",)
# (module, collective) pairs allowed outside a guard
_EXEMPT_SITES = {("h2o3_tpu_torch/deploy/multihost.py",
                  "init_process_group")}
_GUARDS = {"region", "host_collective_guard", "train_guard"}
_GUARD_DECORATOR = "guard_collective"
COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "gather",
    "broadcast", "reduce", "scatter", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "barrier",
    "monitored_barrier", "all_gather_object", "gather_object",
    "broadcast_object_list", "scatter_object_list", "init_process_group",
    "new_group",
}


def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _dist_names(mod: Module):
    """(module aliases of torch.distributed, collectives imported bare)."""
    aliases, bare = set(), set()
    for node in mod.walk():
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    aliases.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    aliases.add(a.asname or a.name)
                elif node.module == "torch.distributed" \
                        and a.name in COLLECTIVES:
                    bare.add(a.asname or a.name)
    return aliases, bare


def _collective(call: ast.Call, aliases: set, bare: set):
    """The collective's name when `call` issues one, else None."""
    name = _dotted(call.func)
    if not name:
        return None
    head, _, term = name.rpartition(".")
    if not head:
        return name if name in bare else None
    if term not in COLLECTIVES:
        return None
    if head == "torch.distributed" or head in aliases:
        return term
    return None


def _guard_helpers(mod: Module) -> set:
    """Module-level functions that return a guard call."""
    out = set()
    for node in mod.tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Return) and isinstance(sub.value,
                                                          ast.Call) \
                    and _dotted(sub.value.func).split(".")[-1] in _GUARDS:
                out.add(node.name)
                break
    return out


def check(mod: Module) -> list:
    rel = mod.rel.replace("\\", "/")
    if not rel.startswith(_SCOPED_PREFIX) or rel in _EXEMPT:
        return []
    aliases, bare = _dist_names(mod)
    if not aliases and not bare and "torch.distributed" not in mod.source:
        return []
    guards = _GUARDS | _guard_helpers(mod)
    parents = mod.parents()

    def guarded(node) -> bool:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call)
                    and _dotted(it.context_expr.func).split(".")[-1]
                    in guards for it in cur.items):
                return True
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(_dotted(d.func if isinstance(d, ast.Call)
                                    else d).split(".")[-1]
                            == _GUARD_DECORATOR
                            for d in cur.decorator_list):
                return True
            cur = parents.get(cur)
        return False

    findings = []
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        name = _collective(node, aliases, bare)
        if name is None or (rel, name) in _EXEMPT_SITES or guarded(node):
            continue
        findings.append(Finding(
            "R014", mod.rel, node.lineno,
            f"torch.distributed {name}() outside the collective guard: "
            "gloo pairs the ranks' collectives by their order, so an "
            "unguarded call from a second thread pairs with the wrong "
            "call of the other ranks (a hang, or another call's data) — "
            "run it under compat.host_collective_guard()/region()/"
            "train_guard() or in a @guard_collective function"))
    return findings


check.RULES = RULES
