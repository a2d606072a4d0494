"""R003 of the port (h2o3_tpu/analysis/rules_locks.py) — lock
discipline: attributes mutated both under and outside a lock.

Derived from the replay channel's bug class: Broadcaster state
(`_owed`, `_bufs`) touched from paths that sometimes held `self._lock` and
sometimes didn't froze /3/Timeline scrapes until the accounting was made
lock-consistent. The rule:

  * a class "declares" a lock when any method assigns `self.X =
    threading.Lock()/RLock()/Condition()` (aliased imports count via the
    terminal callee name);
  * every mutation of `self.Y` in a method body is classified as
    locked (lexically inside `with self.X:` for any declared lock) or
    bare;
  * an attribute with BOTH locked and bare mutation sites is reported at
    each bare site. `__init__` is construction — nothing else can hold a
    reference yet — so its mutations are exempt.

Mutation = assignment/augassign to `self.Y` or `self.Y[...]`, or a call
of a known mutating method (`append`, `pop`, `update`, …) on `self.Y`.
A bare site that is safe by construction (e.g. a helper only ever called
with the lock held) carries an inline `# h2o3-ok: R003 <why>` waiver —
the waiver IS the documentation the next reader needs.
"""

from __future__ import annotations

import ast

from h2o3_tpu_torch.analysis.engine import Finding, Module

RULES = {"R003"}

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore",
               # analysis.lockdep instrumented wrappers count as locks
               "make_lock", "make_rlock", "DepLock"}
_MUTATORS = {"append", "extend", "insert", "add", "remove", "discard",
             "pop", "popitem", "clear", "update", "setdefault",
             "move_to_end", "appendleft", "popleft", "extendleft",
             "sort", "reverse"}


def _self_attr(node: ast.AST):
    """'Y' when node is `self.Y`, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _self_attr_base(node: ast.AST):
    """'Y' for `self.Y`, `self.Y[...]`, `self.Y[...][...]` targets."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return _self_attr(node)


def _lock_attrs(cls: ast.ClassDef) -> set:
    locks = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            callee = node.value.func
            name = callee.attr if isinstance(callee, ast.Attribute) \
                else (callee.id if isinstance(callee, ast.Name) else None)
            if name in _LOCK_CTORS:
                for t in node.targets:
                    a = _self_attr(t)
                    if a:
                        locks.add(a)
    return locks


def _methods(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _mutations(method: ast.AST, lock_attrs: set):
    """Yield (attr, lineno, locked) for every self-attribute mutation,
    where locked means lexically inside `with self.<lock>:`."""

    def visit(node, locked):
        if isinstance(node, ast.With):
            holds = locked or any(
                _self_attr(item.context_expr) in lock_attrs
                for item in node.items)
            for item in node.items:
                yield from visit(item.context_expr, locked)
            for child in node.body:
                yield from visit(child, holds)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return      # nested scope: analyzed as part of its own method
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for e in elts:
                    a = _self_attr_base(e)
                    if a:
                        yield a, node.lineno, locked
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS:
            a = _self_attr_base(node.func.value)
            if a:
                yield a, node.lineno, locked
        for child in ast.iter_child_nodes(node):
            yield from visit(child, locked)

    # start from the method's statements: visit() early-returns on nested
    # function nodes, and the method node itself is one
    for child in method.body:
        yield from visit(child, False)


def check(mod: Module) -> list:
    findings: list = []
    for cls in mod.walk():
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        if not locks:
            continue
        sites: dict = {}      # attr -> [(lineno, locked, method)]
        for method in _methods(cls):
            if method.name == "__init__":
                continue
            for attr, lineno, locked in _mutations(method, locks):
                if attr in locks:
                    continue
                sites.setdefault(attr, []).append(
                    (lineno, locked, method.name))
        for attr, hits in sites.items():
            if not any(locked for _, locked, _ in hits):
                continue
            for lineno, locked, mname in hits:
                if locked:
                    continue
                findings.append(Finding(
                    "R003", mod.rel, lineno,
                    f"{cls.name}.{attr} is mutated under "
                    f"`with self.<lock>` elsewhere but bare in "
                    f"{mname}(): either take the lock here or waive "
                    "with `# h2o3-ok: R003 <why it is safe>`"))
    return findings


check.RULES = RULES
