"""R011 of the port (h2o3_tpu/analysis/rules_spans.py): span-name drift
+ the generated span census.

The span timeline (`h2o3_tpu_torch/obs/timeline.py`) is the trace viewer's
vocabulary: GET /3/Trace/{id}, the flight-recorder search and the SLO
alert spans all join on span NAMES. The same failure modes R005 guards
for metrics apply: a name spelled two ways splits one logical phase into
two rows of every trace view, a second declaration site drifts silently,
and a computed name cannot be censused and usually means unbounded
cardinality in the bounded ring.

R011 therefore enforces, package-wide:
  * every `timeline.span("...")` name is DECLARED at exactly one call
    site (pass-through wrappers that forward a name parameter are
    exempt, like R005's registry helpers);
  * declarations use literal names — a plain string, or a conditional
    expression whose arms are both literals (the scorer's
    `"scorer.warm_hit" if warm else "scorer.compile"` shape, censused as
    two names);
  * the census of what passed is committed as `h2o3_tpu_torch/obs/SPANS.md`
    (`python -m h2o3_tpu_torch.analysis --write-census`) so a span rename
    shows up as a census diff, not as a silently broken trace
    search.

Intentional same-name sites (one logical stage, two engines) carry an
inline `# h2o3-ok: R011 <why>` waiver. Tests are exempt wholesale
(TEST_RELAXED): throwaway fixture spans are the point of a test.
"""

from __future__ import annotations

import ast

from h2o3_tpu_torch.analysis.engine import Finding, Module
from h2o3_tpu_torch.analysis.rules_metrics import _enclosing_params

RULES = {"R011"}

# receivers that denote the span timeline (`timeline.span(...)`,
# `_tl.span(...)`); bare-name calls additionally require the module to
# have imported `span` from obs.timeline (see _span_aliases)
_RECEIVER_ALIASES = {"timeline", "_timeline", "_tl", "_obs_tl"}


def _span_aliases(mod: Module) -> set:
    """Local names bound to obs.timeline's span() by import."""
    out = set()
    for node in mod.walk():
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.endswith("obs.timeline"):
            out.update(a.asname or a.name for a in node.names
                       if a.name == "span")
    return out


def _is_span_call(node: ast.Call, local_aliases: set) -> bool:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id in local_aliases
    if isinstance(fn, ast.Attribute) and fn.attr == "span" \
            and isinstance(fn.value, ast.Name):
        return fn.value.id in _RECEIVER_ALIASES
    return False


def _literal_names(first: ast.AST):
    """The span name(s) a literal first argument declares: a constant
    string, or an IfExp whose two arms are both constant strings.
    Returns None when the argument is not literal."""
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return [first.value]
    if isinstance(first, ast.IfExp) \
            and isinstance(first.body, ast.Constant) \
            and isinstance(first.body.value, str) \
            and isinstance(first.orelse, ast.Constant) \
            and isinstance(first.orelse.value, str):
        return [first.body.value, first.orelse.value]
    return None


def _wrapper_names(mod: Module, aliases: set) -> set:
    """Module-local functions that forward a name parameter into span()
    (mrtask._traced_dispatch): the literal names live at THEIR call
    sites, so those calls are censused like direct span() calls."""
    out = set()
    for fn in mod.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        a = fn.args
        params = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and node.args \
                    and _is_span_call(node, aliases) \
                    and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in params:
                out.add(fn.name)
                break
    return out


def collect(mods: list):
    """(declarations, findings): declarations is {name: [(file, line)]}."""
    decls: dict = {}
    findings: list = []
    for mod in mods:
        rel = mod.rel.replace("\\", "/")
        if rel.endswith("obs/timeline.py"):
            continue   # the span() definition itself (begin() forwards)
        aliases = _span_aliases(mod)
        wrappers = _wrapper_names(mod, aliases)
        parents = None
        for node in mod.walk():
            if not isinstance(node, ast.Call) or not node.args:
                continue
            if not (_is_span_call(node, aliases)
                    or (isinstance(node.func, ast.Name)
                        and node.func.id in wrappers)):
                continue
            names = _literal_names(node.args[0])
            if names is not None:
                for name in names:
                    decls.setdefault(name, []).append((mod.rel,
                                                       node.lineno))
                continue
            if parents is None:
                parents = mod.parents()
            first = node.args[0]
            if isinstance(first, ast.Name) and \
                    first.id in _enclosing_params(node, parents):
                continue   # pass-through wrapper (mrtask._traced_dispatch)
            findings.append(Finding(
                "R011", mod.rel, node.lineno,
                "span() with a non-literal name: cannot be censused and "
                "risks unbounded span-name cardinality in the bounded "
                "timeline ring — declare the name as a string literal "
                "(attrs carry the variable part)"))
    return decls, findings


def check(mods: list) -> list:
    decls, findings = collect(mods)
    for name, sites in sorted(decls.items()):
        if len(sites) > 1:
            first = sites[0]
            for file, line in sites[1:]:
                findings.append(Finding(
                    "R011", file, line,
                    f"span name {name!r} is declared at more than one "
                    f"call site (first at {first[0]}:{first[1]}): "
                    "duplicate declarations drift apart and double-count "
                    "phases in trace views — declare once, or waive with "
                    "a reason if the stage genuinely has two engines"))
    return findings


check.RULES = RULES


def census_markdown(mods: list) -> str:
    """The committed h2o3_tpu_torch/obs/SPANS.md body."""
    decls, _ = collect(mods)
    lines = [
        "# Span census — generated, do not edit",
        "",
        "Generated by `python -m h2o3_tpu_torch.analysis --write-census`; the",
        "R011 rule keeps this file honest (literal names, one declaration",
        "site per name). Regenerate after adding or renaming a span.",
        "",
        "| span | declared at |",
        "|---|---|",
    ]
    for name, sites in sorted(decls.items()):
        # distinct files only, no line numbers: line-shift edits must
        # leave the committed census byte-identical
        where = ", ".join(sorted({f for f, _ln in sites}))
        lines.append(f"| `{name}` | {where} |")
    lines.append("")
    lines.append(f"{len(decls)} span names.")
    return "\n".join(lines) + "\n"
