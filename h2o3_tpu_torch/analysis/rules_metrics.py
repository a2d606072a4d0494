"""R005 of the port (h2o3_tpu/analysis/rules_metrics.py): metric-name
drift + the generated registry census.

The obs registry (`h2o3_tpu_torch/obs/metrics.py`) is get-or-make: registering
"h2o3_scorer_cache_hits_total" twice silently returns the first metric,
so a typo'd duplicate ("..._hit_total") splits one logical series into
two, and a second registration site with a different help string wins or
loses by import order. Prometheus additionally requires a consistent
label set per metric name — emitting `inc(reason=...)` at one site and
`inc()` at another produces series that cannot be aggregated.

R005 therefore enforces, package-wide:
  * every `h2o3_*` metric name is DECLARED at exactly one call site
    (counter()/gauge()/histogram() with a literal name);
  * declarations use literal names (a computed name cannot be censused
    and usually means unbounded cardinality);
  * every emission site (`.inc/.observe/.set/.time`) for one metric uses
    the same label-key set.

The census of what passed is written to `h2o3_tpu_torch/obs/METRICS.md` by
`python -m h2o3_tpu_torch.analysis --write-census` and committed, so a metrics
rename shows up as a diff to the census, not as a silent
dashboard break.
"""

from __future__ import annotations

import ast

from h2o3_tpu_torch.analysis.engine import Finding, Module

RULES = {"R005"}

_DECL_FNS = {"counter", "gauge", "histogram"}
_EMIT_FNS = {"inc", "observe", "set", "time"}
_PREFIX = "h2o3_"
# receivers that denote the obs registry (`_om.counter(...)` etc.) — a
# same-named method on anything else (np.histogram!) is not a declaration
_REGISTRY_ALIASES = {"_om", "om", "_m", "_obs_m", "_obs_metrics",
                     "metrics", "_metrics", "REGISTRY"}


def _terminal(fn: ast.AST):
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _enclosing_params(node: ast.AST, parents: dict) -> set:
    out: set = set()
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = cur.args
            out.update(x.arg for x in a.posonlyargs + a.args + a.kwonlyargs)
        cur = parents.get(cur)
    return out


def _enclosing_class(node: ast.AST, parents: dict) -> str:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        cur = parents.get(cur)
    return ""


def _registry_names(mod: Module) -> set:
    """Declaration helpers this module imported from the obs registry
    (`from h2o3_tpu_torch.obs.metrics import counter, histogram`)."""
    out = set()
    for node in mod.walk():
        if isinstance(node, ast.ImportFrom) and node.module \
                and "obs" in node.module:
            out.update(a.asname or a.name for a in node.names
                       if a.name in _DECL_FNS)
    return out


def _is_registry_call(node: ast.Call, local_decl_names: set) -> bool:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id in local_decl_names
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        return fn.value.id in _REGISTRY_ALIASES
    return False


def collect(mods: list):
    """(declarations, findings): declarations is
    {name: [{kind, help, file, line, var, labels:set}]}"""
    decls: dict = {}
    findings: list = []
    for mod in mods:
        parents = mod.parents()
        var_to_name: dict = {}    # module-level VAR -> metric name
        local_decl = _registry_names(mod)
        if mod.rel.replace("\\", "/").endswith("obs/metrics.py"):
            local_decl = set(_DECL_FNS)   # the registry's own module
        for node in mod.walk():
            if not isinstance(node, ast.Call):
                continue
            kind = _terminal(node.func)
            if kind not in _DECL_FNS or not node.args:
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and \
                    isinstance(first.value, str):
                name = first.value
                if not name.startswith(_PREFIX):
                    continue
                help_arg = ""
                if len(node.args) > 1 and \
                        isinstance(node.args[1], ast.Constant):
                    help_arg = str(node.args[1].value)
                for kw in node.keywords:
                    if kw.arg == "help" and isinstance(kw.value,
                                                      ast.Constant):
                        help_arg = str(kw.value.value)
                entry = {"kind": kind, "help": help_arg, "file": mod.rel,
                         "line": node.lineno, "labels": set()}
                decls.setdefault(name, []).append(entry)
                parent = parents.get(node)
                if isinstance(parent, ast.Assign):
                    for t in parent.targets:
                        if isinstance(t, ast.Name):
                            var_to_name[t.id] = name
                        elif isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id in ("self", "cls"):
                            # instance-attribute metric (self._burn = …),
                            # scoped by class so two classes in one module
                            # can't cross-wire each other's attrs
                            cls = _enclosing_class(parent, parents)
                            var_to_name[f"{cls}.{t.attr}"] = name
            elif not _is_registry_call(node, local_decl):
                pass   # np.histogram(...) and friends — not a metric
            elif isinstance(first, ast.Name) and \
                    first.id in _enclosing_params(node, parents):
                pass   # pass-through wrapper (the registry's own helpers)
            else:
                findings.append(Finding(
                    "R005", mod.rel, node.lineno,
                    f"{kind}() with a non-literal metric name: cannot be "
                    "censused and risks unbounded series cardinality — "
                    "declare the name as a string literal"))
        # emission label sets for module-level metric vars
        for node in mod.walk():
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr not in _EMIT_FNS:
                continue
            recv = node.func.value
            key = None
            if isinstance(recv, ast.Name) and recv.id in var_to_name:
                key = recv.id
            elif isinstance(recv, ast.Attribute) and \
                    isinstance(recv.value, ast.Name) and \
                    recv.value.id in ("self", "cls"):
                k = f"{_enclosing_class(node, parents)}.{recv.attr}"
                if k in var_to_name:
                    key = k
            if key is None:
                continue
            name = var_to_name[key]
            # `exemplar` is the reserved OpenMetrics exemplar kwarg on
            # HISTOGRAM observe/time only — there it is not a label, and
            # passing it at one site but not another must not split the
            # series. On inc()/set() no such parameter exists: the kwarg
            # would land in **labels and mint a series per trace id, so
            # it must stay visible to the cardinality check.
            labels = frozenset(
                kw.arg for kw in node.keywords
                if kw.arg is not None
                and not (kw.arg == "exemplar"
                         and node.func.attr in ("observe", "time")))
            for entry in decls.get(name, []):
                if entry["file"] == mod.rel:
                    entry.setdefault("emissions", []).append(
                        (mod.rel, node.lineno, labels))
    return decls, findings


def check(mods: list) -> list:
    decls, findings = collect(mods)
    for name, entries in sorted(decls.items()):
        if len(entries) > 1:
            first = entries[0]
            for extra in entries[1:]:
                findings.append(Finding(
                    "R005", extra["file"], extra["line"],
                    f"metric {name!r} is declared more than once (first "
                    f"at {first['file']}:{first['line']}): duplicate "
                    "registrations drift apart on help text and typos — "
                    "declare once, import the object"))
        emis = [e for entry in entries
                for e in entry.get("emissions", [])]
        label_sets = {lbls for _, _, lbls in emis}
        if len(label_sets) > 1:
            # report at the minority sites (most emissions define the norm)
            from collections import Counter
            common = Counter(l for _, _, l in emis).most_common(1)[0][0]
            for file, line, lbls in emis:
                if lbls != common:
                    findings.append(Finding(
                        "R005", file, line,
                        f"metric {name!r} emitted with labels "
                        f"{sorted(lbls) or '(none)'} here but "
                        f"{sorted(common) or '(none)'} elsewhere: "
                        "inconsistent label sets split the series — "
                        "emit one label schema per metric"))
    return findings


check.RULES = RULES


def census_markdown(mods: list) -> str:
    """The committed h2o3_tpu_torch/obs/METRICS.md body."""
    decls, _ = collect(mods)
    lines = [
        "# Metric census — generated, do not edit",
        "",
        "Generated by `python -m h2o3_tpu_torch.analysis --write-census`; the",
        "R005 rule keeps this file honest (one declaration per name,",
        "consistent label sets). Regenerate after adding or renaming a",
        "metric.",
        "",
        "| metric | kind | labels | declared at | help |",
        "|---|---|---|---|---|",
    ]
    for name, entries in sorted(decls.items()):
        e = entries[0]
        labels = sorted({lb for en in entries
                         for _, _, ls in en.get("emissions", [])
                         for lb in ls})
        # file only, no line: a pure line-shift edit upstream of a
        # declaration must leave the committed census byte-identical
        lines.append(
            f"| `{name}` | {e['kind']} | "
            f"{', '.join(f'`{l}`' for l in labels) or '—'} | "
            f"{e['file']} | {e['help'] or '—'} |")
    lines.append("")
    lines.append(f"{len(decls)} metrics.")
    return "\n".join(lines) + "\n"
