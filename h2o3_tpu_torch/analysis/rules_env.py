"""R017 of the port (h2o3_tpu/analysis/rules_env.py): the env-var config
census + the generated ENV.md.

The config surface is 60+ `H2O3_*` environment variables. Before this
rule they were read through scattered `os.environ.get(...)` calls with
ad-hoc `int()`/`float()` parses — which shipped real defects: values
that crash at read time (`int("yes")`), the same variable read with two
different defaults (`.get(NAME, "60") or 0`), and zero visibility into
what the config surface even IS (a renamed variable broke deployments
silently, the exact drift class METRICS.md/SPANS.md already gate for
metric and span names).

R017 therefore enforces, package-wide:

  * every H2O3_* read goes through the typed accessors
    (`utils/env.env_str/env_int/env_float/env_bool`) — a direct
    `os.environ.get("H2O3_...")` / `os.environ["H2O3_..."]` /
    `os.getenv("H2O3_...")` is a finding (utils/env.py itself, the
    accessors' implementation, is exempt);
  * accessor calls use a LITERAL variable name and a LITERAL default
    (a computed name cannot be censused; a computed default defeats the
    one-default-per-variable contract). `env_int`/`env_float` must pass
    a default explicitly;
  * each variable is declared at exactly ONE accessor call site
    package-wide — modules that share a variable import the owning
    module's helper (utils/env.process_id, multihost._coordinator_address)
    instead of re-reading;
  * every `H2O3_*` token the README's section on the port (`## PyTorch/
    H100 port`, up to the next `## ` heading) documents must exist in
    the census — documented-but-phantom variables are doc drift (checked
    only on full-package runs, where utils/env.py is among the analyzed
    modules). The rest of the README is the JAX package's, and the JAX
    analyzer holds every token of the whole file against the JAX
    package, so the port's section may name only variables both
    packages declare; the port's own variables are listed in its
    analysis/ENV.md.

The census of what passed is committed as `h2o3_tpu_torch/analysis/ENV.md`
(`python -m h2o3_tpu_torch.analysis --write-census`) and freshness-gated in
pre-commit/tier-1 exactly like the metric and span censuses.
"""

from __future__ import annotations

import ast
import os
import re

from h2o3_tpu_torch.analysis.engine import Finding, Module, repo_root

RULES = {"R017"}

_ACCESSORS = {"env_str": "str", "env_int": "int",
              "env_float": "float", "env_bool": "bool"}
_DEFAULT_OPTIONAL = {"env_str", "env_bool"}
_PREFIX = "H2O3_"
_README_TOKEN = re.compile(r"H2O3_[A-Z0-9_]*[A-Z0-9]")
# README tokens that are namespace/template mentions, not variables
_README_IGNORE = {"H2O3_TPU"}
# the heading of the README's section on the port
_README_SECTION = "## PyTorch/H100 port"


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


def _is_env_read(node: ast.Call):
    """(is_read, name_node) for os.environ.get(...)/os.getenv(...)."""
    chain = _chain(node.func)
    if chain.endswith("environ.get") or chain in ("os.getenv", "getenv"):
        return True, (node.args[0] if node.args else None)
    return False, None


def _literal_default(node: ast.AST) -> bool:
    """Constant, or an expression of constants only (1 << 20, -1.0) —
    the shapes that still declare ONE default, just spelled readably."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Constant, ast.BinOp, ast.UnaryOp,
                            ast.operator, ast.unaryop, ast.Tuple,
                            ast.expr_context)):
            continue        # expr_context: the Load ctx a Tuple carries
        return False
    return True


def _accessor_call(node: ast.Call):
    """kind for env_str(...)/env.env_int(...)-shaped calls, else None."""
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id in _ACCESSORS:
        return _ACCESSORS[fn.id]
    if isinstance(fn, ast.Attribute) and fn.attr in _ACCESSORS and \
            isinstance(fn.value, ast.Name):
        return _ACCESSORS[fn.attr]
    return None


def _env_module(mod: Module) -> bool:
    return mod.rel.replace("\\", "/").endswith("utils/env.py")


def collect(mods: list):
    """(declarations, findings): declarations is
    {name: [{kind, default, file, line}]}."""
    decls: dict = {}
    findings: list = []
    for mod in mods:
        is_env_mod = _env_module(mod)
        for node in mod.walk():
            # ---- direct reads --------------------------------------------
            if isinstance(node, ast.Call) and not is_env_mod:
                is_read, name_node = _is_env_read(node)
                if is_read:
                    if isinstance(name_node, ast.Constant) and \
                            isinstance(name_node.value, str):
                        if name_node.value.startswith(_PREFIX):
                            findings.append(Finding(
                                "R017", mod.rel, node.lineno,
                                f"direct environment read of "
                                f"{name_node.value!r}: H2O3_* config goes "
                                "through the typed accessors (utils/env."
                                "env_str/env_int/env_float/env_bool) so "
                                "bad values can't crash and the variable "
                                "lands in the ENV.md census"))
                    elif name_node is not None:
                        findings.append(Finding(
                            "R017", mod.rel, node.lineno,
                            "environment read with a computed name: "
                            "cannot be censused — read through a typed "
                            "accessor with a literal name (or waive with "
                            "the reason the namespace is dynamic)"))
            if isinstance(node, ast.Subscript) and not is_env_mod and \
                    isinstance(node.ctx, ast.Load) and \
                    _chain(node.value).endswith("environ") and \
                    isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str) and \
                    node.slice.value.startswith(_PREFIX):
                findings.append(Finding(
                    "R017", mod.rel, node.lineno,
                    f"direct os.environ[{node.slice.value!r}] read: "
                    "H2O3_* config goes through the typed accessors — a "
                    "missing variable here is a KeyError at request time"))
            # ---- accessor declarations -----------------------------------
            if not isinstance(node, ast.Call):
                continue
            kind = _accessor_call(node)
            if kind is None:
                continue
            name_node = node.args[0] if node.args else None
            if not (isinstance(name_node, ast.Constant)
                    and isinstance(name_node.value, str)):
                findings.append(Finding(
                    "R017", mod.rel, node.lineno,
                    f"env_{kind}() with a non-literal variable name: "
                    "cannot be censused — declare the name as a string "
                    "literal"))
                continue
            name = name_node.value
            if not name.startswith(_PREFIX):
                continue            # out of the censused namespace
            default_node = node.args[1] if len(node.args) > 1 else None
            if default_node is None:
                for kw in node.keywords:
                    if kw.arg == "default":
                        default_node = kw.value
            fname = _terminal(node.func)
            if default_node is None:
                if fname not in _DEFAULT_OPTIONAL:
                    findings.append(Finding(
                        "R017", mod.rel, node.lineno,
                        f"{fname}({name!r}) without an explicit default: "
                        "every censused variable declares its default at "
                        "the declaration site"))
                default_repr = '""' if fname == "env_str" else "False"
            elif not _literal_default(default_node):
                findings.append(Finding(
                    "R017", mod.rel, node.lineno,
                    f"{fname}({name!r}, <computed default>): a computed "
                    "default defeats the one-default-per-variable "
                    "contract — declare a literal default (compose "
                    "fallbacks OUTSIDE the accessor: env_str(...) or "
                    "computed)"))
                default_repr = "<computed>"
            else:
                default_repr = ast.unparse(default_node)
            decls.setdefault(name, []).append(
                {"kind": kind, "default": default_repr,
                 "file": mod.rel, "line": node.lineno})
    return decls, findings


def _readme_tokens() -> list:
    """(token, line) of the H2O3_* tokens of the README's section on the
    port."""
    path = os.path.join(repo_root(), "README.md")
    if not os.path.exists(path):
        return []
    out = []
    inside = False
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh, start=1):
            if line.startswith("## "):
                inside = line.rstrip() == _README_SECTION
            if not inside:
                continue
            for tok in _README_TOKEN.findall(line):
                if tok not in _README_IGNORE:
                    out.append((tok, i))
    return out


def check(mods: list) -> list:
    decls, findings = collect(mods)
    for name, entries in sorted(decls.items()):
        if len(entries) > 1:
            first = entries[0]
            for extra in entries[1:]:
                findings.append(Finding(
                    "R017", extra["file"], extra["line"],
                    f"env var {name!r} is declared at more than one "
                    f"accessor call site (first at {first['file']}:"
                    f"{first['line']}): two sites drift apart on type "
                    "and default — declare once, wrap in a helper and "
                    "import it"))
    # README cross-check only on full-package runs: seeded fixtures must
    # not be held against the real README's variable tables
    if any(_env_module(m) for m in mods):
        known = set(decls)
        seen: set = set()
        for tok, line in _readme_tokens():
            if tok in known or tok in seen:
                continue
            seen.add(tok)
            f = Finding(
                "R017", "README.md", line,
                f"README's port section documents env var {tok!r} but "
                "no typed-accessor "
                "declaration exists in the package: doc drift — delete "
                "the row, or wire the variable through utils/env")
            f.snippet = tok     # stable fingerprint (README isn't parsed)
            findings.append(f)
    return findings


check.RULES = RULES


def census_markdown(mods: list) -> str:
    """The committed h2o3_tpu_torch/analysis/ENV.md body."""
    decls, _ = collect(mods)
    readme = {tok for tok, _ in _readme_tokens()}
    lines = [
        "# Env-var config census — generated, do not edit",
        "",
        "Generated by `python -m h2o3_tpu_torch.analysis --write-census`; the",
        "R017 rule keeps this file honest (every H2O3_* read goes through",
        "a typed accessor with one literal declaration site and one",
        "default; README rows must exist here). Regenerate after adding,",
        "renaming or re-defaulting a variable.",
        "",
        "| variable | type | default | declared at | README |",
        "|---|---|---|---|---|",
    ]
    for name, entries in sorted(decls.items()):
        e = entries[0]
        # file only, no line: line-shift edits must leave the committed
        # census byte-identical
        lines.append(
            f"| `{name}` | {e['kind']} | `{e['default']}` | "
            f"{e['file']} | "
            f"{'✓' if name in readme else '—'} |")
    lines.append("")
    lines.append(f"{len(decls)} variables.")
    return "\n".join(lines) + "\n"
