"""R012 of the port (h2o3_tpu/analysis/rules_logging.py) — logging
discipline: no print(), no bare logging.getLogger().

The structured logging pillar (utils/log.py) only works if records go
THROUGH it: a `print(...)` bypasses the ring, the durable JSONL segments
under the ice root, the trace/span correlation, and the ERROR keep-rule
— on a worker it lands in a container stdout nobody aggregates, which is
exactly how the rendezvous-deadlock class stayed invisible. A bare
`logging.getLogger(...)` is subtler: the returned logger has none of the
structured handlers, so its records are second-class citizens that
GET /3/Logs cannot see.

R012 therefore flags, package-wide:
  * `print(...)` calls — use `h2o3_tpu_torch.utils.log` (info/warn/err/debug
    or `get_logger("subsystem")`);
  * `logging.getLogger(...)` calls — use `utils.log.get_logger(name)`,
    which returns a child of the structured root.

Exemptions: `__main__.py` CLI entry modules (stdout IS their interface
— the analyzer's own finding report, the REPL banner), and test files
via the engine's TEST_RELAXED profile. Anything else that legitimately
prints (a CLI fallback inside a library module) carries an inline
`# h2o3-ok: R012 reason` waiver.
"""

from __future__ import annotations

import ast

from h2o3_tpu_torch.analysis.engine import Finding, Module

RULES = {"R012"}


def _is_cli_module(rel: str) -> bool:
    r = rel.replace("\\", "/")
    return r.endswith("/__main__.py") or r == "__main__.py"


def check(mod: Module) -> list:
    if _is_cli_module(mod.rel):
        return []
    findings = []
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "print":
            findings.append(Finding(
                "R012", mod.rel, node.lineno,
                "print() bypasses the structured logger (no ring, no "
                "durable JSONL, no trace correlation, invisible to "
                "GET /3/Logs) — use h2o3_tpu_torch.utils.log"))
        elif isinstance(fn, ast.Attribute) and fn.attr == "getLogger" \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id == "logging":
            findings.append(Finding(
                "R012", mod.rel, node.lineno,
                "bare logging.getLogger() yields a logger without the "
                "structured handlers — use "
                "h2o3_tpu_torch.utils.log.get_logger(name)"))
    return findings


check.RULES = RULES
