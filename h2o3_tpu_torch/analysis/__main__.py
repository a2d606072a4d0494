"""The analyzer's CLI of the port (h2o3_tpu/analysis/__main__.py):
python -m h2o3_tpu_torch.analysis [paths] [options].

Exit status is the contract: 0 when every finding is suppressed or
baselined, 1 otherwise — so the tier-1 test and any pre-commit hook can
shell out to the same entry point the developer runs locally.

`--changed-only` scopes findings to git-modified files (staged, unstaged
and untracked): per-file rules skip unchanged modules and project-rule
findings are filtered to the changed set, so the pre-commit hook pays
seconds on a small diff while CI/tier-1 keep whole-package scope. The
census freshness gate still runs in full — a census is whole-package by
definition.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from h2o3_tpu_torch.analysis import engine


def _git_changed_files(root: str):
    """Repo-relative paths of modified/staged/untracked files, or None
    when git is unavailable (fall back to a full run, never skip)."""
    try:
        out = subprocess.run(
            ["git", "-C", root, "status", "--porcelain", "--no-renames",
             "--untracked-files=all"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    changed = set()
    for line in out.stdout.splitlines():
        if len(line) < 4:
            continue
        path = line[3:].strip().strip('"')
        if path:
            changed.add(path.replace("\\", "/"))
    return changed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m h2o3_tpu_torch.analysis",
        description="the port's static analyzer (rules R001-R025)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: the h2o3_tpu_torch "
                         "package)")
    ap.add_argument("--baseline", default=None, metavar="JSON",
                    help="baseline file of grandfathered findings "
                         "(e.g. analysis_baseline.json)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset, e.g. R001,R003")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout "
                         "(includes elapsed_s wall-time)")
    ap.add_argument("--sarif", default=None, metavar="PATH",
                    help="also write findings as SARIF 2.1.0 to PATH "
                         "(CI/editor annotation format)")
    ap.add_argument("--all", action="store_true",
                    help="also print suppressed/baselined findings")
    ap.add_argument("--changed-only", action="store_true",
                    help="scope findings to git-modified files "
                         "(pre-commit mode; project rules still see the "
                         "whole package for cross-file resolution)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather current findings into --baseline")
    ap.add_argument("--write-census", nargs="?", metavar="PATH",
                    const="__default__", default=None,
                    help="write the census markdown files (default: "
                         "h2o3_tpu_torch/obs/METRICS.md + SPANS.md + "
                         "h2o3_tpu_torch/analysis/ENV.md + "
                         "h2o3_tpu_torch/deploy/PROTOCOL.md)")
    ap.add_argument("--check-census", action="store_true",
                    help="exit 1 when a committed census (METRICS.md / "
                         "SPANS.md / ENV.md / PROTOCOL.md) is stale "
                         "(pre-commit freshness gate)")
    args = ap.parse_args(argv)

    t0 = time.monotonic()
    rules = [r.strip().upper() for r in args.rules.split(",")] \
        if args.rules else None
    paths = args.paths or [engine.package_root()]
    mods = engine.load_modules(paths)

    only_files = None
    if args.changed_only:
        changed = _git_changed_files(engine.repo_root())
        if changed is not None:
            only_files = {m.rel for m in mods
                          if m.rel.replace("\\", "/") in changed}
            # R017's doc-drift findings target README.md itself — keep
            # them in scope when the README is what changed (else a
            # phantom config row sails through the hook)
            if "README.md" in changed:
                only_files.add("README.md")
    findings = engine.analyze_modules(mods, rules=rules,
                                      only_files=only_files)

    census_rc = 0
    if args.write_census is not None or args.check_census:
        from h2o3_tpu_torch.analysis import rules_env, rules_metrics, \
            rules_protocol, rules_spans
        # the censuses are PACKAGE-wide by definition — independent of
        # which paths this invocation analyzes (the hook passes tests/
        # too, which must not leak fixture names into a census; a
        # --changed-only run must still gate the full surface). When the
        # analyzed paths cover the whole package, filter the
        # already-parsed modules instead of re-reading the tree;
        # re-load only for partial runs.
        pkg_root = engine.package_root()
        if any(os.path.abspath(p) == pkg_root for p in paths):
            pkg_mods = [m for m in mods
                        if m.path.startswith(pkg_root + os.sep)]
        else:
            pkg_mods = engine.load_modules([pkg_root])
        censuses = [
            (rules_metrics.census_markdown(pkg_mods), "metric",
             os.path.join(engine.package_root(), "obs", "METRICS.md")),
            (rules_spans.census_markdown(pkg_mods), "span",
             os.path.join(engine.package_root(), "obs", "SPANS.md")),
            (rules_env.census_markdown(pkg_mods), "env-var",
             os.path.join(engine.package_root(), "analysis", "ENV.md")),
            (rules_protocol.census_markdown(pkg_mods), "protocol",
             os.path.join(engine.package_root(), "deploy", "PROTOCOL.md")),
        ]
        if args.write_census is not None:
            targets = censuses
            if args.write_census != "__default__":
                # explicit path: the metric census only (legacy
                # spelling). Leave `censuses` itself alone — the
                # --check-census gate below must keep comparing the
                # COMMITTED files, not the file just written
                targets = [(censuses[0][0], "metric", args.write_census)]
            for body, _, out in targets:
                with open(out, "w", encoding="utf-8") as fh:
                    fh.write(body)
                print(f"census written: {out}", file=sys.stderr)
        if args.check_census:
            for body, what, path in censuses:
                have = ""
                if os.path.exists(path):
                    with open(path, encoding="utf-8") as fh:
                        have = fh.read()
                if have != body:
                    print(f"stale {what} census — run: python -m "
                          "h2o3_tpu_torch.analysis --write-census",
                          file=sys.stderr)
                    census_rc = 1

    if args.baseline and not args.write_baseline:
        engine.apply_baseline(findings, engine.load_baseline(args.baseline))
    if args.write_baseline:
        path = args.baseline or "analysis_baseline.json"
        engine.write_baseline(findings, path)
        print(f"baseline written: {path} "
              f"({len([f for f in findings if not f.suppressed])} findings "
              "grandfathered)", file=sys.stderr)
        return 1 if census_rc else 0    # a stale census still gates

    elapsed = time.monotonic() - t0
    bad = engine.unsuppressed(findings)
    shown = findings if args.all else bad
    if args.sarif:
        from h2o3_tpu_torch.analysis import sarif
        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(sarif.to_sarif(findings), fh, indent=2,
                      sort_keys=True)
            fh.write("\n")
        print(f"sarif written: {args.sarif}", file=sys.stderr)
    if args.as_json:
        by_rule: dict = {}
        for f in findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        print(json.dumps({"findings": [f.to_dict() for f in shown],
                          "unsuppressed": len(bad),
                          "total": len(findings),
                          "by_rule": dict(sorted(by_rule.items())),
                          "files_analyzed": len(mods),
                          "changed_only": bool(args.changed_only),
                          "scoped_files": (len(only_files)
                                           if only_files is not None
                                           else None),
                          "elapsed_s": round(elapsed, 3),
                          "rule_timings_s": {
                              k: round(v, 4) for k, v in
                              sorted(engine.RULE_TIMINGS.items())}},
                         indent=2))
    else:
        for f in shown:
            tag = ""
            if f.suppressed:
                tag = " [suppressed]"
            elif f.baselined:
                tag = " [baselined]"
            print(f"{f}{tag}")
        n_sup = sum(1 for f in findings if f.suppressed)
        n_base = sum(1 for f in findings if f.baselined)
        scope = ""
        if only_files is not None:
            scope = f" [changed-only: {len(only_files)} file(s)]"
        print(f"{len(findings)} finding(s): {len(bad)} unsuppressed, "
              f"{n_sup} suppressed inline, {n_base} baselined "
              f"({elapsed:.1f}s){scope}",
              file=sys.stderr)
    return 1 if (bad or census_rc) else 0


if __name__ == "__main__":
    sys.exit(main())
