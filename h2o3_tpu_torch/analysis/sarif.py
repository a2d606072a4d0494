"""SARIF 2.1.0 emission of the port (h2o3_tpu/analysis/sarif.py):
`python -m h2o3_tpu_torch.analysis --sarif out.json`.

SARIF is the interchange format CI annotators (GitHub code scanning)
and editors consume; emitting it makes every R-rule finding a native
PR annotation instead of a log line someone has to grep. The mapping:

  * one `run` with the full rule catalog in the tool component's
    `rules` (rule id, short description) so viewers render names, not
    ids;
  * one `result` per finding — `ruleId`, message, physical location
    (repo-relative URI + 1-based line), and the engine's content-hash
    fingerprint under `partialFingerprints` so SARIF consumers track a
    finding across line drift exactly like the JSON baseline does;
  * inline `# h2o3-ok:` waivers and baselined findings surface as SARIF
    `suppressions` (kind `inSource` / `external`) rather than being
    dropped: the annotator shows them struck-through instead of
    re-flagging them.

The output is deterministic (sorted keys, findings already sorted by
the engine): tests/test_torch_analysis.py holds it against the JAX
package's for the same findings.
"""

from __future__ import annotations

RULE_SUMMARIES = {
    "R001": "a program built per call: a CUDA graph outside the scorer "
            "cache, torch.compile in a function body, ctypes.CDLL "
            "outside ops/_build.py",
    "R002": "device→host sync or host copy in the capture scope, or a "
            "barrier inside a timeline span hot path",
    "R003": "attribute mutated both under its lock and bare",
    "R004": "impure value (time/random/global/torch.rand* without "
            "generator=) fixed at capture time",
    "R005": "metric-name drift vs the obs/METRICS.md census",
    "R006": "REST route capture groups vs handler signature drift",
    "R007": "lock-order cycle (direct or through any call chain)",
    "R008": "blocking operation reachable with a lock held",
    "R009": "donated buffer read after the jitted call consumed it",
    "R010": "thread/executor leak (no daemon/join/shutdown)",
    "R011": "span-name drift vs the obs/SPANS.md census",
    "R012": "print()/bare logging instead of the structured logger",
    "R013": "timeout-less socket wait",
    "R014": "torch.distributed collective outside the collective "
            "guard",
    "R015": "transitive device→host sync inside an instrumented span",
    "R016": "nondeterminism feeding replicated-state mutation in "
            "broadcast-replayed code",
    "R017": "env-config drift vs the analysis/ENV.md census "
            "(direct reads, non-literal names, duplicate declarations)",
    "R018": "replay-exempt route handler transitively mutates "
            "replicated state (coordinator-only mutation)",
    "R019": "host-identity source feeding replicated state in "
            "broadcast-replayed code (interprocedural)",
    "R020": "replay-channel protocol drift vs the deploy/PROTOCOL.md "
            "census (unhandled sends / dead handler arms)",
    "R021": "npz wire-format drift: writer and reader disagree on the "
            "plane/key set",
    "R022": "paired-protocol leak: an acquire whose release is not "
            "proven on every path, exception edges included",
    "R023": "control-flow exception swallowed by a broad handler on a "
            "dispatch/serving/replay path",
    "R024": "paired-protocol token discarded or leaked through a "
            "returning wrapper no caller closes",
    "R025": "module-level tensor or tensor-valued control flow in a "
            "scorer (CUDA-graph capture contract)",
}


def to_sarif(findings: list) -> dict:
    """Findings (engine.Finding, post-suppression/baseline) → a SARIF
    2.1.0 log dict ready for json.dump."""
    results = []
    for f in findings:
        res = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.file.replace("\\", "/"),
                        "uriBaseId": "REPOROOT",
                    },
                    "region": {"startLine": max(1, f.line)},
                },
            }],
            "partialFingerprints": {
                "h2o3ContentHash/v1": f.fingerprint,
            },
        }
        if f.suppressed:
            res["suppressions"] = [{
                "kind": "inSource",
                "justification": "inline h2o3-ok waiver",
            }]
        elif f.baselined:
            res["suppressions"] = [{
                "kind": "external",
                "justification": "grandfathered in "
                                 "analysis_baseline.json",
            }]
        results.append(res)
    return {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "h2o3_tpu_torch.analysis",
                    "informationUri":
                        "https://example.invalid/h2o3_tpu_torch/analysis",
                    "rules": [
                        {"id": rid,
                         "shortDescription": {"text": RULE_SUMMARIES[rid]}}
                        for rid in sorted(RULE_SUMMARIES)
                    ],
                },
            },
            "columnKind": "utf16CodeUnits",
            "originalUriBaseIds": {
                "REPOROOT": {"description": {
                    "text": "repository root (findings use "
                            "repo-relative paths)"}},
            },
            "results": results,
        }],
    }
