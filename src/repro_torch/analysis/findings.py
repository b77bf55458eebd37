"""Finding model, rule registry, and the suppression baseline.

A finding is one (rule, location, message) triple.  Its *fingerprint*
deliberately excludes line/column so a checked-in suppression survives
unrelated edits to the file: two findings are "the same" when the rule,
file, enclosing symbol, and message all match.

The baseline file (``torch-analysis-baseline.json``; the JAX
package's analyzer reads ``analysis-baseline.json``, so the two never
audit each other's entries) is the explicit, reviewed list of accepted
findings.  Every entry carries a ``justification`` string — an empty
one is itself a finding (AN002), so suppressions cannot accumulate
silently.

Messages, fingerprints and the baseline format are the JAX package's
(``repro.analysis.findings``), so a finding of one rule on one file and
symbol has the same fingerprint in both analyzers.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterable, List, Optional

ERROR = "error"
WARNING = "warning"
NOTE = "note"
SEVERITY_ORDER = {ERROR: 0, WARNING: 1, NOTE: 2}

# rule id -> (default severity, one-line description).  Populated by the
# analyzer modules at import time via register_rule().
RULES: Dict[str, tuple] = {}


def register_rule(rule_id: str, severity: str, description: str) -> str:
    """Register a rule id; ids are claimed once, at import time.  A
    duplicate registration is a programming error in the analyzer
    itself (two rules would share fingerprints and ``--select``
    behavior), so it raises instead of silently overwriting."""
    if rule_id in RULES:
        raise ValueError(
            f"rule id {rule_id!r} registered twice "
            f"(existing: {RULES[rule_id][1]!r}, new: {description!r})")
    RULES[rule_id] = (severity, description)
    return rule_id


# Tool-level rules (the analyzers register their own families).
AN001 = register_rule("AN001", ERROR, "file does not parse")
AN002 = register_rule("AN002", WARNING,
                      "baseline suppression has no justification")
AN003 = register_rule("AN003", NOTE,
                      "baseline suppression matches no current finding")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    symbol: str
    message: str
    severity: str = ""

    def __post_init__(self):
        if not self.severity:
            sev = RULES.get(self.rule, (WARNING,))[0]
            object.__setattr__(self, "severity", sev)

    def fingerprint(self) -> str:
        key = "|".join((self.rule, _norm_path(self.path), self.symbol,
                        self.message))
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.severity}] {self.symbol}: {self.message}")

    def to_json(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": _norm_path(self.path), "line": self.line,
                "col": self.col, "symbol": self.symbol,
                "message": self.message,
                "fingerprint": self.fingerprint()}


def _norm_path(path: str) -> str:
    return os.path.normpath(path).replace(os.sep, "/")


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    return sorted(findings,
                  key=lambda f: (SEVERITY_ORDER.get(f.severity, 3),
                                 _norm_path(f.path), f.line, f.rule))


def to_sarif(findings: Iterable[Finding]) -> dict:
    """SARIF 2.1.0 document for GitHub code-scanning upload.

    Severities map 1:1 (SARIF levels are ``error``/``warning``/
    ``note`` too).  The per-result partial fingerprint is the same
    line-independent fingerprint the baseline uses, so code-scanning
    alert identity matches baseline identity.
    """
    results = []
    used_rules = set()
    for f in sort_findings(findings):
        used_rules.add(f.rule)
        results.append({
            "ruleId": f.rule,
            "level": f.severity if f.severity in SEVERITY_ORDER
            else "warning",
            "message": {"text": f"{f.symbol}: {f.message}"},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": _norm_path(f.path),
                        "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(f.line, 1),
                               "startColumn": max(f.col, 1)},
                },
            }],
            "partialFingerprints": {
                "reproAnalysis/v1": f.fingerprint()},
        })
    rules = [{
        "id": rid,
        "shortDescription": {"text": RULES[rid][1]},
        "defaultConfiguration": {"level": RULES[rid][0]},
    } for rid in sorted(used_rules) if rid in RULES]
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "repro_torch.analysis",
                "informationUri":
                    "https://github.com/wtacrs/repro",
                "rules": rules,
            }},
            "results": results,
        }],
    }


class Baseline:
    """Checked-in suppression list; see module docstring."""

    VERSION = 1

    def __init__(self, entries: Optional[List[dict]] = None,
                 path: Optional[str] = None):
        self.entries = entries or []
        self.path = path
        self._by_fp = {e.get("fingerprint"): e for e in self.entries}
        self._hits: set = set()

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if data.get("version") != cls.VERSION:
            raise ValueError(
                f"baseline {path}: version {data.get('version')!r} is "
                f"not {cls.VERSION}")
        return cls(entries=list(data.get("suppressions", [])), path=path)

    @classmethod
    def from_findings(cls, findings: Iterable[Finding],
                      justification: str = "") -> "Baseline":
        entries = [{
            "fingerprint": f.fingerprint(),
            "rule": f.rule,
            "location": f"{_norm_path(f.path)}:{f.symbol}",
            "message": f.message,
            "justification": justification,
        } for f in sort_findings(findings)]
        return cls(entries=entries)

    def save(self, path: str) -> None:
        payload = {"version": self.VERSION, "suppressions": self.entries}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=False)
            f.write("\n")

    def is_suppressed(self, finding: Finding) -> bool:
        hit = finding.fingerprint() in self._by_fp
        if hit:
            self._hits.add(finding.fingerprint())
        return hit

    def audit(self) -> List[Finding]:
        """Findings about the baseline itself: unjustified entries and
        entries that no longer match anything (stale suppressions)."""
        out = []
        for e in self.entries:
            loc = e.get("location", "?")
            if not str(e.get("justification", "")).strip():
                out.append(Finding(
                    rule="AN002", path=self.path or "analysis-baseline",
                    line=1, col=1, symbol=loc,
                    message=f"suppression {e.get('rule')} at {loc} has "
                            f"no justification"))
            if e.get("fingerprint") not in self._hits:
                out.append(Finding(
                    rule="AN003", path=self.path or "analysis-baseline",
                    line=1, col=1, symbol=loc,
                    message=f"suppression {e.get('rule')} at {loc} "
                            f"matches no current finding; delete it"))
        return out
