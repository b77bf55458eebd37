"""Command-line entry point: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 clean (or everything baselined / notes only), 1 gating
findings (errors or warnings by default; tune with ``--fail-on``),
2 usage / internal error.

The JAX package's CLI (``python -m repro.analysis``) over the port's
Python and its CUDA C++ (``.cu`` / ``.cuh``): ``--smem-budget-kb`` is
the counterpart of ``--vmem-budget-mb``.  The default baseline is
``torch-analysis-baseline.json``: the JAX package's CLI reads
``analysis-baseline.json`` from the working directory and would report
every entry of the port's as stale.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis import (csrc, dataflow, kernel_contracts,
                                  policy_check, torch_lints)
from repro_torch.analysis.astutil import EXCLUDED_PARTS, load_modules
from repro_torch.analysis.findings import (ERROR, NOTE, RULES,
                                           SEVERITY_ORDER, WARNING,
                                           Baseline, Finding,
                                           sort_findings, to_sarif)

DEFAULT_BASELINE = "torch-analysis-baseline.json"


def analyze_paths(paths: Sequence[str], *, policy: bool = True,
                  tag_universe: Optional[dict] = None,
                  param_universe: Optional[dict] = None,
                  smem_budget: Optional[int] = None
                  ) -> List[Finding]:
    """Run every analyzer family over ``paths`` and return raw findings
    (no baseline filtering).  The main entry point for tests.

    The dataflow program (def-use chains + call/closure graph) is built
    once over the Python modules and the source model once over the
    CUDA files; every family that reads them shares them."""
    modules, broken = load_modules(paths)
    sources = csrc.Program.load(paths, EXCLUDED_PARTS)
    findings: List[Finding] = [
        Finding(rule="AN001", path=p, line=1, col=1, symbol="<module>",
                message="file does not parse; analyzers skipped it")
        for p in broken + sorted(sources.broken)
    ]
    program = dataflow.Program.build(modules)
    findings.extend(torch_lints.check(modules, program=program))
    findings.extend(kernel_contracts.check(modules, sources,
                                           smem_budget=smem_budget))
    if policy:
        findings.extend(policy_check.check(modules,
                                           universe=tag_universe,
                                           param_universe=param_universe))
    return sort_findings(findings)


def changed_files(base: str, paths: Sequence[str]) -> Optional[List[str]]:
    """Python and CUDA files changed vs ``base`` (plus untracked ones),
    kept only when they fall under one of ``paths``.  None on git
    failure."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", base],
            capture_output=True, text=True, check=True)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    names = [n for n in (diff.stdout + untracked.stdout).splitlines()
             if n.endswith((".py",) + csrc.SOURCE_SUFFIXES)]
    roots = [os.path.abspath(p) for p in paths]
    out = []
    for n in sorted(set(names)):
        full = os.path.abspath(n)
        if not os.path.exists(full):
            continue          # deleted files have nothing to analyze
        if any(full == r or full.startswith(r + os.sep)
               for r in roots):
            out.append(full)
    return out


def _gates(fail_on: str):
    threshold = SEVERITY_ORDER[fail_on]
    return lambda f: SEVERITY_ORDER.get(f.severity, 3) <= threshold


def _list_rules() -> str:
    lines = ["rule   severity  description"]
    for rid in sorted(RULES):
        sev, desc = RULES[rid]
        lines.append(f"{rid:6s} {sev:9s} {desc}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis for the PyTorch/CUDA port: "
                    "host-sync lints for eager torch (JL*), CUDA kernel "
                    "contract checks (PK*), policy/tag cross-checks "
                    "(PT*).")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: "
                         "src/repro_torch)")
    ap.add_argument("--format", choices=["text", "json", "sarif"],
                    default=None,
                    help="output format (default: text); sarif emits a "
                         "SARIF 2.1.0 document for code-scanning "
                         "upload")
    ap.add_argument("--json", action="store_true",
                    help="alias for --format json")
    ap.add_argument("--changed-only", nargs="?", const="HEAD",
                    default=None, metavar="BASE",
                    help="analyze only .py / .cu / .cuh files changed "
                         "vs BASE "
                         "(git diff --name-only; default base: HEAD) "
                         "plus untracked ones, intersected with the "
                         "given paths — the pre-commit mode")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"suppression baseline (default: "
                         f"{DEFAULT_BASELINE} when it exists)")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="write current findings as a new baseline "
                         "(justifications left empty for review) and "
                         "exit 0")
    ap.add_argument("--no-policy", action="store_true",
                    help="skip the policy/tag cross-checker (avoids "
                         "importing torch)")
    ap.add_argument("--smem-budget-kb", type=float, default=None,
                    metavar="KB",
                    help="shared memory a block for PK004 (default 227: "
                         "the opt-in limit on sm_90)")
    ap.add_argument("--select", default=None, metavar="RULES",
                    help="comma-separated rule ids to keep "
                         "(e.g. JL001,PK003)")
    ap.add_argument("--fail-on", choices=[ERROR, WARNING, NOTE],
                    default=WARNING,
                    help="lowest severity that causes exit 1 "
                         "(default: warning)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    fmt = args.format or ("json" if args.json else "text")

    paths = list(args.paths) or ["src/repro_torch"]
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    if args.changed_only is not None:
        changed = changed_files(args.changed_only, paths)
        if changed is None:
            print(f"error: git diff against "
                  f"{args.changed_only!r} failed (not a git "
                  f"checkout, or unknown ref)", file=sys.stderr)
            return 2
        if not changed:
            print("repro_torch.analysis: no changed python files under "
                  "the given paths")
            return 0
        paths = changed

    smem = (int(args.smem_budget_kb * 1024)
            if args.smem_budget_kb is not None else None)
    findings = analyze_paths(paths, policy=not args.no_policy,
                             smem_budget=smem)

    if args.select:
        keep = {r.strip() for r in args.select.split(",") if r.strip()}
        findings = [f for f in findings if f.rule in keep]

    if args.write_baseline:
        Baseline.from_findings(findings).save(args.write_baseline)
        print(f"wrote {len(findings)} suppression(s) to "
              f"{args.write_baseline}; add justifications before "
              f"committing")
        return 0

    baseline_path = args.baseline
    if baseline_path is None and os.path.exists(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE
    baseline = None
    if baseline_path:
        try:
            baseline = Baseline.load(baseline_path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: cannot read baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2

    suppressed: List[Finding] = []
    if baseline is not None:
        live = [f for f in findings if not baseline.is_suppressed(f)]
        suppressed = [f for f in findings if f not in live]
        findings = live + baseline.audit()
        findings = sort_findings(findings)

    gate = _gates(args.fail_on)
    failing = [f for f in findings if gate(f)]

    if fmt == "json":
        doc = {
            "version": 1,
            "findings": [f.to_json() for f in findings],
            "suppressed": len(suppressed),
            "failing": len(failing),
        }
        print(json.dumps(doc, indent=2))
    elif fmt == "sarif":
        print(json.dumps(to_sarif(findings), indent=2))
    else:
        for f in findings:
            print(f.render())
        counts = {}
        for f in findings:
            counts[f.severity] = counts.get(f.severity, 0) + 1
        summary = ", ".join(
            f"{counts.get(s, 0)} {s}(s)" for s in (ERROR, WARNING, NOTE))
        tail = f" ({len(suppressed)} baselined)" if suppressed else ""
        print(f"repro_torch.analysis: {summary}{tail}")

    return 1 if failing else 0


if __name__ == "__main__":
    raise SystemExit(main())
