"""repro_torch.analysis — static analysis of the port's own code.

The JAX package's ``repro.analysis`` frame (findings, the justified
suppression baseline, SARIF, the CLI) with its policy/tag cross-checker
(PT001–PT004, PT008), pure ``ast`` over source text.  Only the
cross-checker's universes import the analyzed package: the tags each
registry architecture's linears emit and the parameter paths its
optimizer layouts match, both traced on the ``meta`` device.

Run with ``python -m repro_torch.analysis [paths...]``; see ``--help``.
"""
from repro_torch.analysis.cli import analyze_paths, changed_files, main
from repro_torch.analysis.findings import (ERROR, NOTE, RULES, WARNING,
                                           Baseline, Finding,
                                           sort_findings, to_sarif)

__all__ = [
    "analyze_paths", "changed_files", "main", "Finding", "Baseline",
    "sort_findings", "to_sarif", "RULES", "ERROR", "WARNING", "NOTE",
]
