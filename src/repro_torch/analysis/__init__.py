"""repro_torch.analysis — static analysis of the port's own code.

The JAX package's ``repro.analysis`` with every family it runs, re-read
for eager torch and CUDA C++.  Pure ``ast`` over the Python and a small
token-level model over the ``.cu`` / ``.cuh`` sources; the analyzed code
is never imported or compiled, except by the policy/tag cross-checker,
whose universes trace each registry architecture on the ``meta`` device:

  * ``torch_lints`` (JL*): host syncs and branches on device tensors in
    step scopes, implicit transfers in a scheduler's tick path, mutable
    captures in recompute scopes (``autograd.Function`` forward /
    backward, ``torch.utils.checkpoint``), seed reuse, ``hash()``-derived
    seeds, device tensors with their history kept in host state.
  * ``kernel_contracts`` (PK*): ``extern "C"`` entry points against
    their ctypes signatures, launch bounds, divisibility and tail
    guards of grids, shared memory against the budget, f32
    accumulation, paired async copies and wgmma commits.
  * ``policy_check`` (PT*): tag-glob policy rules cross-checked against
    the tags each registry architecture emits, plus pure-AST
    schedule-termination proofs (PT008).

The Python families share one ``dataflow.Program`` — per-module def-use
chains and a call/closure graph that propagate step-scope membership and
device-tensor taint; the kernel family reads one ``csrc.Program``.

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
