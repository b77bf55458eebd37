"""Policy / tag cross-checker (rule family PT).

Tag-glob rules (``repro_torch.core.policy``) silently decay: a registry
rename turns ``"*mlp_*"`` into a rule that matches nothing, and the run
trains at the fallback config without a word.  This checker evaluates
every *literal* policy-rule pattern found in the analyzed files against
the tags each ``models/registry.py`` architecture actually emits (the
meta-device trace of linear calls the znorm cache is keyed by,
``train/znorm.py::trace_linears`` — no storage, no FLOPs, seconds for
all architectures).

The same decay mode applies to the optimizer-state layout rules
(``repro_torch.optim.OptimSpec``): their patterns match *parameter
paths* — the JAX package's stacked paths (``unit/<i>/...``) that
``optim/layouts.py`` keys its state by — instead of linear tags, so
every literal ``OptimSpec.of`` / ``LayoutRule`` pattern is additionally
evaluated against the param-path universe of each architecture.

  PT001  dead rule: pattern matches no tag of any architecture
         (policy rules), or no parameter path (optimizer layout rules)
  PT002  uncovered sampled-dense tags: a rules-carrying policy leaves
         token-dim tags to the fallback (note; warning when the policy
         declares ``default=`` and thereby claims coverage)
  PT003  CACHED_GRAD rule matching a rows-dim tag (MoE-router class,
         and the experts' ``<prefix>moe_expert`` plans over capacity
         slots): the cache is keyed per dataset sample, a rows-dim tag
         has no cache column to read — the rule can never be honored
  PT004  shadowed rule: every tag (or param path) it matches is
         claimed by an earlier rule (first-match-wins makes it
         unreachable)
  PT008  schedule-termination proof: a ``BudgetSchedule`` /
         budget-controller literal whose trajectory — abstractly
         interpreted with the exact plateau-quantization arithmetic of
         ``BudgetSchedule.budget_at`` — provably never reaches its
         configured end budget within the module's declared step
         horizon (``RunSpec(steps=N)`` or a ``STEPS``-style constant):
         a linear anneal whose ``end_step`` overshoots the horizon, a
         ``warmup_exact`` that never leaves warmup, a degenerate
         ``end_step <= begin_step``, a ``FixedSchedule`` whose clamp
         band excludes the schedule's end, or a grid controller whose
         far plateau is unreachable in ``warmup + levels - 1`` moves

Only string-literal patterns are checked; dynamically built patterns
are skipped.  The universes can be injected (tests) or built live from
``repro_torch.configs`` (default; torch is imported only then).  PT008
is pure AST arithmetic and needs neither universe nor an import of the
analyzed code.  Rules, messages and fingerprints are the JAX package's
(``repro.analysis.policy_check``).
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import (ERROR, NOTE, WARNING,
                                           Finding, register_rule)

PT001 = register_rule("PT001", ERROR, "dead tag-glob rule")
PT002 = register_rule("PT002", NOTE, "uncovered sampled-dense tags")
PT003 = register_rule("PT003", ERROR, "CACHED_GRAD rule on rows-dim tag")
PT004 = register_rule("PT004", WARNING, "rule shadowed by earlier rules")
PT008 = register_rule("PT008", ERROR,
                      "schedule never reaches end budget in horizon")

# {arch name: {tag: "token" | "rows"}}
TagUniverse = Dict[str, Dict[str, str]]
# {arch name: [param path]} — the universe OptimSpec patterns match
ParamUniverse = Dict[str, List[str]]

# per process, keyed by ``reduced``
_universe_cache: Dict[bool, TagUniverse] = {}
_param_universe_cache: Dict[bool, ParamUniverse] = {}


def tag_universe(reduced: bool = True) -> TagUniverse:
    """Tags each registry architecture emits, with sampled dims.

    Imports torch lazily; traces every config once on the ``meta``
    device with the tag recorder (``znorm.trace_linears``).  The MoE
    experts' plans (``.expert_calls``: ``<prefix>moe_expert``, resolved
    through the policy but not a ``Ctx.linear`` tag) join as rows-dim
    tags: they run over capacity slots, so the per-sample cache has no
    column for them.  Cached per process and per ``reduced``.
    """
    if reduced not in _universe_cache:
        from repro_torch import configs
        from repro_torch.models import common as cm
        from repro_torch.train import znorm

        universe: TagUniverse = {}
        for name in configs.ARCH_NAMES:
            rec = znorm.trace_linears(
                configs.get_config(name, reduced=reduced))
            tags = dict(rec.dims)
            tags.update((tag, cm.SAMPLED_DIM_ROWS)
                        for tag, _ in rec.expert_calls)
            universe[name] = tags
        _universe_cache[reduced] = universe
    return _universe_cache[reduced]


def param_path_universe(reduced: bool = True) -> ParamUniverse:
    """Parameter paths each registry architecture emits, as
    ``repro_torch.optim`` keys them: the JAX package's stacked paths
    (``layouts.reference_path`` of every ``named_leaves`` path of the
    parameters, built on ``meta`` without storage), distinct and sorted.
    Cached per process and per ``reduced``."""
    if reduced not in _param_universe_cache:
        from repro_torch import configs
        from repro_torch.models import registry
        from repro_torch.optim import layouts
        from repro_torch.train import optim

        universe: ParamUniverse = {}
        for name in configs.ARCH_NAMES:
            params = registry.init_params(
                configs.get_config(name, reduced=reduced), 0,
                device="meta")
            n_pattern = layouts.pattern_len(params)
            universe[name] = sorted({
                layouts.reference_path(path, n_pattern)
                for path, _ in optim.named_leaves(params)})
        _param_universe_cache[reduced] = universe
    return _param_universe_cache[reduced]


# ---------------------------------------------------------------------------
# literal extraction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RuleLit:
    pattern: str
    line: int
    col: int
    cached_grad: bool
    exact: bool


@dataclasses.dataclass
class PolicyLit:
    mod: astutil.Module
    node: ast.Call
    rules: List[RuleLit]
    has_default: bool

    @property
    def symbol(self) -> str:
        return self.mod.symbol_for(self.node)


def _resolve_name(mod: astutil.Module, node: ast.expr,
                  scope: Optional[ast.AST]) -> ast.expr:
    """Follow one level of Name -> assignment (module or function)."""
    if not isinstance(node, ast.Name):
        return node
    if scope is not None:
        local = astutil.assignments(scope).get(node.id)
        if local is not None:
            return local
    top = astutil.assignments(mod.tree).get(node.id)
    return top if top is not None else node


def _cfg_flags(mod: astutil.Module, node: Optional[ast.expr],
               scope: Optional[ast.AST]) -> Tuple[bool, bool]:
    """(cached_grad, exact) mentioned anywhere in a config expression:
    as the enum member (``NormSource.CACHED_GRAD``) or as the string the
    config dataclasses coerce (``norm_source="cached_grad"``, the port's
    own spelling, which the JAX package's checker does not read)."""
    if node is None:
        return False, False
    node = _resolve_name(mod, node, scope)
    cached = exact = False
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant):
            name = (sub.value.upper()
                    if sub.value in ("cached_grad", "exact") else None)
        else:
            name = astutil.dotted(sub)
        if name is None:
            continue
        if name.endswith("CACHED_GRAD"):
            cached = True
        if name.endswith("EXACT"):
            exact = True
    return cached, exact


def _rule_from_args(mod: astutil.Module, args: Sequence[ast.expr],
                    keywords: Sequence[ast.keyword],
                    scope: Optional[ast.AST],
                    node: ast.AST) -> Optional[RuleLit]:
    pattern: Optional[ast.expr] = args[0] if args else None
    cfg: Optional[ast.expr] = args[1] if len(args) > 1 else None
    for kw in keywords:
        if kw.arg == "pattern":
            pattern = kw.value
        elif kw.arg == "config":
            cfg = kw.value
    if not (isinstance(pattern, ast.Constant)
            and isinstance(pattern.value, str)):
        return None
    cached, exact = _cfg_flags(mod, cfg, scope)
    # overrides dict may carry norm_source directly as a keyword too
    for kw in keywords:
        if kw.arg == "norm_source":
            c2, _ = _cfg_flags(mod, kw.value, scope)
            cached = cached or c2
    return RuleLit(pattern=pattern.value, line=node.lineno,
                   col=node.col_offset + 1, cached_grad=cached,
                   exact=exact)


def extract_policies(mod: astutil.Module) -> List[PolicyLit]:
    out: List[PolicyLit] = []
    claimed: set = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_name(node) or ""
        if not name.endswith("PolicyRules.of"):
            continue
        scope = None
        cur = mod.parent(node)
        while cur is not None:
            if isinstance(cur, ast.FunctionDef):
                scope = cur
                break
            cur = mod.parent(cur)
        rules: List[RuleLit] = []
        for entry in node.args:
            if isinstance(entry, ast.Starred):
                continue
            if isinstance(entry, ast.Tuple) and entry.elts:
                r = _rule_from_args(mod, entry.elts, [], scope, entry)
            elif isinstance(entry, ast.Call):
                claimed.add(id(entry))
                r = _rule_from_args(mod, entry.args, entry.keywords,
                                    scope, entry)
            else:
                r = None
            if r is not None:
                rules.append(r)
        default = astutil.keyword_arg(node, "default")
        has_default = default is not None and not (
            isinstance(default, ast.Constant) and default.value is None)
        if rules:
            out.append(PolicyLit(mod=mod, node=node, rules=rules,
                                 has_default=has_default))
    # standalone Rule.of / Rule calls outside any PolicyRules.of literal
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or id(node) in claimed:
            continue
        name = astutil.call_name(node) or ""
        if name.endswith("Rule.of") or name.endswith(".Rule") \
                or name == "Rule":
            scope = None
            cur = mod.parent(node)
            while cur is not None:
                if isinstance(cur, ast.FunctionDef):
                    scope = cur
                    break
                cur = mod.parent(cur)
            inside = any(id(node) != id(p.node)
                         and any(id(node) == id(s)
                                 for s in ast.walk(p.node))
                         for p in out)
            if inside:
                continue
            r = _rule_from_args(mod, node.args, node.keywords, scope,
                                node)
            if r is not None:
                out.append(PolicyLit(mod=mod, node=node, rules=[r],
                                     has_default=False))
    return out


# ---------------------------------------------------------------------------
# optimizer layout-rule extraction (repro_torch.optim.OptimSpec literals)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OptimRuleLit:
    pattern: str
    line: int
    col: int


@dataclasses.dataclass
class OptimSpecLit:
    mod: astutil.Module
    node: ast.Call
    rules: List[OptimRuleLit]

    @property
    def symbol(self) -> str:
        return self.mod.symbol_for(self.node)


def _optim_rule_pattern(entry: ast.expr) -> Optional[ast.expr]:
    """The pattern expression of one OptimSpec.of entry: a LayoutRule
    call, a dict(pattern=...) call, a {"pattern": ...} literal, or a
    positional tuple."""
    if isinstance(entry, ast.Call):
        name = astutil.call_name(entry) or ""
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "dict" or "LayoutRule" in name:
            for kw in entry.keywords:
                if kw.arg == "pattern":
                    return kw.value
            if "LayoutRule" in name and entry.args:
                return entry.args[0]
        return None
    if isinstance(entry, ast.Dict):
        for k, v in zip(entry.keys, entry.values):
            if isinstance(k, ast.Constant) and k.value == "pattern":
                return v
        return None
    if isinstance(entry, ast.Tuple) and entry.elts:
        return entry.elts[0]
    return None


def extract_optim_specs(mod: astutil.Module) -> List[OptimSpecLit]:
    out: List[OptimSpecLit] = []
    claimed: set = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_name(node) or ""
        if not name.endswith("OptimSpec.of"):
            continue
        rules: List[OptimRuleLit] = []
        for entry in node.args:
            if isinstance(entry, ast.Starred):
                continue
            claimed.add(id(entry))
            pat = _optim_rule_pattern(entry)
            if isinstance(pat, ast.Constant) and isinstance(
                    pat.value, str):
                rules.append(OptimRuleLit(pattern=pat.value,
                                          line=entry.lineno,
                                          col=entry.col_offset + 1))
        if rules:
            out.append(OptimSpecLit(mod=mod, node=node, rules=rules))
    # standalone LayoutRule.of / LayoutRule calls outside OptimSpec.of
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or id(node) in claimed:
            continue
        name = astutil.call_name(node) or ""
        if not (name.endswith("LayoutRule.of")
                or name.endswith(".LayoutRule")
                or name == "LayoutRule"):
            continue
        pat = _optim_rule_pattern(node)
        if isinstance(pat, ast.Constant) and isinstance(pat.value, str):
            out.append(OptimSpecLit(
                mod=mod, node=node,
                rules=[OptimRuleLit(pattern=pat.value, line=node.lineno,
                                    col=node.col_offset + 1)]))
    return out


def check_optim_rules(specs: Iterable[OptimSpecLit],
                      universe: ParamUniverse) -> List[Finding]:
    """PT001/PT004 over optimizer layout rules vs the param-path
    universe (first-match-wins precedence, same as policy rules)."""
    all_paths: set = set()
    for paths in universe.values():
        all_paths.update(paths)
    out: List[Finding] = []
    for spec in specs:
        mod = spec.mod
        matched_before: set = set()
        for rule in spec.rules:
            matched = {p for p in all_paths
                       if _matches(rule.pattern, p)}
            if not matched:
                out.append(Finding(
                    rule="PT001", path=mod.path, line=rule.line,
                    col=rule.col, symbol=spec.symbol,
                    message=f"optimizer layout rule pattern "
                            f"{rule.pattern!r} matches no parameter "
                            f"path emitted by any registry architecture "
                            f"(checked {len(universe)} configs, "
                            f"{len(all_paths)} distinct paths): the "
                            f"rule is dead and those leaves silently "
                            f"stay dense-AdamW"))
            elif matched <= matched_before:
                out.append(Finding(
                    rule="PT004", path=mod.path, line=rule.line,
                    col=rule.col, symbol=spec.symbol,
                    message=f"optimizer layout rule {rule.pattern!r} "
                            f"is unreachable: every parameter path it "
                            f"matches is claimed by an earlier rule "
                            f"(first match wins)"))
            matched_before |= matched
    return out


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _matches(pattern: str, tag: str) -> bool:
    return fnmatch.fnmatchcase(tag, pattern)


def check_policies(policies: Iterable[PolicyLit],
                   universe: TagUniverse) -> List[Finding]:
    all_tags: Dict[str, str] = {}
    for tags in universe.values():
        all_tags.update(tags)

    out: List[Finding] = []
    for pol in policies:
        mod = pol.mod
        matched_before: set = set()
        for i, rule in enumerate(pol.rules):
            matched = {t for t in all_tags if _matches(rule.pattern, t)}
            if not matched:
                out.append(Finding(
                    rule="PT001", path=mod.path, line=rule.line,
                    col=rule.col, symbol=pol.symbol,
                    message=f"rule pattern {rule.pattern!r} matches no "
                            f"tag emitted by any registry architecture "
                            f"(checked {len(universe)} configs, "
                            f"{len(all_tags)} distinct tags): the rule "
                            f"is dead and the fallback config applies "
                            f"silently"))
            else:
                # First match wins: a tag claimed by an earlier rule
                # never reaches this one, so judge only the remainder.
                effective = matched - matched_before
                rows_hit = sorted(t for t in effective
                                  if all_tags[t] == "rows")
                if rule.cached_grad and rows_hit:
                    out.append(Finding(
                        rule="PT003", path=mod.path, line=rule.line,
                        col=rule.col, symbol=pol.symbol,
                        message=f"rule {rule.pattern!r} resolves "
                                f"norm_source=CACHED_GRAD for rows-dim "
                                f"tag(s) {', '.join(rows_hit[:4])}: "
                                f"the per-sample gradient-norm cache "
                                f"has no column for a flattened-rows "
                                f"plan, so the rule can never be "
                                f"honored (it degrades to activation "
                                f"norms mid-run)"))
                if matched and matched <= matched_before:
                    out.append(Finding(
                        rule="PT004", path=mod.path, line=rule.line,
                        col=rule.col, symbol=pol.symbol,
                        message=f"rule {rule.pattern!r} is unreachable: "
                                f"every tag it matches is claimed by an "
                                f"earlier rule (first match wins)"))
                matched_before |= matched
        if len(pol.rules) > 1 or pol.has_default:
            uncovered = {}
            for arch, tags in universe.items():
                miss = sorted(
                    t for t, dim in tags.items()
                    if dim == "token"
                    and not any(_matches(r.pattern, t)
                                for r in pol.rules))
                if miss:
                    uncovered[arch] = miss
            if uncovered:
                n_archs = len(uncovered)
                example_arch = sorted(uncovered)[0]
                ex = ", ".join(uncovered[example_arch][:4])
                sev_rule = "PT002"
                out.append(Finding(
                    rule=sev_rule, path=mod.path, line=pol.node.lineno,
                    col=pol.node.col_offset + 1, symbol=pol.symbol,
                    severity=WARNING if pol.has_default else NOTE,
                    message=f"policy rules leave sampled-dense "
                            f"(token-dim) tags to the fallback in "
                            f"{n_archs}/{len(universe)} architectures "
                            f"(e.g. {example_arch}: {ex}); add a rule "
                            f"or confirm the fallback is intended"))
    return out


# ---------------------------------------------------------------------------
# PT008 — schedule-termination proofs (pure AST abstract interpretation)
# ---------------------------------------------------------------------------

# BudgetSchedule dataclass defaults (mirrored from
# repro_torch.core.policy; the analyzer never imports the analyzed code).
_SCHED_DEFAULTS = {"start": 1.0, "end": 0.3, "begin_step": 0.0,
                   "end_step": 0.0, "stages": 4.0}
_SCHED_POS = {
    "linear": ("start", "end", "begin_step", "end_step", "stages"),
    "warmup_exact": ("begin_step", "end"),
    "constant": ("end",),
}
# _GridController defaults (repro_torch.core.controller); FixedSchedule
# widens b_min to 0.01.
_CTRL_LEAVES = ("ESSProportional", "ConditionRate")
_CTRL_DEFAULTS = {"levels": 7.0, "warmup": 3.0}
_FIXED_DEFAULTS = {"b_min": 0.01, "b_max": 1.0}
# RankSchedule / RankController defaults (repro_torch.core.policy /
# repro_torch.core.controller): ranks behave exactly like budgets for
# PT008 — plateau-quantized trajectories and hysteresis grids.
_RANK_SCHED_DEFAULTS = {"start": 32.0, "end": 8.0, "begin_step": 0.0,
                        "end_step": 0.0, "stages": 4.0}
_RANK_SCHED_POS = {
    "linear": ("start", "end", "begin_step", "end_step", "stages"),
    "constant": ("end",),
}
_RANK_CTRL_DEFAULTS = {"levels": 4.0, "warmup": 3.0}
_HORIZON_NAMES = ("steps", "num_steps", "total_steps", "train_steps",
                  "horizon", "max_steps")
_EPS = 1e-9


def _enclosing_fn(mod: astutil.Module,
                  node: ast.AST) -> Optional[ast.FunctionDef]:
    cur = mod.parent(node)
    while cur is not None:
        if isinstance(cur, ast.FunctionDef):
            return cur
        cur = mod.parent(cur)
    return None


def _const_num(mod: astutil.Module, node: ast.expr,
               scope: Optional[ast.AST]) -> Optional[float]:
    node = _resolve_name(mod, node, scope)
    if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float)) and not isinstance(
            node.value, bool):
        return float(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_num(mod, node.operand, scope)
        return None if v is None else -v
    return None


def _call_fields(mod: astutil.Module, call: ast.Call,
                 scope: Optional[ast.AST], posnames: Sequence[str],
                 defaults: Dict[str, float]
                 ) -> Optional[Dict[str, float]]:
    """Numeric fields of a constructor-style call; None when any
    supplied argument is not a resolvable literal (dynamic — skip)."""
    fields = dict(defaults)
    for i, arg in enumerate(call.args):
        if i >= len(posnames):
            return None
        v = _const_num(mod, arg, scope)
        if v is None:
            return None
        fields[posnames[i]] = v
    for kw in call.keywords:
        if kw.arg is None:
            return None          # **kwargs: opaque
        if kw.arg not in defaults:
            continue
        v = _const_num(mod, kw.value, scope)
        if v is None:
            return None
        fields[kw.arg] = v
    return fields


def _schedule_fields(mod: astutil.Module, call: ast.Call,
                     scope: Optional[ast.AST]
                     ) -> Optional[Dict[str, float]]:
    """Resolved (kind, start, end, begin_step, end_step, stages) for a
    ``BudgetSchedule`` literal — classmethod or raw constructor."""
    name = astutil.call_name(call) or ""
    parts = name.rsplit(".", 2)
    leaf = parts[-1]
    if leaf in _SCHED_POS and len(parts) > 1 \
            and parts[-2] == "BudgetSchedule":
        fields = _call_fields(mod, call, scope, _SCHED_POS[leaf],
                              _SCHED_DEFAULTS)
        if fields is None:
            return None
        if leaf == "warmup_exact":
            fields["start"] = 1.0
        fields["kind"] = leaf          # type: ignore[assignment]
        return fields
    if leaf == "BudgetSchedule":
        kind = "constant"
        kind_expr: Optional[ast.expr] = (
            call.args[0] if call.args else astutil.keyword_arg(
                call, "kind"))
        if kind_expr is not None:
            kind_expr = _resolve_name(mod, kind_expr, scope)
            if not (isinstance(kind_expr, ast.Constant)
                    and isinstance(kind_expr.value, str)):
                return None
            kind = kind_expr.value
        fields = _call_fields(
            mod, ast.Call(func=call.func, args=call.args[1:],
                          keywords=call.keywords),
            scope, ("start", "end", "begin_step", "end_step", "stages"),
            _SCHED_DEFAULTS)
        if fields is None:
            return None
        fields["kind"] = kind          # type: ignore[assignment]
        return fields
    return None


def _budget_at(f: Dict[str, float], step: int) -> Optional[float]:
    """Mirror of ``BudgetSchedule.budget_at`` over resolved fields."""
    kind = f["kind"]
    if kind == "constant":
        return f["end"]
    if kind == "warmup_exact":
        return f["start"] if step < f["begin_step"] else f["end"]
    if kind == "linear":
        if step <= f["begin_step"]:
            return f["start"]
        if step >= f["end_step"]:
            return f["end"]
        frac = (step - f["begin_step"]) / (f["end_step"]
                                           - f["begin_step"])
        stages = max(int(f["stages"]), 1)
        frac = min(int(frac * stages) + 1, stages) / stages
        return f["start"] * (1.0 - frac) + f["end"] * frac
    return None                        # unknown kind string: skip


def _rank_schedule_fields(mod: astutil.Module, call: ast.Call,
                          scope: Optional[ast.AST]
                          ) -> Optional[Dict[str, float]]:
    """Resolved fields of a ``RankSchedule`` literal — classmethod or
    raw constructor; None when any argument is dynamic."""
    name = astutil.call_name(call) or ""
    parts = name.rsplit(".", 2)
    leaf = parts[-1]
    if leaf in _RANK_SCHED_POS and len(parts) > 1 \
            and parts[-2] == "RankSchedule":
        fields = _call_fields(mod, call, scope, _RANK_SCHED_POS[leaf],
                              _RANK_SCHED_DEFAULTS)
        if fields is None:
            return None
        fields["kind"] = leaf          # type: ignore[assignment]
        return fields
    if leaf == "RankSchedule":
        kind = "constant"
        kind_expr: Optional[ast.expr] = (
            call.args[0] if call.args else astutil.keyword_arg(
                call, "kind"))
        if kind_expr is not None:
            kind_expr = _resolve_name(mod, kind_expr, scope)
            if not (isinstance(kind_expr, ast.Constant)
                    and isinstance(kind_expr.value, str)):
                return None
            kind = kind_expr.value
        fields = _call_fields(
            mod, ast.Call(func=call.func, args=call.args[1:],
                          keywords=call.keywords),
            scope, ("start", "end", "begin_step", "end_step", "stages"),
            _RANK_SCHED_DEFAULTS)
        if fields is None:
            return None
        fields["kind"] = kind          # type: ignore[assignment]
        return fields
    return None


def _rank_at(f: Dict[str, float], step: int) -> Optional[int]:
    """Mirror of ``RankSchedule.rank_at`` over resolved fields."""
    kind = f["kind"]
    if kind == "constant":
        return max(int(f["end"]), 1)
    if kind == "linear":
        if step <= f["begin_step"]:
            return max(int(f["start"]), 1)
        if step >= f["end_step"]:
            return max(int(f["end"]), 1)
        frac = (step - f["begin_step"]) / (f["end_step"]
                                           - f["begin_step"])
        stages = max(int(f["stages"]), 1)
        frac = min(int(frac * stages) + 1, stages) / stages
        return max(int(round(f["start"] * (1.0 - frac)
                             + f["end"] * frac)), 1)
    return None                        # unknown kind string: skip


def _module_horizon(mod: astutil.Module) -> Optional[int]:
    """Declared step horizon: the max of int-literal ``steps=`` call
    keywords (``RunSpec(steps=200)``, ``run.fit(steps=50)``) and
    module-level ``STEPS = N``-style constants.  None when the module
    declares no literal horizon (horizon checks are then skipped —
    the proof obligation belongs to whoever supplies the steps)."""
    best: Optional[int] = None
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            kw = astutil.keyword_arg(node, "steps")
            if isinstance(kw, ast.Constant) and isinstance(
                    kw.value, int) and not isinstance(kw.value, bool):
                best = max(best or 0, kw.value)
    for stmt in mod.tree.body:
        tgt: Optional[ast.expr] = None
        val: Optional[ast.expr] = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt, val = stmt.targets[0], stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            tgt, val = stmt.target, stmt.value
        if (isinstance(tgt, ast.Name)
                and tgt.id.lower() in _HORIZON_NAMES
                and isinstance(val, ast.Constant)
                and isinstance(val.value, int)
                and not isinstance(val.value, bool)):
            best = max(best or 0, val.value)
    return best


def _pt008(mod: astutil.Module, node: ast.Call,
           message: str) -> Finding:
    return Finding(rule="PT008", path=mod.path, line=node.lineno,
                   col=node.col_offset + 1,
                   symbol=mod.symbol_for(node), message=message)


def _check_schedule_literal(mod: astutil.Module, node: ast.Call,
                            f: Dict[str, float],
                            horizon: Optional[int]) -> List[Finding]:
    out: List[Finding] = []
    kind = f["kind"]
    if kind == "linear" and f["end_step"] <= f["begin_step"]:
        out.append(_pt008(
            mod, node,
            f"linear schedule with end_step={int(f['end_step'])} <= "
            f"begin_step={int(f['begin_step'])} never anneals: the "
            f"constructor raises (or the raw dataclass divides by "
            f"zero at the first post-warmup step)"))
        return out
    if horizon is None or kind == "constant":
        return out
    final = _budget_at(f, horizon)
    if final is None or abs(final - f["end"]) <= _EPS:
        return out
    if kind == "warmup_exact":
        detail = (f"warmup_exact(begin_step={int(f['begin_step'])}) "
                  f"never leaves the exact-path warmup within the "
                  f"declared horizon of {horizon} steps")
    else:
        detail = (f"linear anneal to end_step={int(f['end_step'])} "
                  f"plateaus at budget {final:g} by the declared "
                  f"horizon of {horizon} steps")
    out.append(_pt008(
        mod, node,
        f"{detail} — the run finishes at budget {final:g}, short of "
        f"the configured end budget {f['end']:g}; the memory budget "
        f"the policy promises is never realized (shrink end_step / "
        f"begin_step or raise the horizon)"))
    return out


def _check_fixed_schedule(mod: astutil.Module, node: ast.Call,
                          scope: Optional[ast.AST]) -> List[Finding]:
    sched_expr = astutil.keyword_arg(node, "schedule")
    if sched_expr is None:
        return []
    sched_expr = _resolve_name(mod, sched_expr, scope)
    if not isinstance(sched_expr, ast.Call):
        return []
    f = _schedule_fields(mod, sched_expr, scope)
    if f is None:
        return []
    bounds = _call_fields(mod, node, scope, (), _FIXED_DEFAULTS)
    if bounds is None:
        return []
    end = f["end"]
    if bounds["b_min"] - _EPS <= end <= bounds["b_max"] + _EPS:
        return []
    return [_pt008(
        mod, node,
        f"FixedSchedule clamp band [{bounds['b_min']:g}, "
        f"{bounds['b_max']:g}] excludes the wrapped schedule's end "
        f"budget {end:g}: the controller clamps every proposal, so "
        f"the schedule terminates at the band edge, never at its "
        f"configured end")]


def _check_rank_schedule_literal(mod: astutil.Module, node: ast.Call,
                                 f: Dict[str, float],
                                 horizon: Optional[int]
                                 ) -> List[Finding]:
    out: List[Finding] = []
    if f["kind"] == "linear" and f["end_step"] <= f["begin_step"]:
        out.append(_pt008(
            mod, node,
            f"linear rank schedule with end_step="
            f"{int(f['end_step'])} <= begin_step="
            f"{int(f['begin_step'])} never anneals: the constructor "
            f"raises (or the raw dataclass divides by zero at the "
            f"first post-begin step)"))
        return out
    if horizon is None or f["kind"] == "constant":
        return out
    final = _rank_at(f, horizon)
    end = max(int(f["end"]), 1)
    if final is None or final == end:
        return out
    out.append(_pt008(
        mod, node,
        f"rank anneal to end_step={int(f['end_step'])} plateaus at "
        f"rank {final} by the declared horizon of {horizon} steps — "
        f"the run finishes short of the configured end rank {end}; "
        f"the optimizer-state memory the layout promises is never "
        f"realized (shrink end_step / begin_step or raise the "
        f"horizon)"))
    return out


def _check_grid_controller(mod: astutil.Module, node: ast.Call,
                           scope: Optional[ast.AST],
                           horizon: Optional[int],
                           defaults: Optional[Dict[str, float]] = None
                           ) -> List[Finding]:
    if horizon is None:
        return []
    fields = _call_fields(mod, node, scope, (),
                          defaults or _CTRL_DEFAULTS)
    if fields is None:
        return []
    levels = max(int(fields["levels"]), 2)
    warmup = max(int(fields["warmup"]), 0)
    needed = warmup + levels - 1
    if horizon >= needed:
        return []
    leaf = (astutil.call_name(node) or "").rsplit(".", 1)[-1]
    return [_pt008(
        mod, node,
        f"{leaf} grid has {levels} levels behind a {warmup}-step "
        f"warmup: reaching the far plateau takes at least {needed} "
        f"steps (one level per step) but the declared horizon is "
        f"{horizon} — the configured b_min/b_max extreme is "
        f"unreachable within the run")]


def check_schedules(modules: Iterable[astutil.Module]) -> List[Finding]:
    """PT008 over every resolvable schedule/controller literal."""
    out: List[Finding] = []
    for mod in modules:
        horizon = _module_horizon(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            scope = _enclosing_fn(mod, node)
            leaf = (astutil.call_name(node) or "").rsplit(".", 1)[-1]
            if leaf == "FixedSchedule":
                out.extend(_check_fixed_schedule(mod, node, scope))
                continue
            if leaf in _CTRL_LEAVES:
                out.extend(_check_grid_controller(mod, node, scope,
                                                  horizon))
                continue
            if leaf == "RankController":
                out.extend(_check_grid_controller(
                    mod, node, scope, horizon,
                    defaults=_RANK_CTRL_DEFAULTS))
                continue
            rf = _rank_schedule_fields(mod, node, scope)
            if rf is not None:
                out.extend(_check_rank_schedule_literal(mod, node, rf,
                                                        horizon))
                continue
            f = _schedule_fields(mod, node, scope)
            if f is not None:
                out.extend(_check_schedule_literal(mod, node, f,
                                                   horizon))
    return out


def check(modules: Iterable[astutil.Module],
          universe: Optional[TagUniverse] = None,
          param_universe: Optional[ParamUniverse] = None
          ) -> List[Finding]:
    mods = list(modules)
    out = check_schedules(mods)
    policies: List[PolicyLit] = []
    optim_specs: List[OptimSpecLit] = []
    for mod in mods:
        policies.extend(extract_policies(mod))
        optim_specs.extend(extract_optim_specs(mod))
    if policies:
        if universe is None:
            universe = tag_universe()
        out.extend(check_policies(policies, universe))
    if optim_specs:
        if param_universe is None:
            param_universe = param_path_universe()
        out.extend(check_optim_rules(optim_specs, param_universe))
    return out
