"""Per-layer estimator policy: ordered tag-glob rules + budget schedules.

The seed codebase applied one global ``WTACRSConfig`` to every linear in
the network.  This module replaces that single knob with a small policy
engine:

  * :class:`BudgetSchedule` — a (python-side) step -> budget curve,
    resolved against a concrete step; budgets fix the number of kept
    rows k of every sampled linear.
  * :class:`Rule` — one ``(tag glob, config / overrides, schedule)``
    entry.  Tags are the fully-prefixed linear tags the model emits
    (e.g. ``"b3/mlp_wi"``, ``"b0/attn_q"``); globs use fnmatch syntax.
  * :class:`PolicyRules` — an ordered rule list; the FIRST matching
    rule wins, unmatched tags fall back to ``default`` (or the caller's
    fallback config, normally ``Policy.wtacrs``).

Example — exact attention output + aggressively sampled MLPs with a
200-step exact warmup:

    rules = PolicyRules.of(
        ("*attn_o", EXACT_CONFIG),
        ("*mlp_*", WTACRSConfig(kind="wta_crs", budget=0.1),
         BudgetSchedule.warmup_exact(begin_step=200, end=0.1)),
    )
    policy = Policy(wtacrs=WTACRSConfig(budget=0.3), rules=rules)

Everything here is frozen/hashable, so a resolved policy is a value.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Tuple, Union

from repro_torch.core.config import EstimatorKind, WTACRSConfig


@dataclasses.dataclass(frozen=True)
class BudgetSchedule:
    """step -> budget in (0, 1].  Kinds:

      * ``constant``     — always ``end``.
      * ``linear``       — anneal ``start -> end`` over
        ``[begin_step, end_step]``, quantized to ``stages`` plateaus.
      * ``warmup_exact`` — budget 1.0 (== exact, the sampled path
        short-circuits) until ``begin_step``, then ``end``.

    ``budget_at`` is pure Python over a concrete int step: budgets feed
    ``WTACRSConfig.budget_rows`` which fixes static residual shapes.
    """

    kind: str = "constant"
    start: float = 1.0
    end: float = 0.3
    begin_step: int = 0
    end_step: int = 0
    stages: int = 4

    @classmethod
    def constant(cls, budget: float) -> "BudgetSchedule":
        return cls(kind="constant", end=budget)

    @classmethod
    def linear(cls, start: float, end: float, begin_step: int,
               end_step: int, stages: int = 4) -> "BudgetSchedule":
        if end_step <= begin_step:
            raise ValueError("linear schedule needs end_step > begin_step")
        return cls(kind="linear", start=start, end=end,
                   begin_step=begin_step, end_step=end_step, stages=stages)

    @classmethod
    def warmup_exact(cls, begin_step: int, end: float) -> "BudgetSchedule":
        return cls(kind="warmup_exact", start=1.0, end=end,
                   begin_step=begin_step)

    def budget_at(self, step: int) -> float:
        step = int(step)
        if self.kind == "constant":
            return self.end
        if self.kind == "warmup_exact":
            return self.start if step < self.begin_step else self.end
        if self.kind == "linear":
            if step <= self.begin_step:
                return self.start
            if step >= self.end_step:
                return self.end
            frac = (step - self.begin_step) / (self.end_step
                                               - self.begin_step)
            # quantize to `stages` plateaus
            frac = min(int(frac * self.stages) + 1, self.stages) \
                / self.stages
            # convex form: frac == 1.0 lands on `end` exactly, so the
            # plateau sequence meets the >= end_step branch monotonically
            return self.start * (1.0 - frac) + self.end * frac
        raise ValueError(f"unknown schedule kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class RankSchedule:
    """step -> integer rank >= 1, for low-rank optimizer-state layouts
    (``repro_torch.optim.LayoutRule``).  The rank fixes the projection and
    moment shapes the way a budget fixes plan shapes, so the same rules
    apply: a schedule resolves against a concrete step, and ``linear``
    quantizes to ``stages`` plateaus.  Kinds:

      * ``constant`` — always ``end``.
      * ``linear``   — anneal ``start -> end`` over
        ``[begin_step, end_step]`` in ``stages`` plateaus.
    """

    kind: str = "constant"
    start: int = 32
    end: int = 8
    begin_step: int = 0
    end_step: int = 0
    stages: int = 4

    @classmethod
    def constant(cls, rank: int) -> "RankSchedule":
        if rank < 1:
            raise ValueError("need rank >= 1")
        return cls(kind="constant", end=int(rank))

    @classmethod
    def linear(cls, start: int, end: int, begin_step: int,
               end_step: int, stages: int = 4) -> "RankSchedule":
        if end_step <= begin_step:
            raise ValueError("linear rank schedule needs "
                             "end_step > begin_step")
        if start < 1 or end < 1:
            raise ValueError("need start >= 1 and end >= 1")
        return cls(kind="linear", start=int(start), end=int(end),
                   begin_step=begin_step, end_step=end_step,
                   stages=stages)

    def rank_at(self, step: int) -> int:
        step = int(step)
        if self.kind == "constant":
            return max(int(self.end), 1)
        if self.kind == "linear":
            if step <= self.begin_step:
                return max(int(self.start), 1)
            if step >= self.end_step:
                return max(int(self.end), 1)
            frac = (step - self.begin_step) / (self.end_step
                                               - self.begin_step)
            # same plateau quantization as BudgetSchedule.budget_at
            frac = min(int(frac * self.stages) + 1, self.stages) \
                / self.stages
            return max(int(round(self.start * (1.0 - frac)
                                 + self.end * frac)), 1)
        raise ValueError(f"unknown rank schedule kind {self.kind!r}")


_OVERRIDE_FIELDS = {f.name for f in dataclasses.fields(WTACRSConfig)}


@dataclasses.dataclass(frozen=True)
class Rule:
    """One ordered policy entry.

    ``config``: full replacement config, or ``None`` to inherit the
    fallback.  ``overrides``: sorted tuple of (field, value) pairs
    applied on top (use :meth:`Rule.of` to pass a dict).  ``schedule``:
    optional BudgetSchedule replacing the config's static budget.
    ``controller``: optional adaptive budget controller
    (``repro_torch.core.controller.BudgetController``) replacing the
    budget with a statistics-driven one — mutually exclusive with
    ``schedule``.  A controller needs a loop that feeds it znorm
    statistics and pins the decided budget
    (``launch.train_steps.make_scheduled_train_step``); undriven, the
    rule resolves to the controller's initial budget.
    """

    pattern: str
    config: Optional[WTACRSConfig] = None
    overrides: Tuple[Tuple[str, object], ...] = ()
    schedule: Optional[BudgetSchedule] = None
    controller: Optional[object] = None    # BudgetController (duck-typed)

    def __post_init__(self):
        if self.schedule is not None and self.controller is not None:
            raise ValueError(
                f"rule {self.pattern!r}: schedule and controller are "
                f"mutually exclusive (a controller already owns the "
                f"budget trajectory; wrap the schedule in "
                f"controller.FixedSchedule to mix)")

    @classmethod
    def of(cls, pattern: str,
           config: Union[WTACRSConfig, dict, None] = None,
           schedule: Optional[BudgetSchedule] = None,
           controller: Optional[object] = None) -> "Rule":
        """``config`` may be a WTACRSConfig or an override dict; the
        third positional slot accepts either a BudgetSchedule or a
        BudgetController (they are distinguished by type)."""
        overrides: Tuple[Tuple[str, object], ...] = ()
        if isinstance(config, dict):
            bad = set(config) - _OVERRIDE_FIELDS
            if bad:
                raise ValueError(f"unknown WTACRSConfig fields {sorted(bad)}")
            overrides = tuple(sorted(config.items()))
            config = None
        if schedule is not None and not isinstance(schedule, BudgetSchedule):
            if controller is not None:
                raise ValueError("pass either a schedule or a controller")
            schedule, controller = None, schedule
        if controller is not None and not hasattr(controller, "propose"):
            raise TypeError(f"controller {controller!r} does not implement "
                            f"the BudgetController protocol")
        return cls(pattern=pattern, config=config, overrides=overrides,
                   schedule=schedule, controller=controller)

    def matches(self, tag: str) -> bool:
        return fnmatch.fnmatchcase(tag, self.pattern)

    def static_budget(self, fallback: WTACRSConfig) -> Optional[float]:
        """The rule's config budget before any schedule/controller."""
        cfg = self.config if self.config is not None else fallback
        if self.overrides:
            cfg = dataclasses.replace(cfg, **dict(self.overrides))
        return cfg.budget

    def resolve(self, fallback: WTACRSConfig, step: int,
                budget: Optional[float] = None) -> WTACRSConfig:
        """``budget``: caller-pinned value (from a controller decision)
        overriding both the static budget and any schedule."""
        cfg = self.config if self.config is not None else fallback
        if self.overrides:
            cfg = dataclasses.replace(cfg, **dict(self.overrides))
        if budget is not None:
            cfg = dataclasses.replace(cfg, budget=float(budget))
        elif self.schedule is not None:
            cfg = dataclasses.replace(
                cfg, budget=self.schedule.budget_at(step))
        elif self.controller is not None:
            cfg = dataclasses.replace(
                cfg, budget=self.controller.initial_budget(cfg.budget))
        return cfg


@dataclasses.dataclass(frozen=True)
class PolicyRules:
    """Ordered per-tag rules; first match wins, else ``default``/fallback."""

    rules: Tuple[Rule, ...] = ()
    default: Optional[WTACRSConfig] = None

    @classmethod
    def of(cls, *entries, default: Optional[WTACRSConfig] = None
           ) -> "PolicyRules":
        """Build from ``(pattern, config[, schedule])`` tuples or Rules."""
        built = []
        for e in entries:
            if isinstance(e, Rule):
                built.append(e)
            else:
                built.append(Rule.of(*e))
        return cls(rules=tuple(built), default=default)

    def resolve(self, tag: str, step: int = 0,
                fallback: Optional[WTACRSConfig] = None,
                rule_budgets: Optional[Tuple[Optional[float], ...]] = None
                ) -> WTACRSConfig:
        """``rule_budgets``: optional per-rule pinned budgets (aligned
        with ``self.rules``, ``None`` = not pinned), set by a training loop
        that resolves controllers against live statistics."""
        base = self.default if self.default is not None else fallback
        if base is None:
            base = WTACRSConfig(kind=EstimatorKind.EXACT)
        for i, rule in enumerate(self.rules):
            if rule.matches(tag):
                pinned = (rule_budgets[i] if rule_budgets is not None
                          else None)
                return rule.resolve(base, step, budget=pinned)
        return base

    def dynamic_rule_indices(self) -> Tuple[int, ...]:
        """Indices of rules whose budget can change over training."""
        return tuple(i for i, r in enumerate(self.rules)
                     if r.schedule is not None or r.controller is not None)

    def controller_rule_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, r in enumerate(self.rules)
                     if r.controller is not None)

    def schedule_signature(self, step: int,
                           rule_budgets: Optional[Tuple] = None,
                           fallback: Optional[WTACRSConfig] = None
                           ) -> Tuple[float, ...]:
        """Resolved budget per schedule- or controller-carrying rule —
        the key of a step-scheduled trainer's plateau (changes exactly
        when a budget changes; empty when every rule is static)."""
        base = self.default if self.default is not None else fallback
        if base is None:
            base = WTACRSConfig(kind=EstimatorKind.EXACT)
        sig = []
        for i in self.dynamic_rule_indices():
            r = self.rules[i]
            if rule_budgets is not None and rule_budgets[i] is not None:
                sig.append(float(rule_budgets[i]))
            elif r.schedule is not None:
                sig.append(r.schedule.budget_at(step))
            else:
                sig.append(r.controller.initial_budget(
                    r.static_budget(base)))
        return tuple(sig)
