"""Declarative optimizer-state specification: per-leaf layouts by rule.

The monolithic ``train.optim.AdamWConfig`` keeps two full fp32 moments
per parameter — 2x the model in optimizer state.  :class:`OptimSpec`
replaces that single knob with the same ordered glob-rule mechanism the
estimator policy uses for budgets (``repro_torch.core.policy.PolicyRules``):
each parameter leaf (addressed by its checkpoint path, e.g.
``"unit/0/mlp/wi"``) resolves — first match wins — to a
:class:`LayoutRule` choosing its state layout:

  * ``dense``    — plain AdamW (m, v), bit-identical to
    ``train.optim.adamw_update``.  The default for unmatched leaves.
  * ``factored`` — row/col-factored second moments à la
    Adafactor/SM3, with CAME's confidence-guided update clipping when
    ``momentum=True``: O(n + m) second-moment state per (n, m) matrix
    instead of O(n * m).
  * ``lowrank``  — first/second moments kept in a rank-``r`` column
    subspace (GaLore / AdaRankGrad): a projection ``P`` refreshed every
    ``refresh_every`` steps from the gradient's top-``r`` left singular
    vectors, moments of shape (r, m) instead of (n, m).

Low-rank rules can carry a :class:`~repro_torch.core.policy.RankSchedule`
(step -> rank plateaus) or a
:class:`~repro_torch.core.controller.RankController` (hysteresis-banded rank
grid fed by the captured-energy statistics the update publishes into
``budget_stats``) — a rank change re-plans through the same
signature-keyed step cache as a budget change, once per plateau.

Rules are globs on the REFERENCE's leaf paths (``unit/<j>/mlp/wi``,
``embed``): the port keeps one tensor per layer (``layers/<i>/mlp/wi``)
and resolves each under the path of the stacked leaf it belongs to
(``repro_torch.optim.layouts.reference_path``), so one spec picks the
same layout in both packages.  The module is the reference's, field for
field and message for message.  Everything is frozen/hashable;
``as_spec`` adapts a legacy ``AdamWConfig``.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, Optional, Tuple, Union

from repro_torch.core.policy import RankSchedule
from repro_torch.train import optim as adamw_lib

KNOWN_LAYOUTS = ("dense", "factored", "lowrank")

# budget_stats key carrying rule i's captured-energy statistics (the
# rank analogue of a znorm tag; namespaced so it can never collide with
# a model linear tag)
_RANK_STAT_PREFIX = "optim:rank:"


def rank_stat_key(rule_idx: int) -> str:
    return f"{_RANK_STAT_PREFIX}{int(rule_idx)}"


def is_rank_stat_key(key: str) -> bool:
    return key.startswith(_RANK_STAT_PREFIX)


@dataclasses.dataclass(frozen=True)
class LayoutRule:
    """One ordered layout entry: leaf-path glob -> state layout.

    ``rank``/``refresh_every``/``schedule``/``controller`` only apply to
    ``layout="lowrank"``; ``momentum`` only to ``"factored"``
    (``False`` drops the first moment entirely — pure Adafactor,
    O(n + m) total state).  ``schedule`` and ``controller`` are
    mutually exclusive, exactly like budget rules.
    """

    pattern: str
    layout: str = "dense"
    rank: int = 8
    momentum: bool = True
    refresh_every: int = 50
    schedule: Optional[RankSchedule] = None
    controller: Optional[object] = None   # RankController (duck-typed)

    def __post_init__(self):
        if self.layout not in KNOWN_LAYOUTS:
            raise ValueError(f"rule {self.pattern!r}: unknown layout "
                             f"{self.layout!r}; one of {KNOWN_LAYOUTS}")
        if self.rank < 1:
            raise ValueError(f"rule {self.pattern!r}: need rank >= 1")
        if self.refresh_every < 1:
            raise ValueError(f"rule {self.pattern!r}: need "
                             f"refresh_every >= 1")
        if self.schedule is not None and self.controller is not None:
            raise ValueError(
                f"rule {self.pattern!r}: schedule and controller are "
                f"mutually exclusive (a controller already owns the "
                f"rank trajectory)")
        if (self.schedule is not None or self.controller is not None) \
                and self.layout != "lowrank":
            raise ValueError(
                f"rule {self.pattern!r}: rank schedules/controllers "
                f"only apply to layout='lowrank' (dense and factored "
                f"states have no rank)")
        if self.controller is not None \
                and not hasattr(self.controller, "propose"):
            raise TypeError(
                f"controller {self.controller!r} does not implement "
                f"the BudgetController protocol")

    @classmethod
    def of(cls, pattern: str, layout: str = "dense",
           schedule: Optional[object] = None, *, rank: int = 8,
           momentum: bool = True, refresh_every: int = 50,
           controller: Optional[object] = None) -> "LayoutRule":
        """The third positional slot accepts either a RankSchedule or a
        RankController (distinguished by type, like ``Rule.of``)."""
        if schedule is not None and not isinstance(schedule, RankSchedule):
            if controller is not None:
                raise ValueError("pass either a schedule or a controller")
            schedule, controller = None, schedule
        return cls(pattern=pattern, layout=layout, rank=rank,
                   momentum=momentum, refresh_every=refresh_every,
                   schedule=schedule, controller=controller)

    def matches(self, path: str) -> bool:
        return fnmatch.fnmatchcase(path, self.pattern)

    def dynamic(self) -> bool:
        return self.schedule is not None or self.controller is not None

    def initial_rank(self) -> int:
        """Rank before any step/statistics exist."""
        if self.schedule is not None:
            return self.schedule.rank_at(0)
        if self.controller is not None:
            return int(self.controller.initial_budget(self.rank))
        return self.rank


@dataclasses.dataclass(frozen=True)
class OptimSpec:
    """Frozen optimizer spec: AdamW hyperparameters + ordered layout
    rules.  Unmatched leaves are ``dense`` — an empty-rule spec is
    bit-identical to ``AdamWConfig`` with the same hyperparameters.

    ``b3``/``clip_threshold`` are the CAME knobs of the factored
    layout: confidence EMA decay and the RMS clip on the normalized
    update.
    """

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0        # 0 = off
    b3: float = 0.999
    clip_threshold: float = 1.0
    rules: Tuple[LayoutRule, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        for name in ("b1", "b2", "b3"):
            v = getattr(self, name)
            if not (0.0 < v < 1.0):
                raise ValueError(f"need 0 < {name} < 1, got {v}")
        if self.eps <= 0 or self.clip_threshold <= 0:
            raise ValueError("need eps > 0 and clip_threshold > 0")
        if self.weight_decay < 0 or self.grad_clip_norm < 0:
            raise ValueError("need weight_decay >= 0 and "
                             "grad_clip_norm >= 0")

    @classmethod
    def of(cls, *entries, **hypers) -> "OptimSpec":
        """Build from ``(pattern, layout[, schedule/controller])``
        tuples, LayoutRules, or dicts of LayoutRule fields."""
        built = []
        for e in entries:
            if isinstance(e, LayoutRule):
                built.append(e)
            elif isinstance(e, dict):
                built.append(LayoutRule.of(**e))
            else:
                built.append(LayoutRule.of(*e))
        return cls(rules=tuple(built), **hypers)

    @classmethod
    def from_adamw(cls, cfg: adamw_lib.AdamWConfig) -> "OptimSpec":
        return cls(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                   weight_decay=cfg.weight_decay,
                   grad_clip_norm=cfg.grad_clip_norm)

    # -- resolution -----------------------------------------------------

    def resolve_with_index(self, path: str
                           ) -> Tuple[Optional[int],
                                      Optional[LayoutRule]]:
        """(rule index, rule) of the first match; (None, None) means
        the dense default."""
        for i, rule in enumerate(self.rules):
            if rule.matches(path):
                return i, rule
        return None, None

    def layout_for(self, path: str) -> str:
        _, rule = self.resolve_with_index(path)
        return rule.layout if rule is not None else "dense"

    @property
    def all_dense(self) -> bool:
        return all(r.layout == "dense" for r in self.rules)

    def layouts_used(self) -> Tuple[str, ...]:
        """Sorted distinct layout names this spec can resolve to
        (always includes the dense default)."""
        return tuple(sorted({"dense"} | {r.layout for r in self.rules}))

    # -- rank dynamics --------------------------------------------------

    def dynamic_rule_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, r in enumerate(self.rules) if r.dynamic())

    def schedule_rule_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, r in enumerate(self.rules)
                     if r.schedule is not None)

    def controller_rule_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, r in enumerate(self.rules)
                     if r.controller is not None)

    def initial_ranks(self) -> Dict[int, int]:
        """Rank per dynamic rule before any step/statistics exist —
        what ``layouts.init`` sizes the subspaces to when the scheduled
        step supplies nothing."""
        return {i: self.rules[i].initial_rank()
                for i in self.dynamic_rule_indices()}

    def rank_stat_keys(self) -> Tuple[str, ...]:
        return tuple(rank_stat_key(i)
                     for i in self.controller_rule_indices())


def as_spec(cfg: Union[OptimSpec, adamw_lib.AdamWConfig]) -> OptimSpec:
    """Normalize: an OptimSpec passes through, a legacy AdamWConfig
    becomes the equivalent all-dense spec."""
    if isinstance(cfg, OptimSpec):
        return cfg
    if isinstance(cfg, adamw_lib.AdamWConfig):
        return OptimSpec.from_adamw(cfg)
    raise TypeError(f"expected OptimSpec or AdamWConfig, got "
                    f"{type(cfg).__name__}")
