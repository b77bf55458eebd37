"""Adaptive budget controllers: znorm-cache statistics -> per-rule budgets.

The paper fixes the budget k for the whole run, but the leverage-score
distribution behind Theorem 2 differs per layer and drifts over
training.  This module closes the loop: the train step accumulates
cheap per-tag statistics from the gradient-norm tap
(``repro_torch.train.znorm.update_stats``) and a :class:`BudgetController`
attached to a policy :class:`~repro_torch.core.policy.Rule` maps them to
a budget.  Budgets fix the residual shapes, so every budget change is a
re-plan (new plan shapes, one new step function); controllers therefore
quantize their output to a small level grid and only move when the
driving statistic crosses a hysteresis band
(``launch.train_steps.make_scheduled_train_step``).

Statistics (one :class:`TagStats` view per tag, see ``train.znorm``):

  * ``ess``       — effective-sample-size fraction (Σz)²/(n·Σz²) of the
    tap's norm distribution: 1.0 = uniform norms (sampling needs many
    slots), → 1/n = fully concentrated (a few winners carry the mass).
  * ``cond_rate`` — EMA of the Theorem-2 condition indicator
    (sum_C p > |C|/k at the optimal |C|): how often WTA-CRS provably
    beats iid CRS at the current budget.
  * ``util``      — budget utilization: probability mass captured by the
    top-k atoms at the current budget (≈1 = over-provisioned).
  * ``count``     — number of EMA updates absorbed (controllers hold
    until ``count >= warmup``).

Controllers are frozen/hashable pure functions of
``(stats, current_budget, step)`` — deterministic given the same stats
stream, and always inside ``[b_min, b_max]``.  They run on the host and
decide exactly as the reference's do on the same statistics.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.policy import BudgetSchedule


@dataclasses.dataclass(frozen=True)
class TagStats:
    """Host-side view of one tag's (or one rule's aggregated) stat vector."""

    ess: float
    cond_rate: float
    util: float
    count: float

    @classmethod
    def from_vector(cls, vec) -> "TagStats":
        v = np.asarray(vec, dtype=np.float64).reshape(-1)
        return cls(ess=float(v[0]), cond_rate=float(v[1]),
                   util=float(v[2]), count=float(v[3]))

    @classmethod
    def aggregate(cls, stats: dict, pattern: str = "*",
                  tags=None) -> Optional["TagStats"]:
        """Mean stats over the selected tags, with the most conservative
        (minimum) update count; ``None`` when nothing matches — a
        controller holds on ``None``.

        ``stats`` maps tag -> stat vector on the host (numpy).  ``tags``:
        explicit tag subset (the scheduled step passes the tags
        actually GOVERNED by the controller's rule under first-match-wins
        precedence — a bare fnmatch would also swallow tags an earlier
        rule owns); without it, ``pattern`` filters."""
        if tags is None:
            tags = [t for t in stats if fnmatch.fnmatchcase(t, pattern)]
        vecs = [np.asarray(stats[t], dtype=np.float64)
                for t in tags if t in stats]
        if not vecs:
            return None
        a = np.stack(vecs)
        return cls(ess=float(a[:, 0].mean()), cond_rate=float(a[:, 1].mean()),
                   util=float(a[:, 2].mean()), count=float(a[:, 3].min()))


@runtime_checkable
class BudgetController(Protocol):
    """step/stats -> budget.  Implementations must be frozen/hashable,
    deterministic, and keep every returned budget in [b_min, b_max].
    ``needs_stats`` (class attribute, default True via ``getattr``)
    tells the scheduled step whether the controller consumes znorm
    statistics — stats-free controllers (FixedSchedule) run without a
    znorm cache."""

    b_min: float
    b_max: float

    def initial_budget(self, config_budget: Optional[float]) -> float:
        """Budget before any statistics exist (start of a run / signature
        of an undriven policy).  ``config_budget`` is the rule's static
        config budget, or None when the rule inherits the fallback."""
        ...

    def propose(self, stats: Optional[TagStats], budget: float,
                step: int) -> float:
        """Next budget given the current one.  Returning ``budget``
        unchanged means "hold" — the step re-plans exactly when the
        returned value differs."""
        ...


def _check_bounds(b_min: float, b_max: float) -> None:
    if not (0.0 < b_min <= b_max <= 1.0):
        raise ValueError(f"need 0 < b_min <= b_max <= 1, "
                         f"got [{b_min}, {b_max}]")


@dataclasses.dataclass(frozen=True)
class _GridController:
    """Shared level-grid machinery: budgets live on a linear grid of
    ``levels`` points in [b_min, b_max] and move at most one level per
    step, so an oscillating statistic can at worst toggle between two
    adjacent plateaus — and with a hysteresis band, not even that."""

    b_min: float = 0.1
    b_max: float = 1.0
    levels: int = 7
    warmup: int = 3

    needs_stats = True      # class attr, not a field: scheduler metadata

    def __post_init__(self):
        _check_bounds(self.b_min, self.b_max)
        if self.levels < 2:
            raise ValueError("need levels >= 2")
        if self.warmup < 0:
            raise ValueError("need warmup >= 0")

    def grid(self) -> Tuple[float, ...]:
        n = self.levels
        return tuple(self.b_min + (self.b_max - self.b_min) * i / (n - 1)
                     for i in range(n))

    def spacing(self) -> float:
        return (self.b_max - self.b_min) / (self.levels - 1)

    def clamp(self, budget: float) -> float:
        return min(max(float(budget), self.b_min), self.b_max)

    def nearest_level(self, budget: float) -> int:
        g = self.grid()
        return min(range(len(g)), key=lambda i: abs(g[i] - budget))

    def initial_budget(self, config_budget: Optional[float]) -> float:
        """Snap the rule's static budget onto the grid so subsequent
        single-level moves are exact plateau transitions."""
        base = self.b_max if config_budget is None else config_budget
        return self.grid()[self.nearest_level(self.clamp(base))]


@dataclasses.dataclass(frozen=True)
class FixedSchedule(_GridController):
    """A :class:`BudgetSchedule` wearing the controller interface —
    ignores statistics entirely.  Lets schedule- and stats-driven rules
    share one code path (and one trajectory report)."""

    schedule: BudgetSchedule = BudgetSchedule.constant(0.3)
    b_min: float = 0.01
    b_max: float = 1.0

    needs_stats = False     # runs fine without a znorm cache

    def initial_budget(self, config_budget: Optional[float]) -> float:
        return self.clamp(self.schedule.budget_at(0))

    def propose(self, stats: Optional[TagStats], budget: float,
                step: int) -> float:
        return self.clamp(self.schedule.budget_at(step))


@dataclasses.dataclass(frozen=True)
class _StatsController(_GridController):
    """Base for controllers that consume znorm statistics.

    Requires ``b_max < 1.0``: budget 1.0 short-circuits the layer onto
    the exact path, whose tap is all-zero and marked inactive — the
    tag's statistics freeze at whatever values drove the climb, so 1.0
    would be an absorbing state the controller could never leave (and
    the activation-memory savings would be silently forfeited for the
    rest of the run).
    """

    b_max: float = 0.9

    def __post_init__(self):
        super().__post_init__()
        if self.b_max >= 1.0:
            raise ValueError(
                "stats-driven controllers need b_max < 1.0: at budget "
                "1.0 the layer runs exact, its tap goes inactive and "
                "its statistics freeze (absorbing state); use "
                "FixedSchedule for exact phases")

    def _hold(self, stats: Optional[TagStats]) -> bool:
        # also hold on count < 1: the neutral init vector is fabricated
        # (init_stats), never evidence — even at warmup=0
        return (stats is None or stats.count < 1
                or stats.count < self.warmup)


@dataclasses.dataclass(frozen=True)
class RankController:
    """Hysteresis-banded integer rank grid for low-rank optimizer-state
    layouts, riding the :class:`BudgetController` protocol —
    ``initial_budget``/``propose`` with the "budget" being the projection
    rank.  The ``ess`` slot of its statistics carries the captured-energy
    fraction ``||P^T g||^2 / ||g||^2``: above ``hi`` the rank steps DOWN
    one grid level, below ``lo`` it steps UP, inside [lo, hi] it holds.

    ``repro_torch.optim.LayoutRule(controller=...)`` carries it;
    ``make_scheduled_train_step`` feeds it the energy statistics the
    optimizer update publishes under ``optim:rank:<rule>``.
    """

    r_min: int = 4
    r_max: int = 32
    levels: int = 4
    warmup: int = 3
    lo: float = 0.70
    hi: float = 0.97

    needs_stats = True      # class attr, not a field: scheduler metadata

    def __post_init__(self):
        if not (1 <= self.r_min <= self.r_max):
            raise ValueError(f"need 1 <= r_min <= r_max, "
                             f"got [{self.r_min}, {self.r_max}]")
        if self.levels < 2:
            raise ValueError("need levels >= 2")
        if self.warmup < 0:
            raise ValueError("need warmup >= 0")
        if not (0.0 <= self.lo < self.hi <= 1.0):
            raise ValueError(f"need 0 <= lo < hi <= 1, "
                             f"got [{self.lo}, {self.hi}]")

    # protocol-compat bounds (budgets ARE ranks here)
    @property
    def b_min(self) -> float:
        return float(self.r_min)

    @property
    def b_max(self) -> float:
        return float(self.r_max)

    def grid(self) -> Tuple[int, ...]:
        n = self.levels
        out: list = []
        for i in range(n):
            r = int(round(self.r_min
                          + (self.r_max - self.r_min) * i / (n - 1)))
            if not out or r > out[-1]:
                out.append(r)
        return tuple(out)

    def nearest_level(self, rank: float) -> int:
        g = self.grid()
        return min(range(len(g)), key=lambda i: abs(g[i] - rank))

    def initial_budget(self, config_budget: Optional[float]) -> int:
        """Snap the rule's static rank onto the grid (protocol name;
        the value is an integer rank)."""
        base = self.r_max if config_budget is None else config_budget
        base = min(max(int(round(base)), self.r_min), self.r_max)
        return self.grid()[self.nearest_level(base)]

    def propose(self, stats: Optional[TagStats], budget: float,
                step: int) -> int:
        g = self.grid()
        j = self.nearest_level(budget)
        if stats is None or stats.count < 1 or stats.count < self.warmup:
            return g[j]
        energy = stats.ess        # captured-energy fraction (see docstring)
        if energy > self.hi and j > 0:
            return g[j - 1]
        if energy < self.lo and j < len(g) - 1:
            return g[j + 1]
        return g[j]


@dataclasses.dataclass(frozen=True)
class ESSProportional(_StatsController):
    """Budget proportional to the effective-sample-size fraction.

    Flat norm distributions (ess -> 1) need many sampled slots to keep
    the Eq. 5/6 variance down; concentrated ones (ess -> 0) are captured
    by WTA's deterministic winners with a small budget.  The raw target
    ``b_min + (b_max - b_min) * ess`` is tracked on the level grid, one
    level per step, and only when the target leaves the current level's
    hysteresis band of half-width ``spacing * (0.5 + hysteresis)`` —
    an ess wobble smaller than ``spacing * hysteresis`` can never cause
    a re-plan.
    """

    hysteresis: float = 0.25

    def __post_init__(self):
        super().__post_init__()
        if self.hysteresis < 0:
            raise ValueError("need hysteresis >= 0")

    def propose(self, stats: Optional[TagStats], budget: float,
                step: int) -> float:
        if self._hold(stats):
            return self.clamp(budget)
        target = self.b_min + ((self.b_max - self.b_min)
                               * min(max(stats.ess, 0.0), 1.0))
        g = self.grid()
        j = self.nearest_level(self.clamp(budget))
        band = self.spacing() * (0.5 + self.hysteresis)
        if target > g[j] + band and j < len(g) - 1:
            return g[j + 1]
        if target < g[j] - band and j > 0:
            return g[j - 1]
        return self.clamp(budget)


@dataclasses.dataclass(frozen=True)
class ConditionRate(_StatsController):
    """Hysteresis-banded control on the Theorem-2 condition rate.

    When the condition sum_C p_C > |C|/k holds almost always
    (``cond_rate > hi``) the deterministic winners are doing the work and
    the budget steps DOWN one level; when it rarely holds
    (``cond_rate < lo``) sampling is under-provisioned and the budget
    steps UP.  Inside the [lo, hi] band the budget holds — the band IS
    the hysteresis, so a rate oscillating within it never re-plans.
    """

    lo: float = 0.35
    hi: float = 0.75

    def __post_init__(self):
        super().__post_init__()
        if not (0.0 <= self.lo < self.hi <= 1.0):
            raise ValueError(f"need 0 <= lo < hi <= 1, "
                             f"got [{self.lo}, {self.hi}]")

    def propose(self, stats: Optional[TagStats], budget: float,
                step: int) -> float:
        if self._hold(stats):
            return self.clamp(budget)
        g = self.grid()
        j = self.nearest_level(self.clamp(budget))
        if stats.cond_rate > self.hi and j > 0:
            return g[j - 1]
        if stats.cond_rate < self.lo and j < len(g) - 1:
            return g[j + 1]
        return self.clamp(budget)
