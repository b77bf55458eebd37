"""The port's adaptive budget controllers against the JAX package's: the
same seeded statistics streams (numpy, with ``None`` gaps, counts below
and past every warmup, out-of-range ``ess``) through both packages'
controllers give the same decision at every step, exactly.  The
controllers are host logic in Python floats on both sides, so nothing
is allowed to differ.  Also ``TagStats`` and the validation of the
controllers' parameters."""
import numpy as np
import pytest
import torch

from repro.core import controller as jax_ctrl
from repro.core import policy as jax_policy
from repro_torch.core import (BudgetController, BudgetSchedule,
                              ConditionRate, ESSProportional, FixedSchedule,
                              RankController, TagStats)
from repro_torch.core import controller as ctrl_mod

torch.set_num_threads(1)

SEEDS = list(range(6))


def _pair(name):
    """The same controller built in both packages."""
    if name == "ess":
        kw = dict(b_min=0.1, b_max=0.6, levels=6, warmup=2)
        return jax_ctrl.ESSProportional(**kw), ESSProportional(**kw)
    if name == "ess_tight":
        kw = dict(b_min=0.05, b_max=0.8, levels=9, warmup=0, hysteresis=0.0)
        return jax_ctrl.ESSProportional(**kw), ESSProportional(**kw)
    if name == "cond":
        kw = dict(b_min=0.2, b_max=0.9, levels=5, warmup=1, lo=0.3, hi=0.8)
        return jax_ctrl.ConditionRate(**kw), ConditionRate(**kw)
    if name == "fixed":
        args = dict(start=1.0, end=0.1, begin_step=2, end_step=20, stages=4)
        return (jax_ctrl.FixedSchedule(
                    schedule=jax_policy.BudgetSchedule.linear(**args),
                    b_min=0.05, b_max=1.0),
                FixedSchedule(schedule=BudgetSchedule.linear(**args),
                              b_min=0.05, b_max=1.0))
    if name == "rank":
        kw = dict(r_min=4, r_max=32, levels=4, warmup=2, lo=0.7, hi=0.95)
        return jax_ctrl.RankController(**kw), RankController(**kw)
    raise KeyError(name)


CONTROLLERS = ["ess", "ess_tight", "cond", "fixed", "rank"]


def _stream(seed, n=40):
    """Raw stat rows (ess, cond, util, count) or None, from numpy."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if rng.rand() < 0.15:
            out.append(None)
            continue
        # ess drifts slowly with noise, sometimes outside [0, 1]
        ess = 0.5 + 0.6 * np.sin(i / 5.0 + seed) + 0.1 * rng.randn()
        out.append((float(ess), float(rng.rand()), float(rng.rand()),
                    float(min(i, rng.randint(0, 6) + i // 2))))
    return out


def _drive(ctrl, stats_cls, stream, start):
    b = ctrl.initial_budget(start)
    out = [b]
    for step, row in enumerate(stream):
        s = None if row is None else stats_cls(
            ess=row[0], cond_rate=row[1], util=row[2], count=row[3])
        b = ctrl.propose(s, b, step)
        out.append(b)
    return out


@pytest.mark.parametrize("name", CONTROLLERS)
@pytest.mark.parametrize("seed", SEEDS)
def test_decisions_equal_the_reference_on_seeded_streams(name, seed):
    jc, tc = _pair(name)
    start = [None, 0.3, 0.55, 1.0, 16, 0.0][seed]
    stream = _stream(seed)
    want = _drive(jc, jax_ctrl.TagStats, stream, start)
    got = _drive(tc, TagStats, stream, start)
    # host floats on both sides: the same decisions, to the bit
    assert got == want
    assert all(tc.b_min <= b <= tc.b_max for b in got)
    assert isinstance(tc, BudgetController)


@pytest.mark.parametrize("name", CONTROLLERS)
def test_grids_and_initial_budgets_equal_the_reference(name):
    jc, tc = _pair(name)
    assert tc.grid() == jc.grid()
    for start in (None, 0.0, 0.13, 0.3, 0.77, 1.0, 2, 9, 40):
        assert tc.initial_budget(start) == jc.initial_budget(start)
    assert (getattr(tc, "needs_stats", True)
            == getattr(jc, "needs_stats", True))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_tag_stats_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    names = ["b0/mlp_wi", "b0/mlp_wo", "b1/mlp_wi", "b0/attn_q"]
    stats = {t: rng.rand(4).astype(np.float32) * [1, 1, 1, 9]
             for t in names}
    for t in names:
        assert TagStats.from_vector(stats[t]) == \
            TagStats(**vars(jax_ctrl.TagStats.from_vector(stats[t])))
    for kw in (dict(pattern="*mlp*"), dict(pattern="b0/*"),
               dict(tags=["b1/mlp_wi", "b0/attn_q"]), dict(tags=[]),
               dict(pattern="*none*")):
        want = jax_ctrl.TagStats.aggregate(stats, **kw)
        got = TagStats.aggregate(stats, **kw)
        assert (got is None) == (want is None)
        if want is not None:
            # f64 means of the same values in the same order
            assert vars(got) == vars(want)


@pytest.mark.parametrize("make,error", [
    (lambda m: m.ESSProportional(b_min=0.0), ValueError),
    (lambda m: m.ESSProportional(b_min=0.9, b_max=0.5), ValueError),
    (lambda m: m.ESSProportional(levels=1), ValueError),
    (lambda m: m.ESSProportional(hysteresis=-0.1), ValueError),
    (lambda m: m.ESSProportional(b_max=1.0), ValueError),
    (lambda m: m.ConditionRate(lo=0.8, hi=0.4), ValueError),
    (lambda m: m.ConditionRate(b_max=1.0), ValueError),
    (lambda m: m.RankController(r_min=0), ValueError),
    (lambda m: m.RankController(lo=0.9, hi=0.5), ValueError),
    (lambda m: m.ConditionRate(warmup=-1), ValueError),
])
def test_invalid_parameters_rejected_like_the_reference(make, error):
    with pytest.raises(error):
        make(jax_ctrl)
    with pytest.raises(error):
        make(ctrl_mod)


def test_stats_free_schedule_may_reach_exact():
    assert FixedSchedule(b_max=1.0).b_max == 1.0
    assert not FixedSchedule.needs_stats and ESSProportional.needs_stats
    sched = BudgetSchedule.warmup_exact(begin_step=5, end=0.3)
    ctrl = FixedSchedule(schedule=sched)
    assert ctrl.initial_budget(None) == 1.0
    for step in (0, 4, 5, 9):
        assert ctrl.propose(None, 1.0, step) == sched.budget_at(step)
