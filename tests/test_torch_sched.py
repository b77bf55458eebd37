"""Algorithm 1's whole training loop in both packages: the dataset
gradient-norm cache (``CACHED_GRAD``), the budget statistics, gradient
accumulation over microbatches and the controller-driven scheduled step.

Both sides start from the same state: the reference's parameters (norm
gains redrawn from [0.5, 1.5], see ``test_torch_train.py``) carried over
by ``convert.params_from_jax``, its cache and statistics by
``convert.cache_from_jax``.  Under ``det_topk`` no random number is
drawn, so the cache, the statistics, the parameters and the budget
trajectory must agree; every JAX whole-step run is shared by a
module-scoped fixture."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import controller as jax_ctrl
from repro.core import policy as jax_policy
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.launch import train_steps as jax_train_steps
from repro.models import common as jax_cm
from repro.train import optim as jax_optim
from repro.train import znorm as jax_znorm
from repro_torch import convert
from repro_torch.core import (BudgetSchedule, ESSProportional, FixedSchedule,
                              PolicyRules, Rule, WTACRSConfig)
from repro_torch.launch import train_steps
from repro_torch.models import common as cm
from repro_torch.models.registry import get_config
from repro_torch.train import data, optim, znorm

torch.set_num_threads(1)

ARCH = "qwen2.5-3b"
SEQ, BATCH, N_SAMPLES = 32, 4, 8
LR, WARMUP = 1e-3, 2
CACHED = dict(kind="det_topk", budget=0.3, min_rows=4,
              norm_source="cached_grad")
CTRL = dict(b_min=0.1, b_max=0.6, levels=6, warmup=1)


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _policies(adaptive):
    """(reference policy, port policy): det_topk from the cache on every
    linear, or on the MLP linears under an ESSProportional controller."""
    if not adaptive:
        return (jax_cm.Policy(wtacrs=JaxWTACRSConfig(**CACHED)),
                cm.Policy(wtacrs=WTACRSConfig(**CACHED)))
    return (jax_cm.Policy(rules=jax_policy.PolicyRules.of(jax_policy.Rule.of(
                "*mlp*", JaxWTACRSConfig(**CACHED),
                jax_ctrl.ESSProportional(**CTRL)))),
            cm.Policy(rules=PolicyRules.of(Rule.of(
                "*mlp*", WTACRSConfig(**CACHED), ESSProportional(**CTRL)))))


def _start(jpol, budget_stats=True):
    """Both packages' train state on the same values, cache included."""
    jcfg = _f32(jax_get_config(ARCH, reduced=True))
    tcfg = _f32(get_config(ARCH, reduced=True))
    tags = jax_znorm.collect_linear_tags(jcfg, policy=jpol)
    js = jax_train_steps.init_train_state(
        jcfg, jax.random.PRNGKey(0), znorm_tags=tags, n_dataset=N_SAMPLES,
        budget_stats=budget_stats)
    rng = np.random.RandomState(0)

    def redraw(path, a):
        a = np.array(a)
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, js["params"])
    js = dict(js, params=jax.tree.map(jnp.asarray, tree))
    params = convert.params_from_jax(tcfg, tree, device="cpu")
    ts = {"params": params, "opt": optim.adamw_init(params), "step": 0,
          "base_seed": 11}
    ts.update(convert.cache_from_jax(
        {n: jax.tree.map(np.asarray, js[n])
         for n in ("znorm", "budget_stats") if n in js}, device="cpu"))
    return jcfg, tcfg, tags, js, ts


def _dataset(tcfg):
    return data.SyntheticLM(tcfg.vocab_size, SEQ, N_SAMPLES, seed=0)


def _port_snapshot(tcfg, state, tags):
    """Host copies of what the loop compares: params, cache, stats (the
    optimizer updates the parameters in place, hence the copies)."""
    return (jax.tree.map(np.copy, convert.params_to_numpy(tcfg,
                                                          state["params"])),
            {t: state["znorm"][t].numpy().copy() for t in tags},
            {t: state["budget_stats"][t].numpy().copy() for t in tags})


def _jax_snapshot(state, tags):
    return (jax.tree.map(np.asarray, state["params"]),
            {t: np.asarray(state["znorm"][t]) for t in tags},
            {t: np.asarray(state["budget_stats"][t]) for t in tags})


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's cached det_topk loop, 3 steps at microbatches 1
    and 2: per step the loss, grad norm and a host snapshot."""
    jpol, _ = _policies(adaptive=False)
    out = {}
    for m in (1, 2):
        jcfg, tcfg, tags, js, _ = _start(jpol)
        step = jax.jit(jax_train_steps.make_train_step(
            jcfg, jpol, jax_optim.AdamWConfig(),
            jax_optim.linear_warmup_constant(LR, WARMUP),
            use_znorm_cache=True, microbatches=m))
        ds = _dataset(tcfg)
        rows = []
        for i in range(3):
            js, jm = step(js, ds.batch_at(i, BATCH))
            rows.append((float(jm["loss"]), float(jm["grad_norm"]),
                         _jax_snapshot(js, tags)))
        out[m] = rows
    return out


def _port_run(microbatches, n_steps=3):
    _, tpol = _policies(adaptive=False)
    _, tcfg, tags, _, ts = _start(_policies(adaptive=False)[0])
    step = train_steps.make_train_step(
        tcfg, tpol, optim.AdamWConfig(),
        optim.linear_warmup_constant(LR, WARMUP), use_znorm_cache=True,
        microbatches=microbatches, device="cpu")
    ds = _dataset(tcfg)
    rows = []
    for i in range(n_steps):
        ts, tm = step(ts, ds.batch_at(i, BATCH))
        rows.append((float(tm["loss"]), float(tm["grad_norm"]),
                     _port_snapshot(tcfg, ts, tags)))
    return tcfg, tags, rows


@pytest.fixture(scope="module")
def port_runs():
    return {m: _port_run(m) for m in (1, 2)}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_cached_det_topk_loop_matches_reference(reference_runs, port_runs,
                                                microbatches):
    """Three whole steps: the cache and the statistics to 1e-5, the
    parameters to 1e-4 (f32 on both sides; only summation orders
    differ), one statistics update per optimizer step."""
    tcfg, tags, rows = port_runs[microbatches]
    for i, ((tl, tg, (tp, tc, tst)), (jl, jg, (jp, jc, jst))) in enumerate(
            zip(rows, reference_runs[microbatches])):
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(tg, jg, rtol=1e-4)
        for t in tags:
            np.testing.assert_allclose(tc[t], jc[t], rtol=1e-5, atol=1e-5,
                                       err_msg=f"cache {t} step {i}")
            np.testing.assert_allclose(tst[t], jst[t], rtol=1e-5, atol=1e-5,
                                       err_msg=f"stats {t} step {i}")
            assert tst[t][znorm.STAT_COUNT] == i + 1
            assert not np.allclose(tc[t], 1.0), f"cache {t} never written"
        flat_t = jax.tree_util.tree_leaves_with_path(tp)
        flat_j = jax.tree_util.tree_leaves_with_path(jp)
        assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
        for (path, a), (_, b) in zip(flat_t, flat_j):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=jax.tree_util.keystr(path))


def test_microbatches_2_matches_microbatches_1_of_the_port(port_runs):
    """Two equal microbatches with fully valid labels: the loss, grad
    norm and statistics equal the single batch's to 1e-5, the parameters
    to 1e-4; the cached
    norms double (each microbatch's loss normalizes over half the
    tokens, and det_topk plans see only the per-sample ratio)."""
    _, tags, one = port_runs[1]
    _, _, two = port_runs[2]
    for (l1, g1, (p1, c1, s1)), (l2, g2, (p2, c2, s2)) in zip(one, two):
        np.testing.assert_allclose(l2, l1, rtol=1e-5)
        np.testing.assert_allclose(g2, g1, rtol=1e-5)
        for t in tags:
            written = c1[t] != 1.0
            np.testing.assert_allclose(c2[t][written], 2.0 * c1[t][written],
                                       rtol=1e-5)
            np.testing.assert_allclose(s2[t], s1[t], rtol=1e-5, atol=1e-5)
        # Adam's step g / (|g| + eps) turns an f32 summation-order
        # difference in a near-zero gradient into up to lr/eps times as
        # much: the parameters are held to the cross-framework 1e-4
        for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(p1)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_batch_that_does_not_split_or_lacks_ids_is_refused():
    _, tpol = _policies(adaptive=False)
    _, tcfg, _, _, ts = _start(_policies(adaptive=False)[0])
    mk = lambda m: train_steps.make_train_step(  # noqa: E731
        tcfg, tpol, optim.AdamWConfig(), lambda s: 1e-3,
        use_znorm_cache=True, microbatches=m, device="cpu")
    batch = _dataset(tcfg).batch_at(0, BATCH)
    with pytest.raises(ValueError, match="microbatches"):
        mk(3)(ts, batch)
    with pytest.raises(ValueError, match="sample_ids"):
        mk(1)(ts, {k: v for k, v in batch.items() if k != "sample_ids"})
    with pytest.raises(ValueError, match="microbatches"):
        mk(0)


# ---------------------------------------------------------------------------
# The scheduled step: controllers, trajectories, schedule state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trajectories():
    """The same controller-driven det_topk run (6 steps) in both
    packages: losses and the schedule state."""
    jpol, tpol = _policies(adaptive=True)
    jcfg, tcfg, tags, js, ts = _start(jpol)
    jstep = jax_train_steps.make_scheduled_train_step(
        jcfg, jpol, jax_optim.AdamWConfig(),
        jax_optim.linear_warmup_constant(LR, WARMUP), use_znorm_cache=True)
    tstep = train_steps.make_scheduled_train_step(
        tcfg, tpol, optim.AdamWConfig(),
        optim.linear_warmup_constant(LR, WARMUP), use_znorm_cache=True,
        device="cpu")
    ds = _dataset(tcfg)
    jl, tl = [], []
    for i in range(6):
        batch = ds.batch_at(i, BATCH)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, batch)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return {"jax": (jstep, jl, js), "torch": (tstep, tl, ts), "tags": tags}


def test_det_topk_budget_trajectory_equals_the_reference(trajectories):
    jstep, jl, _ = trajectories["jax"]
    tstep, tl, _ = trajectories["torch"]
    assert tstep.budget_trajectory == jstep.budget_trajectory
    assert tstep.replans == jstep.replans >= 1
    assert tstep.owned_tags == jstep.owned_tags
    assert len(tstep.compiled) == len(jstep.compiled) <= tstep.replans + 1
    # f32 on both sides, the same plans at every step
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_schedule_state_crosses_from_the_reference_as_json(trajectories):
    """The reference's record, through JSON text, restores the port's
    scheduled step; and the two records agree field for field."""
    jstep, _, _ = trajectories["jax"]
    tstep, _, _ = trajectories["torch"]
    text = json.dumps(jstep.schedule_state.to_json())
    restored = train_steps.ScheduleState.from_json(json.loads(text))
    assert restored == tstep.schedule_state
    assert restored.to_json() == jstep.schedule_state.to_json()
    assert train_steps.ScheduleState.VERSION == \
        jax_train_steps.ScheduleState.VERSION
    _, tpol = _policies(adaptive=True)
    step = train_steps.make_scheduled_train_step(
        get_config(ARCH, reduced=True), tpol, optim.AdamWConfig(),
        lambda s: 1e-3, schedule_state=restored, use_znorm_cache=True,
        device="cpu")
    assert step.replans == jstep.replans
    assert step.schedule_state.budgets == jstep.schedule_state.budgets


def test_resumed_scheduled_step_continues_the_trajectory(trajectories):
    """Steps 0-2, the schedule state through JSON into a new scheduled step, steps
    3-5: the same trajectory as the uninterrupted port run."""
    _, tpol = _policies(adaptive=True)
    _, tcfg, _, _, ts = _start(_policies(adaptive=True)[0])
    mk = lambda st=None: train_steps.make_scheduled_train_step(  # noqa
        tcfg, tpol, optim.AdamWConfig(),
        optim.linear_warmup_constant(LR, WARMUP), schedule_state=st,
        use_znorm_cache=True, device="cpu")
    ds = _dataset(tcfg)
    first = mk()
    for i in range(3):
        ts, _ = first(ts, ds.batch_at(i, BATCH))
    second = mk(train_steps.ScheduleState.from_json(
        json.loads(json.dumps(first.schedule_state.to_json()))))
    for i in range(3, 6):
        ts, m = second(ts, ds.batch_at(i, BATCH))
    tstep, tl, _ = trajectories["torch"]
    assert second.budget_trajectory == tstep.budget_trajectory
    assert second.replans == tstep.replans
    np.testing.assert_allclose(float(m["loss"]), tl[-1], rtol=1e-6)


@pytest.mark.parametrize("change,match", [
    (lambda d: dict(d, version=99), "version"),
    (lambda d: dict(d, budgets={"7": 0.3}), "policy changed"),
    (lambda d: dict(d, ranks={"0": 8}), "ranks"),
])
def test_schedule_state_refusals(change, match):
    _, tpol = _policies(adaptive=True)
    good = train_steps.ScheduleState(
        budgets={0: 0.3}, replans=2,
        trajectory=[{"step": 0, "rule": 0, "pattern": "*mlp*",
                     "budget": 0.3, "prev": None}])
    assert train_steps.ScheduleState.from_json(good.to_json()) == good
    with pytest.raises(ValueError, match=match):
        st = train_steps.ScheduleState.from_json(change(good.to_json()))
        train_steps.make_scheduled_train_step(
            get_config(ARCH, reduced=True), tpol, optim.AdamWConfig(),
            lambda s: 1e-3, schedule_state=st, use_znorm_cache=True,
            device="cpu")


def test_replans_counted_and_steady_state_reuses_step_functions():
    """``tests/test_controller.py``'s re-plan test on the port: a
    WTA-CRS run whose near-uniform taps drive the controller up, one
    step function per band position, converged before the end."""
    cfg = get_config(ARCH, reduced=True)
    ctrl = ESSProportional(b_min=0.1, b_max=0.6, levels=6, warmup=2)
    pol = cm.Policy(rules=PolicyRules.of(Rule.of(
        "*mlp*", WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=2,
                              norm_source="cached_grad"), ctrl)))
    tags = znorm.collect_linear_tags(cfg, policy=pol)
    state = train_steps.init_train_state(cfg, 0, znorm_tags=tags,
                                         n_dataset=8, budget_stats=True,
                                         device="cpu")
    step = train_steps.make_scheduled_train_step(
        cfg, pol, optim.AdamWConfig(), optim.linear_warmup_constant(1e-3),
        use_znorm_cache=True, device="cpu")
    batch = data.SyntheticLM(cfg.vocab_size, 16, 8, seed=0).batch_at(0, 4)
    for _ in range(8):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"]))
    changes = [r for r in step.budget_trajectory if r["prev"] is not None]
    assert changes, "controller never moved despite uniform stats"
    assert step.replans == len(changes)
    assert len(step.compiled) <= step.replans + 1
    for r in step.budget_trajectory:
        assert ctrl.b_min <= r["budget"] <= ctrl.b_max
    assert changes[-1]["step"] < 8 - 1, "controller still churning"
    for t in tags:
        assert float(state["budget_stats"][t][znorm.STAT_COUNT]) == 8


def test_fixed_schedule_controller_runs_without_znorm_cache():
    cfg = get_config(ARCH, reduced=True)
    ctrl = FixedSchedule(schedule=BudgetSchedule.warmup_exact(begin_step=2,
                                                              end=0.5))
    pol = cm.Policy(rules=PolicyRules.of(Rule.of(
        "*mlp*", WTACRSConfig(budget=0.5, min_rows=4), ctrl)))
    state = train_steps.init_train_state(cfg, 0, device="cpu")
    step = train_steps.make_scheduled_train_step(
        cfg, pol, optim.AdamWConfig(), optim.linear_warmup_constant(1e-3),
        device="cpu")
    batch = data.SyntheticLM(cfg.vocab_size, 16, 8, seed=0).batch_at(0, 2)
    for _ in range(3):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"]))
    # exact warmup (steps 0-1) + sampled phase (step 2) = 2 step functions
    assert len(step.compiled) == 2
    assert step.replans == 1
    assert [r["budget"] for r in step.budget_trajectory] == [1.0, 0.5]


def test_first_match_wins_governs_stat_ownership():
    cfg = get_config(ARCH, reduced=True)
    wcfg = WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=2,
                        norm_source="cached_grad")
    pol = cm.Policy(rules=PolicyRules.of(
        Rule.of("*mlp_wi", wcfg, ESSProportional(b_min=0.1, b_max=0.4,
                                                 levels=4, warmup=1)),
        Rule.of("*mlp*", wcfg, ESSProportional(b_min=0.1, b_max=0.6,
                                               levels=6, warmup=1))))
    tags = znorm.collect_linear_tags(cfg, policy=pol)
    state = train_steps.init_train_state(cfg, 0, znorm_tags=tags,
                                         n_dataset=8, budget_stats=True,
                                         device="cpu")
    step = train_steps.make_scheduled_train_step(
        cfg, pol, optim.AdamWConfig(), optim.linear_warmup_constant(1e-3),
        use_znorm_cache=True, device="cpu")
    step(state, data.SyntheticLM(cfg.vocab_size, 16, 8, seed=0
                                 ).batch_at(0, 4))
    owned = step.owned_tags
    assert owned[0] and all(t.endswith("mlp_wi") for t in owned[0])
    assert owned[1] and not any(t.endswith("mlp_wi") for t in owned[1])


def test_controller_without_znorm_cache_raises():
    cfg = get_config(ARCH, reduced=True)
    pol = cm.Policy(rules=PolicyRules.of(Rule.of(
        "*mlp*", WTACRSConfig(budget=0.3, min_rows=2), ESSProportional())))
    with pytest.raises(ValueError, match="use_znorm_cache"):
        train_steps.make_scheduled_train_step(
            cfg, pol, optim.AdamWConfig(), lambda s: 1e-3, device="cpu")
    step = train_steps.make_scheduled_train_step(
        cfg, pol, optim.AdamWConfig(), lambda s: 1e-3,
        use_znorm_cache=True, device="cpu")
    state = train_steps.init_train_state(cfg, 0, device="cpu")
    batch = data.SyntheticLM(cfg.vocab_size, 16, 8, seed=0).batch_at(0, 2)
    with pytest.raises(ValueError, match="budget_stats"):
        step(state, batch)


# ---------------------------------------------------------------------------
# optimizer rank dynamics (OptimSpec low-rank rules)
# ---------------------------------------------------------------------------

def _rank_specs(which):
    """(reference spec, port spec): low-rank moments on every unit matrix,
    the rank under a linear RankSchedule or a RankController."""
    from repro import optim as jax_optim_lib
    from repro_torch import optim as optim_lib

    def build(pkg):
        if which == "schedule":
            dyn = dict(schedule=pkg.RankSchedule.linear(
                8, 2, begin_step=0, end_step=4, stages=2))
        else:
            dyn = dict(rank=2, controller=pkg.RankController(
                r_min=2, r_max=8, levels=4, warmup=1, lo=0.7, hi=0.97))
        return pkg.OptimSpec.of(dict(pattern="unit/*/mlp/*",
                                     layout="lowrank", **dyn))
    return build(jax_optim_lib), build(optim_lib)


@pytest.mark.parametrize("which", ["schedule", "controller"])
def test_rank_trajectory_equals_the_reference(which):
    """``make_scheduled_train_step`` with a dynamic low-rank rule: the
    ranks it pins, their trajectory, the re-plans and the step functions
    equal the reference's, and the parameters agree to 1e-4 (det_topk,
    f32; a rank change migrates the subspace, a RankController reads the
    captured-energy statistics the update publishes in budget_stats)."""
    jspec, tspec = _rank_specs(which)
    wta = dict(kind="det_topk", budget=0.3, min_rows=4)
    jcfg = _f32(jax_get_config(ARCH, reduced=True))
    tcfg = _f32(get_config(ARCH, reduced=True))
    js = jax_train_steps.init_train_state(jcfg, jax.random.PRNGKey(0),
                                          opt=jspec)
    rng = np.random.RandomState(0)

    def redraw(path, a):       # the norm gains, as in _start
        a = np.array(a)
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, js["params"])
    js = dict(js, params=jax.tree.map(jnp.asarray, tree))
    ts = train_steps.init_train_state(
        tcfg, 0, device="cpu", opt=tspec,
        params=convert.params_from_jax(tcfg, tree, device="cpu"))
    assert sorted(ts.get("budget_stats", {})) == sorted(
        js.get("budget_stats", {}))
    jstep = jax_train_steps.make_scheduled_train_step(
        jcfg, jax_cm.Policy(wtacrs=JaxWTACRSConfig(**wta)), jspec,
        jax_optim.linear_warmup_constant(LR, WARMUP))
    tstep = train_steps.make_scheduled_train_step(
        tcfg, cm.Policy(wtacrs=WTACRSConfig(**wta)), tspec,
        optim.linear_warmup_constant(LR, WARMUP), device="cpu")
    ds = data.SyntheticLM(tcfg.vocab_size, SEQ, N_SAMPLES, seed=0)
    for i in range(3):
        batch = ds.batch_at(i, BATCH)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, batch)
        assert tstep.schedule_state.ranks == jstep.schedule_state.ranks
    st, jst = tstep.schedule_state, jstep.schedule_state
    assert st.rank_trajectory == jst.rank_trajectory
    assert st.replans == jst.replans > 0
    assert len(tstep.compiled) == len(jstep.compiled)
    assert st.to_json() == jst.to_json()
    # f32 on both sides; gradients differ by summation order
    got = convert.params_to_numpy(tcfg, ts["params"])
    want = jax.tree.map(np.asarray, js["params"])
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
