"""The port's ``repro_torch.api`` façade against the JAX package's
``repro.api`` and against its own hand-wired parts.

RunSpec construction errors (the reference's cases, both packages, the
same error class and match); ``Run.fit`` bit-equal to the port's own
``make_scheduled_train_step`` loop; ``Run.fit`` against JAX ``Run.fit``
under ``det_topk`` on the same parameters (f32 compute on both sides, norm
gains redrawn from [0.5, 1.5] — see ``test_torch_train.py``); kill and
resume bit-faithful with the controller trajectory continued; the report
sections' text against the reference's; ``lora_linear`` against the
reference's with the plan injected."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.core import controller as jax_ctrl
from repro.core import linear as jax_linear
from repro.core import lora as jax_lora
from repro.core import policy as jax_policy
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.launch import report as jax_report
from repro.models import common as jax_cm
from repro_torch import convert, core
from repro_torch.api import DataSpec, Run, RunSpec
from repro_torch.core import (ESSProportional, KernelConfig, LoRAConfig,
                              PolicyRules, Rule, WTACRSConfig, lora)
from repro_torch.launch import report, train_steps
from repro_torch.models import common as cm
from repro_torch.serve import ServeSpec
from repro_torch.train import checkpoint, optim, znorm

torch.set_num_threads(1)

ARCH = "qwen2.5-3b"
CPU = dict(device="cpu")

# the two packages' policy vocabularies, side by side
JAX = types.SimpleNamespace(
    cm=jax_cm, WTACRSConfig=JaxWTACRSConfig,
    PolicyRules=jax_policy.PolicyRules, Rule=jax_policy.Rule, ESSProportional=jax_ctrl.ESSProportional,
    RunSpec=jax_api.RunSpec, DataSpec=jax_api.DataSpec)
PORT = types.SimpleNamespace(
    cm=cm, WTACRSConfig=WTACRSConfig, PolicyRules=PolicyRules, Rule=Rule,
    ESSProportional=ESSProportional, RunSpec=RunSpec, DataSpec=DataSpec)


def _policy(pkg, kind, estimator="wta_crs", warmup=1):
    """plain (activation-only), cached (CACHED_GRAD), ctrl (CACHED_GRAD on
    the MLPs under ESSProportional) or act_ctrl (activation-only under it)."""
    base = dict(kind=estimator, budget=0.3, min_rows=2)
    cached = dict(base, norm_source="cached_grad")
    ess = dict(b_min=0.1, b_max=0.6, levels=6, warmup=warmup)
    if kind == "plain":
        return pkg.cm.Policy(wtacrs=pkg.WTACRSConfig(**base))
    if kind == "cached":
        return pkg.cm.Policy(wtacrs=pkg.WTACRSConfig(**cached))
    cfg = pkg.WTACRSConfig(**(cached if kind == "ctrl" else base))
    return pkg.cm.Policy(rules=pkg.PolicyRules.of(pkg.Rule.of(
        "*mlp*", cfg, pkg.ESSProportional(**ess))))


def _spec(pkg, policy, **kw):
    kw.setdefault("arch", ARCH)
    kw.setdefault("steps", 4)
    kw.setdefault("batch_size", 4)
    kw.setdefault("data", pkg.DataSpec(seq_len=16, n_samples=32))
    return pkg.RunSpec(policy=policy, **kw)


# ---------------------------------------------------------------------------
# (a) RunSpec: construction-time validation, both packages
# ---------------------------------------------------------------------------

REFUSED = [
    ("cached", dict(znorm_cache=False), ValueError, "CACHED_GRAD"),
    ("act_ctrl", dict(znorm_cache=False), ValueError, "controllers"),
    ("ctrl", dict(budget_stats=False), ValueError, "budget_stats"),
    ("plain", dict(budget_stats=True, znorm_cache=False), ValueError,
     "needs the znorm cache"),
    ("plain", dict(batch_size=4, microbatches=3), ValueError, "microbatches"),
    ("plain", dict(lr_schedule="nope"), ValueError, "lr_schedule"),
    ("plain", dict(checkpoint_every=5), ValueError, "checkpoint_dir"),
    ("plain", dict(batch_size=64), ValueError, "n_samples"),
    ("plain", dict(mesh="pod"), ValueError, "unknown mesh"),
    ("plain", dict(steps=0), ValueError, "steps"),
    ("plain", dict(prefill_chunk=0), ValueError, "prefill_chunk"),
]


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
@pytest.mark.parametrize("kind,kw,error,match", REFUSED,
                         ids=[m for *_, m in REFUSED])
def test_runspec_refuses_footguns_at_construction(pkg, kind, kw, error,
                                                  match):
    with pytest.raises(error, match=match):
        _spec(pkg, _policy(pkg, kind), **kw)


@pytest.mark.parametrize("kind,kw,cache,stats", [
    ("plain", {}, False, False), ("cached", {}, True, False),
    ("ctrl", {}, True, True), ("act_ctrl", {}, True, True),
    ("plain", dict(znorm_cache=True), True, False)])
def test_wiring_derived_from_policy_as_in_the_reference(kind, kw, cache,
                                                        stats):
    for pkg in (JAX, PORT):
        s = _spec(pkg, _policy(pkg, kind), **kw)
        assert (s.use_znorm_cache, s.track_budget_stats) == (cache, stats)
    assert _spec(PORT, _policy(PORT, kind)).requirements() == \
        _spec(JAX, _policy(JAX, kind)).requirements()


@pytest.mark.parametrize("kw", [
    dict(mesh="host"), dict(model_parallel=2), dict(data_axes=("data",))],
    ids=["mesh_host", "model_parallel", "data_axes"])
def test_unported_fields_raise_not_implemented(kw):
    """``mesh="host"``, ``model_parallel`` and ``data_axes`` are accepted
    (tensor / expert parallelism runs in ``tests/test_torch_tp.py``).
    Without a process group a host mesh is one rank: its Run equals the
    plain Run bit for bit, and ``model_parallel=2`` does not divide it —
    nor runs without ``mesh="host"``."""
    if "model_parallel" in kw:
        spec = _spec(PORT, _policy(PORT, "plain"), **kw)
        assert spec.model_parallel == _spec(
            JAX, _policy(JAX, "plain"), **kw).model_parallel == 2
        with pytest.raises(ValueError, match="needs mesh='host'"):
            Run(spec, **CPU)
        with pytest.raises(ValueError, match="does not divide"):
            Run(_spec(PORT, _policy(PORT, "plain"), mesh="host", **kw),
                **CPU)
        return
    runs = [Run(_spec(PORT, _policy(PORT, "cached"), steps=3, **extra),
                **CPU) for extra in (kw, {})]
    for run in runs:
        run.fit()
    (a, b) = runs
    assert (a.mesh is not None) == ("mesh" in kw)
    assert a.history == b.history
    for x, y in zip(optim.tree_leaves(a.state["params"]),
                    optim.tree_leaves(b.state["params"])):
        assert torch.equal(x, y)
    for t in b.state["znorm"]:
        assert torch.equal(a.state["znorm"][t], b.state["znorm"][t])


def test_spec_fields_are_the_reference_fields_but_jit():
    ours = {f.name: f.default for f in dataclasses.fields(RunSpec)}
    theirs = {f.name: f.default for f in dataclasses.fields(jax_api.RunSpec)}
    assert set(theirs) - set(ours) == {"jit"} and set(ours) <= set(theirs)
    for name in ("reduced", "seed", "steps", "batch_size", "microbatches",
                 "lr", "lr_schedule", "warmup", "znorm_cache",
                 "budget_stats", "checkpoint_dir", "checkpoint_every",
                 "checkpoint_keep", "mesh", "model_parallel", "data_axes",
                 "prefill_chunk"):
        assert ours[name] == theirs[name], name
    assert dataclasses.asdict(DataSpec()) == \
        dataclasses.asdict(jax_api.DataSpec())
    sched, ref = RunSpec(arch=ARCH, lr_schedule="wsd", steps=50) \
        .make_lr_schedule(), jax_api.RunSpec(arch=ARCH, lr_schedule="wsd",
                                             steps=50).make_lr_schedule()
    np.testing.assert_allclose([sched(s) for s in range(50)],
                               [float(ref(jnp.asarray(s))) for s in range(50)],
                               rtol=1e-6)


def test_run_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Run(_spec(PORT, _policy(PORT, "plain")))
    # the dry run needs no card: it traces one rank on the meta device
    run = Run(_spec(PORT, _policy(PORT, "plain")), **CPU)
    rec = run.dryrun(shape="decode_32k")
    assert rec["status"] == "ok" and rec["memory"]["argument_bytes"] > 0
    assert "## §Roofline" in run.report()


def test_kernel_config_reaches_every_resolved_config():
    pol = cm.Policy(rules=PolicyRules.of(
        ("*attn_o", WTACRSConfig(kind="exact")), ("*mlp*", {"budget": 0.1}),
        default=WTACRSConfig(budget=0.2)))
    run = Run(_spec(PORT, pol, kernel=KernelConfig(dw_tile=64)), **CPU)
    for tag in ("layers_0/attn_o", "layers_0/mlp_wi", "layers_1/attn_q"):
        assert run.policy.config_for(tag).kernel.dw_tile == 64, tag
    assert run.policy.config_for("x/mlp_wo").budget == 0.1
    assert pol.config_for("x/mlp_wo").kernel.dw_tile is None


# ---------------------------------------------------------------------------
# (b) the façade is sugar: bit-equal to the hand-wired scheduled step
# ---------------------------------------------------------------------------

def _hand_wired_losses(spec, policy, use_cache):
    run = Run(spec, **CPU)        # only for its config and dataset
    tags = (znorm.collect_linear_tags(run.cfg, policy=policy)
            if use_cache else None)
    state = train_steps.init_train_state(
        run.cfg, spec.seed, znorm_tags=tags,
        n_dataset=spec.data.n_samples, **CPU)
    step = train_steps.make_scheduled_train_step(
        run.cfg, policy, spec.optimizer, spec.make_lr_schedule(),
        use_znorm_cache=use_cache, microbatches=1, **CPU)
    losses = []
    for s in range(spec.steps):
        b = run.dataset.batch_at(s, spec.batch_size)
        if not use_cache:
            b.pop("sample_ids")
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("kind,use_cache", [("plain", False),
                                            ("cached", True)])
def test_fit_loss_trace_bit_matches_the_hand_wired_loop(kind, use_cache):
    pol = _policy(PORT, kind)
    spec = _spec(PORT, pol)
    run = Run(spec, **CPU)
    run.fit()
    assert run.use_znorm_cache == use_cache
    assert [h["loss"] for h in run.history] == \
        _hand_wired_losses(spec, pol, use_cache)
    assert [h["step"] for h in run.history] == list(range(spec.steps))


def test_fit_refuses_a_dataset_larger_than_the_cache():
    run = Run(_spec(PORT, _policy(PORT, "cached")), **CPU)
    big = DataSpec(seq_len=16, n_samples=64).build(run.cfg)
    with pytest.raises(ValueError, match="n_samples"):
        run.fit(dataset=big)
    # without a cache any corpus will do
    plain = Run(_spec(PORT, _policy(PORT, "plain"), steps=1), **CPU)
    assert len(plain.fit(dataset=big)) == 1


# ---------------------------------------------------------------------------
# (c) Run.fit against the JAX package's Run.fit (det_topk, same params)
# ---------------------------------------------------------------------------

PARITY = dict(steps=3, batch_size=4, lr=1e-3, warmup=2)


def _parity_runs(kind):
    """Both packages' Run on the same parameters (the JAX Run's, gains
    redrawn), f32 compute, ``det_topk``: no random draw, so the two runs
    build the same plans.  The JAX Run's parameters go into the port's by
    ``copy_`` (both optimizers start from zero moments)."""
    jrun = jax_api.Run(_spec(JAX, _policy(JAX, kind, "det_topk"),
                             data=JAX.DataSpec(seq_len=32, n_samples=8),
                             **PARITY))
    trun = Run(_spec(PORT, _policy(PORT, kind, "det_topk"),
                     data=DataSpec(seq_len=32, n_samples=8), **PARITY),
               **CPU)
    for run in (jrun, trun):
        run.cfg = dataclasses.replace(run.cfg, compute_dtype="float32")
        run.init()
    rng = np.random.RandomState(0)

    def redraw(path, a):
        a = np.array(a)
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, jrun.state["params"])
    jrun.state = dict(jrun.state, params=jax.tree.map(jnp.asarray, tree))
    carried = convert.params_from_jax(trun.cfg, tree, **CPU)
    with torch.no_grad():
        for dst, src in zip(optim.tree_leaves(trun.state["params"]),
                            optim.tree_leaves(carried)):
            dst.copy_(src)
    jrun.fit()
    trun.fit()
    return jrun, trun


@pytest.fixture(scope="module")
def parity_plain():
    return _parity_runs("plain")


@pytest.fixture(scope="module")
def parity_ctrl():
    return _parity_runs("ctrl")


@pytest.mark.parametrize("which", ["plain", "ctrl"])
def test_fit_matches_the_jax_run(which, request):
    jrun, trun = request.getfixturevalue(f"parity_{which}")
    # f32 on both sides, the same plans: only summation orders differ
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in trun.history],
                                   [h[key] for h in jrun.history],
                                   rtol=1e-4)
    got = convert.params_to_numpy(trun.cfg, trun.state["params"])
    want = jax.tree.map(np.asarray, jrun.state["params"])
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert trun.state["step"] == int(jrun.state["step"]) == 3
    assert trun.tags == jrun.tags


def test_budget_trajectory_equals_the_jax_run(parity_ctrl):
    jrun, trun = parity_ctrl
    assert trun.schedule_state.trajectory == jrun.schedule_state.trajectory
    assert trun.step_fn.replans == jrun.step_fn.replans >= 1
    assert len(trun.step_fn.compiled) == len(jrun.step_fn.compiled)
    for t in trun.tags:
        np.testing.assert_allclose(
            trun.state["budget_stats"][t].numpy(),
            np.asarray(jrun.state["budget_stats"][t]), rtol=1e-4, atol=1e-6)
    # the budget section of the report is the reference's, character for
    # character (the §Run line prints losses, which agree to 1e-4 only)
    assert report.budget_report(trun.schedule_state.trajectory, 3, 2) == \
        jax_report.budget_report(jrun.schedule_state.trajectory, 3, 2)


# ---------------------------------------------------------------------------
# (d) (e) kill and resume
# ---------------------------------------------------------------------------

@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("block", [True, False])
def test_kill_resume_is_bit_faithful_and_trajectory_continues(
        block, tmp_path, deterministic):
    """A controller-carrying run killed after 3 steps and resumed through
    ``Run.restore`` reproduces the uninterrupted run: params, opt, znorm
    and budget_stats bit-equal, metrics history equal, and the budget
    trajectory CONTINUED from the restored band position."""
    pol = _policy(PORT, "ctrl")
    base = dict(steps=6, batch_size=4)
    ref = Run(_spec(PORT, pol, **base), **CPU)
    ref.fit()
    changes = [r for r in ref.schedule_state.trajectory
               if r["prev"] is not None]
    assert changes, "controller never moved; test is vacuous"

    spec = _spec(PORT, pol, checkpoint_dir=str(tmp_path), **base)
    a = Run(spec, **CPU)
    a.fit(steps=3)
    a.save(block=block)
    a.fit(steps=4)          # the killed run went on; the checkpoint did not
    b = Run.restore(spec, step=3, **CPU)
    assert int(b.state["step"]) == 3 and len(b.history) == 3
    assert b.schedule_state.budgets == {
        i: next(r["budget"] for r in reversed(ref.schedule_state.trajectory)
                if r["rule"] == i and r["step"] < 3)
        for i in b.schedule_state.budgets}
    b.fit()
    assert b.schedule_state.trajectory == ref.schedule_state.trajectory
    assert b.history == ref.history
    want, got = checkpoint._flatten(ref.state), checkpoint._flatten(b.state)
    assert want[1] == got[1]                    # same keys, same dtypes
    for key, arr in want[0].items():
        assert np.array_equal(arr, got[0][key]), key


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    spec = _spec(PORT, _policy(PORT, "plain"),
                 checkpoint_dir=str(tmp_path / "none"))
    run = Run.resume(spec, **CPU)
    assert run.state is None and run.history == []
    with pytest.raises(FileNotFoundError):
        Run.restore(spec, **CPU)


def test_report_after_restore_covers_whole_run(tmp_path):
    spec = _spec(PORT, _policy(PORT, "ctrl"), steps=4,
                 checkpoint_dir=str(tmp_path), checkpoint_every=2)
    a = Run(spec, **CPU)
    a.fit(steps=2)                      # checkpoint_every wrote step 2
    b = Run.resume(spec, **CPU)
    assert int(b.state["step"]) == 2
    b.fit()
    rep = b.report()
    assert "4 steps" in rep and "§Budgets" in rep
    assert f"loss {a.history[0]['loss']:.4f}" in rep
    assert checkpoint.list_steps(str(tmp_path)) == [2, 4]


@pytest.mark.parametrize("layouts,error", [
    pytest.param(["bogus"], ValueError, id="layouts1-ValueError")])
def test_checkpoints_of_unported_optimizer_layouts_are_refused(
        layouts, error, tmp_path):
    """An unknown layout name, and a layout checkpoint under a legacy
    ``AdamWConfig``, are refused with the reference's errors."""
    spec = _spec(PORT, _policy(PORT, "plain"), checkpoint_dir=str(tmp_path))
    checkpoint.save(str(tmp_path), 1, {"x": torch.zeros(1)},
                    metadata=checkpoint.pack_run_state(
                        train_steps.ScheduleState().to_json(),
                        optim_layouts=layouts))
    with pytest.raises(error, match="layout"):
        Run.restore(spec, **CPU)
    checkpoint.save(str(tmp_path), 2, {"opt/leaves/w/m": torch.zeros(1)})
    with pytest.raises(ValueError, match="OptimSpec.from_adamw"):
        Run.restore(spec, **CPU)


# ---------------------------------------------------------------------------
# (f) microbatches keep one statistics update per optimizer step
# ---------------------------------------------------------------------------

def test_microbatches_keep_one_stats_update_per_step():
    """Controller warmup and EMA timing follow optimizer steps, not the
    microbatch (memory) knob: ONE statistics update a step, and after the
    first step (the same parameters on both sides) the same values up to
    float rounding — the stat atoms are normalized, and the taps (||dZ||)
    are exact whatever the plans."""
    runs = {}
    for m in (1, 2):
        run = Run(_spec(PORT, _policy(PORT, "ctrl", warmup=10), steps=2,
                        microbatches=m), **CPU)
        run.fit(steps=1)
        runs[m] = run
    for t in runs[2].tags:
        np.testing.assert_allclose(
            runs[2].state["budget_stats"][t].numpy(),
            runs[1].state["budget_stats"][t].numpy(), rtol=1e-4, atol=1e-6)
    runs[2].fit()
    for t in runs[2].tags:
        assert float(runs[2].state["budget_stats"][t][znorm.STAT_COUNT]) \
            == 2.0, t


# ---------------------------------------------------------------------------
# serving through the façade
# ---------------------------------------------------------------------------

def test_serve_builds_its_spec_from_the_run():
    run = Run(_spec(PORT, _policy(PORT, "plain"), prefill_chunk=4), **CPU)
    sess = run.serve(max_slots=2, max_len=24)
    assert (sess.spec.arch, sess.spec.device, sess.spec.prefill_chunk,
            sess.spec.policy) == (ARCH, "cpu", 4, run.policy)
    prompt = [5, 9, 2, 7, 1, 3]
    h = sess.submit(prompt, max_new=5)
    sess.run_until_idle()
    # the pool's greedy tokens against Run.generate at the pool's shapes
    # need a batch of max_slots rows; a lone row at 6 + 5 tokens is held
    # against the solo route instead (tests/test_torch_serve.py)
    assert len(h.result(timeout=0)) == 5
    with pytest.raises(ValueError, match="not both"):
        run.serve(ServeSpec(arch=ARCH, device="cpu"), max_slots=2)


def test_generate_greedy_and_sampled_are_repeatable():
    run = Run(_spec(PORT, _policy(PORT, "plain")), **CPU)
    prompts = np.asarray([[3, 14, 15, 9, 2], [7, 1, 8, 2, 8]], np.int32)
    g1, g2 = run.generate(prompts, 6), run.generate(prompts, 6)
    assert g1.shape == (2, 6) and g1.dtype == torch.int32
    assert torch.equal(g1, g2)
    s1 = run.generate(prompts, 6, temperature=0.9, seed=3, top_k=8)
    s2 = run.generate(prompts, 6, temperature=0.9, seed=3, top_k=8)
    assert torch.equal(s1, s2)
    # the prefill chunk never changes the tokens
    run.spec = dataclasses.replace(run.spec, prefill_chunk=3)
    assert torch.equal(run.generate(prompts, 6), g1)


def test_serving_a_fresh_run_allocates_no_train_state():
    """generate/serve before init() draw the parameters alone; a later
    init() adopts those same tensors, equal to a train state's own draw."""
    run = Run(_spec(PORT, _policy(PORT, "plain")), **CPU)
    prompts = np.asarray([[3, 14, 15, 9, 2]], np.int32)
    g = run.generate(prompts, 4)
    run.serve(max_slots=2, max_len=16)
    assert run.state is None
    served = optim.tree_leaves(run.params)
    run.init()
    trained = optim.tree_leaves(run.state["params"])
    assert all(a is b for a, b in zip(served, trained))
    fresh = Run(_spec(PORT, _policy(PORT, "plain")), **CPU).init()
    for a, b in zip(trained, optim.tree_leaves(fresh.state["params"])):
        assert torch.equal(a, b)        # bit-equal: the same seed's draw
    assert torch.equal(run.generate(prompts, 4), g)


# ---------------------------------------------------------------------------
# (j) report sections: the reference's text on the same records
# ---------------------------------------------------------------------------

TRAJ = [{"step": 0, "rule": 0, "pattern": "*mlp*", "budget": 0.3,
         "prev": None},
        {"step": 3, "rule": 0, "pattern": "*mlp*", "budget": 0.4,
         "prev": 0.30000000000000004},
        {"step": 5, "rule": 1, "pattern": "b1/*", "budget": 0.125,
         "prev": 0.25}]
RANKS = [{"step": 0, "rule": 0, "pattern": "*", "rank": 8, "prev": None},
         {"step": 4, "rule": 0, "pattern": "*", "rank": 16, "prev": 8}]
OPTIM = {"rows": [{"layout": "factored", "leaves": 4, "params": 4096,
                   "state_bytes": 1536, "dense_bytes": 32768},
                  {"layout": "dense", "leaves": 2, "params": 64,
                   "state_bytes": 512, "dense_bytes": 512}],
         "state_bytes": 2048, "dense_bytes": 33280, "ratio": 16.25}
HISTORY = [{"step": 0, "loss": 5.25, "lr": 1e-3},
           {"step": 1, "loss": 4.125}, {"step": 2, "lr": 2e-3},
           {"step": 3, "loss": 4.5}]
STEP_FN = types.SimpleNamespace(budget_trajectory=TRAJ,
                                compiled={(): None, (0.4,): None})
REPORTS = {
    "budget_trajectory_table": [(TRAJ,), ([],)],
    "budget_report": [(TRAJ, 6, 2), ([], 4, 1)],
    "budget_report_from_step_fn": [(STEP_FN, 6)],
    "rank_trajectory_table": [(RANKS,), ([],)],
    "optimizer_memory_report": [(OPTIM,), (OPTIM, RANKS)],
}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_report_text_equals_the_reference(name):
    for args in REPORTS[name]:
        assert getattr(report, name)(*args) == \
            getattr(jax_report, name)(*args)


@pytest.mark.parametrize("kw", [
    dict(n_steps=6, budget_records=TRAJ, n_compiles=2, history=HISTORY),
    dict(n_steps=0, budget_records=[], n_compiles=0),
    dict(n_steps=4, budget_records=[], n_compiles=1,
         history=[{"step": 0, "lr": 1.0}]),
    dict(n_steps=6, budget_records=TRAJ, n_compiles=2, history=HISTORY,
         optim_rec=OPTIM, rank_records=RANKS)])
def test_run_report_equals_the_reference(kw):
    assert report.run_report(**kw) == jax_report.run_report(**kw)


def test_run_report_optimizer_section_equals_the_reference():
    """``Run.report`` under an ``OptimSpec``: the §Optimizer memory section
    is the reference's text over the reference's memory record of the
    same spec and ranks, with the run's rank trajectory."""
    from repro import optim as jax_optim_lib
    from repro.configs import get_config as jax_get_config
    from repro.models import registry as jax_registry
    from repro_torch import optim as optim_lib

    def spec(pkg):
        return pkg.OptimSpec.of(
            dict(pattern="unit/*/attn/*", layout="lowrank",
                 schedule=pkg.RankSchedule.linear(8, 4, begin_step=1,
                                                  end_step=3, stages=2)),
            dict(pattern="embed*", layout="factored", momentum=False))
    run = Run(_spec(PORT, _policy(PORT, "plain"), optimizer=spec(optim_lib),
                    steps=3), **CPU)
    run.fit()
    st = run.schedule_state
    assert any(r["prev"] is not None for r in st.rank_trajectory)
    params, _ = jax_registry.abstract_params(jax_get_config(ARCH,
                                                            reduced=True))
    want = jax_report.optimizer_memory_report(
        jax_optim_lib.memory_report(spec(jax_optim_lib), params,
                                    ranks=st.ranks),
        rank_records=st.rank_trajectory)
    assert want in run.report()


def test_run_report_has_no_roofline_until_the_dry_run_is_ported():
    """A record that did not trace (skipped, error) adds no §Roofline; an
    ok one adds the reference's section with the H100's rates
    (``tests/test_torch_dryrun.py`` holds the text to the reference's)."""
    kw = dict(n_steps=1, budget_records=[], n_compiles=0)
    for rec in (None, {"status": "skipped"}, {"status": "error"}):
        assert "§Roofline" not in report.run_report(roofline_rec=rec, **kw)
    rec = {"arch": "a", "shape": "train_4k", "mesh": "single",
           "status": "ok", "kind": "train", "seq_len": 8,
           "global_batch": 2, "n_active_params": 10,
           "cost": {"flops": 989.4e12, "bytes_accessed": 3.35e12},
           "collectives": {"total_bytes": 450e9}}
    text = report.run_report(roofline_rec=rec, **kw)
    assert ("a x train_4k x single: compute 1.0000s | memory 1.0000s | "
            "collective 1.0000s") in text


# ---------------------------------------------------------------------------
# (k) LoRA: lora_linear against the reference, plan injected
# ---------------------------------------------------------------------------

def _lora_inputs(seed=0, b=2, s=32, d=64, e=48, r=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, d).astype(np.float32),
            (rng.randn(d, e) / 8).astype(np.float32),
            (rng.randn(d, r) / 2).astype(np.float32),
            (rng.randn(r, e) / 10).astype(np.float32),
            (np.abs(rng.randn(b, s)) + 0.1).astype(np.float32),
            rng.randn(b, s, e).astype(np.float32))


@pytest.mark.parametrize("norm_source", ["activation_only", "cached_grad"])
@pytest.mark.parametrize("kind", ["wta_crs", "det_topk"])
def test_lora_linear_matches_the_reference_with_injected_plan(kind,
                                                              norm_source):
    h, w, a, b, zn, ct = _lora_inputs()
    jcfg = JaxWTACRSConfig(kind=kind, budget=0.5, min_rows=4,
                           norm_source=norm_source)
    tcfg = WTACRSConfig(kind=kind, budget=0.5, min_rows=4,
                        norm_source=norm_source)
    lj, lt = jax_lora.LoRAConfig(rank=4, alpha=8.0, enabled=True), \
        LoRAConfig(rank=4, alpha=8.0, enabled=True)
    assert lt.scaling == lj.scaling == 2.0
    key = jax.random.PRNGKey(1)

    def f(ww, aa, bb):
        z = jax_lora.lora_linear(jnp.asarray(h), ww, aa, bb, lj, key=key,
                                 znorm=jnp.asarray(zn), cfg=jcfg)
        return jnp.sum(z * jnp.asarray(ct)), z

    (_, zj), (gw, ga, gb) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (w, a, b)))
    # the plan the reference's down-projection builds: its key folded by 1
    k = jcfg.budget_rows(h.shape[1])
    idx, scale = jax_linear._make_plans(
        jnp.asarray(h), jnp.asarray(zn),
        jax.random.key_data(jax.random.fold_in(key, 1)), jcfg, k)
    plan = (torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(scale)))
    tw, ta, tb = (torch.from_numpy(x.copy()).requires_grad_(True)
                  for x in (w, a, b))
    zt = lora.lora_linear(torch.from_numpy(h), tw, ta, tb, lt, key=7,
                          znorm=torch.from_numpy(zn), cfg=tcfg, plan=plan)
    (zt * torch.from_numpy(ct)).sum().backward()
    # the base is frozen: exactly no gradient reaches w, on both sides
    assert tw.grad is None and float(jnp.max(jnp.abs(gw))) == 0.0
    # f32, the same plan: summation orders differ only
    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(zj),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb),
                               rtol=1e-4, atol=1e-5)


def test_lora_zero_b_init_is_identity_and_ctx_dispatches_it():
    h, w, *_ = _lora_inputs(seed=1)
    p = lora.init_lora_params(0, 64, 48, 4, **CPU)
    assert p["lora_a"].shape == (64, 4) and not p["lora_b"].any()
    np.testing.assert_allclose(float(p["lora_a"].std()), 0.5, rtol=0.2)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    lcfg = LoRAConfig(rank=4, enabled=True)
    z = lora.lora_linear(th, tw, p["lora_a"], p["lora_b"], lcfg, key=1,
                         cfg=WTACRSConfig(budget=1.0))
    np.testing.assert_allclose(z.numpy(), (th @ tw).numpy(), rtol=2e-5,
                               atol=2e-5)
    lb = torch.ones(4, 48) / 10
    on = cm.Ctx(policy=cm.Policy(lora=lcfg), key=3)
    off = cm.Ctx(policy=cm.Policy(), key=3)
    want = lora.lora_linear(th, tw, p["lora_a"], lb, lcfg,
                            key=on._key_for("mlp_wi"), cfg=on.policy.wtacrs)
    got = on.linear("mlp_wi", th, tw, lora={"lora_a": p["lora_a"],
                                            "lora_b": lb})
    assert torch.equal(got, want)
    plain = off.linear("mlp_wi", th, tw, lora={"lora_a": p["lora_a"],
                                               "lora_b": lb})
    assert torch.equal(plain, off.linear("mlp_wi", th, tw))
    assert core.lora_linear is lora.lora_linear
