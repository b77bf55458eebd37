"""The port's optimizer-state layouts (``repro_torch.optim``) against the
JAX package's ``repro.optim`` on the same numpy inputs.

Specs, rules and ``RankSchedule``: the same constructions, the same
values, the same error classes and messages.  Layout state: the port's
parameters are one tensor a layer (``layers/<i>/mlp/wi``), its state the
reference's stacked slots (``unit/0/mlp/wi``, a leading ``n_repeats``
axis), so ``convert.opt_state_from_jax`` starts the port from the
reference's state and ``convert.opt_state_to_numpy`` compares them.
``update`` is held per layout at 1e-6 (f32 on both sides, summation
orders differ).  An SVD fixes each singular vector up
to its sign, which LAPACK builds do not share: low-rank parity is held on
the parameters, ``v`` and the captured energy, never on ``proj`` or
``m``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim_lib
from repro.configs import get_config as jax_get_config
from repro.core import controller as jax_ctrl
from repro.core import policy as jax_policy
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.launch import train_steps as jax_train_steps
from repro.models import common as jax_cm
from repro.models import registry as jax_registry
from repro.train import optim as jax_adamw
from repro_torch import convert
from repro_torch import optim as optim_lib
from repro_torch.core import RankController, RankSchedule, WTACRSConfig
from repro_torch.launch import train_steps
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.models.registry import get_config
from repro_torch.train import data
from repro_torch.train import optim as adamw

torch.set_num_threads(1)

ARCH = "qwen2.5-3b"
LR = 1e-2


def _specs(pkg):
    """The reference's benchmark specs (``benchmarks/bench_memory.py``),
    built from either package's ``optim``."""
    return {
        "dense_adamw": pkg.OptimSpec(),
        "factored_came": pkg.OptimSpec.of(
            dict(pattern="*", layout="factored", momentum=True)),
        "factored": pkg.OptimSpec.of(
            dict(pattern="*", layout="factored", momentum=False)),
        "lowrank@8": pkg.OptimSpec.of(
            dict(pattern="*", layout="lowrank", rank=8)),
        "mixed": pkg.OptimSpec.of(
            dict(pattern="unit/*", layout="lowrank", rank=8),
            dict(pattern="embed*", layout="factored", momentum=False)),
    }


SPEC_NAMES = list(_specs(optim_lib))


def _params(arch=ARCH, seed=0):
    """The reference's reduced parameters (numpy) and the port's copy."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype="float32")
    jparams, _ = jax_registry.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return tcfg, tree, convert.params_from_jax(tcfg, tree, device="cpu")


def _grads(tree, seed, scale=1e-2):
    """Gradients like ``tree`` (numpy), every matrix a product
    Q1 diag(s) Q2^T with well-separated singular values (an SVD of it is
    unique up to signs) and every vector Gaussian."""
    rng = np.random.RandomState(seed)

    def one(a):
        a = np.asarray(a)
        if a.ndim < 2:
            return (rng.randn(*a.shape) * scale).astype(np.float32)
        n, m = a.shape[-2:]
        k = min(n, m)
        out = np.empty(a.shape, np.float32)
        for idx in np.ndindex(*a.shape[:-2]):
            q1, _ = np.linalg.qr(rng.randn(n, k))
            q2, _ = np.linalg.qr(rng.randn(m, k))
            # neighbours 6 % apart at k = 64: the singular vectors are
            # determined to f32 precision over the gaps
            s = np.geomspace(1.0, 0.02, k)
            out[idx] = (q1 * s) @ q2.T * scale
        return out

    return jax.tree.map(one, tree)


def _port_grads(tcfg, gtree):
    """The reference-layout gradient tree as the port's list of leaves."""
    return adamw.tree_leaves(convert.params_from_jax(tcfg, gtree,
                                                     device="cpu"))


_JAX_UPDATE = jax.jit(jax_optim_lib.update, static_argnums=(4,))


def _jax_update(spec, state, params, grads):
    return _JAX_UPDATE(jax.tree.map(jnp.asarray, grads), state,
                       jax.tree.map(jnp.asarray, params),
                       jnp.asarray(LR, jnp.float32), spec)


def _assert_tree_close(got, want, what, **tol):
    fg = jax.tree_util.tree_leaves_with_path(got)
    fw = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, g), (_, w) in zip(fg, fw):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w),
            err_msg=f"{what} {jax.tree_util.keystr(path)}", **tol)


def _assert_state_close(got, want, rtol):
    """Every slot to ``rtol`` of its own scale (a moment that crosses zero
    has no relative precision there)."""
    fg = jax.tree_util.tree_leaves_with_path(got)
    fw = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (path, g), (_, w) in zip(fg, fw):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(
            np.asarray(g, np.float64), w, rtol=rtol,
            atol=rtol * float(np.abs(w).max(initial=0.0)),
            err_msg=f"state {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# spec, rules, schedules
# ---------------------------------------------------------------------------

def _both_raise(build):
    """``build(pkg)`` raises the same class with the same message in both
    packages."""
    errors = []
    for pkg in (jax_optim_lib, optim_lib):
        with pytest.raises((ValueError, TypeError)) as info:
            build(pkg)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("case", [
    "unknown_layout", "rank0", "refresh0", "schedule_and_controller",
    "schedule_on_factored", "controller_not_a_controller", "b1", "b3",
    "eps", "weight_decay", "as_spec_dict", "of_schedule_and_controller"])
def test_spec_validation_errors_equal_the_reference(case):
    def build(pkg):
        sched = pkg.RankSchedule.constant(8)
        ctrl = pkg.RankController()
        return {
            "unknown_layout": lambda: pkg.LayoutRule.of("*", "svd"),
            "rank0": lambda: pkg.LayoutRule(pattern="w*", layout="lowrank",
                                            rank=0),
            "refresh0": lambda: pkg.LayoutRule(pattern="w*",
                                               refresh_every=0),
            "schedule_and_controller": lambda: pkg.LayoutRule(
                pattern="*", layout="lowrank", schedule=sched,
                controller=ctrl),
            "schedule_on_factored": lambda: pkg.LayoutRule.of(
                "*", "factored", sched),
            "controller_not_a_controller": lambda: pkg.LayoutRule(
                pattern="*", layout="lowrank", controller=object()),
            "b1": lambda: pkg.OptimSpec(b1=1.5),
            "b3": lambda: pkg.OptimSpec(b3=0.0),
            "eps": lambda: pkg.OptimSpec(eps=0.0),
            "weight_decay": lambda: pkg.OptimSpec(weight_decay=-1.0),
            "as_spec_dict": lambda: pkg.as_spec({"lr": 1.0}),
            "of_schedule_and_controller": lambda: pkg.LayoutRule.of(
                "*", "lowrank", ctrl, controller=ctrl),
        }[case]()
    _both_raise(build)


def test_spec_resolution_and_rank_keys_equal_the_reference():
    def build(pkg):
        return pkg.OptimSpec.of(
            dict(pattern="unit/*/mlp/*", layout="lowrank", rank=6,
                 refresh_every=3),
            dict(pattern="unit/*/attn/*", layout="lowrank",
                 schedule=pkg.RankSchedule.linear(8, 4, begin_step=2,
                                                  end_step=8, stages=2)),
            dict(pattern="unit/*", layout="lowrank", rank=16,
                 controller=pkg.RankController(r_min=4, r_max=16,
                                               levels=4)),
            dict(pattern="embed*", layout="factored", momentum=False))
    j, t = build(jax_optim_lib), build(optim_lib)
    for path in ("unit/0/mlp/wi", "unit/0/attn/wq", "unit/0/norm1/gamma",
                 "embed", "final_norm/gamma", "head"):
        assert t.layout_for(path) == j.layout_for(path)
        assert t.resolve_with_index(path)[0] == j.resolve_with_index(path)[0]
    assert t.layouts_used() == j.layouts_used()
    assert t.all_dense == j.all_dense is False
    assert t.initial_ranks() == j.initial_ranks()
    assert t.dynamic_rule_indices() == j.dynamic_rule_indices()
    assert t.schedule_rule_indices() == j.schedule_rule_indices()
    assert t.controller_rule_indices() == j.controller_rule_indices()
    assert t.rank_stat_keys() == j.rank_stat_keys() == ("optim:rank:2",)
    assert optim_lib.is_rank_stat_key("optim:rank:2")
    assert not optim_lib.is_rank_stat_key("b0/mlp_wi")
    assert optim_lib.as_spec(adamw.AdamWConfig(weight_decay=0.1)) == \
        optim_lib.OptimSpec(weight_decay=0.1)
    assert optim_lib.KNOWN_LAYOUTS == jax_optim_lib.KNOWN_LAYOUTS


@pytest.mark.parametrize("kw", [
    dict(kind="constant", end=16),
    dict(kind="linear", start=32, end=8, begin_step=10, end_step=50),
    dict(kind="linear", start=2, end=1, begin_step=0, end_step=10,
         stages=3),
    dict(kind="linear", start=4, end=12, begin_step=5, end_step=9,
         stages=2)])
def test_rank_schedule_equals_the_reference(kw):
    j, t = jax_policy.RankSchedule(**kw), RankSchedule(**kw)
    for step in range(-1, 70):
        assert t.rank_at(step) == j.rank_at(step)
    if kw["kind"] == "linear":
        ranks = [t.rank_at(s) for s in range(kw["begin_step"],
                                             kw["end_step"] + 1)]
        assert len(set(ranks)) <= kw.get("stages", 4) + 1


@pytest.mark.parametrize("args", [(0,), (5, 3, 4, 4), (0, 3, 0, 9),
                                  (3, 0, 0, 9)], ids=str)
def test_rank_schedule_errors_equal_the_reference(args):
    def build(pkg):
        sched = pkg.RankSchedule
        return (sched.constant(*args) if len(args) == 1
                else sched.linear(*args))
    _both_raise(build)


# ---------------------------------------------------------------------------
# init, migration, legacy conversion, memory report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SPEC_NAMES + ["factored_came@unit"])
def test_init_shapes_through_the_stacked_paths(name):
    tcfg, tree, params = _params()

    def spec(pkg):
        if name == "factored_came@unit":
            return pkg.OptimSpec.of(dict(pattern="unit/*/mlp/*",
                                         layout="factored"))
        return _specs(pkg)[name]
    want = jax_optim_lib.init(spec(jax_optim_lib),
                              jax.tree.map(jnp.asarray, tree))
    got = optim_lib.init(spec(optim_lib), params)
    assert got["count"] == 0
    stacked = convert.opt_state_to_numpy(got)
    jax.tree.map(lambda a, b: (np.testing.assert_array_equal(a, b),
                               None)[1],
                 stacked, jax.tree.map(np.asarray, want))


def test_layouts_resolve_under_the_reference_path():
    _, _, params = _params()
    spec = optim_lib.OptimSpec.of(
        dict(pattern="unit/*/mlp/*", layout="lowrank", rank=4),
        dict(pattern="unit/*", layout="factored"))
    st = optim_lib.init(spec, params)
    assert optim_lib.layouts.reference_path("layers/1/mlp/wi") == \
        "unit/0/mlp/wi"
    assert optim_lib.layouts.reference_path("embed") == "embed"
    assert set(st["leaves"]["unit/0/mlp/wi"]) == {"proj", "m", "v"}
    assert st["leaves"]["unit/0/mlp/wi"]["proj"].shape == (2, 64, 4)
    assert set(st["leaves"]["unit/0/attn/wq"]) == {
        "m", "v_row", "v_col", "u_row", "u_col"}
    # a norm gain stacked over the layers is a matrix to the layouts
    assert st["leaves"]["unit/0/norm1/gamma"]["v_row"].shape == (2,)
    assert st["leaves"]["unit/0/norm1/gamma"]["v_col"].shape == (64,)
    assert set(st["leaves"]["embed"]) == {"m", "v"}


def test_migrate_ranks_pads_and_truncates_as_the_reference():
    tcfg, tree, params = _params()

    def spec(pkg):
        return pkg.OptimSpec.of(dict(
            pattern="unit/*", layout="lowrank", rank=4,
            controller=pkg.RankController(r_min=2, r_max=5, levels=4)))
    jspec, tspec = spec(jax_optim_lib), spec(optim_lib)
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jax_optim_lib.init(jspec, jp, ranks={0: 4})
    _, jst, _, _ = _jax_update(jspec, jst, tree, _grads(tree, 1))
    tst = convert.opt_state_from_jax(jax.tree.map(np.asarray, jst),
                                     device="cpu")
    for new in (2, 5, 3):
        jst = jax_optim_lib.migrate_ranks(jspec, jst, jp, {0: new})
        tst = optim_lib.migrate_ranks(tspec, tst, params, {0: new})
        # slicing and zero padding are exact
        _assert_tree_close(convert.opt_state_to_numpy(tst),
                           jax.tree.map(np.asarray, jst), f"rank {new}",
                           rtol=0, atol=0)
    assert tst["leaves"]["unit/0/mlp/wi"]["proj"].shape == (2, 64, 3)


def test_from_legacy_adamw_continues_bit_identically():
    _, tree, params = _params()
    p_old = adamw.tree_map(lambda t: t.clone(), params)
    st_old = adamw.adamw_init(p_old)
    cfg = adamw.AdamWConfig(weight_decay=0.01)
    adamw.adamw_update(_port_grads(get_config(ARCH, reduced=True),
                                   _grads(tree, 0)), st_old, p_old, LR, cfg)
    p_new = adamw.tree_map(lambda t: t.clone(), p_old)
    st_new = optim_lib.from_legacy_adamw(
        adamw.AdamWState(st_old.count, adamw.tree_map(torch.clone, st_old.m),
                         adamw.tree_map(torch.clone, st_old.v)), p_new)
    assert st_new["count"] == 1
    spec = optim_lib.OptimSpec.from_adamw(cfg)
    for seed in (1, 2):
        g = _port_grads(get_config(ARCH, reduced=True), _grads(tree, seed))
        adamw.adamw_update(g, st_old, p_old, LR, cfg)
        optim_lib.update(g, st_new, p_new, LR, spec)
    for a, b in zip(adamw.tree_leaves(p_old), adamw.tree_leaves(p_new)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "nemotron-4-15b",
                                  "granite-moe-1b-a400m", "dbrx-132b",
                                  "zamba2-2.7b", "xlstm-125m"])
@pytest.mark.parametrize("name", SPEC_NAMES)
def test_memory_report_equals_the_reference(arch, name):
    jparams, _ = jax_registry.abstract_params(jax_get_config(arch,
                                                             reduced=True))
    want = jax_optim_lib.memory_report(_specs(jax_optim_lib)[name], jparams)
    params = registry.init_params(get_config(arch, reduced=True), 0,
                                  device="meta")
    got = optim_lib.memory_report(_specs(optim_lib)[name], params)
    assert got == want
    assert optim_lib.dense_adamw_bytes(params) == \
        jax_optim_lib.dense_adamw_bytes(jparams)
    # the state init allocates is what the report counts
    cpu = registry.init_params(get_config(arch, reduced=True), 0,
                               device="cpu")
    assert optim_lib.tree_bytes(optim_lib.init(_specs(optim_lib)[name],
                                               cpu)) == got["state_bytes"]


# ---------------------------------------------------------------------------
# update, per layout
# ---------------------------------------------------------------------------

def _run_both(spec_of, steps, grads_of, jstate=None, ranks=None):
    """``steps`` updates of both packages from the same parameters (and
    the same state, when ``jstate`` is given); returns the reference's
    (params, state, energies) and the port's, stacked."""
    tcfg, tree, params = _params()
    jspec, tspec = spec_of(jax_optim_lib), spec_of(optim_lib)
    jp = jax.tree.map(jnp.asarray, tree)
    if jstate is None:
        jstate = jax_optim_lib.init(jspec, jp, ranks=ranks)
    tstate = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jstate), device="cpu")
    jen, ten = [], []
    for s in range(steps):
        g = grads_of(tree, s)
        jp, jstate, jm, je = _jax_update(jspec, jstate, jp, g)
        _, tstate, tm, te = optim_lib.update(_port_grads(tcfg, g), tstate,
                                             params, LR, tspec)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        jen.append({i: float(e) for i, e in je.items()})
        ten.append({i: float(e) for i, e in te.items()})
    return ((jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jstate),
             jen),
            (convert.params_to_numpy(tcfg, params),
             convert.opt_state_to_numpy(tstate), ten))


def test_dense_update_is_the_legacy_adamw_bit_for_bit_and_the_reference():
    _, tree, params = _params()
    tcfg = get_config(ARCH, reduced=True)
    cfg = adamw.AdamWConfig(weight_decay=0.01, grad_clip_norm=1.0)
    spec = optim_lib.OptimSpec(weight_decay=0.01, grad_clip_norm=1.0)
    p_old = adamw.tree_map(torch.clone, params)
    st_old, st_new = adamw.adamw_init(p_old), optim_lib.init(spec, params)
    for s in range(3):
        g = _port_grads(tcfg, _grads(tree, s, scale=1.0))
        _, _, m_old = adamw.adamw_update(g, st_old, p_old, LR, cfg)
        _, _, m_new, energy = optim_lib.update(g, st_new, params, LR, spec)
        assert torch.equal(m_new["grad_norm"], m_old["grad_norm"])
        assert energy == {}
        for a, b in zip(adamw.tree_leaves(p_old), adamw.tree_leaves(params)):
            assert torch.equal(a, b)
    (jp, js, _), (tp, ts, _) = _run_both(
        lambda pkg: pkg.OptimSpec(weight_decay=0.01, grad_clip_norm=1.0),
        3, lambda t, s: _grads(t, s, scale=1.0))
    # f32 on both sides
    _assert_tree_close(tp, jp, "params", rtol=1e-6, atol=1e-6)
    _assert_state_close(ts, js, rtol=1e-5)


# The reference takes the bias corrections 1 - b**t in f32, the port (as
# its legacy AdamW) in double: at the default b2 = 0.999 that is 2e-5
# relative at t = 2, which CAME's step (up to ~30 where the confidence
# EMA is small) carries into the parameters as up to 2e-6.  With
# b1 = b2 = 0.5 every 1 - b**t is exact in f32, and the layouts are held
# at 1e-6; at the defaults at 1e-5.
BETAS = {"exact_bias": (dict(b1=0.5, b2=0.5), 1e-6),
         "default_betas": (dict(), 1e-5)}


def test_reference_bias_correction_is_f32():
    bc2 = 1.0 - 0.999 ** jnp.float32(2)
    assert abs(float(bc2) / (1.0 - 0.999 ** 2) - 1) > 1e-5
    assert float(1.0 - 0.5 ** jnp.float32(3)) == 1.0 - 0.5 ** 3


@pytest.mark.parametrize("betas", list(BETAS))
@pytest.mark.parametrize("momentum", [True, False])
def test_factored_update_equals_the_reference(momentum, betas):
    hyper, atol = BETAS[betas]
    (jp, js, _), (tp, ts, _) = _run_both(
        lambda pkg: pkg.OptimSpec.of(
            dict(pattern="*", layout="factored", momentum=momentum),
            weight_decay=0.01, **hyper),
        3, _grads)
    # f32 on both sides (bias corrections: see BETAS)
    _assert_tree_close(tp, jp, "params", rtol=1e-6, atol=atol)
    _assert_state_close(ts, js, rtol=1e-5)


def _u_rms(g):
    """RMS of the factored layout's first normalized update of one layer
    (count 1: v_row, v_col are the squared gradient's means)."""
    g2 = g.astype(np.float64) ** 2
    row, col = g2.mean(-1), g2.mean(-2)
    vhat = (row / max(row.mean(), 1e-30))[:, None] * col[None, :]
    return float(np.sqrt(np.mean(g2 / (np.sqrt(vhat) + 1e-8) ** 2)))


def _clip_split_grads(tree, seed):
    """Gradients whose ``unit/0/mlp/wi`` layers have first factored
    updates of RMS on either side of 1: layer 0 additive in its squares
    (RMS < 1), layer 1 Gaussian with a few large entries (RMS > 1)."""
    g = _grads(tree, seed)
    rng = np.random.RandomState(100 + seed)
    wi = g["unit"][0]["mlp"]["wi"]
    n, m = wi.shape[-2:]
    x, y = rng.uniform(0, 10, n), rng.uniform(0, 10, m)
    wi[0] = (np.sqrt(x[:, None] + y[None, :]) * 1e-2
             * rng.choice([-1.0, 1.0], (n, m))).astype(np.float32)
    spiky = rng.randn(n, m) * 1e-2
    spiky[rng.rand(n, m) < 0.02] *= 30
    wi[1] = spiky.astype(np.float32)
    return g


@pytest.mark.parametrize("momentum", [True, False])
def test_factored_clip_is_taken_over_the_whole_stacked_leaf(momentum):
    """One layer of a stacked leaf above the clip threshold, the other
    below it: the reference clips both by the RMS of the whole leaf, so a
    per-layer RMS would give another update."""
    _, tree, _ = _params()
    for seed in (0, 1):
        wi = _clip_split_grads(tree, seed)["unit"][0]["mlp"]["wi"]
        rms = [_u_rms(wi[0]), _u_rms(wi[1])]
        whole = float(np.sqrt(np.mean(np.square(rms))))
        assert rms[0] < 1.0 < rms[1] and whole > 1.0, rms

    def spec(pkg):
        return pkg.OptimSpec.of(
            dict(pattern="*", layout="factored", momentum=momentum),
            **BETAS["exact_bias"][0])
    (jp, js, _), (tp, ts, _) = _run_both(spec, 2, _clip_split_grads)
    _assert_tree_close(tp, jp, "params", rtol=1e-6, atol=1e-6)
    _assert_state_close(ts, js, rtol=1e-5)
    # layer 0 as a leaf of its own: its own RMS (below the threshold) sets
    # no clip, and its two steps are not the stacked leaf's
    _, _, params = _params()
    alone = {"w": params["layers"][0]["mlp"]["wi"].clone()}
    st = optim_lib.init(spec(optim_lib), alone)
    for seed in (0, 1):
        g = _clip_split_grads(tree, seed)["unit"][0]["mlp"]["wi"][0]
        optim_lib.update([torch.from_numpy(g)], st, alone, LR,
                         spec(optim_lib))
    assert np.abs(alone["w"].numpy()
                  - jp["unit"][0]["mlp"]["wi"][0]).max() > 1e-4


@pytest.mark.parametrize("refresh_every", [1, 2])
def test_lowrank_update_equals_the_reference_up_to_svd_signs(refresh_every):
    """Refreshes at count 1 and, with refresh_every=2, at count 3 (the
    moments rotated into the new basis); energies reported per
    controller rule as one ratio over the stacked leaf, averaged over the
    rule's leaves."""
    def spec(pkg):
        return pkg.OptimSpec.of(
            dict(pattern="unit/*/mlp/*", layout="lowrank", rank=4,
                 refresh_every=refresh_every,
                 controller=pkg.RankController(r_min=2, r_max=8,
                                               levels=4)),
            dict(pattern="unit/*", layout="lowrank", rank=3,
                 refresh_every=refresh_every),
            weight_decay=0.01)
    (jp, js, je), (tp, ts, te) = _run_both(spec, 4, _grads,
                                           ranks={0: 4})
    _assert_tree_close(tp, jp, "params", rtol=1e-6, atol=1e-6)
    for path, slots in js["leaves"].items():
        # v is sign-invariant; |proj| columns match up to sign
        np.testing.assert_allclose(ts["leaves"][path]["v"], slots["v"],
                                   rtol=1e-4, atol=1e-12, err_msg=path)
        if "proj" in slots:
            np.testing.assert_allclose(
                np.abs(ts["leaves"][path]["proj"]), np.abs(slots["proj"]),
                atol=1e-5, err_msg=path)
    assert [set(e) for e in te] == [set(e) for e in je] == [{0}] * 4
    for a, b in zip(te, je):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
        assert 0.0 < a[0] <= 1.0 + 1e-6


def test_energy_is_one_ratio_over_the_stacked_leaf():
    """The captured energy of a stacked leaf is sum(|P^T g|^2) over its
    layers divided by sum(|g|^2) over its layers, not a mean of per-layer
    ratios; with layers of very different gradient norms the two differ."""
    def grads(tree, seed):
        # layer 0 Gaussian (a flat spectrum: little energy at rank 2),
        # layer 1 of decaying spectrum and 50x the norm
        g = _grads(tree, seed)
        wi = g["unit"][0]["mlp"]["wi"]
        wi[0] = np.random.RandomState(seed).randn(*wi[0].shape) * 1e-2
        wi[1] *= 50.0
        return g

    def spec(pkg):
        return pkg.OptimSpec.of(dict(
            pattern="unit/*/mlp/wi", layout="lowrank", rank=2,
            controller=pkg.RankController(r_min=2, r_max=8, levels=4)))
    (_, _, je), (_, ts, te) = _run_both(spec, 1, grads, ranks={0: 2})
    np.testing.assert_allclose(te[0][0], je[0][0], rtol=1e-6)
    _, tree, _ = _params()
    wi = grads(tree, 0)["unit"][0]["mlp"]["wi"].astype(np.float64)
    ratios = []
    for layer in wi:
        s = np.linalg.svd(layer, compute_uv=False)
        ratios.append(np.sum(s[:2] ** 2) / np.sum(s ** 2))
    assert abs(np.mean(ratios) - te[0][0]) > 1e-3


def test_rank_stats_ride_budget_stats_as_the_reference():
    def spec(pkg):
        return pkg.OptimSpec.of(dict(
            pattern="unit/*", layout="lowrank", rank=4,
            controller=pkg.RankController(r_min=2, r_max=8, levels=4)))
    jst = jax_optim_lib.init_rank_stats(spec(jax_optim_lib))
    tst = optim_lib.init_rank_stats(spec(optim_lib), device="cpu")
    assert list(tst) == list(jst) == ["optim:rank:0"]
    for e in (0.4, 0.9, 0.75):
        jst = jax_optim_lib.update_rank_stats(jst, {0: jnp.float32(e)})
        tst = optim_lib.update_rank_stats(tst, {0: torch.tensor(e)})
        np.testing.assert_allclose(tst["optim:rank:0"].numpy(),
                                   np.asarray(jst["optim:rank:0"]),
                                   rtol=1e-6)
    # a rule without a stats vector is left alone
    assert optim_lib.update_rank_stats({}, {3: torch.tensor(0.5)}) == {}
    assert jax_ctrl.TagStats.from_vector(
        np.asarray(jst["optim:rank:0"])).count == 3.0


# ---------------------------------------------------------------------------
# the train step under each spec, against the reference's
# ---------------------------------------------------------------------------

SEQ, BATCH, N_SAMPLES, WARMUP = 32, 4, 32, 2


def _train_states(arch, jspec, tspec):
    """Both packages' train state on the same parameters (the JAX
    initialiser's, norm gains redrawn from [0.5, 1.5] as in
    ``test_torch_train.py``: at gains of exactly 1 a top-k is decided by
    the last bit), each with its own zeroed layout state."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype="float32")
    jstate = jax_train_steps.init_train_state(jcfg, jax.random.PRNGKey(0),
                                              opt=jspec)
    rng = np.random.RandomState(0)

    def redraw(path, a):
        a = np.array(a)
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, jstate["params"])
    jstate = dict(jstate, params=jax.tree.map(jnp.asarray, tree))
    tstate = train_steps.init_train_state(
        tcfg, 0, device="cpu", opt=tspec,
        params=convert.params_from_jax(tcfg, tree, device="cpu"))
    return jcfg, tcfg, jstate, tstate


def _clip_between_layers(jcfg, jstate, policy, batch):
    """A clip threshold between the two layers' first factored-update RMS
    of the stacked leaf where they differ most (the step-1 gradient of the
    reference), so that exactly one of them crosses it there."""
    def loss(p):
        return jax_registry.loss_fn(jcfg, p, batch, policy)[0]
    grads = jax.jit(jax.grad(loss))(jstate["params"])
    best = None
    for path, g in jax.tree_util.tree_leaves_with_path(grads["unit"]):
        g = np.asarray(g)
        if g.ndim == 3:
            lo, hi = sorted(_u_rms(layer) for layer in g)
            if best is None or hi - lo > best[1] - best[0]:
                best = (lo, hi)
    threshold = 0.5 * (best[0] + best[1])
    assert best[0] < threshold < best[1], best
    return threshold


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "nemotron-4-15b",
                                  "granite-moe-1b-a400m"])
@pytest.mark.parametrize("name", SPEC_NAMES + ["factored@one_layer_clipped"])
def test_three_det_topk_steps_under_each_spec_match_reference(arch, name):
    """``make_train_step`` with an ``OptimSpec``, f32 compute,
    ``kind="det_topk"``: loss, grad norm and the updated parameters of
    three whole steps agree to 1e-4 (the legacy recipe's tolerance:
    gradients differ by summation order).  A near-tie in the sampling
    probabilities flips a top-k slot between the frameworks (ROADMAP
    Queue C): data seed 0 has one at the second step under lowrank@8 on
    qwen2.5-3b (the exact estimator agrees there to 5e-6), so the data
    seed is fixed to one where no spec meets one; the tolerance is not
    loosened for it."""
    wta = dict(kind="det_topk", budget=0.3, min_rows=4)
    jpol = jax_cm.Policy(wtacrs=JaxWTACRSConfig(**wta))
    ds = data.SyntheticLM(256, SEQ, N_SAMPLES, seed=1)
    hyper = {}
    if name == "factored@one_layer_clipped":
        jcfg, _, jstate, _ = _train_states(arch, None, None)
        hyper = dict(clip_threshold=_clip_between_layers(
            jcfg, jstate, jpol, ds.batch_at(0, BATCH)))

    def spec(pkg):
        if name == "factored@one_layer_clipped":
            return pkg.OptimSpec.of(
                dict(pattern="*", layout="factored", momentum=False),
                **hyper)
        return _specs(pkg)[name]
    jcfg, tcfg, jstate, tstate = _train_states(arch, spec(jax_optim_lib),
                                               spec(optim_lib))
    jstep = jax.jit(jax_train_steps.make_train_step(
        jcfg, jpol, spec(jax_optim_lib),
        jax_adamw.linear_warmup_constant(1e-3, WARMUP)))
    tstep = train_steps.make_train_step(
        tcfg, cm.Policy(wtacrs=WTACRSConfig(**wta)), spec(optim_lib),
        adamw.linear_warmup_constant(1e-3, WARMUP), device="cpu")
    for i in range(3):
        batch = ds.batch_at(i, BATCH)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        # f32 on both sides; only summation orders differ
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        _assert_tree_close(convert.params_to_numpy(tcfg, tstate["params"]),
                           jax.tree.map(np.asarray, jstate["params"]),
                           f"step {i}", rtol=1e-4, atol=1e-4)
    assert tstate["opt"]["count"] == 3 == int(jstate["opt"]["count"])
