"""``train/znorm.py`` of the port — Algorithm 1's gradient-norm cache and
the per-tag budget statistics — against the JAX package's on the same
numpy inputs: the tag list the cache is keyed by, the policy's
requirements and active tags, gather/scatter with the reference's
masking, and every statistics update (to 1e-6)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import controller as jax_ctrl
from repro.core import policy as jax_policy
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.models import common as jax_cm
from repro.train import znorm as jax_znorm
from repro_torch.core import ESSProportional, WTACRSConfig, policy
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models.registry import get_config
from repro_torch.train import znorm

torch.set_num_threads(1)

ARCHS = ["qwen2.5-3b", "minicpm-2b", "nemotron-4-15b", "command-r-35b"]
# zamba2's shared block carries the attention/MLP tags every policy names;
# the VLM adds vis_proj, the encoder-decoder's two stacks share their tags
TAG_ARCHS = ARCHS + ["zamba2-2.7b", "qwen2-vl-2b", "whisper-base"]


def _policies(pkg):
    """The same policies built from either package's classes."""
    if pkg == "jax":
        cfg_cls, pol_mod, ess, policy_cls = (
            JaxWTACRSConfig, jax_policy, jax_ctrl.ESSProportional,
            jax_cm.Policy)
    else:
        cfg_cls, pol_mod, ess, policy_cls = (
            WTACRSConfig, policy, ESSProportional, cm.Policy)
    cached = cfg_cls(kind="wta_crs", budget=0.3, min_rows=2,
                     norm_source="cached_grad")
    return {
        "none": None,
        "all_wta": policy_cls(wtacrs=cfg_cls(kind="wta_crs", budget=0.3)),
        "mlp_controller": policy_cls(rules=pol_mod.PolicyRules.of(
            pol_mod.Rule.of("*mlp*", cached,
                            ess(b_min=0.1, b_max=0.6, levels=6, warmup=2)))),
        "attn_o_exact": policy_cls(
            wtacrs=cfg_cls(kind="det_topk", budget=0.4, min_rows=2),
            rules=pol_mod.PolicyRules.of(
                ("*attn_o", cfg_cls(kind="exact")),
                pol_mod.Rule.of("*mlp_w?", cached,
                                pol_mod.BudgetSchedule.warmup_exact(
                                    begin_step=3, end=0.25)))),
    }


POLICY_NAMES = ["none", "all_wta", "mlp_controller", "attn_o_exact"]


@pytest.mark.parametrize("name", POLICY_NAMES)
@pytest.mark.parametrize("arch", TAG_ARCHS)
def test_collect_linear_tags_equals_the_reference(arch, name):
    """The cache keys: the token-dim sampled linears in trace order, less
    the exact-ruled ones — traced on the ``meta`` device, no storage."""
    want = jax_znorm.collect_linear_tags(
        jax_get_config(arch, reduced=True), policy=_policies("jax")[name])
    got = znorm.collect_linear_tags(get_config(arch, reduced=True),
                                    policy=_policies("torch")[name])
    assert got == want and got


@pytest.mark.parametrize("name", POLICY_NAMES[1:])
def test_policy_requirements_equal_the_reference(name):
    assert znorm.policy_requirements(_policies("torch")[name]) == \
        jax_znorm.policy_requirements(_policies("jax")[name])


@pytest.mark.parametrize("step", [0, 2, 3, 7])
def test_sampling_active_tags_equal_the_reference(step):
    tags = jax_znorm.collect_linear_tags(jax_get_config("qwen2.5-3b",
                                                        reduced=True))
    jp = _policies("jax")["attn_o_exact"].at_step(step)
    tp = _policies("torch")["attn_o_exact"].at_step(step)
    for seq in (None, 4, 16, 64):
        assert znorm.sampling_active_tags(tp, tags, seq_len=seq) == \
            jax_znorm.sampling_active_tags(jp, tags, seq_len=seq)


def _cache_case(seed, r=3, n=10, b=4):
    rng = np.random.RandomState(seed)
    tags = ["b0/attn_q", "b0/mlp_wi", "b1/mlp_wo"]
    cache = {t: rng.rand(r, n).astype(np.float32) + 0.5 for t in tags}
    ids = rng.choice(n, b, replace=False).astype(np.int32)
    taps = {t: (rng.rand(r, b) * 4).astype(np.float32) for t in tags}
    taps["b0/mlp_wi"][0, 1] = 0.0          # a genuine zero norm is written
    taps["b1/mlp_wo"][1, 0] = -1e-9        # rounding below 0 clamps to 0
    return tags, cache, ids, taps


@pytest.mark.parametrize("active", [None, ("b0/mlp_wi",),
                                    ("b0/attn_q", "b1/mlp_wo")])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_and_scatter_equal_the_reference(seed, active):
    """Inactive tags hold; active ones write sqrt(tap) verbatim; the
    caller's tensors are not modified."""
    tags, cache, ids, taps = _cache_case(seed)
    tc = {t: torch.from_numpy(c.copy()) for t, c in cache.items()}
    act = None if active is None else frozenset(active)
    got_g = znorm.gather(tc, torch.from_numpy(ids))
    want_g = jax_znorm.gather({t: jnp.asarray(c) for t, c in cache.items()},
                              jnp.asarray(ids))
    for t in tags:
        np.testing.assert_array_equal(got_g[t].numpy(), np.asarray(want_g[t]))
    got = znorm.scatter(tc, torch.from_numpy(ids),
                        {t: torch.from_numpy(x) for t, x in taps.items()},
                        active_tags=act)
    want = jax_znorm.scatter({t: jnp.asarray(c) for t, c in cache.items()},
                             jnp.asarray(ids),
                             {t: jnp.asarray(x) for t, x in taps.items()},
                             active_tags=act)
    for t in tags:
        # one f32 sqrt per entry on both sides
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(tc[t].numpy(), cache[t])
        if act is not None and t not in act:
            assert got[t] is tc[t]


def test_scatter_refuses_a_tap_that_is_not_per_sample():
    tags, cache, ids, taps = _cache_case(0)
    tc = {t: torch.from_numpy(c) for t, c in cache.items()}
    taps = {t: torch.from_numpy(x) for t, x in taps.items()}
    taps["b0/mlp_wi"] = torch.ones(7, 13)     # a rows-dim tap
    with pytest.raises(ValueError, match="n_repeats, batch"):
        znorm.scatter(tc, torch.from_numpy(ids), taps)
    # held when inactive: its tap is never read
    znorm.scatter(tc, torch.from_numpy(ids), taps,
                  active_tags=frozenset({"b0/attn_q"}))


def test_init_cache_and_stats_equal_the_reference():
    jcfg = jax_get_config("qwen2.5-3b", reduced=True)
    tcfg = get_config("qwen2.5-3b", reduced=True)
    tags = ["b0/mlp_wi", "b0/mlp_wo"]
    want = jax_znorm.init_cache(jcfg, tags, 6)
    got = znorm.init_cache(tcfg, tags, 6, device="cpu")
    ws, gs = jax_znorm.init_stats(tags), znorm.init_stats(tags, device="cpu")
    for t in tags:
        np.testing.assert_array_equal(got[t].numpy(), np.asarray(want[t]))
        np.testing.assert_array_equal(gs[t].numpy(), np.asarray(ws[t]))
    gs["b0/mlp_wi"][0] = 5.0                  # one tensor per tag
    assert float(gs["b0/mlp_wo"][0]) == 1.0
    assert (znorm.N_STATS, znorm.STAT_ESS, znorm.STAT_COND, znorm.STAT_UTIL,
            znorm.STAT_COUNT, znorm.STATS_DECAY) == \
        (jax_znorm.N_STATS, jax_znorm.STAT_ESS, jax_znorm.STAT_COND,
         jax_znorm.STAT_UTIL, jax_znorm.STAT_COUNT, jax_znorm.STATS_DECAY)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_update_stats_sequence_equals_the_reference(seed):
    """Six updates with another budget and active set each
    step: ESS, condition rate, utilization and count to 1e-6.  The first
    genuine update replaces the neutral init; held tags keep their count."""
    rng = np.random.RandomState(seed)
    tags = ["b0/mlp_wi", "b0/mlp_wo", "b1/mlp_wi"]
    js, ts = jax_znorm.init_stats(tags), znorm.init_stats(tags, device="cpu")
    r, b = 2, 4
    for i in range(6):
        taps = {}
        for t in tags:
            z = rng.rand(r, b).astype(np.float32)
            if rng.rand() < 0.5:
                z[0, 0] *= 20.0                       # one dominant atom
            if rng.rand() < 0.15:
                z[:] = 0.0                            # all-zero tap
            taps[t] = z * z
        budgets = {t: float(rng.choice([0.1, 0.25, 0.3, 0.6, 1.0]))
                   for t in tags}
        act = None if i == 0 else frozenset(
            t for t in tags if rng.rand() < 0.7)
        decay = 0.8 if seed % 2 else 0.5
        js = jax_znorm.update_stats(js, {t: jnp.asarray(x)
                                         for t, x in taps.items()},
                                    budgets, active_tags=act, decay=decay)
        prev = {t: v.clone() for t, v in ts.items()}
        ts = znorm.update_stats(ts, {t: torch.from_numpy(x)
                                     for t, x in taps.items()},
                                budgets, active_tags=act, decay=decay)
        for t in tags:
            # f32 sums of the same atoms in other orders
            np.testing.assert_allclose(ts[t].numpy(), np.asarray(js[t]),
                                       rtol=1e-6, atol=1e-6)
            if act is not None and t not in act:
                assert torch.equal(ts[t], prev[t])


def test_stat_vector_by_hand():
    """One dominant atom out of four (z = 10, 1, 1, 1), budget 0.5."""
    stats = znorm.update_stats(
        znorm.init_stats(["t"], device="cpu"),
        {"t": torch.tensor([[100.0, 1.0, 1.0, 1.0]])}, {"t": 0.5})
    v = stats["t"].numpy()
    assert v[znorm.STAT_ESS] == pytest.approx(169 / 412, rel=1e-6)
    assert v[znorm.STAT_COND] == 1.0
    assert v[znorm.STAT_UTIL] == pytest.approx(11 / 13, rel=1e-6)
    assert v[znorm.STAT_COUNT] == 1.0
    zero = znorm.update_stats(znorm.init_stats(["t"], device="cpu"),
                              {"t": torch.zeros(1, 4)}, {"t": 0.5})["t"]
    assert float(zero[znorm.STAT_ESS]) == pytest.approx(1.0)
    assert float(zero[znorm.STAT_UTIL]) == pytest.approx(0.5)


def test_stats_ignore_taps_that_are_not_their_keys():
    stats = znorm.init_stats(["a"], device="cpu")
    new = znorm.update_stats(stats, {"a": torch.ones(1, 4),
                                     "router": torch.full((7, 13), 1e9)},
                             {"a": 0.5})
    assert set(new) == {"a"}
    held = znorm.update_stats(znorm.init_stats(["a", "b"], device="cpu"),
                              {"a": torch.ones(1, 4)}, {"a": 0.5, "b": 0.5})
    assert float(held["b"][znorm.STAT_COUNT]) == 0.0


def test_collect_linear_tags_traces_on_meta_at_published_width(
        monkeypatch):
    """The tag trace takes parameters on the meta device: no second
    full-width parameter set is allocated, whatever the width."""
    made = []
    init = lm.init_params

    def recording(cfg, seed, device="cuda"):
        params = init(cfg, seed, device=device)
        made.extend(p.device.type for p in
                    torch.utils._pytree.tree_leaves(params))
        return params

    monkeypatch.setattr(lm, "init_params", recording)
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2)
    tags = znorm.collect_linear_tags(cfg)
    assert made and set(made) == {"meta"}
    assert tags[:7] == ["b0/attn_q", "b0/attn_k", "b0/attn_v", "b0/attn_o",
                        "b0/mlp_wi", "b0/mlp_wg", "b0/mlp_wo"]


@pytest.mark.parametrize("arch", ARCHS)
def test_trace_linears_records_every_call_with_its_tags(arch):
    """``.calls`` holds one tuple of tags per linear call, repeats
    included: the shared q/k/v and (SwiGLU) wi/wg calls as groups, in
    trace order, one block's four calls per layer."""
    cfg = get_config(arch, reduced=True)
    rec = znorm.trace_linears(cfg)
    assert len(rec.calls) == 4 * cfg.n_layers
    n_pat = len(cfg.pattern)
    for i in range(cfg.n_layers):
        j = i % n_pat
        up = ((f"b{j}/mlp_wi", f"b{j}/mlp_wg") if cfg.mlp_type == "swiglu"
              else (f"b{j}/mlp_wi",))
        assert rec.calls[4 * i:4 * i + 4] == [
            (f"b{j}/attn_q", f"b{j}/attn_k", f"b{j}/attn_v"),
            (f"b{j}/attn_o",), up, (f"b{j}/mlp_wo",)]
    assert list(dict.fromkeys(t for c in rec.calls for t in c)) == rec.tags


QKV = ("b0/attn_q", "b0/attn_k", "b0/attn_v")


@pytest.mark.parametrize("case,keyed,want", [
    ("all_wta", True, [QKV]),
    ("all_wta", False, [(t,) for t in QKV]),
    ("q_budget", True, [(t,) for t in QKV]),
    ("exact", True, [(t,) for t in QKV]),
])
def test_plan_groups_split_like_the_shared_linear(case, keyed, want,
                                                  monkeypatch):
    """One plan for a group only when every tag resolves to the same
    sampling config and a key is there; ``Ctx.linear_shared`` takes the
    shared path exactly then."""
    wta = WTACRSConfig(kind="wta_crs", budget=0.5, min_rows=2)
    pol = {"all_wta": cm.Policy(wtacrs=wta),
           "q_budget": cm.Policy(wtacrs=wta, rules=policy.PolicyRules.of(
               ("*attn_q", WTACRSConfig(kind="wta_crs", budget=0.25)))),
           "exact": cm.EXACT_POLICY}[case]
    assert cm.plan_groups(pol, QKV, keyed=keyed) == want
    routes = []
    monkeypatch.setattr(cm, "wtacrs_linear_shared",
                        lambda h, ws, **kw: routes.append("shared") or
                        tuple(h @ w for w in ws))
    monkeypatch.setattr(cm, "wtacrs_linear",
                        lambda h, w, **kw: routes.append("own") or h @ w)
    ctx = cm.Ctx(policy=pol, key=7 if keyed else None, tag_prefix="b0/")
    h = torch.ones((2, 8, 4))
    ctx.linear_shared(("attn_q", "attn_k", "attn_v"), h,
                      [torch.ones((4, 3))] * 3)
    assert routes == (["shared"] if len(want) == 1 else ["own"] * 3)
