"""The MoE slice of the port against the JAX package: the sort-based
capacity dispatch, the MoE layer's output, aux losses and gradients, the
expert-batched sampled linear and the expert axis of the dW kernel's plain
version, the remat legs, the tag trace, parameter conversion, the serving
pool and ``Run.fit`` on the reduced MoE configs.

Inputs are made from a seed with numpy and handed to both packages.  The
expert inputs of the layer tests are not RMS-normed, so their rows have
distinct lengths and ``det_topk`` plans are not decided by the last bit;
the whole-model tests redraw the norm gains from [0.5, 1.5] (ROADMAP
Queue C).  Router probabilities come from random weights and inputs: no
two of a token's probabilities are near-tied, so both packages route
every token to the same experts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.configs import get_config as jax_get_config
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.core.kernel_config import KernelConfig as JaxKernelConfig
from repro.kernels import ops as jax_ops
from repro.models import common as jax_cm
from repro.models import mlp as jax_mlp
from repro.models import registry as jax_registry
from repro.train import znorm as jax_znorm
from repro_torch import convert
from repro_torch.api import DataSpec, Run, RunSpec
from repro_torch.core import WTACRSConfig
from repro_torch.core import linear as lin
from repro_torch.kernels import fused_sampling, ops
from repro_torch.models import common as cm
from repro_torch.models import lm, mlp, registry
from repro_torch.models.registry import get_config
from repro_torch.serve import ServeSession, ServeSpec
from repro_torch.train import data, optim, znorm

from test_torch_serve import GENS, PROMPTS, alone_in_a_pool, \
    solo_in_pool_shapes

torch.set_num_threads(1)

MOE_ARCHS = ["granite-moe-1b-a400m", "dbrx-132b"]
CPU = dict(device="cpu")
DET = dict(kind="det_topk", budget=0.3, min_rows=4)


def _cfgs(arch="dbrx-132b", **change):
    """Both packages' reduced config, f32 compute, with ``change``."""
    change.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jax_get_config(arch, reduced=True), **change),
            dataclasses.replace(get_config(arch, reduced=True), **change))


def _moe_params(jcfg, seed=0):
    """The reference's MoE parameters (numpy) and the port's copy."""
    p = jax_cm.unbox(jax_mlp.init_moe(jcfg, jax.random.PRNGKey(seed),
                                      jnp.float32))[0]
    p = {k: np.asarray(v) for k, v in p.items()}
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _x(cfg, b, s, seed=1):
    return np.random.RandomState(seed).randn(b, s, cfg.d_model).astype(
        np.float32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [48, 5], ids=["ample", "tight"])
@pytest.mark.parametrize("seed", [0, 1])
def test_dispatch_group_equals_the_reference(cap, seed):
    """tok_of_slot, w_of_slot, occupied, keep and the gathered slots equal
    the reference's exactly (integer routing, gathers of the same
    values)."""
    e, k, t, d = 4, 2, 24, 8
    rng = np.random.RandomState(seed)
    x = rng.randn(t, d).astype(np.float32)
    probs = rng.dirichlet(np.ones(e), t).astype(np.float32)
    top_e = np.argsort(-probs, axis=1)[:, :k]
    top_p = np.take_along_axis(probs, top_e, 1)
    want = jax_mlp._dispatch_group(e, k, cap, jnp.asarray(x),
                                   jnp.asarray(top_p),
                                   jnp.asarray(top_e.astype(np.int32)))
    got = mlp._dispatch_group(e, k, cap, torch.from_numpy(x),
                              torch.from_numpy(top_p),
                              torch.from_numpy(top_e))
    names = ("xs", "tok_of_slot", "w_of_slot", "occupied", "keep")
    for name, w, g in zip(names, want, got):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    keep = got[4].numpy()
    assert keep.all() if cap == 48 else not keep.all()


def test_capacity_is_the_reference_formula():
    for arch in MOE_ARCHS:
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        for n in (1, 7, 2048, 4096):
            assert mlp.moe_capacity(tcfg, n) == jax_mlp.moe_capacity(jcfg, n)
    # the train phases' capacities (chip_smoke.py)
    assert mlp.moe_capacity(get_config("granite-moe-1b-a400m"), 4096) == 1280
    assert mlp.moe_capacity(get_config("dbrx-132b"), 2048) == 640


# ---------------------------------------------------------------------------
# the MoE layer: output, aux, gradients
# ---------------------------------------------------------------------------

MOE_CASES = [(8.0, 1, 2, 16), (0.5, 1, 2, 16), (1.0, 2, 2, 16),
             (0.5, 2, 2, 16), (1.25, 1, 5, 1)]
MOE_IDS = ["ample", "tight", "cf1-2groups", "tight-2groups", "decode"]


def _both_moe(cf, groups, b, s, estimator, key=True):
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    x = _x(jcfg, b, s)
    wcfg = dict(DET) if estimator == "det_topk" else dict(kind="exact")
    jctx = jax_cm.Ctx(policy=jax_cm.Policy(
        wtacrs=JaxWTACRSConfig(**wcfg), moe_groups=groups),
        key=jax.random.PRNGKey(3) if key else None,
        compute_dtype=jnp.float32)
    tctx = cm.Ctx(policy=cm.Policy(wtacrs=WTACRSConfig(**wcfg),
                                   moe_groups=groups),
                  key=3 if key else None, compute_dtype=torch.float32)
    return jcfg, tcfg, jp, tp, x, jctx, tctx


@pytest.mark.parametrize("cf,groups,b,s", MOE_CASES, ids=MOE_IDS)
def test_apply_moe_output_and_aux_match_jax(cf, groups, b, s):
    jcfg, tcfg, jp, tp, x, jctx, tctx = _both_moe(cf, groups, b, s,
                                                  "exact", key=False)
    jout, jaux = jax_mlp.apply_moe(jcfg, jp, jctx, jnp.asarray(x))
    with torch.no_grad():
        out, aux = mlp.apply_moe(tcfg, tp, tctx, torch.from_numpy(x))
    want = np.asarray(jout)
    # f32 on both sides, the same experts and slots: only the summation
    # order inside the products differs (1e-5 of the output's scale)
    np.testing.assert_allclose(_np(out), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(jaux["lb_loss"]), rtol=1e-5)
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"])
    # decode (S == 1) dispatches at capacity T: nothing drops
    assert (float(aux["drop_frac"]) > 0) == (s > 1 and cf <= 1.0)


@pytest.mark.parametrize("estimator", ["exact", "det_topk"])
@pytest.mark.parametrize("cf,groups,b,s", MOE_CASES[:4], ids=MOE_IDS[:4])
def test_moe_gradients_match_jax_grad(cf, groups, b, s, estimator):
    """Router, wi, wg, wo and the input: exact, and under ``det_topk``
    (the router sampled over the B*S rows, every expert over its capacity
    slots, the same plans in both packages); load-balancing loss
    included."""
    jcfg, tcfg, jp, tp, x, jctx, tctx = _both_moe(cf, groups, b, s,
                                                  estimator)
    r = np.random.RandomState(5).randn(*x.shape).astype(np.float32)

    def jloss(pp, xx):
        y, a = jax_mlp.apply_moe(jcfg, pp, jctx, xx)
        return jnp.sum(y * r) + a["lb_loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    for v in tp.values():
        v.requires_grad_(True)
    y, a = mlp.apply_moe(tcfg, tp, tctx, xt)
    loss = torch.sum(y * torch.from_numpy(r)) + a["lb_loss"]
    grads = torch.autograd.grad(loss, [*tp.values(), xt])
    # f32, the same routing and plans: summation order only (1e-5 of each
    # gradient's scale)
    for name, g in zip([*tp, "x"], grads):
        want = np.asarray(jgx if name == "x" else jg[name])
        np.testing.assert_allclose(_np(g), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
        assert np.abs(want).max() > 0, name


def _dense_moe_reference(cfg, p, x):
    """Every expert runs every token; combine with renormalised top-k (the
    port's version of ``tests/test_moe.py``'s dense reference)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    probs = torch.softmax(xf @ p["router"], dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    up = torch.einsum("td,edf->tef", xf, p["wi"])
    gate = torch.einsum("td,edf->tef", xf, p["wg"])
    y_all = torch.einsum("tef,efd->ted", torch.nn.functional.silu(gate) * up,
                         p["wo"])
    out = torch.zeros_like(xf)
    for j in range(cfg.moe_top_k):
        y = y_all[torch.arange(b * s), top_e[:, j]]
        out = out + top_p[:, j:j + 1] * y
    return out.reshape(b, s, d)


def _port_moe(capacity_factor):
    cfg = dataclasses.replace(get_config("dbrx-132b", reduced=True),
                              capacity_factor=capacity_factor,
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = mlp.init_moe(cfg, gen, torch.float32, "cpu")
    ctx = cm.Ctx(policy=cm.Policy(), compute_dtype=torch.float32)
    return cfg, p, ctx


def test_dispatch_matches_dense_reference_when_capacity_is_ample():
    cfg, p, ctx = _port_moe(8.0)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator(
    ).manual_seed(1))
    with torch.no_grad():
        got, aux = mlp.apply_moe(cfg, p, ctx, x)
        want = _dense_moe_reference(cfg, p, x)
    assert float(aux["drop_frac"]) == 0.0
    # the reference test's tolerance
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_tight_capacity_drops_tokens_but_stays_finite():
    cfg, p, ctx = _port_moe(0.5)
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator(
    ).manual_seed(0))
    with torch.no_grad():
        got, aux = mlp.apply_moe(cfg, p, ctx, x)
    assert float(aux["drop_frac"]) > 0.0
    assert bool(torch.isfinite(got).all())


def test_load_balance_loss_positive_and_grads_reach_every_group():
    cfg, p, ctx = _port_moe(8.0)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator(
    ).manual_seed(0))
    for v in p.values():
        v.requires_grad_(True)
    y, aux = mlp.apply_moe(cfg, p, ctx, x)
    assert float(aux["lb_loss"].detach()) > 0.0
    grads = torch.autograd.grad(torch.sum(y * y), list(p.values()))
    for name, g in zip(p, grads):
        assert float(g.abs().max()) > 0.0, name


def test_moe_groups_and_pspec_policy_fields():
    assert cm.Policy().moe_groups == jax_cm.Policy().moe_groups == 1
    # the reference's optimized dry run sets it; the port carries it
    # (its expert-parallel program is explicit, tests/test_torch_tp.py)
    spec = ("model", ("data",))
    assert cm.Policy(moe_pspec=spec).moe_pspec == \
        jax_cm.Policy(moe_pspec=spec).moe_pspec == spec
    with pytest.raises(ValueError, match="moe_groups"):
        cm.Policy(moe_groups=0)


def test_dispatch_runs_on_the_meta_device_without_a_host_sync():
    """Static shapes only: the whole layer runs on meta tensors (the tag
    trace's device), where any ``.item()`` or data-dependent shape
    raises."""
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    p = mlp.init_moe(cfg, None, torch.float32, "meta")
    ctx = cm.Ctx(policy=cm.Policy(moe_groups=2), compute_dtype=torch.float32)
    out, aux = mlp.apply_moe(cfg, p, ctx, torch.zeros(
        (2, 8, cfg.d_model), device="meta"))
    assert out.shape == (2, 8, cfg.d_model) and out.is_meta
    assert aux["lb_loss"].shape == () and aux["drop_frac"].shape == ()


def test_combine_sums_each_token_in_increasing_expert_order():
    """bf16: a token's k contributions are added from the first in
    increasing expert id, rounding after each add, as the reference's
    expert-major scatter-add does; the result is bit-equal to that sum
    written out and to the reference's bf16 layer."""
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    jp, tp = _moe_params(jcfg)
    x = _x(jcfg, 2, 16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ctx = cm.Ctx(policy=cm.Policy(), compute_dtype=torch.bfloat16)
    with torch.no_grad():
        out, _ = mlp.apply_moe(tcfg, tp, ctx, xb)
        xf = xb.reshape(-1, tcfg.d_model)
        probs = torch.softmax((xf @ tp["router"].to(torch.bfloat16)).float(),
                              -1)
        top_p, top_e = torch.topk(probs, tcfg.moe_top_k, -1)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        order = torch.argsort(top_e, -1)
        want = torch.zeros_like(xf)
        for j in range(tcfg.moe_top_k):
            ex = torch.gather(top_e, 1, order[:, j:j + 1])[:, 0]
            w = torch.gather(top_p, 1, order[:, j:j + 1])
            wi, wg, wo = (tp[n].to(torch.bfloat16)[ex]
                          for n in ("wi", "wg", "wo"))
            z = torch.nn.functional.silu(torch.bmm(xf[:, None], wg)) * \
                torch.bmm(xf[:, None], wi)
            y = torch.bmm(z, wo)[:, 0]
            want = want + y * w.to(torch.bfloat16)
    assert torch.equal(out.reshape(-1, tcfg.d_model), want)
    jout, _ = jax_mlp.apply_moe(
        jcfg, jp, jax_cm.Ctx(policy=jax_cm.Policy(),
                             compute_dtype=jnp.bfloat16),
        jnp.asarray(x, jnp.bfloat16))
    # bf16 GEMMs of two libraries round their intermediates (up, gate, z)
    # apart by an ulp, which reaches the output as about one bf16 ulp of
    # its scale: rtol 3e-2 (the reference's bf16 tolerance) and atol 1e-2
    # of the output's largest magnitude (a bf16 ulp is 2^-8 relative)
    want = np.asarray(jout, np.float32)
    np.testing.assert_allclose(_np(out), want, rtol=3e-2,
                               atol=1e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the expert-batched sampled linear and the dW kernel's expert axis
# ---------------------------------------------------------------------------

def _expert_inputs(e, c, d, f, seed=0, empty=0.4):
    """xs (E, C, D) with the trailing ``empty`` share of every expert's
    slots zero, as unoccupied capacity slots are, and stacked weights."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(e, c, d).astype(np.float32)
    xs[:, int(c * (1 - empty)):] = 0.0
    w = {"wi": rng.randn(e, d, f) / np.sqrt(d),
         "wg": rng.randn(e, d, f) / np.sqrt(d),
         "wo": rng.randn(e, f, d) / np.sqrt(f)}
    return xs, {k: v.astype(np.float32) for k, v in w.items()}


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("estimator", ["exact", "det_topk"])
def test_expert_ffn_gradients_match_the_reference_vmap(groups, estimator):
    """``_expert_ffn``: the reference's ``jax.vmap`` of per-expert
    ``wtacrs_linear_shared`` / ``wtacrs_linear`` against the port's two
    expert-batched linears, outputs and gradients of the input and all
    three stacked weights (f32, the same det_topk plans: 1e-5)."""
    e, c, d, f = 3, 40, 16, 24
    xs, w = _expert_inputs(e, c, d, f)
    jcfg, tcfg = _cfgs(d_model=d, d_ff=f, n_experts=e)
    wcfg = dict(DET) if estimator == "det_topk" else dict(kind="exact")
    jctx = jax_cm.Ctx(policy=jax_cm.Policy(wtacrs=JaxWTACRSConfig(**wcfg),
                                           moe_groups=groups),
                      key=jax.random.PRNGKey(0), compute_dtype=jnp.float32)
    tctx = cm.Ctx(policy=cm.Policy(wtacrs=WTACRSConfig(**wcfg),
                                   moe_groups=groups),
                  key=0, compute_dtype=torch.float32)
    r = np.random.RandomState(9).randn(e, c, d).astype(np.float32)

    def jloss(pp, xx):
        return jnp.sum(jax_mlp._expert_ffn(jcfg, pp, jctx, xx) * r)

    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jy = jax_mlp._expert_ffn(jcfg, jw, jctx, jnp.asarray(xs))
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jw, jnp.asarray(xs))
    tw = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in w.items()}
    xt = torch.from_numpy(xs.copy()).requires_grad_(True)
    y = mlp._expert_ffn(tcfg, tw, tctx, xt)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)),
                                [*tw.values(), xt])
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for name, g in zip([*tw, "x"], grads):
        want = np.asarray(jgx if name == "x" else jg[name])
        np.testing.assert_allclose(_np(g), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_expert_plans_never_choose_empty_slots_while_mass_remains():
    """Unoccupied capacity slots are zero rows (p = 0): a WTA-CRS plan
    draws its k rows from the occupied ones."""
    e, c, d = 4, 64, 16
    xs, _ = _expert_inputs(e, c, d, 8, empty=0.5)
    cfg = WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=4)
    stash = lin.RematStash()
    ws = (torch.zeros((e, d, 8)),)
    lin.expert_linear(torch.from_numpy(xs), ws, key=5, cfg=cfg, groups=2,
                      stash=stash)
    (h_sub, idx, scale), = stash.kept
    assert tuple(idx.shape) == (e * 2, cfg.budget_rows(c // 2))
    # group 0 of each expert holds the occupied rows 0..31, group 1 none:
    # an all-zero sample falls back to the uniform distribution
    assert bool((idx[0::2] < 32).all())
    assert float(h_sub[1::2].abs().max()) == 0.0


def test_expert_linear_exact_short_circuits_as_the_dense_linear():
    xs, w = _expert_inputs(2, 8, 4, 4)
    h = torch.from_numpy(xs)
    wi = torch.from_numpy(w["wi"])
    cfg = WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=8)
    stash = lin.RematStash()
    # budget_rows(8) == 8: the plain product, no plan
    out, = lin.expert_linear(h, (wi,), key=1, cfg=cfg, stash=stash)
    assert torch.equal(out, torch.bmm(h, wi)) and not stash.kept
    with pytest.raises(ValueError, match="sampling groups"):
        lin.expert_linear(h, (wi,), key=1, cfg=cfg, groups=3)


def _dw4(e, b, k, n, d_in, d_out, seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    hs = rng.randn(e, b, k, d_in).astype(np.float32)
    dz = rng.randn(e, b, n, d_out).astype(np.float32)
    idx = rng.randint(0, n, (e, b, k)).astype(np.int32)
    idx[..., 1] = idx[..., 0]                 # duplicate indices
    scale = (rng.rand(e, b, k) * 2 + 0.25).astype(np.float32)
    return hs, dz, idx, scale


@pytest.mark.parametrize("e,b,k,n,d_in,d_out", [
    (3, 2, 13, 40, 24, 16), (2, 1, 9, 20, 33, 17), (4, 2, 16, 32, 16, 48)])
def test_expert_axis_dw_matches_the_vmapped_pallas_kernel(e, b, k, n, d_in,
                                                          d_out):
    """The plain version of the expert axis against the reference's kernel
    under ``jax.vmap`` over the experts (one batched pallas_call, run by
    the interpreter), f32: the products agree, the f32 sums differ in
    order only (1e-4 as the kernel sweep)."""
    hs, dz, idx, scale = _dw4(e, b, k, n, d_in, d_out)
    got = ops.fused_sampled_dw(*map(torch.from_numpy, (hs, dz, idx, scale)))
    assert got.shape == (e, d_in, d_out) and got.dtype == torch.float32
    kcfg = JaxKernelConfig(backend="pallas", autotune=False, bm=d_in,
                           bn=d_out, bk=8)
    want = jax.vmap(lambda a, z, i, s: jax_ops.fused_sampled_dw(
        a, z, i, s, kernel=kcfg))(*map(jnp.asarray, (hs, dz, idx, scale)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_axis_of_one_is_the_plain_call_bit_for_bit(dtype):
    hs, dz, idx, scale = (torch.from_numpy(a) for a in
                          _dw4(1, 3, 11, 30, 20, 12))
    hs, dz = hs.to(dtype), dz.to(dtype)
    got = ops.fused_sampled_dw(hs, dz, idx, scale)
    want = ops.fused_sampled_dw(hs[0], dz[0], idx[0], scale[0])
    assert torch.equal(got[0], want)
    hs, dz, idx, scale = (torch.from_numpy(a) for a in
                          _dw4(3, 2, 7, 10, 8, 8, seed=1))
    whole = fused_sampling.fused_sampled_dw_plain(hs, dz, idx, scale)
    for i in range(3):
        assert torch.equal(whole[i], ops.fused_sampled_dw(
            hs[i], dz[i], idx[i], scale[i]))


@pytest.mark.parametrize("which,change", [
    (1, lambda t: t[0]),                       # rank mismatch
    (2, lambda t: t[:, :, :3]),                # plan shape
    (3, lambda t: t[:2]),                      # expert count
])
def test_expert_axis_wrapper_refuses_mismatched_operands(which, change):
    args = [torch.from_numpy(a) for a in _dw4(3, 2, 5, 8, 8, 8)]
    args[which] = change(args[which]).contiguous()
    with pytest.raises(ValueError):
        ops.fused_sampled_dw(*args)


def test_expert_dw_is_one_call_a_weight():
    """The backward of the two expert linears calls the dW wrapper once a
    weight (wi, wg, wo), each with the expert axis; the router, a dense
    sampled linear, once."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m",
                                         reduced=True),
                              compute_dtype="float32")
    p = mlp.init_moe(cfg, torch.Generator().manual_seed(0), torch.float32,
                     "cpu")
    ctx = cm.Ctx(policy=cm.Policy(wtacrs=WTACRSConfig(**DET)), key=1,
                 compute_dtype=torch.float32)
    calls = []
    real = ops.fused_sampled_dw

    def spy(hsub, *args, **kw):
        calls.append(tuple(hsub.shape))
        return real(hsub, *args, **kw)

    lin.kernel_ops.fused_sampled_dw = spy
    try:
        for v in p.values():
            v.requires_grad_(True)
        y, aux = mlp.apply_moe(cfg, p, ctx, torch.randn(
            (2, 16, cfg.d_model), generator=torch.Generator().manual_seed(2)))
        torch.autograd.grad(y.sum() + aux["lb_loss"], list(p.values()))
    finally:
        lin.kernel_ops.fused_sampled_dw = real
    cap = mlp.moe_capacity(cfg, 32)
    k = WTACRSConfig(**DET).budget_rows(cap)
    e = cfg.n_experts
    assert sorted(calls) == sorted([(e, 1, k, cfg.d_ff)]
                                   + [(e, 1, k, cfg.d_model)] * 2
                                   + [(1, WTACRSConfig(**DET).budget_rows(32),
                                       cfg.d_model)])


# ---------------------------------------------------------------------------
# whole model: remat, tags, conversion, losses
# ---------------------------------------------------------------------------

def _model(arch, compute_dtype="float32"):
    """The reference's reduced parameters, gains redrawn from [0.5, 1.5],
    and the port's copy."""
    jcfg, tcfg = _cfgs(arch, compute_dtype=compute_dtype)
    jparams, _ = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def redraw(path, a):
        a = np.array(a)
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, jparams)
    return jcfg, tcfg, tree, convert.params_from_jax(tcfg, tree, **CPU)


def _grads(cfg, params, batch, policy, key=7):
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, aux = lm.lm_loss(cfg, params, tb, policy, key=key)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), aux["lb_loss"].detach(), grads


@pytest.mark.parametrize("remat", ["full", "wtacrs_names"])
@pytest.mark.parametrize("kind", ["det_topk", "wta_crs"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_gradients_equal_none_bit_for_bit(arch, kind, remat):
    """The remat'd layer carries (h, lb_loss): loss, lb_loss and every
    gradient — the router's through the load-balancing loss included —
    bit-equal to ``"none"``, in f32 and bf16."""
    _, tcfg, _, params = _model(arch)
    batch = data.SyntheticLM(tcfg.vocab_size, 32, 8, seed=0).batch_at(0, 2)
    wcfg = WTACRSConfig(kind=kind, budget=0.3, min_rows=4)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(tcfg, compute_dtype=dtype)
        want = _grads(cfg, params, batch, cm.Policy(wtacrs=wcfg))
        got = _grads(cfg, params, batch, cm.Policy(wtacrs=wcfg, remat=remat))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert float(want[1]) > 0
        names = [n for n, _ in optim.named_leaves(params)]
        for name, a, b in zip(names, got[2], want[2]):
            assert torch.equal(a, b), name
        router = names.index("layers/0/moe/router")
        assert float(want[2][router].abs().max()) > 0


def test_lb_loss_reaches_the_router_under_remat():
    """Without the load-balancing term the router's gradient changes: the
    remat'd layer really back-propagates it."""
    _, tcfg, _, params = _model("granite-moe-1b-a400m")
    batch = data.SyntheticLM(tcfg.vocab_size, 16, 8, seed=0).batch_at(0, 2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    router = params["layers"][0]["moe"]["router"]
    router.requires_grad_(True)
    try:
        pol = cm.Policy(remat="full")
        loss, aux = lm.lm_loss(tcfg, params, tb, pol, key=1)
        g_all, = torch.autograd.grad(loss, [router])
        loss, aux = lm.lm_loss(tcfg, params, tb, pol, key=1)
        g_ce, = torch.autograd.grad(loss - 0.01 * aux["lb_loss"]
                                    / tcfg.n_layers, [router])
    finally:
        router.requires_grad_(False)
    assert float((g_all - g_ce).abs().max()) > 1e-6


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_carries_the_load_balancing_term_as_the_reference(arch):
    jcfg, tcfg, tree, params = _model(arch)
    batch = data.SyntheticLM(tcfg.vocab_size, 32, 8, seed=0).batch_at(0, 2)
    jloss, jaux = jax_registry.loss_fn(
        jcfg, jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax_cm.Policy())
    with torch.no_grad():
        loss, aux = registry.loss_fn(
            tcfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
            cm.Policy())
        logits, _ = registry.forward(
            tcfg, params, {"tokens": torch.from_numpy(batch["tokens"])},
            cm.Policy())
    # f32 on both sides: summation order only
    np.testing.assert_allclose(float(aux["lb_loss"]), float(jaux["lb_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(aux["ce_loss"]) == float(loss)     # as the reference's
    labels = torch.from_numpy(batch["labels"]).long()
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[
        -1]).float(), labels.reshape(-1))
    np.testing.assert_allclose(
        float(loss), float(ce + 0.01 * aux["lb_loss"] / tcfg.n_layers),
        rtol=1e-6)


POLICIES = {
    "all_wta": [("*", dict(kind="wta_crs", budget=0.3))],
    "router_exact": [("*moe_router", dict(kind="exact")),
                     ("*", dict(kind="wta_crs", budget=0.3))],
    "attn_o_exact": [("*attn_o", dict(kind="exact")),
                     ("*", dict(kind="wta_crs", budget=0.3))],
}


def _rules(pkg_cm, cfg_cls, rules_cls, name):
    return pkg_cm.Policy(rules=rules_cls.of(*[(g, cfg_cls(**c))
                                              for g, c in POLICIES[name]]))


@pytest.mark.parametrize("name", [None, *POLICIES])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_collect_linear_tags_equals_the_reference(arch, name):
    """The cache keys of an MoE arch: the attention linears; the rows-dim
    router and the experts (not ``Ctx.linear`` tags) stay out."""
    from repro.core.policy import PolicyRules as JaxRules
    from repro_torch.core.policy import PolicyRules
    jpol = tpol = None
    if name is not None:
        jpol = _rules(jax_cm, JaxWTACRSConfig, JaxRules, name)
        tpol = _rules(cm, WTACRSConfig, PolicyRules, name)
    want = jax_znorm.collect_linear_tags(jax_get_config(arch, reduced=True),
                                         policy=jpol)
    got = znorm.collect_linear_tags(get_config(arch, reduced=True),
                                    policy=tpol)
    assert got == want
    assert not any("moe" in t for t in got)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_trace_records_the_router_and_the_expert_plans(arch):
    cfg = get_config(arch, reduced=True)
    rec = znorm.trace_linears(cfg)
    assert rec.tags == ["b0/attn_q", "b0/attn_k", "b0/attn_v", "b0/attn_o",
                        "b0/moe_router"]
    assert rec.dims["b0/moe_router"] == cm.SAMPLED_DIM_ROWS
    assert rec.calls == [("b0/attn_q", "b0/attn_k", "b0/attn_v"),
                         ("b0/attn_o",), ("b0/moe_router",)] * cfg.n_layers
    assert rec.expert_calls == [("b0/moe_expert", (2, 1))] * cfg.n_layers


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_round_trip(arch):
    jcfg, tcfg, tree, params = _model(arch)
    layer = params["layers"][1]["moe"]
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(layer["router"].shape) == (d, e)
    assert tuple(layer["wi"].shape) == tuple(layer["wg"].shape) == (e, d, f)
    assert tuple(layer["wo"].shape) == (e, f, d)
    np.testing.assert_array_equal(layer["wo"].numpy(),
                                  np.asarray(tree["unit"][0]["moe"]["wo"])[1])
    back = convert.params_to_numpy(tcfg, params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_b] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_b, flat_t):
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    # the port's own initialiser: the reference's shapes and names
    mine = lm.init_params(tcfg, 0, **CPU)
    assert [(n, tuple(t.shape)) for n, t in optim.named_leaves(mine)] == \
        [(n, tuple(t.shape)) for n, t in optim.named_leaves(params)]


def test_expert_init_follows_the_reference_fan_in():
    """The reference's ``dense_init`` takes the fan-in from a weight's
    first axis, the expert count for the stacked (E, d, f) experts (ROADMAP
    Queue C): both packages draw them at std 1/sqrt(E), the router at
    0.02.  Sample stds (5.2e5 draws an expert stack, 8192 the router;
    seeded): within 2 %."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", d_model=256, d_ff=64,
                       n_experts=32)
    jp, _ = _moe_params(jcfg)
    tp = mlp.init_moe(tcfg, torch.Generator().manual_seed(0), torch.float32,
                      "cpu")
    for name, want in (("wi", 32 ** -0.5), ("wg", 32 ** -0.5),
                       ("wo", 32 ** -0.5), ("router", 0.02)):
        for got in (float(np.std(jp[name])), float(tp[name].std())):
            np.testing.assert_allclose(got, want, rtol=0.02, err_msg=name)


def test_configs_and_parameter_counts_equal_the_reference():
    for arch in MOE_ARCHS:
        j, t = jax_get_config(arch), get_config(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (t.n_params(), t.n_active_params()) == (j.n_params(),
                                                       j.n_active_params())
    g = get_config("granite-moe-1b-a400m")
    assert g.tie_embeddings and not get_config("dbrx-132b").tie_embeddings
    # n_params() counts the attention and expert matrices and the
    # embedding; the tensors add the routers and the norm gains
    assert g.n_params() == 1_333_791_744
    meta = lm.init_params(g, 0, device="meta")
    extra = g.n_layers * (g.d_model * g.n_experts + 2 * g.d_model) + g.d_model
    assert sum(p.numel() for p in optim.tree_leaves(meta)) == \
        1_333_791_744 + extra == 1_334_628_352


# ---------------------------------------------------------------------------
# serving and the façade
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite_params():
    return lm.init_params(get_config("granite-moe-1b-a400m", reduced=True),
                          0, **CPU)


def test_moe_archs_serve_and_pool_composition_is_independent(granite_params):
    """A token's capacity slot depends on its neighbours in the step; its
    result must not.  Every request through a churning pool equals itself
    served alone in a pool of the same spec and the solo route at the
    pool's shapes, bit for bit."""
    assert registry.serve_compatible(get_config("dbrx-132b")) == (True, "")
    spec = ServeSpec(arch="granite-moe-1b-a400m", max_slots=2, page_size=4,
                     max_len=16, prefill_chunk=3, device="cpu")
    sess = ServeSession(spec, granite_params)
    handles = [sess.submit(p, max_new=g) for p, g in zip(PROMPTS, GENS)]
    sess.run_until_idle()
    pooled = [h.result(timeout=0) for h in handles]
    assert pooled == [alone_in_a_pool(spec, granite_params, p, g)
                      for p, g in zip(PROMPTS, GENS)]
    assert pooled == [solo_in_pool_shapes(spec, granite_params, p, g)
                      for p, g in zip(PROMPTS, GENS)]
    assert [len(t) for t in pooled] == GENS


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_and_prefill_continue_the_forward_where_nothing_drops(arch):
    """At the published capacity factor 1.25 a forward over 24 tokens
    drops entries, decode (capacity = the batch) never does; at capacity
    factor E / top-k nothing drops in either, and a prefill of 8 tokens
    continued by 8 decode steps equals the teacher-forced forward (f32:
    summation order only, 1e-4)."""
    _, tcfg, _, params = _model(arch)
    cfg = dataclasses.replace(tcfg, capacity_factor=1.25)
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.moe_top_k)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int64))
    with torch.no_grad():
        x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator(
        ).manual_seed(0))
        ctx = cm.Ctx(policy=cm.Policy(), compute_dtype=torch.float32)
        assert float(mlp.apply_moe(cfg, params["layers"][0]["moe"], ctx,
                                   x)[1]["drop_frac"]) > 0
        assert float(mlp.apply_moe(nodrop, params["layers"][0]["moe"], ctx,
                                   x)[1]["drop_frac"]) == 0
        full, _ = lm.forward(nodrop, params, {"tokens": toks}, cm.Policy())
        last, states = lm.prefill(nodrop, params, {"tokens": toks[:, :8]},
                                  cm.Policy())
        states = tuple({n: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 8))
                        for n, v in st.items()} for st in states)
        outs = [last]
        for t in range(8, 15):
            lg, states = lm.decode_step(cfg, params, toks[:, t], t, states,
                                        cm.Policy())
            outs.append(lg)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full[:, 7:15]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_cached_loop_with_microbatches_matches_the_reference(microbatches):
    """Algorithm 1's loop on reduced granite: ``det_topk`` from the znorm
    cache (the attention linears' taps; the router and the experts keep
    none), microbatches 1 and 2 (each microbatch dispatches against its
    own capacity), three steps: loss and grad norm to 1e-4, the cache to
    1e-5, the parameters to 1e-4 (f32; summation orders only)."""
    from repro.launch import train_steps as jax_train_steps
    from repro.train import optim as jax_optim
    from repro_torch.launch import train_steps
    cached = dict(DET, norm_source="cached_grad")
    jpol = jax_cm.Policy(wtacrs=JaxWTACRSConfig(**cached))
    tpol = cm.Policy(wtacrs=WTACRSConfig(**cached))
    jcfg, tcfg, tree, params = _model("granite-moe-1b-a400m")
    tags = jax_znorm.collect_linear_tags(jcfg, policy=jpol)
    assert tags == znorm.collect_linear_tags(tcfg, policy=tpol)
    js = jax_train_steps.init_train_state(jcfg, jax.random.PRNGKey(0),
                                          znorm_tags=tags, n_dataset=8)
    js = dict(js, params=jax.tree.map(jnp.asarray, tree))
    ts = {"params": params, "opt": optim.adamw_init(params), "step": 0,
          "base_seed": 11}
    ts.update(convert.cache_from_jax(
        {"znorm": jax.tree.map(np.asarray, js["znorm"])}, **CPU))
    jstep = jax.jit(jax_train_steps.make_train_step(
        jcfg, jpol, jax_optim.AdamWConfig(),
        jax_optim.linear_warmup_constant(1e-3, 2), use_znorm_cache=True,
        microbatches=microbatches))
    tstep = train_steps.make_train_step(
        tcfg, tpol, optim.AdamWConfig(), optim.linear_warmup_constant(1e-3, 2),
        use_znorm_cache=True, microbatches=microbatches, **CPU)
    ds = data.SyntheticLM(tcfg.vocab_size, 32, 8, seed=0)
    for i in range(3):
        batch = ds.batch_at(i, 4)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        for t in tags:
            np.testing.assert_allclose(ts["znorm"][t].numpy(),
                                       np.asarray(js["znorm"][t]),
                                       rtol=1e-5, atol=1e-5, err_msg=t)
    got = convert.params_to_numpy(tcfg, ts["params"])
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(
                jax.tree.map(np.asarray, js["params"]))):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_scheduled_step_trajectory_matches_the_reference(arch):
    """The controller-driven scheduled step on an MoE arch: ``det_topk``
    from the cache on the attention linears under an ESSProportional
    controller (the router and the experts exact), six steps — the budget
    trajectory, re-plans and owned tags equal the reference's, the losses
    to 1e-4 (f32, the same plans)."""
    from repro.core import controller as jax_ctrl
    from repro.core import policy as jax_policy
    from repro.launch import train_steps as jax_train_steps
    from repro.train import optim as jax_optim
    from repro_torch.core import ESSProportional, PolicyRules, Rule
    from repro_torch.launch import train_steps
    cached = dict(DET, norm_source="cached_grad")
    ctrl = dict(b_min=0.1, b_max=0.6, levels=6, warmup=1)
    jpol = jax_cm.Policy(rules=jax_policy.PolicyRules.of(jax_policy.Rule.of(
        "*attn*", JaxWTACRSConfig(**cached),
        jax_ctrl.ESSProportional(**ctrl))))
    tpol = cm.Policy(rules=PolicyRules.of(Rule.of(
        "*attn*", WTACRSConfig(**cached), ESSProportional(**ctrl))))
    jcfg, tcfg, tree, params = _model(arch)
    tags = jax_znorm.collect_linear_tags(jcfg, policy=jpol)
    js = jax_train_steps.init_train_state(
        jcfg, jax.random.PRNGKey(0), znorm_tags=tags, n_dataset=8,
        budget_stats=True)
    js = dict(js, params=jax.tree.map(jnp.asarray, tree))
    ts = {"params": params, "opt": optim.adamw_init(params), "step": 0,
          "base_seed": 11}
    ts.update(convert.cache_from_jax(
        {n: jax.tree.map(np.asarray, js[n])
         for n in ("znorm", "budget_stats")}, **CPU))
    jstep = jax_train_steps.make_scheduled_train_step(
        jcfg, jpol, jax_optim.AdamWConfig(),
        jax_optim.linear_warmup_constant(1e-3, 2), use_znorm_cache=True)
    tstep = train_steps.make_scheduled_train_step(
        tcfg, tpol, optim.AdamWConfig(),
        optim.linear_warmup_constant(1e-3, 2), use_znorm_cache=True, **CPU)
    ds = data.SyntheticLM(tcfg.vocab_size, 32, 8, seed=0)
    jl, tl = [], []
    for i in range(6):
        batch = ds.batch_at(i, 4)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, batch)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert tstep.budget_trajectory == jstep.budget_trajectory
    assert tstep.replans == jstep.replans >= 1
    assert tstep.owned_tags == jstep.owned_tags
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_run_fit_on_reduced_granite_matches_the_jax_run():
    """``Run.fit`` of both packages on the same parameters (the JAX
    Run's, gains redrawn), f32 compute, ``det_topk`` on every linear —
    the router and the experts included: losses, grad norms and the
    parameters after three steps agree to 1e-4."""
    kw = dict(arch="granite-moe-1b-a400m", steps=3, batch_size=4, lr=1e-3,
              warmup=2)
    jrun = jax_api.Run(jax_api.RunSpec(
        policy=jax_cm.Policy(wtacrs=JaxWTACRSConfig(**DET)),
        data=jax_api.DataSpec(seq_len=32, n_samples=8), **kw))
    trun = Run(RunSpec(policy=cm.Policy(wtacrs=WTACRSConfig(**DET)),
                       data=DataSpec(seq_len=32, n_samples=8), **kw), **CPU)
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
    # f32 on both sides, the same plans: summation order only
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in trun.history],
                                   [h[key] for h in jrun.history],
                                   rtol=1e-4)
    got = convert.params_to_numpy(trun.cfg, trun.state["params"])
    want = jax.tree.map(np.asarray, jrun.state["params"])
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert trun.state["step"] == int(jrun.state["step"]) == 3
