"""The sampled linear of the port against the JAX package, with the plan
the JAX reference built injected into the port (random draws do not cross
frameworks): z, dh, dw and the gradient-norm tap — per-weight and shared,
with bias, 2-D input and the exact short-circuit — plus the paper's
memory claim: the full input is not among the saved tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear as jax_linear
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.core.kernel_config import KernelConfig as JaxKernelConfig
from repro_torch.core import linear
from repro_torch.core.config import EXACT_CONFIG, WTACRSConfig

torch.set_num_threads(1)

B, S, D, E = 3, 32, 32, 16
BUDGET = dict(budget=0.3, min_rows=4)
# f32 on both sides, same plan: only summation orders differ
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed=0, shape=(B, S, D), n_out=(E,)):
    rng = np.random.RandomState(seed)
    h = rng.randn(*shape).astype(np.float32)
    ws = [rng.randn(shape[-1], e).astype(np.float32) / 4 for e in n_out]
    zn = (np.abs(rng.randn(*shape[:-1])) + 0.1).astype(np.float32)
    cts = [rng.randn(*shape[:-1], e).astype(np.float32) for e in n_out]
    return h, ws, zn, cts


def _jax_plan(h, zn, key, cfg):
    """The (idx, scale) the reference's forward builds for this key."""
    h3 = jnp.asarray(h)[None] if h.ndim == 2 else jnp.asarray(h)
    zn3 = jnp.asarray(zn).reshape(h3.shape[:2])
    k = cfg.budget_rows(h3.shape[1])
    idx, scale = jax_linear._make_plans(h3, zn3, jax.random.key_data(key),
                                        cfg, k)
    return torch.from_numpy(np.array(idx)), \
        torch.from_numpy(np.array(scale))


def _torch_leaves(*arrays):
    return [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]


JAX_KERNELS = {
    "jnp": JaxKernelConfig(backend="jnp"),
    "pallas": JaxKernelConfig(backend="pallas", autotune=False, bm=16,
                              bn=16, bk=8, block_rows=16, block_d=32),
}


@pytest.mark.parametrize("norm_source", ["activation_only", "cached_grad"])
@pytest.mark.parametrize("kind", ["wta_crs", "crs", "det_topk"])
@pytest.mark.parametrize("jax_kernel", ["jnp", "pallas"])
def test_per_weight_linear_matches_with_injected_plan(jax_kernel, kind,
                                                      norm_source):
    h, (w,), zn, (ct,) = _inputs()
    bias = np.linspace(-1, 1, E).astype(np.float32)
    jcfg = JaxWTACRSConfig(kind=kind, norm_source=norm_source,
                           kernel=JAX_KERNELS[jax_kernel], **BUDGET)
    tcfg = WTACRSConfig(kind=kind, norm_source=norm_source, **BUDGET)
    key = jax.random.PRNGKey(3)

    def jloss(h_, w_, zn_, b_):
        z = jax_linear.wtacrs_linear(h_, w_, key=key, znorm=zn_, cfg=jcfg,
                                     bias=b_)
        return jnp.sum(z * ct), z

    (_, jz), (jdh, jdw, jtap, jdb) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (h, w, zn, bias)))

    th, tw, tzn, tb = _torch_leaves(h, w, zn, bias)
    z = linear.wtacrs_linear(th, tw, znorm=tzn, cfg=tcfg, bias=tb,
                             plan=_jax_plan(h, zn, key, jcfg))
    (z * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), **TOL)
    # the tap: squared row norms of dz, not a derivative
    np.testing.assert_allclose(tzn.grad.numpy(), np.asarray(jtap), **TOL)
    np.testing.assert_allclose(tzn.grad.numpy(), (ct ** 2).sum(-1), **TOL)
    np.testing.assert_allclose(
        linear.read_grad_norm_tap(tzn.grad).numpy(),
        np.asarray(jax_linear.read_grad_norm_tap(jtap)), **TOL)


def test_shared_linear_matches_with_injected_plan():
    h, ws, zn, cts = _inputs(1, n_out=(16, 8, 8))
    biases = [np.full(16, 0.5, np.float32), None, np.full(8, -1, np.float32)]
    jcfg = JaxWTACRSConfig(kind="wta_crs", **BUDGET)
    tcfg = WTACRSConfig(kind="wta_crs", **BUDGET)
    key = jax.random.PRNGKey(5)

    def jloss(h_, ws_, zn_):
        zs = jax_linear.wtacrs_linear_shared(
            h_, ws_, key=key, znorm=zn_, cfg=jcfg,
            biases=[None if b is None else jnp.asarray(b) for b in biases])
        return sum(jnp.sum(z * c) for z, c in zip(zs, cts)), zs

    (_, jzs), (jdh, jdws, jtap) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(h), [jnp.asarray(w) for w in ws], jnp.asarray(zn))

    th, tzn, *tws = _torch_leaves(h, zn, *ws)
    zs = linear.wtacrs_linear_shared(
        th, tws, znorm=tzn, cfg=tcfg,
        biases=[None if b is None else torch.from_numpy(b) for b in biases],
        plan=_jax_plan(h, zn, key, jcfg))
    sum((z * torch.from_numpy(c)).sum() for z, c in zip(zs, cts)).backward()
    for z, jz in zip(zs, jzs):
        np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), **TOL)
    # dh and the tap are summed over the weights
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(tzn.grad.numpy(), np.asarray(jtap), **TOL)
    for tw, jdw in zip(tws, jdws):
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                                   rtol=1e-4, atol=1e-4)


def test_2d_input_is_one_sample_of_n_rows():
    h, (w,), zn, (ct,) = _inputs(2, shape=(40, D))
    jcfg = JaxWTACRSConfig(kind="wta_crs", **BUDGET)
    tcfg = WTACRSConfig(kind="wta_crs", **BUDGET)
    key = jax.random.PRNGKey(7)
    jdw = jax.grad(lambda w_: jnp.sum(jax_linear.wtacrs_linear(
        jnp.asarray(h), w_, key=key, cfg=jcfg) * ct))(jnp.asarray(w))
    plan = _jax_plan(h, zn * 0 + 1, key, jcfg)
    assert plan[0].shape == (1, 12)
    th, tw = _torch_leaves(h, w)
    z = linear.wtacrs_linear(th, tw, cfg=tcfg, plan=plan)
    assert z.shape == (40, E)
    (z * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg_kwargs", [
    dict(kind="exact", budget=1.0),
    dict(kind="wta_crs", budget=0.3, min_rows=S),     # budget_rows(S) >= S
])
def test_exact_short_circuit(cfg_kwargs):
    h, (w,), zn, (ct,) = _inputs(3)
    jdh, jdw = jax.grad(lambda h_, w_: jnp.sum(jax_linear.wtacrs_linear(
        h_, w_, cfg=JaxWTACRSConfig(**cfg_kwargs)) * ct), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _torch_leaves(h, w)
    z = linear.wtacrs_linear(th, tw, cfg=WTACRSConfig(**cfg_kwargs))
    (z * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(),
                               np.einsum("bsd,bse->de", h, ct), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **TOL)


def test_own_plan_is_unbiased_for_dw():
    """Without an injected plan the port draws its own: the mean of dW
    over many keys approaches the exact H^T dZ."""
    h, (w,), _, (ct,) = _inputs(4)
    cfg = WTACRSConfig(kind="wta_crs", **BUDGET)
    th, tct = torch.from_numpy(h), torch.from_numpy(ct)
    acc = torch.zeros(D, E)
    n = 400
    for key in range(n):
        tw = torch.from_numpy(w.copy()).requires_grad_(True)
        (linear.wtacrs_linear(th, tw, key=key, cfg=cfg) * tct).sum().backward()
        acc += tw.grad
    exact = np.einsum("bsd,bse->de", h, ct)
    rel = np.linalg.norm(acc.numpy() / n - exact) / np.linalg.norm(exact)
    assert rel < 0.1, rel


def _saved_shapes(fn):
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return shapes, out


@pytest.mark.parametrize("shared", [False, True])
def test_full_input_is_not_among_the_saved_tensors(shared):
    h, ws, _, _ = _inputs(5, n_out=(16, 8))
    cfg = WTACRSConfig(kind="wta_crs", **BUDGET)
    k = cfg.budget_rows(S)
    th, *tws = _torch_leaves(h, *ws)

    def sampled():
        if shared:
            return linear.wtacrs_linear_shared(th, tws, key=1, cfg=cfg)
        return linear.wtacrs_linear(th, tws[0], key=1, cfg=cfg)

    shapes, _ = _saved_shapes(sampled)
    assert (B, S, D) not in shapes
    assert all(int(np.prod(sh)) < B * S * D for sh in shapes), shapes
    assert shapes.count((B, k, D)) == 1          # ONE stored H', also shared
    assert shapes.count((B, k)) == 2             # idx and scale
    # the hook does see a full input where one is saved: the exact path
    exact_shapes, _ = _saved_shapes(
        lambda: linear.wtacrs_linear(th, tws[0], cfg=EXACT_CONFIG))
    # (matmul saves it folded to (B*S, D))
    assert any(int(np.prod(sh)) == B * S * D for sh in exact_shapes)


def test_dispatch_errors():
    h, (w,), _, _ = _inputs(6)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    with pytest.raises(ValueError, match="requires a key"):
        linear.wtacrs_linear(th, tw, cfg=WTACRSConfig(**BUDGET))
    with pytest.raises(ValueError, match="injected plan"):
        linear.wtacrs_linear(
            th, tw, cfg=WTACRSConfig(**BUDGET),
            plan=(torch.zeros(B, 3, dtype=torch.int32), torch.ones(B, 3)))
    # det_topk needs no key
    z = linear.wtacrs_linear(th, tw, cfg=WTACRSConfig(kind="det_topk",
                                                      **BUDGET))
    assert z.shape == (B, S, E)
