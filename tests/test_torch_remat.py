"""Layer rematerialisation (``Policy.remat``) in the port: ``"full"`` keeps
a layer's input only, ``"wtacrs_names"`` also the sampled linears' kept
(H', idx, scale), the reference's ``wtacrs_saved`` names.  Both give the
gradients of ``"none"`` bit for bit on the CPU (the recompute runs the
same ops on the same inputs; a plan is redrawn from the same seed under
``"full"`` and taken back from the stash under ``"wtacrs_names"``), store
fewer saved-tensor bytes, and agree with the JAX package's remat'd
gradients at the whole-step tolerance."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.models import common as jax_cm
from repro.models import registry as jax_registry
from repro_torch import convert
from repro_torch.core import WTACRSConfig
from repro_torch.core import linear as lin
from repro_torch.launch import train_steps
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models.registry import get_config
from repro_torch.train import data, optim

torch.set_num_threads(1)

REMATS = ["full", "wtacrs_names"]


def _setup(arch="qwen2.5-3b", compute_dtype="float32", seq=32):
    """The reference's reduced parameters (norm gains redrawn from
    [0.5, 1.5]: top-k must not be decided by the last bit, see
    ``test_torch_train.py``), the port's copy and a batch."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype=compute_dtype)
    jparams, _ = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def redraw(path, a):
        a = np.array(a)
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, jparams)
    batch = data.SyntheticLM(tcfg.vocab_size, seq, 8, seed=0).batch_at(0, 2)
    return jcfg, tcfg, tree, convert.params_from_jax(tcfg, tree,
                                                     device="cpu"), batch


def _policy(kind, remat):
    return cm.Policy(wtacrs=WTACRSConfig(kind=kind, budget=0.3, min_rows=4),
                     remat=remat)


def _grads(tcfg, params, batch, policy, znorms=None, key=7):
    """(loss, gradients of every parameter, znorm taps)."""
    leaves = optim.tree_leaves(params)
    zn = ({t: z.clone().requires_grad_(True) for t, z in znorms.items()}
          if znorms else {})
    for p in leaves:
        p.requires_grad_(True)
    try:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, _ = lm.lm_loss(tcfg, params, tb, policy, key=key,
                             znorms=zn or None)
        grads = torch.autograd.grad(loss, leaves + list(zn.values()))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads[:len(leaves)], grads[len(leaves):]


def _znorms(tcfg, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return {t: torch.rand((tcfg.n_repeats, 2), generator=gen) + 0.5
            for t in ("b0/attn_q", "b0/mlp_wi", "b0/mlp_wo")}


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "nemotron-4-15b"])
@pytest.mark.parametrize("kind", ["det_topk", "wta_crs"])
@pytest.mark.parametrize("remat", REMATS)
def test_remat_gradients_equal_none_bit_for_bit(arch, kind, remat):
    """f32 and bf16 compute; the znorm taps through the recompute too."""
    _, tcfg, _, params, batch = _setup(arch)
    zn = _znorms(tcfg)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(tcfg, compute_dtype=dtype)
        want = _grads(cfg, params, batch, _policy(kind, "none"), zn)
        got = _grads(cfg, params, batch, _policy(kind, remat), zn)
        assert torch.equal(got[0], want[0])
        for part in (1, 2):
            assert len(got[part]) == len(want[part])
            for a, b in zip(got[part], want[part]):
                assert torch.equal(a, b)


def _saved_bytes(tcfg, params, batch, policy):
    """Bytes of the distinct storages autograd saves for the backward
    (``saved_tensors_hooks``), parameters and batch not counted — the
    port's ``saved_residuals`` audit (``tests/test_system.py``)."""
    leaves = optim.tree_leaves(params)
    skip = {p.untyped_storage().data_ptr() for p in leaves}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = st.nbytes()
        return t

    for p in leaves:
        p.requires_grad_(True)
    try:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            lm.lm_loss(tcfg, params, tb, policy, key=3)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return sum(seen.values())


def test_wtacrs_names_stores_fewer_activation_bytes():
    """WTA-CRS under names-remat stores fewer activation bytes than exact
    training without remat (the paper's memory mechanism), and fewer than
    WTA-CRS without remat; ``full`` stores the least."""
    _, tcfg, _, params, batch = _setup(compute_dtype="bfloat16", seq=64)
    wta = WTACRSConfig(kind="wta_crs", budget=0.25, min_rows=4)
    exact_none = _saved_bytes(tcfg, params, batch, cm.Policy())
    wta_none = _saved_bytes(tcfg, params, batch, cm.Policy(wtacrs=wta))
    wta_names = _saved_bytes(tcfg, params, batch,
                             cm.Policy(wtacrs=wta, remat="wtacrs_names"))
    wta_full = _saved_bytes(tcfg, params, batch,
                            cm.Policy(wtacrs=wta, remat="full"))
    assert wta_names < wta_none < exact_none, (wta_names, wta_none,
                                               exact_none)
    assert wta_full < wta_names


@pytest.mark.parametrize("remat,builds", [("none", 1), ("full", 2),
                                          ("wtacrs_names", 1)])
def test_plans_are_rebuilt_only_under_full(remat, builds, monkeypatch):
    """What ``launches_per_step`` counts on the card: under ``"full"`` the
    recompute builds every plan and gathers every H' again (row_norms and
    gather_scale launch twice a step), under ``"wtacrs_names"`` it takes
    them from the stash."""
    _, tcfg, _, params, batch = _setup()
    calls = {"plans": 0, "gathers": 0}
    make, gather = lin._make_plans, lin._rowgather

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper
    monkeypatch.setattr(lin, "_make_plans", counted("plans", make))
    monkeypatch.setattr(lin, "_rowgather", counted("gathers", gather))
    _grads(tcfg, params, batch, _policy("wta_crs", remat))
    # 2 layers x (q/k/v shared, attn_o, wi/wg shared, wo) = 8 plans
    assert calls == {"plans": 8 * builds, "gathers": 8 * builds}


def test_recompute_records_no_tag_twice():
    _, tcfg, _, params, batch = _setup()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    rec = {}
    for remat in ("none", "wtacrs_names", "full"):
        r = cm.tag_recorder()
        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        logits, _ = lm.forward(tcfg, params, tb, _policy("wta_crs", remat),
                               key=1, recorder=r)
        logits.float().sum().backward()
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None
        rec[remat] = (r.tags, r.calls)
    assert rec["full"] == rec["wtacrs_names"] == rec["none"]


def test_unknown_remat_is_refused_as_in_the_reference():
    jcfg, tcfg, tree, params, batch = _setup()
    with pytest.raises(ValueError):
        jax_registry.loss_fn(jcfg, tree, batch, jax_cm.Policy(remat="some"))
    with pytest.raises(ValueError, match="remat"):
        _grads(tcfg, params, batch, _policy("det_topk", "some"))


@pytest.mark.parametrize("remat", REMATS)
def test_remat_gradients_match_the_reference(remat):
    """``det_topk``, f32: the port's remat'd gradients against the JAX
    package's under the same remat, at the whole-step tolerance (1e-4,
    summation orders)."""
    jcfg, tcfg, tree, params, batch = _setup()
    wta = dict(kind="det_topk", budget=0.3, min_rows=4)

    def jloss(p):
        return jax_registry.loss_fn(
            jcfg, p, batch, jax_cm.Policy(wtacrs=JaxWTACRSConfig(**wta),
                                          remat=remat))[0]
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jax.numpy.asarray,
                                                    tree))
    loss, grads, _ = _grads(tcfg, params, batch,
                            cm.Policy(wtacrs=WTACRSConfig(**wta),
                                      remat=remat))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got = convert.params_to_numpy(tcfg, _unflatten(params, grads))
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jg)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _unflatten(params, flat):
    """``flat`` (in ``tree_leaves`` order: dict keys sorted) in the
    structure of ``params``."""
    it = iter(flat)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return [build(x) for x in node]
    return build(params)


@pytest.mark.parametrize("remat", REMATS)
def test_train_step_under_remat_equals_none(remat):
    """Two whole ``make_train_step`` steps (WTA-CRS, bf16 compute): the
    parameters and moments equal the no-remat step's bit for bit."""
    _, tcfg, _, params, _ = _setup(compute_dtype="bfloat16")
    ds = data.SyntheticLM(tcfg.vocab_size, 32, 8, seed=0)
    out = {}
    for r in ("none", remat):
        p = optim.tree_map(torch.clone, params)
        state = {"params": p, "opt": optim.adamw_init(p), "step": 0,
                 "base_seed": 5}
        step = train_steps.make_train_step(
            tcfg, _policy("wta_crs", r), optim.AdamWConfig(),
            optim.linear_warmup_constant(1e-3, 1), device="cpu")
        for i in range(2):
            state, m = step(state, ds.batch_at(i, 4))
        out[r] = optim.tree_leaves(state["params"]) + optim.tree_leaves(
            state["opt"].v)
    assert all(torch.equal(a, b) for a, b in zip(out["none"], out[remat]))
