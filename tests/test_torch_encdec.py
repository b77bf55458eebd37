"""The encoder-decoder slice of the port (whisper-base) against the JAX
package: parameters, the bidirectional encoder, the decoder with
cross-attention, the loss, ``det_topk`` gradients and whole steps,
``prime_cross_cache`` and token-by-token decode, the raises the
reference has (vector positions, prefill, the per-block pool state,
``ServeSpec``), the tag trace, a factored ``OptimSpec`` over the stacked
``encoder/…`` / ``decoder/…`` leaves, the ignored ``Policy.remat`` and
znorm cache, ``Run`` in both packages, and the parameter counts.

Inputs are made from a seed with numpy and handed to both packages;
parameters cross through ``repro_torch.convert``; f32 compute unless a
test says otherwise.  Gradient tests redraw the LayerNorm gains from
[0.5, 1.5] (ROADMAP Queue C: at gains of 1 a top-k over normed rows is
decided by the last bit)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro import optim as jax_optim_lib
from repro.configs import get_config as jax_get_config
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.launch import train_steps as jax_train_steps
from repro.models import common as jax_cm
from repro.models import encdec as jax_encdec
from repro.models import registry as jax_registry
from repro.serve import ServeSpec as JaxServeSpec
from repro.train import optim as jax_optim
from repro.train import znorm as jax_znorm
from repro_torch import convert
from repro_torch import optim as optim_lib
from repro_torch.api import DataSpec, Run, RunSpec
from repro_torch.core import WTACRSConfig
from repro_torch.launch import train_steps
from repro_torch.models import common as cm
from repro_torch.models import encdec, registry
from repro_torch.models.registry import get_config
from repro_torch.serve import ServeSpec
from repro_torch.train import optim, znorm

from test_torch_optim import (_assert_state_close, _assert_tree_close,
                              _grads, _jax_update, _port_grads)

torch.set_num_threads(1)

ARCH = "whisper-base"
CPU = dict(device="cpu")
DET = dict(kind="det_topk", budget=0.3, min_rows=4)
LR, WARMUP = 1e-3, 2
TAGS = ["attn_q", "attn_k", "attn_v", "attn_o", "mlp_wi", "mlp_wo",
        "xattn_q", "xattn_k", "xattn_v", "xattn_o"]


def _cfgs(**change):
    change.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jax_get_config(ARCH, reduced=True), **change),
            dataclasses.replace(get_config(ARCH, reduced=True), **change))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(redraw=False, **change):
    """Both configs, the reference's parameters (LayerNorm gains redrawn
    from [0.5, 1.5] with ``redraw``) and the port's copy."""
    jcfg, tcfg = _cfgs(**change)
    jp, _ = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def leaf(path, a):
        a = np.array(a)
        if redraw and jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(leaf, jp)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree,
            convert.params_from_jax(tcfg, tree, **CPU))


def _batch(cfg, b=2, s_enc=16, s_dec=16, seed=0):
    """Frame embeddings N(0, 1) (the frontend stub), decoder tokens and
    next-token labels (the first two masked)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, s_dec + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, :2] = -100
    return {"frames": rng.randn(b, s_enc, cfg.d_model).astype(np.float32),
            "tokens": toks[:, :-1], "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tree_close(got, want, rtol, what):
    """Each leaf to ``rtol`` of its own scale."""
    fg = jax.tree_util.tree_leaves_with_path(got)
    fw = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, g), (_, w) in zip(fg, fw):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=rtol, atol=rtol * np.abs(w).max(),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# parameters, encoder, forward, loss
# ---------------------------------------------------------------------------

def test_init_params_names_shapes_and_scales():
    """The reference's tree (``encoder`` / ``decoder`` stacked on a layer
    axis) from the port's own initialiser: every name and shape, each
    leaf's spread (same distribution, another random stream)."""
    _, tcfg, _, tree, params = _both()
    assert len(params["encoder"]) == tcfg.encoder_layers
    assert len(params["decoder"]) == tcfg.n_layers
    assert sorted(params["decoder"][0]) == ["attn", "mlp", "norm1", "norm2",
                                            "norm_x", "xattn"]
    own = convert.params_to_numpy(tcfg, registry.init_params(tcfg, 0, **CPU))
    flat_a = jax.tree_util.tree_leaves_with_path(own)
    flat_b = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.1, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    back = convert.params_to_numpy(tcfg, params)
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              flat_b):
        np.testing.assert_array_equal(a, b)
    meta = registry.init_params(get_config(ARCH), 0, device="meta")
    assert meta["pos_enc"].shape == (32768, 512)


def test_encode_matches_the_reference():
    jcfg, tcfg, jp, _, tp = _both()
    frames = _batch(tcfg)["frames"]
    jctx = jax_cm.Ctx(policy=jax_cm.Policy(), compute_dtype=jcfg.cdtype)
    want = jax_encdec.encode(jcfg, jp, jnp.asarray(frames), jctx)
    with torch.no_grad():
        got = encdec.encode(tcfg, tp, torch.from_numpy(frames),
                            cm.Ctx(policy=cm.Policy(),
                                   compute_dtype=tcfg.cdtype))
    # f32, bidirectional attention over the 16 frames: summation orders
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s_enc,s_dec", [(16, 16), (32, 8)])
def test_forward_and_loss_match_the_reference(s_enc, s_dec):
    """Sampled linears on both sides (the forward is exact under any
    estimator), frames and tokens of other lengths too."""
    jcfg, tcfg, jp, _, tp = _both()
    batch = _batch(tcfg, s_enc=s_enc, s_dec=s_dec, seed=1)
    wta = dict(kind="wta_crs", budget=0.3, min_rows=4)
    jpol = jax_cm.Policy(wtacrs=JaxWTACRSConfig(**wta))
    jlogits, _ = jax_registry.forward(jcfg, jp, _jb(batch), jpol,
                                      key=jax.random.PRNGKey(1))
    jloss, _ = jax_registry.loss_fn(jcfg, jp, _jb(batch), jpol,
                                    key=jax.random.PRNGKey(1))
    pol = cm.Policy(wtacrs=WTACRSConfig(**wta))
    with torch.no_grad():
        logits, aux = registry.forward(tcfg, tp, _tb(batch), pol, key=3)
        loss, laux = registry.loss_fn(tcfg, tp, _tb(batch), pol, key=3)
    assert logits.shape == (2, s_dec, tcfg.vocab_size) and aux == {}
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(laux["ce_loss"]) == float(loss)


def test_bf16_forward_within_the_reference_tolerance():
    jcfg, tcfg, jp, _, tp = _both(compute_dtype="bfloat16")
    batch = _batch(tcfg, seed=2)
    jlogits, _ = jax_registry.forward(jcfg, jp, _jb(batch), jax_cm.Policy())
    with torch.no_grad():
        logits, _ = registry.forward(tcfg, tp, _tb(batch), cm.Policy())
    assert logits.dtype == torch.bfloat16
    # bf16 rounds at other places in the two frameworks: the reference's
    # bf16 tolerance, 3e-2
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=3e-2,
                               atol=3e-2)


# ---------------------------------------------------------------------------
# gradients and train steps
# ---------------------------------------------------------------------------

def _port_grad_tree(tcfg, params, batch, policy):
    leaves = optim.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    try:
        loss, _ = registry.loss_fn(tcfg, params, _tb(batch), policy)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    return convert.params_to_numpy(tcfg, jax.tree.unflatten(
        jax.tree.structure(params), list(grads)))


def test_det_topk_gradients_match_the_reference():
    """Every linear sampled (``xattn_k`` / ``xattn_v`` over the encoder's
    rows, each its own plan): the gradient of every leaf against
    ``jax.grad`` of the reference's loss (f32, 1e-5 of its scale)."""
    jcfg, tcfg, jp, _, tp = _both(redraw=True)
    batch = _batch(tcfg, s_enc=32, seed=3)
    want = jax.grad(lambda p: jax_registry.loss_fn(
        jcfg, p, _jb(batch),
        jax_cm.Policy(wtacrs=JaxWTACRSConfig(**DET)))[0])(jp)
    got = _port_grad_tree(tcfg, tp, batch,
                          cm.Policy(wtacrs=WTACRSConfig(**DET)))
    _tree_close(got, jax.tree.map(np.asarray, want), 1e-5, "grad")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_det_topk_train_steps_match_the_reference(microbatches):
    """Two whole steps (AdamW), one batch or two microbatches: loss and
    grad norm at 1e-5; the updated parameters at the whole-step tolerance
    of test_torch_train.py, 1e-4 (Adam carries an entry's rounding into a
    step of up to lr where its gradient is near zero)."""
    jcfg, tcfg, jp, _, tp = _both(redraw=True)
    jstate = dict(jax_train_steps.init_train_state(jcfg,
                                                   jax.random.PRNGKey(0)),
                  params=jp)
    tstate = {"params": tp, "opt": optim.adamw_init(tp), "step": 0,
              "base_seed": 11}
    jstep = jax.jit(jax_train_steps.make_train_step(
        jcfg, jax_cm.Policy(wtacrs=JaxWTACRSConfig(**DET)),
        jax_optim.AdamWConfig(), jax_optim.linear_warmup_constant(LR, WARMUP),
        microbatches=microbatches))
    tstep = train_steps.make_train_step(
        tcfg, cm.Policy(wtacrs=WTACRSConfig(**DET)), optim.AdamWConfig(),
        optim.linear_warmup_constant(LR, WARMUP), microbatches=microbatches,
        **CPU)
    for i in range(2):
        batch = _batch(tcfg, b=4, seed=10 + i)
        jstate, jm = jstep(jstate, _jb(batch))
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    _assert_tree_close(convert.params_to_numpy(tcfg, tstate["params"]),
                       jax.tree.map(np.asarray, jstate["params"]), "params",
                       rtol=1e-4, atol=1e-4)


def test_cached_grad_step_writes_the_references_zero_taps():
    """The reference's enc-dec forward builds its context with
    ``znorms=None`` (``src/repro/models/encdec.py:114``): a
    ``cached_grad`` policy never reads the cache there, every tap is
    zero, and the scatter writes zeros into the batch's columns; the
    budget statistics take one update of those zeros.  The port does the
    same (ROADMAP Queue C), the losses those of activation-only plans."""
    jcfg, tcfg, jp, _, tp = _both(redraw=True)
    cached = dict(DET, norm_source="cached_grad")
    tags = znorm.collect_linear_tags(tcfg)
    jstate = dict(jax_train_steps.init_train_state(
        jcfg, jax.random.PRNGKey(0), znorm_tags=tags, n_dataset=8,
        budget_stats=True), params=jp)
    tstate = train_steps.init_train_state(
        tcfg, 0, znorm_tags=tags, n_dataset=8, budget_stats=True,
        params=tp, **CPU)
    jstate, jm = jax.jit(jax_train_steps.make_train_step(
        jcfg, jax_cm.Policy(wtacrs=JaxWTACRSConfig(**cached)),
        jax_optim.AdamWConfig(), jax_optim.linear_warmup_constant(LR, WARMUP),
        use_znorm_cache=True))(
        jstate, dict(_jb(_batch(tcfg, b=4, seed=5)),
                     sample_ids=jnp.arange(4, dtype=jnp.int32)))
    tstate, tm = train_steps.make_train_step(
        tcfg, cm.Policy(wtacrs=WTACRSConfig(**cached)), optim.AdamWConfig(),
        optim.linear_warmup_constant(LR, WARMUP), use_znorm_cache=True,
        **CPU)(tstate, dict(_batch(tcfg, b=4, seed=5),
                            sample_ids=np.arange(4, dtype=np.int32)))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for t in tags:
        np.testing.assert_array_equal(_np(tstate["znorm"][t]),
                                      np.asarray(jstate["znorm"][t]))
        np.testing.assert_allclose(_np(tstate["budget_stats"][t]),
                                   np.asarray(jstate["budget_stats"][t]),
                                   rtol=1e-6, atol=1e-6)
        assert not tstate["znorm"][t][:, :4].any()
        assert bool((tstate["znorm"][t][:, 4:] == 1).all())


def test_remat_is_ignored_as_in_the_reference():
    """``encdec.forward`` never wraps a layer for remat in the reference
    (its loss's program holds no checkpoint more under ``"full"`` than
    under ``"none"``, while ``lm.forward``'s does); the port's enc-dec
    keeps every activation under ``"full"`` and ``"wtacrs_names"`` too:
    the same saved tensors, the same gradients bit for bit (ROADMAP Queue
    C)."""
    jcfg, tcfg, jp, _, tp = _both(redraw=True)
    batch = _batch(tcfg, seed=6)

    def remats(cfg, params, b, remat):
        """jax.checkpoint calls in the loss's program (the flash
        attention's own blocks are some of them)."""
        pol = jax_cm.Policy(wtacrs=JaxWTACRSConfig(**DET), remat=remat)
        return str(jax.make_jaxpr(lambda p: jax_registry.loss_fn(
            cfg, p, b, pol)[0])(params)).count("remat")

    assert remats(jcfg, jp, _jb(batch), "full") == \
        remats(jcfg, jp, _jb(batch), "none")
    lcfg = dataclasses.replace(jax_get_config("qwen2.5-3b", reduced=True),
                               compute_dtype="float32")
    lp, _ = jax_registry.init_params(lcfg, jax.random.PRNGKey(0))
    toks = jnp.zeros((2, 16), jnp.int32)
    lb = {"tokens": toks, "labels": toks}
    assert remats(lcfg, lp, lb, "full") > remats(lcfg, lp, lb, "none")

    def saved_and_grads(remat):
        pol = cm.Policy(wtacrs=WTACRSConfig(**DET), remat=remat)
        shapes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
            grads = _port_grad_tree(tcfg, tp, batch, pol)
        return shapes, grads

    base_shapes, base = saved_and_grads("none")
    for remat in ("full", "wtacrs_names"):
        shapes, grads = saved_and_grads(remat)
        assert shapes == base_shapes
        for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(base)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def test_prime_cross_cache_matches_the_reference():
    jcfg, tcfg, jp, _, tp = _both()
    frames = _batch(tcfg, s_enc=24)["frames"]
    jxk, jxv = jax_encdec.prime_cross_cache(jcfg, jp, jnp.asarray(frames),
                                            jax_cm.Policy())
    with torch.no_grad():
        xk, xv = encdec.prime_cross_cache(tcfg, tp, torch.from_numpy(frames),
                                          cm.Policy())
    assert tuple(xk.shape) == (tcfg.n_layers, 2, 24, tcfg.n_kv_heads,
                               tcfg.head_dim)
    for got, want in ((xk, jxk), (xv, jxv)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_decode_token_by_token_matches_the_reference_and_the_forward():
    """A primed cross cache, then 12 decode steps at a shared scalar
    position: each step's logits against the reference's ``decode_step``
    (f32, 1e-5), all of them against the teacher-forced forward on the
    same frames (f32: the reference's decode tolerance 5e-2 would hide
    nothing here; held at 1e-5)."""
    jcfg, tcfg, jp, _, tp = _both()
    batch = _batch(tcfg, s_enc=20, s_dec=12, seed=7)
    frames, toks = batch["frames"], batch["tokens"]
    jxk, jxv = jax_encdec.prime_cross_cache(jcfg, jp, jnp.asarray(frames),
                                            jax_cm.Policy())
    jstate = dict(jax_encdec.decode_state_init(jcfg, 2, 12, enc_len=20),
                  xk=jxk, xv=jxv)
    with torch.no_grad():
        xk, xv = encdec.prime_cross_cache(tcfg, tp, torch.from_numpy(frames),
                                          cm.Policy())
    state = encdec.decode_state_init(tcfg, 2, 12, enc_len=20, **CPU)
    assert {n: tuple(x.shape) for n, x in state.items()} == \
        {n: x.shape for n, x in jstate.items()}
    state["xk"].copy_(xk)
    state["xv"].copy_(xv)
    serve = train_steps.make_serve_step(tcfg, cm.Policy(), **CPU)
    got = []
    for t in range(12):
        jl, jstate = jax_registry.decode_step(
            jcfg, jp, jnp.asarray(toks[:, t]), jnp.asarray(t), jstate,
            jax_cm.Policy())
        _, logits, state = serve(tp, toks[:, t], t, state)
        np.testing.assert_allclose(_np(logits), _np(jl), rtol=1e-5,
                                   atol=1e-5)
        got.append(logits)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(state[name]), _np(jstate[name]),
                                   rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        full, _ = registry.forward(tcfg, tp, _tb(batch), cm.Policy())
    np.testing.assert_allclose(_np(torch.stack(got, 1)), _np(full),
                               rtol=1e-5, atol=1e-5)


def test_decode_state_init_of_the_registry_halves_the_length():
    jcfg, tcfg = _cfgs()
    want = jax_registry.decode_state_init(jcfg, 3, 20)
    got = registry.decode_state_init(tcfg, 3, 20, **CPU)
    assert {n: tuple(x.shape) for n, x in got.items()} == \
        {n: x.shape for n, x in want.items()}
    assert got["xk"].shape[2] == 10 and got["k"].dtype == torch.float32


# ---------------------------------------------------------------------------
# where the reference raises
# ---------------------------------------------------------------------------

def test_vector_positions_raise_in_both_packages():
    jcfg, tcfg, jp, _, tp = _both()
    jstate = jax_registry.decode_state_init(jcfg, 2, 8)
    state = registry.decode_state_init(tcfg, 2, 8, **CPU)
    tok = np.asarray([1, 2], np.int32)
    with pytest.raises(NotImplementedError, match="one shared scalar"):
        jax_registry.decode_step(jcfg, jp, jnp.asarray(tok),
                                 jnp.asarray([3, 4]), jstate,
                                 jax_cm.Policy())
    with pytest.raises(NotImplementedError, match="one shared scalar"):
        registry.decode_step(tcfg, tp, torch.from_numpy(tok),
                             torch.tensor([3, 4]), state, cm.Policy())


def test_prefill_and_the_block_state_raise_in_both_packages():
    jcfg, tcfg, jp, _, tp = _both()
    batch = _batch(tcfg)
    for fn, args in ((jax_registry.prefill, (jcfg, jp, _jb(batch),
                                             jax_cm.Policy())),
                     (registry.prefill, (tcfg, tp, _tb(batch), cm.Policy())),
                     (train_steps.make_prefill_step(tcfg, cm.Policy(),
                                                    **CPU), (tp, batch))):
        with pytest.raises(NotImplementedError,
                           match="prime_cross_cache \\+ decode loop"):
            fn(*args)
    for fn, cfg in ((jax_registry.block_decode_init, jcfg),
                    (registry.block_decode_init, tcfg)):
        with pytest.raises(NotImplementedError, match="monolithic"):
            fn(cfg, "attn", 2, 8)


def test_servespec_refuses_the_encoder_decoder_as_the_reference():
    with pytest.raises(ValueError) as jerr:
        JaxServeSpec(arch=ARCH)
    with pytest.raises(ValueError) as terr:
        ServeSpec(arch=ARCH, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "encoder-decoder arch" in str(terr.value)
    assert registry.serve_compatible(get_config(ARCH)) == \
        jax_registry.serve_compatible(jax_get_config(ARCH))


# ---------------------------------------------------------------------------
# tags, optimizer layouts, Run, parameter counts
# ---------------------------------------------------------------------------

def test_collect_linear_tags_of_the_reference():
    """The encoder and decoder share their tags (no block prefix): the
    cache keys are the reference's ten; every call of both stacks is in
    the trace."""
    for reduced in (True, False):
        assert znorm.collect_linear_tags(get_config(ARCH, reduced)) == TAGS
    assert jax_znorm.collect_linear_tags(jax_get_config(ARCH, True)) == TAGS
    rec = znorm.trace_linears(get_config(ARCH))
    # encoder layer: q/k/v shared, attn_o, mlp_wi, mlp_wo (4 calls);
    # decoder layer: those and xattn_q, xattn_k, xattn_v, xattn_o (8)
    assert len(rec.calls) == 6 * 4 + 6 * 8
    assert rec.calls[:4] == [("attn_q", "attn_k", "attn_v"), ("attn_o",),
                             ("mlp_wi",), ("mlp_wo",)]


def test_factored_optim_spec_over_the_stacked_leaves_matches_the_reference():
    """One factored (CAME) ``OptimSpec`` over whisper's leaves: the
    reference's ``encoder/…`` / ``decoder/…`` stacked slots, the state
    bytes of ``memory_report`` and three updates (b1 = b2 = 0.5, every
    bias correction exact in f32, as in test_torch_optim.py: parameters
    1e-6, state 1e-5 of its scale)."""
    jcfg, tcfg, _, tree, params = _both()

    def spec(pkg):
        return pkg.OptimSpec.of(dict(pattern="*", layout="factored",
                                     momentum=True), b1=0.5, b2=0.5)
    jspec, tspec = spec(jax_optim_lib), spec(optim_lib)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jax_optim_lib.init(jspec, jp)
    tstate = optim_lib.init(tspec, params)
    want = jax.tree.map(np.asarray, jstate)
    assert sorted(tstate["leaves"]) == sorted(want["leaves"])
    for path, slots in tstate["leaves"].items():
        assert sorted(slots) == sorted(want["leaves"][path]), path
        for name, t in slots.items():
            assert tuple(t.shape) == want["leaves"][path][name].shape, path
    assert "decoder/xattn/wk" in tstate["leaves"]
    assert tstate["leaves"]["encoder/attn/wq"]["m"].shape[0] == \
        tcfg.encoder_layers
    assert optim_lib.memory_report(tspec, params) == \
        jax_optim_lib.memory_report(jspec, jp)
    for s in range(3):
        g = _grads(tree, s)
        jp, jstate, _, _ = _jax_update(jspec, jstate, jp, g)
        optim_lib.update(_port_grads(tcfg, g), tstate, params, 1e-2, tspec)
    _assert_tree_close(convert.params_to_numpy(tcfg, params),
                       jax.tree.map(np.asarray, jp), "params", rtol=1e-6,
                       atol=1e-6)
    _assert_state_close(convert.opt_state_to_numpy(tstate),
                        jax.tree.map(np.asarray, jstate), rtol=1e-5)


def _runs(**kw):
    kw = dict(dict(arch=ARCH, steps=2, batch_size=2, lr=1e-3, warmup=2),
              **kw)
    jrun = jax_api.Run(jax_api.RunSpec(
        data=jax_api.DataSpec(seq_len=16, n_samples=4), **kw))
    trun = Run(RunSpec(data=DataSpec(seq_len=16, n_samples=4), **kw), **CPU)
    return jrun, trun


def test_run_generate_matches_the_jax_run_and_fit_raises_as_there():
    """``Run.generate`` decodes the enc-dec over an unprimed (zero) cross
    cache of ``(S + gen) // 2`` rows, as the reference's does: greedy
    tokens equal on the same parameters (f32).  ``Run.fit``'s
    ``SyntheticLM`` yields tokens only, so both packages fail for want of
    the frames."""
    jrun, trun = _runs()
    for run in (jrun, trun):
        run.cfg = dataclasses.replace(run.cfg, compute_dtype="float32")
        run.init()
    tree = jax.tree.map(np.asarray, jrun.state["params"])
    with torch.no_grad():
        for dst, src in zip(optim.tree_leaves(trun.state["params"]),
                            optim.tree_leaves(convert.params_from_jax(
                                trun.cfg, tree, **CPU))):
            dst.copy_(src)
    prompts = np.asarray([[3, 14, 15, 9, 2, 6, 5], [7, 1, 4, 4, 2, 0, 9]],
                         np.int32)
    np.testing.assert_array_equal(trun.generate(prompts, gen=6).numpy(),
                                  np.asarray(jrun.generate(prompts, gen=6)))
    for run in (jrun, trun):
        with pytest.raises(KeyError, match="frames"):
            run.fit()


def test_run_report_and_serve_refusal_match_the_jax_run():
    jrun, trun = _runs(optimizer=None)
    jrun.init()
    trun.init()
    assert trun.report() == jrun.report()
    with pytest.raises(ValueError, match="encoder-decoder arch"):
        trun.serve(max_slots=2)


def test_checkpoint_of_a_factored_run_keys_the_reference_stacks(tmp_path):
    """A whisper ``Run`` under a factored ``OptimSpec``, stepped by hand
    (``Run.fit`` has no frames to feed): its checkpoint keys the layout
    state by the reference's stacked ``encoder/…`` / ``decoder/…`` paths,
    and ``Run.restore`` brings back params and optimizer state bit for
    bit."""
    from repro_torch.train import checkpoint
    spec = RunSpec(arch=ARCH, steps=2, batch_size=2,
                   optimizer=optim_lib.OptimSpec.of(
                       dict(pattern="*", layout="factored")),
                   data=DataSpec(seq_len=16, n_samples=4),
                   checkpoint_dir=str(tmp_path / "ckpt"))
    run = Run(spec, **CPU)
    run.step(_batch(run.cfg, seed=8))
    run.save()
    keys = checkpoint.read_manifest(str(tmp_path / "ckpt"))["keys"]
    assert "opt/leaves/encoder/attn/wq/v_row" in keys
    assert "opt/leaves/decoder/xattn/wv/v_col" in keys
    assert "params/decoder/1/xattn/wk" in keys
    resumed = Run.restore(spec, **CPU)
    assert int(resumed.state["step"]) == 1
    fa, ta = checkpoint._flatten(run.state)
    fb, tb = checkpoint._flatten(resumed.state)
    assert ta == tb and all(np.array_equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("arch,formula,tensors", [
    ("whisper-base", 104_149_504, 104_182_272),
    ("qwen2-vl-2b", 1_543_569_408, 1_546_073_600)])
def test_parameter_counts_of_the_formula_and_of_the_tensors(arch, formula,
                                                            tensors):
    """``ArchConfig.n_params()`` (the reference's formula, copied) leaves
    out norm gains and betas, biases and (for the VLM) ``vis_proj``: the
    tensors hold more (ROADMAP Queue C).  Both counts in both packages."""
    cfg = get_config(arch)
    assert cfg.n_params() == jax_get_config(arch).n_params() == formula
    n = sum(p.numel() for p in optim.tree_leaves(
        registry.init_params(cfg, 0, device="meta")))
    jparams, _ = jax_registry.abstract_params(jax_get_config(arch))
    assert n == sum(int(np.prod(x.shape))
                    for x in jax.tree.leaves(jparams)) == tensors
