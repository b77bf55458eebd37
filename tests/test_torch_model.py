"""The model of the port against the JAX package on the same parameters
(JAX ``init_params`` -> numpy -> ``params_from_jax``): logits and loss of
the dense REDUCED configs, attention against both packages' references,
norms and rope."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.models import attention as jax_attn
from repro.models import common as jax_cm
from repro.models import lm as jax_lm
from repro.models import registry as jax_registry
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES
from repro_torch.core import WTACRSConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import lm, registry
from repro_torch.models.registry import get_config

torch.set_num_threads(1)

ARCHS = ["qwen2.5-3b", "minicpm-2b", "nemotron-4-15b", "command-r-35b",
         "granite-moe-1b-a400m", "dbrx-132b", "zamba2-2.7b", "xlstm-125m",
         "qwen2-vl-2b", "whisper-base"]


def _both(arch, compute_dtype):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype=compute_dtype)
    jparams, _ = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree, \
        convert.params_from_jax(tcfg, tree, device="cpu")


def _batch(cfg, b=2, s=32, seed=0):
    """Tokens and next-token labels of ``registry.train_batch_specs``'s
    text length; a VLM's patch embeddings and M-RoPE positions, an
    encoder-decoder's frame embeddings (N(0, 1) stubs)."""
    specs = registry.train_batch_specs(cfg, b, s)
    rng = np.random.RandomState(seed)
    s_txt = specs["tokens"][0][1]
    toks = rng.randint(0, cfg.vocab_size, (b, s_txt + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, :3] = -100                       # masked positions
    out = {"tokens": toks[:, :-1], "labels": labels}
    for name in ("patches", "frames"):
        if name in specs:
            out[name] = rng.randn(*specs[name][0]).astype(np.float32)
    if "positions3" in specs:
        out["positions3"] = np.broadcast_to(
            np.arange(s, dtype=np.int32), specs["positions3"][0]).copy()
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_configs_are_the_reference_field_for_field(arch):
    for reduced in (False, True):
        j = dataclasses.asdict(jax_get_config(arch, reduced=reduced))
        t = dataclasses.asdict(get_config(arch, reduced=reduced))
        assert j == t
    assert get_config(arch).cdtype is torch.bfloat16
    assert get_config(arch).pdtype is torch.float32
    # every arch of the reference is ported, in the reference's order
    assert ARCH_NAMES == JAX_ARCH_NAMES
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_in_f32(arch):
    jcfg, tcfg, jparams, _, params = _both(arch, "float32")
    batch = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # the forward is exact under ANY estimator: sampled on both sides, with
    # unrelated random streams
    wta = dict(kind="wta_crs", budget=0.3, min_rows=4)
    jlogits, _ = jax_registry.forward(
        jcfg, jparams, jb, jax_cm.Policy(wtacrs=JaxWTACRSConfig(**wta)),
        key=jax.random.PRNGKey(1))
    jloss, _ = jax_registry.loss_fn(
        jcfg, jparams, jb, jax_cm.Policy(wtacrs=JaxWTACRSConfig(**wta)),
        key=jax.random.PRNGKey(1))
    with torch.no_grad():
        policy = cm.Policy(wtacrs=WTACRSConfig(**wta))
        logits, _ = registry.forward(tcfg, params, tb, policy, key=99)
        loss, aux = registry.loss_fn(tcfg, params, tb, policy, key=99)
    # a VLM's logits cover its patch prefix too
    s_out = batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                        if "patches" in batch else 0)
    assert logits.shape == (2, s_out, tcfg.vocab_size)
    # f32 on both sides; summation orders differ
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert float(aux["ce_loss"]) == float(loss)


def test_logits_and_loss_match_in_bf16():
    jcfg, tcfg, jparams, _, params = _both("qwen2.5-3b", "bfloat16")
    batch = _batch(tcfg, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, _ = jax_registry.forward(jcfg, jparams, jb, jax_cm.Policy())
    jloss, _ = jax_registry.loss_fn(jcfg, jparams, jb, jax_cm.Policy())
    with torch.no_grad():
        logits, _ = registry.forward(tcfg, params, tb, cm.Policy())
        loss, _ = registry.loss_fn(tcfg, params, tb, cm.Policy())
    assert logits.dtype == torch.bfloat16
    # bf16 rounds at different places in the two frameworks: 3e-2 (the
    # reference's bf16 tolerance), absolute against logits of order 1
    np.testing.assert_allclose(
        logits.float().numpy(),
        np.asarray(jlogits.astype(jnp.float32)), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=3e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_numpy(arch):
    _, tcfg, _, tree, params = _both(arch, "float32")
    back = convert.params_to_numpy(tcfg, params)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    layers = params["decoder"] if tcfg.is_encdec else params["layers"]
    assert len(layers) == tcfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_has_the_reference_shapes_and_scales(arch):
    _, tcfg, _, tree, _ = _both(arch, "float32")
    own = convert.params_to_numpy(tcfg, registry.init_params(tcfg, 0,
                                                             device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(own)
    flat_b = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        # same distribution, another random stream: compare the spread
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.1, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    a = registry.init_params(tcfg, 0, device="cpu")["embed"]
    b = registry.init_params(tcfg, 0, device="cpu")["embed"]
    c = registry.init_params(tcfg, 1, device="cpu")["embed"]
    assert torch.equal(a, b) and not torch.equal(a, c)


def _qkv(dtype, b=2, sq=64, h=4, kvh=2, dh=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, sq, n, dh).astype(np.float32) for n in (h, kvh, kvh)]


@pytest.mark.parametrize("mode", ["full", "triangular"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_both_references_f32(mode, causal):
    q, k, v = _qkv("float32")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attn.flash_attention(tq, tk, tv, causal=causal, q_block=16,
                               kv_block=16, mode=mode)
    own_ref = attn.attention_reference(tq, tk, tv, causal=causal)
    jref = jax_attn.attention_reference(*map(jnp.asarray, (q, k, v)),
                                        causal=causal)
    jflash = jax_attn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                      causal=causal, q_block=16,
                                      kv_block=16, mode=mode)
    # f32 throughout; blockwise vs one-shot softmax differ by rounding
    for want in (own_ref.numpy(), np.asarray(jref), np.asarray(jflash)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flash_attention_bf16_and_q_offset():
    q, k, v = _qkv("bfloat16", seed=1)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = attn.flash_attention(tq, tk, tv, q_block=32, kv_block=32)
    jflash = jax_attn.flash_attention(jq, jk, jv, q_block=32, kv_block=32)
    assert got.dtype == torch.bfloat16
    # bf16 p-blocks on both sides, rounded at the same place: 3e-2 covers
    # the frameworks' differing bf16 matmul accumulation
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jflash.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)
    # chunked prefill: the last 16 queries at their absolute offset
    tail = attn.flash_attention(tq[:, 48:], tk, tv, q_block=16, kv_block=16,
                                q_offset=48)
    np.testing.assert_allclose(tail.float().numpy(),
                               got[:, 48:].float().numpy(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("q_offset,q_block,kv_block", [
    (16, 16, 16), (48, 16, 16), (0, 32, 16)])
def test_triangular_flash_is_exact_where_the_reference_drops_blocks(
        q_offset, q_block, kv_block):
    """Triangular mode at a query offset, or with q blocks larger than kv
    blocks: the port visits every kv block a query can see (counted from
    its absolute position) and holds the exact attention; the reference's
    ``_block_pairs`` visits kv blocks 0..qi whatever the offset and block
    sizes, so it drops visible blocks there (ROADMAP Queue C) — held here
    to stay on record, not to be matched."""
    q, k, v = _qkv("float32")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attn.flash_attention(tq, tk, tv, q_block=q_block,
                               kv_block=kv_block, mode="triangular",
                               q_offset=q_offset)
    want = attn.attention_reference(tq, tk, tv, q_offset=q_offset)
    jref = jax_attn.attention_reference(*map(jnp.asarray, (q, k, v)),
                                        q_offset=q_offset)
    # f32 throughout; blockwise vs one-shot softmax differ by rounding
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-5,
                               atol=1e-5)
    jflash = jax_attn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                      q_block=q_block, kv_block=kv_block,
                                      mode="triangular", q_offset=q_offset)
    assert float(np.abs(np.asarray(jflash) - want.numpy()).max()) > 0.5


def test_flash_attention_gradients_match_reference_and_recompute():
    q, k, v = _qkv("float32", sq=32, seed=2)
    ct = np.random.RandomState(3).randn(*q.shape).astype(np.float32)

    def grads(fn):
        leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (q, k, v)]
        (fn(*leaves) * torch.from_numpy(ct)).sum().backward()
        return [t.grad.numpy() for t in leaves]

    flash = grads(lambda a, b, c: attn.flash_attention(
        a, b, c, q_block=8, kv_block=8))
    ref = grads(lambda a, b, c: attn.attention_reference(a, b, c))
    jg = jax.grad(lambda a, b, c: jnp.sum(jax_attn.flash_attention(
        a, b, c, q_block=8, kv_block=8) * ct), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for g, r, j in zip(flash, ref, jg):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g, np.asarray(j), rtol=1e-4, atol=1e-5)

    # the p-blocks are recomputed, not stored: no saved tensor of a q-row
    # has the (bq, bk) score shape
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (q, k, v)]
        attn.flash_attention(*leaves, q_block=8, kv_block=8)
    assert not [s for s in saved if s[-2:] == (8, 8)], saved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope_match(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 32).astype(np.float32)
    g = rng.rand(32).astype(np.float32) + 0.5
    bta = rng.randn(32).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=3e-2, atol=3e-2)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    np.testing.assert_allclose(
        cm.rms_norm(tx, torch.from_numpy(g), 1e-5).float().numpy(),
        np.asarray(jax_cm.rms_norm(jx, jnp.asarray(g), 1e-5
                                   ).astype(jnp.float32)), **tol)
    np.testing.assert_allclose(
        cm.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(bta),
                      1e-5).float().numpy(),
        np.asarray(jax_cm.layer_norm(jx, jnp.asarray(g), jnp.asarray(bta),
                                     1e-5).astype(jnp.float32)), **tol)
    xr = rng.randn(2, 8, 4, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)).copy()
    np.testing.assert_allclose(
        cm.apply_rope(torch.from_numpy(xr).to(td), torch.from_numpy(pos),
                      1e6).float().numpy(),
        np.asarray(jax_cm.apply_rope(jnp.asarray(xr, jd), jnp.asarray(pos),
                                     1e6).astype(jnp.float32)), **tol)


def test_shared_plan_keys_fold_the_prefixed_tags():
    """q/k/v share one stored H' (so do wi/wg), and the key of a shared
    plan folds the PREFIXED tags: two blocks never share a plan."""
    tcfg = dataclasses.replace(get_config("qwen2.5-3b", reduced=True),
                               compute_dtype="float32")
    params = lm.init_params(tcfg, 0, device="cpu")
    policy = cm.Policy(wtacrs=WTACRSConfig(kind="wta_crs", budget=0.3,
                                           min_rows=4))
    rec = cm.tag_recorder()
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        leaves = [p.requires_grad_(True) for p in
                  (params["layers"][0]["attn"]["wq"],)]
        lm.forward(tcfg, params, tb, policy, key=5, recorder=rec)
        leaves[0].requires_grad_(False)
    assert rec.tags == ["b0/attn_q", "b0/attn_k", "b0/attn_v", "b0/attn_o",
                        "b0/mlp_wi", "b0/mlp_wg", "b0/mlp_wo"]
    assert set(rec.dims.values()) == {cm.SAMPLED_DIM_TOKEN}
    k = policy.wtacrs.budget_rows(32)
    idxs = [t for t in saved if t.dtype == torch.int32
            and tuple(t.shape) == (2, k)]
    # 4 plans a layer (qkv shared, attn_o, wi/wg shared, mlp_wo), 2 layers
    assert len(idxs) == 8
    for i in range(4):
        assert not torch.equal(idxs[i], idxs[i + 4])
    ctx = cm.Ctx(policy=policy, key=1, tag_prefix="b0/")
    other = dataclasses.replace(ctx, tag_prefix="b1/")
    shared_tag = "+".join(p + t for p in ("b0/",)
                          for t in ("attn_q", "attn_k", "attn_v"))
    assert ctx._key_for(shared_tag) != other._key_for(
        shared_tag.replace("b0/", "b1/"))


def test_unported_blocks_and_options_raise():
    """A recurrent pattern initialises; an ``"xattn"`` block type raises
    ``ValueError`` in ``lm`` as in the reference (cross-attention lives in
    the encoder-decoder model, ``models/encdec.py``; only
    ``ArchConfig.n_params`` counts an ``"xattn"``); the enc-dec and VLM
    archs initialise."""
    tcfg = get_config("qwen2.5-3b", reduced=True)
    ssm = dataclasses.replace(tcfg, pattern=("mamba",))
    layer = lm.init_params(ssm, 0, device="cpu")["layers"][0]
    assert sorted(layer) == ["mamba", "norm1"]
    xattn = dataclasses.replace(tcfg, pattern=("xattn",))
    with pytest.raises(ValueError, match="xattn"):
        lm.init_params(xattn, 0, device="cpu")
    with pytest.raises(ValueError, match="xattn"):
        jax_lm.init_block(xattn, "xattn", jax.random.PRNGKey(0), jnp.float32)
    with pytest.raises(ValueError, match="xattn"):
        lm.block_decode_init(xattn, "xattn", 1, 4, device="cpu")
    enc = registry.init_params(get_config("whisper-base", reduced=True), 0,
                               device="cpu")
    assert sorted(enc) == ["decoder", "embed", "enc_norm", "encoder",
                           "final_norm", "pos_dec", "pos_enc"]
    vlm = registry.init_params(get_config("qwen2-vl-2b", reduced=True), 0,
                               device="cpu")
    assert "vis_proj" in vlm and len(vlm["layers"]) == 2
