"""The VLM slice of the port (qwen2-vl-2b) against the JAX package: M-RoPE,
the patch stub through ``vis_proj`` ahead of the text, the loss over the
text, whole ``det_topk`` train steps (with microbatches, ``positions3``
split on its batch dim 1), prefill and M-RoPE decode against JAX
``registry``, the serving pool, the tag trace, ``Run`` in both packages,
and learned positions in a decoder-only config.

Inputs are made from a seed with numpy and handed to both packages;
parameters cross through ``repro_torch.convert``; f32 compute unless a
test says otherwise.  Whole-step gradient tests redraw the norm gains
from [0.5, 1.5] (ROADMAP Queue C: at gains of 1 a top-k over normed rows
is decided by the last bit)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.configs import get_config as jax_get_config
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.launch import train_steps as jax_train_steps
from repro.models import common as jax_cm
from repro.models import lm as jax_lm
from repro.models import registry as jax_registry
from repro.train import optim as jax_optim
from repro.train import znorm as jax_znorm
from repro_torch import convert
from repro_torch.api import DataSpec, Run, RunSpec
from repro_torch.core import WTACRSConfig
from repro_torch.launch import train_steps
from repro_torch.models import common as cm
from repro_torch.models import lm, registry
from repro_torch.models.registry import get_config
from repro_torch.serve import ServeSession, ServeSpec
from repro_torch.train import optim, znorm

from test_torch_serve import GENS, PROMPTS, alone_in_a_pool, \
    solo_in_pool_shapes

torch.set_num_threads(1)

ARCH = "qwen2-vl-2b"
CPU = dict(device="cpu")
DET = dict(kind="det_topk", budget=0.3, min_rows=4)
LR, WARMUP = 1e-3, 2


def _cfgs(arch=ARCH, **change):
    """Both packages' reduced config, f32 compute, with ``change``."""
    change.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jax_get_config(arch, reduced=True), **change),
            dataclasses.replace(get_config(arch, reduced=True), **change))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(arch=ARCH, redraw=False, **change):
    """Both configs, the reference's parameters (gains redrawn from
    [0.5, 1.5] with ``redraw``) and the port's copy."""
    jcfg, tcfg = _cfgs(arch, **change)
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


def _batch(cfg, b=4, s=32, seed=0, mask=True):
    """A VLM batch of ``registry.train_batch_specs``'s shapes from numpy:
    patch embeddings N(0, 1), text tokens and next-token labels (the
    first two masked with ``mask``), ``positions3`` = arange on each
    stream."""
    specs = registry.train_batch_specs(cfg, b, s)
    rng = np.random.RandomState(seed)
    s_txt = specs["tokens"][0][1]
    toks = rng.randint(0, cfg.vocab_size, (b, s_txt + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if mask:
        labels[:, :2] = -100
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
    return {"tokens": toks[:, :-1], "labels": labels,
            "patches": rng.randn(*specs["patches"][0]).astype(np.float32),
            "positions3": pos}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# M-RoPE, embeddings, forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh,sections", [(16, None), (128, None),
                                         (32, (4, 6, 6))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_the_reference(dh, sections, dtype):
    """Three position streams, distinct on purpose (t, h, w of a patch
    grid), each rotating its own section of the frequency slots."""
    rng = np.random.RandomState(dh)
    x = rng.randn(2, 9, 3, dh).astype(np.float32)
    pos3 = np.stack([np.arange(9), np.arange(9) // 3, np.arange(9) % 3])
    pos3 = np.broadcast_to(pos3[:, None], (3, 2, 9)).astype(np.int32) + \
        rng.randint(0, 50, (3, 2, 1)).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_cm.apply_mrope(jnp.asarray(x, jd), jnp.asarray(pos3), 1e6,
                              sections)
    got = cm.apply_mrope(torch.from_numpy(x).to(td), torch.from_numpy(pos3),
                         1e6, sections)
    assert got.dtype == td
    # f32: the same angles and rotation (1e-6); bf16 rounds once at the
    # end on both sides, so a result may land one bf16 ulp apart (1e-2
    # of the rotated values, which are of order 1)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_mrope_with_equal_streams_is_rope():
    """positions3 with one position on all three streams rotates as plain
    RoPE at that position, the decode step's case (bit for bit)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 5, 4, 128).astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 4000, (2, 5)))
    got = cm.apply_mrope(x, pos[None].expand(3, 2, 5), 1e6)
    assert torch.equal(got, cm.apply_rope(x, pos, 1e6))


def test_embed_inputs_puts_the_projected_patches_before_the_text():
    jcfg, tcfg, jp, _, tp = _both()
    batch = _batch(tcfg)
    jctx = jax_cm.Ctx(policy=jax_cm.Policy(), compute_dtype=jcfg.cdtype)
    jh, jpos = jax_lm.embed_inputs(jcfg, jp, _jb(batch), jctx)
    rec = cm.tag_recorder()
    ctx = cm.Ctx(policy=cm.Policy(), compute_dtype=tcfg.cdtype, recorder=rec)
    with torch.no_grad():
        h, pos = lm.embed_inputs(tcfg, tp, _tb(batch), ctx)
    assert h.shape == (4, 32, tcfg.d_model) and tuple(pos.shape) == (3, 4, 32)
    assert rec.tags == ["vis_proj"]
    assert rec.dims["vis_proj"] == cm.SAMPLED_DIM_TOKEN
    # f32: one product (the projection), summation order only
    np.testing.assert_allclose(_np(h), _np(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(_np(h[:, 8:]),
                                  _np(tp["embed"][batch["tokens"]]))


def test_forward_and_text_only_loss_match_the_reference():
    jcfg, tcfg, jp, _, tp = _both()
    batch = _batch(tcfg, seed=1)
    jlogits, _ = jax_registry.forward(jcfg, jp, _jb(batch), jax_cm.Policy())
    jloss, jaux = jax_registry.loss_fn(jcfg, jp, _jb(batch), jax_cm.Policy())
    with torch.no_grad():
        logits, _ = registry.forward(tcfg, tp, _tb(batch), cm.Policy())
        loss, aux = registry.loss_fn(tcfg, tp, _tb(batch), cm.Policy())
    # one logit row a position, vision prefix included; the loss over the
    # 24 text positions only (f32 1e-5)
    assert logits.shape == (4, 32, tcfg.vocab_size)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(aux["ce_loss"]) == float(loss)
    text = torch.log_softmax(logits[:, 8:].double(), dim=-1)
    lab = torch.from_numpy(batch["labels"]).long()
    keep = lab >= 0
    ce = -text.gather(-1, lab.clamp(min=0)[..., None])[..., 0][keep].mean()
    np.testing.assert_allclose(float(loss), float(ce), rtol=1e-5)


def test_init_params_names_and_shapes():
    _, tcfg, _, tree, _ = _both()
    own = convert.params_to_numpy(tcfg, registry.init_params(tcfg, 0, **CPU))
    flat_a = jax.tree_util.tree_leaves_with_path(own)
    flat_b = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
    assert own["vis_proj"].shape == (tcfg.d_model, tcfg.d_model)
    # the vision projection at 1/sqrt(fan-in), as the reference draws it
    np.testing.assert_allclose(own["vis_proj"].std(),
                               tcfg.d_model ** -0.5, rtol=0.1)


def test_train_batch_specs_and_synthetic_batch_follow_the_reference():
    for b, s in ((2, 8), (4, 32), (4, 1024), (3, 100)):
        jcfg, tcfg = _cfgs()
        want = jax_registry.train_batch_specs(jcfg, b, s)
        got = registry.train_batch_specs(tcfg, b, s)
        assert sorted(got) == sorted(want)
        for name, (shape, _) in got.items():
            assert shape == want[name].shape, name
    full = registry.train_batch_specs(get_config(ARCH), 4, 1024)
    assert full["patches"][0] == (4, 256, 1536)
    assert full["tokens"][0] == (4, 768)
    batch = registry.make_synthetic_batch(tcfg, 2, 32, 7, **CPU)
    assert batch["patches"].dtype == torch.float32
    assert torch.equal(batch["positions3"][2, 1],
                       torch.arange(32, dtype=torch.int32))
    again = registry.make_synthetic_batch(tcfg, 2, 32, 7, **CPU)
    other = registry.make_synthetic_batch(tcfg, 2, 32, 8, **CPU)
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    assert not torch.equal(batch["tokens"], other["tokens"])
    assert int(batch["tokens"].max()) < tcfg.vocab_size


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------

def _steps(microbatches, n=3):
    jcfg, tcfg, jp, tree, tp = _both(redraw=True)
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
    for i in range(n):
        batch = _batch(tcfg, seed=10 + i)
        jstate, jm = jstep(jstate, _jb(batch))
        tstate, tm = tstep(tstate, batch)
        # f32 on both sides, the same (det_topk) plans: summation orders
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        # the updated parameters at the whole-step tolerance of
        # test_torch_train.py (1e-4): Adam divides each gradient entry by
        # its own RMS, so an entry near zero carries its rounding into a
        # step of up to lr (the gradients themselves: 1e-5, below)
        got = convert.params_to_numpy(tcfg, tstate["params"])
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves_with_path(
                    jax.tree.map(np.asarray, jstate["params"]))):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=jax.tree_util.keystr(path))
    return tstate


def test_three_det_topk_steps_match_the_reference():
    """Every linear sampled (``vis_proj`` over the 8 patch rows, k = 4 at
    min_rows; the blocks over all 32 positions), three steps: loss and
    grad norm at 1e-5, the updated parameters at 1e-4."""
    _steps(1)


def test_det_topk_gradients_match_the_reference():
    """The sampled gradients of every leaf, ``vis_proj``'s over the patch
    rows included, against ``jax.grad`` of the reference's loss (f32,
    1e-5 of each gradient's scale)."""
    jcfg, tcfg, jp, _, tp = _both(redraw=True)
    batch = _batch(tcfg, seed=9)
    want = jax.grad(lambda p: jax_registry.loss_fn(
        jcfg, p, _jb(batch), jax_cm.Policy(wtacrs=JaxWTACRSConfig(**DET)))[
            0])(jp)
    leaves = optim.tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = registry.loss_fn(tcfg, tp, _tb(batch),
                               cm.Policy(wtacrs=WTACRSConfig(**DET)))
    grads = torch.autograd.grad(loss, leaves)
    got = convert.params_to_numpy(tcfg, jax.tree.unflatten(
        jax.tree.structure(tp), list(grads)))
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(
                jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_microbatches_split_positions3_on_its_batch_dim():
    """Two microbatches: ``positions3`` (3, B, S) splits along dim 1, the
    other inputs along dim 0 (``src/repro/launch/train_steps.py:188``)."""
    state = _steps(2, n=2)
    assert state["step"] == 2


def test_cached_grad_step_caches_and_stats_equal_the_reference():
    """Under a ``cached_grad`` policy the reference threads the cache into
    the layer stack only: ``vis_proj`` runs in ``embed_inputs`` without a
    znorm, so its tap is zero and the scatter writes zeros into its
    cache columns; the blocks' columns get their norms.  The port does
    the same (cache and statistics at 1e-5)."""
    jcfg, tcfg, jp, tree, tp = _both(redraw=True)
    cached = dict(DET, norm_source="cached_grad")
    tags = znorm.collect_linear_tags(tcfg)
    assert tags == jax_znorm.collect_linear_tags(jcfg)
    jstate = dict(jax_train_steps.init_train_state(
        jcfg, jax.random.PRNGKey(0), znorm_tags=tags, n_dataset=8,
        budget_stats=True), params=jp)
    tstate = train_steps.init_train_state(
        tcfg, 0, znorm_tags=tags, n_dataset=8, budget_stats=True,
        params=tp, **CPU)
    jstep = jax.jit(jax_train_steps.make_train_step(
        jcfg, jax_cm.Policy(wtacrs=JaxWTACRSConfig(**cached)),
        jax_optim.AdamWConfig(), jax_optim.linear_warmup_constant(LR, WARMUP),
        use_znorm_cache=True))
    tstep = train_steps.make_train_step(
        tcfg, cm.Policy(wtacrs=WTACRSConfig(**cached)), optim.AdamWConfig(),
        optim.linear_warmup_constant(LR, WARMUP), use_znorm_cache=True,
        **CPU)
    for i in range(2):
        batch = dict(_batch(tcfg, seed=20 + i),
                     sample_ids=np.arange(4 * (i % 2), 4 * (i % 2) + 4,
                                          dtype=np.int32))
        jstate, jm = jstep(jstate, _jb(batch))
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    for name in ("znorm", "budget_stats"):
        for t in tags:
            # f32 norms of the same gradients: 1e-5 of their scale
            want = np.asarray(jstate[name][t])
            np.testing.assert_allclose(_np(tstate[name][t]), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{name}/{t}")
    assert not tstate["znorm"]["vis_proj"][:, :8].any()
    assert tstate["znorm"]["b0/mlp_wo"][:, :8].min() > 0


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def test_prefill_matches_jax_registry_prefill():
    jcfg, tcfg, jp, _, tp = _both()
    batch = _batch(tcfg, b=2, s=32, seed=3)
    del batch["labels"]
    jlast, jstates = jax_registry.prefill(jcfg, jp, _jb(batch),
                                          jax_cm.Policy())
    last, states = train_steps.make_prefill_step(tcfg, cm.Policy(), **CPU)(
        tp, batch)
    # f32: the flash kernel's plain version against the reference's
    # flash, summation orders only (1e-5 of the logits' scale)
    np.testing.assert_allclose(_np(last), _np(jlast), rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        assert states[0][name].shape == jstates[0][name].shape
        np.testing.assert_allclose(_np(states[0][name]),
                                   _np(jstates[0][name]), rtol=1e-5,
                                   atol=1e-5)


def test_mrope_decode_after_prefill_matches_jax_decode_step():
    """Prefill 32 positions (8 patches, 24 text), then 4 decode steps with
    ``pos`` on all three streams, each against the reference's
    ``decode_step`` from its own prefill (f32, 1e-5); and the decoded
    logits against the forward over the longer text, the patches
    unchanged (the reference's decode tolerance, 2e-3: decode attends
    in one block, the forward in two)."""
    jcfg, tcfg, jp, _, tp = _both()
    batch = _batch(tcfg, b=2, s=36, seed=4, mask=False)
    s_txt = batch["tokens"].shape[1] - 4
    first = {"tokens": batch["tokens"][:, :s_txt],
             "patches": batch["patches"],
             "positions3": batch["positions3"][:, :, :32]}
    jlast, jstates = jax_registry.prefill(jcfg, jp, _jb(first),
                                          jax_cm.Policy())
    last, states = train_steps.make_prefill_step(tcfg, cm.Policy(), **CPU)(
        tp, first)
    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    jstates = tuple({n: jnp.pad(x, pad) for n, x in st.items()}
                    for st in jstates)
    states = tuple({n: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 4))
                    for n, x in st.items()} for st in states)
    serve = train_steps.make_serve_step(tcfg, cm.Policy(), **CPU)
    got = []
    for t in range(4):
        tok = batch["tokens"][:, s_txt + t]
        jl, jstates = jax_registry.decode_step(
            jcfg, jp, jnp.asarray(tok), jnp.asarray(32 + t), jstates,
            jax_cm.Policy())
        _, logits, states = serve(tp, tok, 32 + t, states)
        np.testing.assert_allclose(_np(logits), _np(jl), rtol=1e-5,
                                   atol=1e-5)
        got.append(logits)
    with torch.no_grad():
        full, _ = registry.forward(tcfg, tp, _tb(batch), cm.Policy())
    np.testing.assert_allclose(_np(torch.stack(got, 1)), _np(full[:, 32:]),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# serving, tags, Run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm_params():
    return registry.init_params(get_config(ARCH, reduced=True), 0, **CPU)


def test_pool_composition_independence(vlm_params):
    """Text prompts through the slot pool (decode steps with M-RoPE at
    per-slot positions): every request's tokens equal those it gets
    alone and those of the solo route at the pool's shapes, bit for
    bit."""
    spec = ServeSpec(arch=ARCH, device="cpu", max_slots=2, page_size=4,
                     max_len=16, prefill_chunk=3)
    sess = ServeSession(spec, vlm_params)
    handles = [sess.submit(p, max_new=g) for p, g in zip(PROMPTS, GENS)]
    sess.run_until_idle()
    pooled = [h.result(timeout=0) for h in handles]
    assert pooled == [alone_in_a_pool(spec, vlm_params, p, g)
                      for p, g in zip(PROMPTS, GENS)]
    assert pooled == [solo_in_pool_shapes(spec, vlm_params, p, g)
                      for p, g in zip(PROMPTS, GENS)]
    assert [len(t) for t in pooled] == GENS


def test_collect_linear_tags_of_the_reference():
    """The reference's trace at seq 8 is all patches and no text (a
    zero-length token tensor); ``vis_proj`` samples over the patch
    tokens and joins the cache keys."""
    want = ['vis_proj', 'b0/attn_q', 'b0/attn_k', 'b0/attn_v', 'b0/attn_o',
            'b0/mlp_wi', 'b0/mlp_wg', 'b0/mlp_wo']
    for reduced in (True, False):
        assert znorm.collect_linear_tags(get_config(ARCH, reduced)) == want
    assert jax_znorm.collect_linear_tags(jax_get_config(ARCH, True)) == want
    rec = znorm.trace_linears(get_config(ARCH))
    assert rec.calls[0] == ("vis_proj",)
    assert len(rec.calls) == 1 + 4 * 28


def _runs(**kw):
    kw = dict(dict(arch=ARCH, steps=2, batch_size=2, lr=1e-3, warmup=2),
              **kw)
    jrun = jax_api.Run(jax_api.RunSpec(
        data=jax_api.DataSpec(seq_len=16, n_samples=4), **kw))
    trun = Run(RunSpec(data=DataSpec(seq_len=16, n_samples=4), **kw), **CPU)
    return jrun, trun


def test_run_generate_matches_the_jax_run_and_fit_raises_as_there():
    """``Run.generate`` serves the VLM text-only through decode steps:
    the greedy tokens equal the reference's on the same parameters (f32).
    ``Run.fit``'s ``SyntheticLM`` yields tokens only, so both packages
    fail for want of the patches."""
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
        with pytest.raises(KeyError, match="patches"):
            run.fit()


def test_run_report_matches_the_jax_run():
    jrun, trun = _runs()
    jrun.init()
    trun.init()
    assert trun.report() == jrun.report()


# ---------------------------------------------------------------------------
# learned positions in a decoder-only config
# ---------------------------------------------------------------------------

LEARNED = dict(pos_mode="learned")


def test_learned_positions_forward_and_decode_match_the_reference():
    """No shipped decoder-only config learns its positions (whisper is an
    encoder-decoder), so qwen2.5-3b's reduced config with
    ``pos_mode="learned"`` holds ``pos_embed`` in the forward and in
    decode (per-row positions) against the reference (f32, 1e-5)."""
    jcfg, tcfg, jp, tree, tp = _both("qwen2.5-3b", **LEARNED)
    assert tree["pos_embed"].shape == (tcfg.max_learned_pos, tcfg.d_model)
    assert "pos_embed" in tp and "vis_proj" not in tp
    rng = np.random.RandomState(5)
    toks = rng.randint(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    jlogits, _ = jax_registry.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                      jax_cm.Policy())
    with torch.no_grad():
        logits, _ = registry.forward(tcfg, tp,
                                     {"tokens": torch.from_numpy(toks)},
                                     cm.Policy())
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-5,
                               atol=1e-5)
    jstates = jax_registry.decode_state_init(jcfg, 2, 12)
    states = registry.decode_state_init(tcfg, 2, 12, **CPU)
    offsets = np.asarray([0, 3])
    for t in range(6):
        pos = offsets + t
        jl, jstates = jax_registry.decode_step(
            jcfg, jp, jnp.asarray(toks[:, t]), jnp.asarray(pos), jstates,
            jax_cm.Policy())
        with torch.no_grad():
            tl, states = registry.decode_step(
                tcfg, tp, torch.from_numpy(toks[:, t]),
                torch.from_numpy(pos), states, cm.Policy())
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=1e-5)


def test_learned_positions_params_round_trip_and_train_step():
    """``pos_embed`` crosses both ways, and one ``det_topk`` step updates
    it as the reference does (f32, 1e-5)."""
    jcfg, tcfg, jp, tree, tp = _both("qwen2.5-3b", redraw=True, **LEARNED)
    back = convert.params_to_numpy(tcfg, tp)
    np.testing.assert_array_equal(back["pos_embed"], tree["pos_embed"])
    rng = np.random.RandomState(6)
    toks = rng.randint(0, tcfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    jstate = dict(jax_train_steps.init_train_state(jcfg,
                                                   jax.random.PRNGKey(0)),
                  params=jp)
    tstate = {"params": tp, "opt": optim.adamw_init(tp), "step": 0,
              "base_seed": 11}
    jstate, jm = jax.jit(jax_train_steps.make_train_step(
        jcfg, jax_cm.Policy(wtacrs=JaxWTACRSConfig(**DET)),
        jax_optim.AdamWConfig(), jax_optim.linear_warmup_constant(
            LR, WARMUP)))(jstate, _jb(batch))
    tstate, tm = train_steps.make_train_step(
        tcfg, cm.Policy(wtacrs=WTACRSConfig(**DET)), optim.AdamWConfig(),
        optim.linear_warmup_constant(LR, WARMUP), **CPU)(tstate, batch)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(_np(tstate["params"]["pos_embed"]),
                               np.asarray(jstate["params"]["pos_embed"]),
                               rtol=1e-5, atol=1e-5)
    assert not np.array_equal(_np(tstate["params"]["pos_embed"][:16]),
                              tree["pos_embed"][:16])
