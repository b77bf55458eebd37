"""The serving slice of the port against the JAX package and against its
own contracts.

Model level, on the same parameters (JAX ``init_params`` -> numpy ->
``params_from_jax``): ``prefill`` (attention through the flash kernel's
plain version on the CPU) against JAX ``registry.prefill``,
``decode_attention`` and ``decode_step`` against JAX's, cached decode
against the port's own forward, and greedy tokens of the port's solo
route and the port's ``Run.generate`` against JAX ``Run.generate``.

Serving level, ``tests/test_serve.py`` mirrored on the port: ServeSpec
validation, page accounting, the pool's composition independence (a
request served with unrelated requests admitted and evicted around it
gives the tokens it gives alone), single-token prompts, sampled
determinism, backpressure, page-gated admission, the background loop and
chunk-size invariance.

The solo route is ``Run.generate``'s composition written out:
``make_prefill_chunk_step``,
then ``make_serve_step`` + ``sample_logits`` per token, keyed by
(seed, row).  Against the pool it runs at the pool's product shapes:
prefill at batch 1 into a ``slot_len`` cache (as the pool's per-slot
prefill), decode at ``max_slots`` rows with the request in row 0 and the
other rows idle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Run, RunSpec
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import common as jax_cm
from repro.models import registry as jax_registry
from repro.serve import ServeSpec as JaxServeSpec
from repro.serve import pool as jax_pool
from repro_torch import convert
from repro_torch.api import Run as PortRun
from repro_torch.api import RunSpec as PortRunSpec
from repro_torch.launch import train_steps
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import lm, registry
from repro_torch.models.registry import get_config
from repro_torch.serve import ServeSession, ServeSpec, Status, pool, sampling
from repro_torch.serve.pool import PageAllocator
from repro_torch.train import optim

torch.set_num_threads(1)

POLICY = cm.Policy()
CPU = dict(device="cpu")


def _both(arch, compute_dtype=None):
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    if compute_dtype is not None:
        jcfg = dataclasses.replace(jcfg, compute_dtype=compute_dtype)
        tcfg = dataclasses.replace(tcfg, compute_dtype=compute_dtype)
    jparams, _ = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.params_from_jax(tcfg, tree, **CPU)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def generate(cfg, params, prompts, gen, *, chunk=16, cache_len=None,
             rows=None, temperature=0.0, seed=0, top_k=0, uids=None):
    """The solo route: (B, S) prompts -> (B, gen) tokens.

    ``cache_len`` (default S + gen) and ``rows`` (the decode batch,
    default B; extra rows idle at position 0) set the product shapes;
    ``uids`` key the sampling (default: the row index)."""
    prompts = np.asarray(prompts, np.int32)
    b, s = prompts.shape
    rows = rows or b
    states = registry.decode_state_init(cfg, b, cache_len or s + gen, **CPU)
    t = 0
    while t < s - 1:
        n = min(chunk, s - 1 - t)
        step = train_steps.make_prefill_chunk_step(cfg, POLICY, n, **CPU)
        states = step(params, prompts[:, t:t + n], t, states)
        t += n
    if rows > b:
        states = tuple({name: torch.cat([x, x.new_zeros(
            (x.shape[0], rows - b) + x.shape[2:])], dim=1)
            for name, x in st.items()} for st in states)
    serve = train_steps.make_serve_step(cfg, POLICY, **CPU)
    uids = list(range(b)) if uids is None else list(uids)
    base = [sampling.request_key(seed, u) for u in uids] + [0] * (rows - b)
    temp = np.zeros(rows, np.float32)
    temp[:b] = temperature
    tok = np.zeros(rows, np.int64)
    tok[:b] = prompts[:, -1]
    pos = np.zeros(rows, np.int64)
    out = []
    for g in range(gen):
        pos[:b] = s - 1 + g
        _, logits, states = serve(params, tok, torch.from_numpy(pos), states)
        nxt = sampling.sample_logits(logits, sampling.step_keys(
            base, [g] * rows), temp, top_k=top_k).numpy()
        tok[:b] = nxt[:b]
        out.append(nxt[:b])
    return np.stack(out, axis=1)


def solo_in_pool_shapes(spec, params, prompt, gen, **kw):
    """One request through the solo route at the pool's product shapes."""
    return list(generate(spec.config, params, np.asarray([prompt]), gen,
                         chunk=spec.prefill_chunk, cache_len=spec.slot_len,
                         rows=spec.max_slots, top_k=spec.top_k, **kw)[0])


def alone_in_a_pool(spec, params, prompt, gen, **kw):
    sess = ServeSession(spec, params)
    h = sess.submit(prompt, max_new=gen, **kw)
    sess.run_until_idle()
    return h.result(timeout=0)


@pytest.fixture(scope="module")
def qwen_params():
    return lm.init_params(get_config("qwen2.5-3b", reduced=True), 0, **CPU)


def _spec(**kw):
    base = dict(arch="qwen2.5-3b", max_slots=2, page_size=4, max_len=16,
                device="cpu")
    base.update(kw)
    return ServeSpec(**base)


# ---------------------------------------------------------------------------
# Prefill against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm-2b",
                                  "command-r-35b", "granite-moe-1b-a400m",
                                  "dbrx-132b"])
def test_prefill_matches_jax_in_f32(arch):
    jcfg, tcfg, jparams, params = _both(arch, "float32")
    toks = _tokens(tcfg, 2, 32)
    jlast, jstates = jax_registry.prefill(
        jcfg, jparams, {"tokens": jnp.asarray(toks)}, jax_cm.Policy())
    step = train_steps.make_prefill_step(tcfg, POLICY, **CPU)
    last, states = step(params, {"tokens": toks})
    assert last.shape == (2, tcfg.vocab_size)
    # f32 on both sides: the plain version's PV (what the kernel wrapper
    # runs on the CPU) and the reference's p-rounded-to-the-input-dtype PV
    # are the same function in f32; only the summation orders differ
    np.testing.assert_allclose(_np(last), _np(jlast), rtol=1e-4, atol=1e-4)
    assert len(states) == len(jstates) == 1
    for name in ("k", "v"):
        assert states[0][name].shape == jstates[0][name].shape
        assert states[0][name].dtype == torch.float32
        np.testing.assert_allclose(_np(states[0][name]),
                                   _np(jstates[0][name]),
                                   rtol=1e-4, atol=1e-4)


def test_prefill_matches_jax_in_bf16():
    jcfg, tcfg, jparams, params = _both("qwen2.5-3b")
    toks = _tokens(tcfg, 2, 32, seed=1)
    jlast, jstates = jax_registry.prefill(
        jcfg, jparams, {"tokens": jnp.asarray(toks)}, jax_cm.Policy())
    last, states = train_steps.make_prefill_step(tcfg, POLICY, **CPU)(
        params, {"tokens": toks})
    assert last.dtype == torch.bfloat16
    assert states[0]["k"].dtype == torch.bfloat16
    # bf16: on the CPU the kernel wrapper runs its plain version, which
    # keeps p in f32 where the reference's prefill (and the kernel on the
    # card) rounds it to bf16, and bf16 rounds at other places in the two
    # frameworks: the reference's own prefill-vs-forward tolerance, 3e-2
    np.testing.assert_allclose(_np(last), _np(jlast), rtol=3e-2, atol=3e-2)
    # The first layer's K/V come straight from the embeddings: 3e-2.
    # Deeper layers' K/V are read off a residual stream that already went
    # through bf16 attention rounded differently (p in f32 here, in bf16
    # there; 0.034 apart in the second layer) and are compared only
    # through the last logits above.
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(states[0][name][0]),
                                   _np(jstates[0][name][0]),
                                   rtol=3e-2, atol=3e-2)


def test_prefill_matches_own_forward_last_logits(qwen_params):
    cfg = get_config("qwen2.5-3b", reduced=True)
    toks = _tokens(cfg, 2, 32, seed=2)
    last, _ = train_steps.make_prefill_step(cfg, POLICY, **CPU)(
        qwen_params, {"tokens": toks})
    with torch.no_grad():
        full, _ = lm.forward(cfg, qwen_params,
                             {"tokens": torch.from_numpy(toks)}, POLICY)
    # bf16, flash kernel vs the forward's tensor-op flash: the reference's
    # prefill-vs-forward tolerance (tests/test_models.py)
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), rtol=3e-2,
                               atol=3e-2)


# ---------------------------------------------------------------------------
# Decode against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_len", [9, (3, 12)])
def test_decode_attention_matches_jax(cache_len):
    rng = np.random.RandomState(0)
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    kc = rng.randn(2, 12, 2, 16).astype(np.float32)
    vc = rng.randn(2, 12, 2, 16).astype(np.float32)
    cl = np.asarray(cache_len, np.int32)
    got = attn.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                torch.from_numpy(cl))
    want = jax_attn.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                     jnp.asarray(cl))
    # f32, the same formula; summation order only
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # whatever lies beyond cache_len is masked to exact zeros
    lens = np.broadcast_to(cl, (2,))
    for b in range(2):
        kc[b, lens[b]:] = 1e4
        vc[b, lens[b]:] = -1e4
    again = attn.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                  torch.from_numpy(cl))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_decode_step_matches_jax_with_per_row_positions():
    _decode_matches_jax("qwen2.5-3b")


def test_command_r_decode_matches_jax():
    """command-r-35b: LayerNorm, tied embeddings, rope theta 8e6."""
    _decode_matches_jax("command-r-35b")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "dbrx-132b"])
def test_moe_decode_matches_jax(arch):
    """MoE blocks: decode dispatches at capacity = the batch (no drops)."""
    _decode_matches_jax(arch)


def _decode_matches_jax(arch):
    jcfg, tcfg, jparams, params = _both(arch, "float32")
    toks = _tokens(tcfg, 6, 2, seed=3)
    jstates = jax_registry.decode_state_init(jcfg, 2, 16)
    states = registry.decode_state_init(tcfg, 2, 16, **CPU)
    assert [s["k"].shape for s in states] == [s["k"].shape for s in jstates]
    offsets = np.asarray([0, 5])          # the rows at their own positions
    for t in range(6):
        pos = (offsets + t).astype(np.int32)
        jlogits, jstates = jax_registry.decode_step(
            jcfg, jparams, jnp.asarray(toks[t]), jnp.asarray(pos), jstates,
            jax_cm.Policy())
        with torch.no_grad():
            logits, states = registry.decode_step(
                tcfg, params, torch.from_numpy(toks[t]),
                torch.from_numpy(pos), states, POLICY)
        # f32 on both sides: summation order only
        np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4,
                                   atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(states[0][name]),
                                       _np(jstates[0][name]),
                                       rtol=1e-4, atol=1e-4)


def test_scalar_position_is_the_broadcast_vector(qwen_params):
    cfg = get_config("qwen2.5-3b", reduced=True)
    toks = torch.from_numpy(_tokens(cfg, 1, 2, seed=4)[0])
    a = registry.decode_state_init(cfg, 2, 8, **CPU)
    b = registry.decode_state_init(cfg, 2, 8, **CPU)
    with torch.no_grad():
        la, a = registry.decode_step(cfg, qwen_params, toks, 3, a, POLICY)
        lb, b = registry.decode_step(cfg, qwen_params, toks,
                                     torch.tensor([3, 3]), b, POLICY)
    assert torch.equal(la, lb)
    assert torch.equal(a[0]["k"], b[0]["k"])


def test_decode_matches_own_forward_token_by_token(qwen_params):
    cfg = get_config("qwen2.5-3b", reduced=True)
    toks = _tokens(cfg, 2, 12, seed=5)
    with torch.no_grad():
        full, _ = lm.forward(cfg, qwen_params,
                             {"tokens": torch.from_numpy(toks)}, POLICY)
        states = registry.decode_state_init(cfg, 2, 12, **CPU)
        outs = []
        for t in range(12):
            lg, states = registry.decode_step(
                cfg, qwen_params, torch.from_numpy(toks[:, t]), t, states,
                POLICY)
            outs.append(lg)
    # bf16, the reference's decode-vs-forward tolerance
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               rtol=5e-2, atol=5e-2)


def test_prefill_states_continue_into_decode():
    """Prefill states padded along the KV axis feed decode: the next
    step's logits equal those of the decode-scan route over the same
    prompt (f32: the two routes differ by summation order only)."""
    _, cfg, _, params = _both("qwen2.5-3b", "float32")
    toks = _tokens(cfg, 2, 10, seed=6)
    nxt = torch.from_numpy(_tokens(cfg, 2, 1, seed=7)[:, 0])
    _, states = train_steps.make_prefill_step(cfg, POLICY, **CPU)(
        params, {"tokens": toks})
    padded = tuple({n: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 4))
                    for n, x in st.items()} for st in states)
    serve = train_steps.make_serve_step(cfg, POLICY, **CPU)
    _, got, _ = serve(params, nxt, 10, padded)
    scan = registry.decode_state_init(cfg, 2, 14, **CPU)
    scan = train_steps.make_prefill_chunk_step(cfg, POLICY, 10, **CPU)(
        params, toks, 0, scan)
    _, want, _ = serve(params, nxt, 10, scan)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_serve_step_returns_the_greedy_token(qwen_params):
    cfg = get_config("qwen2.5-3b", reduced=True)
    states = registry.decode_state_init(cfg, 3, 4, **CPU)
    tok, logits, out = train_steps.make_serve_step(cfg, POLICY, **CPU)(
        qwen_params, np.asarray([1, 2, 3]), 0, states)
    assert out is states                   # the caches were written in place
    assert tok.dtype == torch.int32
    assert torch.equal(tok, torch.argmax(logits, -1).to(torch.int32))
    assert float(states[0]["k"][:, :, 0].abs().sum()) > 0


# ---------------------------------------------------------------------------
# Greedy tokens against the JAX package's Run.generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run():
    return Run(RunSpec(arch="qwen2.5-3b", steps=1)).init()


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's Run on the JAX Run's parameters (``copy_`` into the
    state the port's Run allocated)."""
    run = PortRun(PortRunSpec(arch="qwen2.5-3b", steps=1), **CPU).init()
    tree = jax.tree.map(np.asarray, jax_run.state["params"])
    carried = convert.params_from_jax(run.cfg, tree, **CPU)
    with torch.no_grad():
        for dst, src in zip(optim.tree_leaves(run.state["params"]),
                            optim.tree_leaves(carried)):
            dst.copy_(src)
    return run


@pytest.mark.parametrize("prompt,gen", [([3, 14, 15, 9, 2, 6, 5], 8),
                                        ([7, 1], 6)])
def test_greedy_solo_route_equals_jax_run_generate(jax_run, port_run, prompt,
                                                   gen):
    """bf16 compute on both sides, shared parameters (RunSpec seed 0): the
    port's ``Run.generate`` against the reference's, and the solo route
    composed by hand against both.  Greedy argmax can flip on a near-tie
    where the frameworks round differently; these prompts, with the
    reference's seed, have none."""
    prompts = np.asarray([prompt], np.int32)
    want = np.asarray(jax_run.generate(prompts, gen=gen))
    got = port_run.generate(prompts, gen=gen)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    solo = generate(port_run.cfg, port_run.state["params"], [prompt], gen)
    np.testing.assert_array_equal(solo, want)


# ---------------------------------------------------------------------------
# ServeSpec: construction-time validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-125m", "zamba2-2.7b",
                                  "qwen2-vl-2b"])
def test_servespec_rejects_archs_not_ported_at_construction(arch):
    """The recurrent archs and the VLM are served; the encoder-decoder is
    refused at construction with the reference's reason (its decode needs
    a primed per-batch cross-attention cache and a shared scalar
    position)."""
    if arch != "whisper-base":
        assert ServeSpec(arch=arch, device="cpu").config.name == arch
        return
    with pytest.raises(ValueError, match="encoder-decoder arch: decode "
                       "requires a primed per-batch cross-attention cache"):
        ServeSpec(arch=arch, device="cpu")


@pytest.mark.parametrize("change,reason", [
    (dict(encoder_layers=2), "encoder-decoder"),
    (dict(pattern=("slstm",)), None),
    (dict(pattern=("attn", "mamba")), None),
    (dict(family="vlm", pos_mode="mrope"), None),
])
def test_serve_compatible_names_the_reason(change, reason):
    """Recurrent and mixed patterns and the VLM are served (``reason``
    None); enc-dec is refused with the reference's reason."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b", reduced=True),
                              **change)
    ok, why = registry.serve_compatible(cfg)
    if reason is None:
        assert (ok, why) == (True, "")
    else:
        assert not ok and reason in why
    assert registry.serve_compatible(get_config("minicpm-2b")) == (True, "")
    assert registry.serve_compatible(cfg) == jax_registry.serve_compatible(
        dataclasses.replace(jax_get_config("qwen2.5-3b", reduced=True),
                            **change))


def test_servespec_rejects_bad_geometry():
    with pytest.raises(ValueError, match="max_slots"):
        _spec(max_slots=0)
    with pytest.raises(ValueError, match="n_pages"):
        _spec(max_len=64, page_size=16, n_pages=2)
    with pytest.raises(ValueError, match="prefill_chunk"):
        _spec(prefill_chunk=0)
    with pytest.raises(ValueError, match="top_k"):
        _spec(top_k=-1)


def test_servespec_geometry_and_request_validation():
    spec = _spec(max_slots=2, page_size=16, max_len=40)
    assert spec.pages_per_slot == 3          # ceil(40/16)
    assert spec.slot_len == 48
    assert spec.total_pages == 2 * 3 + 1     # + scratch page 0
    assert spec.pages_needed(5, 11) == 1
    assert spec.pages_needed(5, 12) == 2
    spec.validate_request(8, 32)             # fits exactly
    with pytest.raises(ValueError, match="max_len"):
        spec.validate_request(8, 33)
    with pytest.raises(ValueError, match="empty"):
        spec.validate_request(0, 4)


# ---------------------------------------------------------------------------
# Page allocator and pool layout
# ---------------------------------------------------------------------------

def test_page_allocator_accounting():
    a = PageAllocator(total_pages=5)         # pages 1..4 usable
    assert a.n_free == 4
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert not a.can_alloc(2)
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc(2)
    a.free(got[:1])
    assert a.can_alloc(2)
    with pytest.raises(ValueError, match="double free"):
        a.free(got[:1])
    with pytest.raises(ValueError, match="scratch"):
        a.free([0])


def test_pool_bytes_counts_what_init_pool_allocates():
    spec = _spec(max_slots=3, page_size=4, max_len=12)
    cfg = spec.config
    states = pool.init_pool(cfg, spec, **CPU)
    real = sum(x.numel() * x.element_size() for st in states
               for x in st.values())
    assert pool.pool_bytes(cfg, spec) == real
    assert states[0]["k"].shape == (cfg.n_repeats, spec.total_pages, 4,
                                    cfg.n_kv_heads, cfg.head_dim)


def test_recurrent_blocks_raise_in_the_pool():
    """A recurrent pattern's pool is slot-indexed state, and ``pool_bytes``
    counts what ``init_pool`` allocates; a block type that no decoder has
    (``"xattn"``) raises ``ValueError`` in both, as the reference's pool
    does through ``block_decode_init``."""
    spec = _spec()
    cfg = dataclasses.replace(spec.config, pattern=("mamba",))
    states = pool.init_pool(cfg, spec, **CPU)
    real = sum(x.numel() * x.element_size() for st in states
               for x in st.values())
    assert pool.pool_bytes(cfg, spec) == real
    assert states[0]["ssm"].shape[:2] == (cfg.n_repeats, spec.max_slots)
    xattn = dataclasses.replace(spec.config, pattern=("xattn",))
    with pytest.raises(ValueError, match="xattn"):
        pool.init_pool(xattn, spec, **CPU)
    with pytest.raises(ValueError, match="xattn"):
        pool.pool_bytes(xattn, spec)
    with pytest.raises(ValueError, match="xattn"):
        jax_pool.pool_bytes(dataclasses.replace(
            jax_get_config("qwen2.5-3b", reduced=True), pattern=("xattn",)),
            JaxServeSpec(arch="qwen2.5-3b", reduced=True, max_slots=2,
                         page_size=4, max_len=16))


def test_gather_and_scatter_round_trip_through_pages():
    spec = _spec(max_slots=2, page_size=4, max_len=8)
    cfg = spec.config
    states = pool.init_pool(cfg, spec, **CPU)
    table = torch.tensor([[3, 1], [2, 4]])
    fill = torch.randn(cfg.n_repeats, 1, 8, cfg.n_kv_heads, cfg.head_dim
                       ).to(cfg.cdtype)
    pool.scatter_slot_states(cfg, states, ({"k": fill, "v": -fill},),
                             table[1], 1)
    got = pool.gather_slot_states(cfg, states, table[1], 1, fresh=False)
    assert torch.equal(got[0]["k"], fill) and torch.equal(got[0]["v"], -fill)
    assert torch.equal(states[0]["k"][:, 2], fill[:, 0, :4])
    both = pool.gather_decode_states(cfg, states, table)
    assert torch.equal(both[0]["k"][:, 1], fill[:, 0])
    assert not bool(both[0]["k"][:, 0].any())


# ---------------------------------------------------------------------------
# The pool: composition independence
# ---------------------------------------------------------------------------

PROMPTS = [[3, 14, 15, 9, 2, 6, 5], [7, 7], [1], [9, 8, 7, 6, 5, 4],
           [2, 4, 6]]
GENS = [8, 5, 4, 3, 6]


def test_pool_bitmatch_ragged_with_churn(qwen_params):
    """Ragged prompts and generation lengths, chunked prefill, more
    requests than slots (queueing, eviction, slot REUSE): every request's
    tokens equal those it gets alone through a pool of the same spec, and
    those of the solo route at the pool's shapes, bit for bit."""
    spec = _spec(max_slots=2, page_size=4, max_len=16, prefill_chunk=3)
    sess = ServeSession(spec, qwen_params)
    handles = [sess.submit(p, max_new=g) for p, g in zip(PROMPTS, GENS)]
    sess.run_until_idle()
    pooled = [h.result(timeout=0) for h in handles]
    alone = [alone_in_a_pool(spec, qwen_params, p, g)
             for p, g in zip(PROMPTS, GENS)]
    assert pooled == alone
    solo = [solo_in_pool_shapes(spec, qwen_params, p, g)
            for p, g in zip(PROMPTS, GENS)]
    assert pooled == solo
    st = sess.stats
    assert st["admitted"] == st["evicted"] == len(PROMPTS)
    assert st["tokens_generated"] == sum(GENS)
    assert sess.scheduler.alloc.n_free == sess.scheduler.alloc.total_usable
    assert [len(t) for t in pooled] == GENS


def test_single_token_prompt_bitmatch(qwen_params):
    """Zero prefill chunks: straight to decode."""
    spec = _spec(max_slots=2, page_size=4, max_len=8)
    got = alone_in_a_pool(spec, qwen_params, [4], 5)
    assert got == solo_in_pool_shapes(spec, qwen_params, [4], 5)
    sess = ServeSession(spec, qwen_params)
    h = sess.submit([4], max_new=5)
    sess.submit([5, 6, 7], max_new=4)         # a neighbour mid-prefill
    sess.run_until_idle()
    assert h.result(timeout=0) == got


# ---------------------------------------------------------------------------
# Sampling: deterministic, composition-independent
# ---------------------------------------------------------------------------

def test_sample_logits_greedy_and_topk_limits():
    logits = torch.from_numpy(
        np.random.default_rng(0).normal(size=(3, 32)).astype(np.float32))
    keys = [sampling.request_key(0, r) for r in range(3)]
    greedy = torch.argmax(logits, -1).to(torch.int32)
    # temperature 0 == argmax, exactly
    assert torch.equal(sampling.sample_logits(logits, keys, np.zeros(3)),
                       greedy)
    # top_k=1 == argmax regardless of temperature
    assert torch.equal(sampling.sample_logits(logits, keys, np.full(3, 2.0),
                                              top_k=1), greedy)
    # same keys -> same draw
    a = sampling.sample_logits(logits, keys, np.ones(3))
    assert torch.equal(a, sampling.sample_logits(logits, keys, np.ones(3)))
    # mixed rows: temp-0 rows greedy, temp>0 rows sampled with their keys
    m = sampling.sample_logits(logits, keys, np.asarray([0.0, 1.0, 0.0]))
    assert m[0] == greedy[0] and m[2] == greedy[2] and m[1] == a[1]
    # a draw depends on its row's key only, not on the batch it sits in
    alone = sampling.sample_logits(logits[1:2], keys[1:2], np.ones(1))
    assert alone[0] == a[1]
    # top_k never draws outside the k largest
    top3 = set(torch.topk(logits[0], 3).indices.tolist())
    for n in range(20):
        draw = sampling.sample_logits(logits[:1], [n], np.full(1, 5.0),
                                      top_k=3)
        assert int(draw[0]) in top3


def test_step_keys_depend_on_seed_uid_and_count_only():
    k = sampling.request_key(11, 3)
    assert k == sampling.request_key(11, 3) != sampling.request_key(11, 4)
    assert sampling.step_keys([k, k], [0, 1]) == [
        sampling.step_keys([k], [0])[0], sampling.step_keys([k], [1])[0]]
    assert len(set(sampling.step_keys([k] * 4, range(4)))) == 4


def test_sampled_serving_deterministic_and_matches_solo(qwen_params):
    prompt, gen = [3, 14, 15, 9], 6
    spec = _spec(max_slots=2, page_size=4, max_len=16, top_k=8)

    def serve_once(neighbour):
        sess = ServeSession(spec, qwen_params)
        h = sess.submit(prompt, max_new=gen, temperature=0.7, seed=11,
                        uid=0)
        sess.submit(neighbour, max_new=4, temperature=1.3, seed=5)
        sess.run_until_idle()
        return h.result(timeout=0)

    first, second = serve_once([8, 8, 8]), serve_once([1, 2, 3, 4, 5])
    assert first == second           # deterministic, whatever the neighbour
    assert first == solo_in_pool_shapes(spec, qwen_params, prompt, gen,
                                        temperature=0.7, seed=11)
    greedy = solo_in_pool_shapes(spec, qwen_params, prompt, gen)
    assert first != greedy           # the draw did sample


# ---------------------------------------------------------------------------
# Admission control / queue backpressure / the host loop
# ---------------------------------------------------------------------------

def test_queue_overflow_raises(qwen_params):
    sess = ServeSession(_spec(max_slots=1, page_size=4, max_len=8,
                              max_queue=2), qwen_params)
    sess.submit([1, 2], max_new=2)
    sess.submit([1, 2], max_new=2)           # queue now at max_queue
    with pytest.raises(RuntimeError, match="queue full"):
        sess.submit([1, 2], max_new=2)
    sess.step()                              # admission drains the queue
    sess.submit([1, 2], max_new=2)           # accepted again
    sess.run_until_idle()


def test_admission_gated_on_pages(qwen_params):
    """Pages scarcer than slots: the second request must WAIT for the
    first one's pages even though a slot is free, then still complete."""
    sess = ServeSession(_spec(max_slots=2, page_size=4, max_len=8,
                              n_pages=3), qwen_params)  # 2 usable pages
    a = sess.submit([1, 2, 3], max_new=5)     # needs 2 pages: takes all
    b = sess.submit([4, 5, 6], max_new=5)
    sess.step()
    reqs = [s.req for s in sess.scheduler.slots]
    assert b.request.status is Status.QUEUED and b.request not in reqs
    sess.run_until_idle()
    assert len(a.result(0)) == 5 and len(b.result(0)) == 5


def test_async_host_loop_serves_from_background_thread(qwen_params):
    spec = _spec(max_slots=2, page_size=4, max_len=16)
    with ServeSession(spec, qwen_params).start() as sess:
        hs = [sess.submit([3, 1, 4], max_new=4) for _ in range(3)]
        outs = [h.result(timeout=120) for h in hs]
        assert sess.stats["decode_steps"] >= 4
    assert outs[0] == outs[1] == outs[2]
    assert outs[0] == alone_in_a_pool(spec, qwen_params, [3, 1, 4], 4)


def test_report_carries_the_counters(qwen_params):
    spec = _spec(max_slots=2, page_size=4, max_len=16)
    sess = ServeSession(spec, qwen_params)
    for p, g in zip(PROMPTS[:3], GENS[:3]):
        sess.submit(p, max_new=g)
    sess.run_until_idle()
    text = sess.report()
    assert "qwen2.5-3b: 2 slots x 4 pages x 4 tok/page" in text
    assert f"{sum(GENS[:3])} tokens over" in text
    assert "3 admitted / 3 completed" in text


# ---------------------------------------------------------------------------
# Chunked prefill: chunk size never changes results
# ---------------------------------------------------------------------------

def test_solo_route_chunk_size_invariant(qwen_params):
    cfg = get_config("qwen2.5-3b", reduced=True)
    prompts = np.asarray([[3, 14, 15, 9, 2, 6, 5, 11, 12],
                          [1, 2, 3, 4, 5, 6, 7, 8, 9]], np.int32)
    outs = [generate(cfg, qwen_params, prompts, 5, chunk=c)
            for c in (1, 4, 64)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[1], outs[2])


def test_pool_chunk_size_invariant(qwen_params):
    prompt = [3, 14, 15, 9, 2, 6, 5, 11, 12]
    outs = [alone_in_a_pool(_spec(max_slots=2, page_size=4, max_len=16,
                                  prefill_chunk=c), qwen_params, prompt, 5)
            for c in (1, 3, 16)]
    assert outs[0] == outs[1] == outs[2]
