"""Whisper-style encoder-decoder backbone (the conv frontend is a stub).

As in the reference, the modality frontend is stubbed: the batch carries
precomputed frame embeddings (B, S_enc, D) in place of the log-mel +
conv1d stack.  The backbone follows arXiv:2212.04356: encoder blocks are
bidirectional (learned positions), decoder blocks are causal
self-attention + cross-attention to the encoder output, all with GELU
MLPs and pre-LayerNorm.

Parameter tree (plain dicts of tensors, weights (d_in, d_out))::

    {"embed": (V, D), "pos_enc": (P, D), "pos_dec": (P, D),
     "encoder": [ {"norm1", "attn", "norm2", "mlp"}, ... encoder_layers ],
     "decoder": [ {"norm1", "attn", "norm_x", "xattn", "norm2", "mlp"},
                  ... n_layers ],
     "enc_norm": {"gamma", "beta"}, "final_norm": {"gamma", "beta"}}

The reference stacks ``encoder`` and ``decoder`` along a leading layer
axis and scans; here they are lists and the loops are written out
(``repro_torch.convert`` maps between the two).  The encoder's and the
decoder's linears share their tags (``attn_q`` ... ``mlp_wo``, no block
prefix); their plans differ by seed: the encoder's under
``fold(10_000)`` then its layer index, the decoder's under its layer
index, as in the reference.  Like the reference, the enc-dec forward
takes no cached gradient norms (``znorms`` is accepted and ignored) and
no ``Policy.remat`` (ROADMAP Queue C).

Over a model-parallel mesh (``mesh``, M ranks; the parameters this
rank's shards) the encoder's and the decoder's self-attention and MLPs
take the decoder-only LM's program (``models/lm.py``): q heads
column-parallel, kv heads column-parallel or replicated as the rules
shard them, the out-projections and ``mlp_wo`` row-parallel.  ``frames``,
``pos_enc`` / ``pos_dec`` and the LayerNorms are replicated.  The
cross-attention's ``xattn_q`` is column-parallel on the decoder rows and
``xattn_k`` / ``xattn_v`` column-parallel on the encoder output, which
is replicated after the encoder's last row-parallel product: where the
kv heads shard, the encoder output passes *f* once, and that one
all-reduce sums the gradients of every layer's cross k / v; where they
do not, every rank projects them whole and each passes *f*.  The tied
head is vocab-parallel where the vocabulary divides M (the loss then
``lm._vocab_parallel_nll``), whole otherwise.

Decode keeps the self-attention caches split on their sequence dim, as
the decoder-only LM's, and the cross caches split by heads: the layout
the column-parallel ``xattn_k`` / ``xattn_v`` give, so a decode step's
cross-attention reads its own heads and issues no collective (whole on
every rank where the kv heads do not shard).  ``launch.sharding.
decode_state_specs`` gives both.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, resolve_or_meta
from repro_torch.models import attention as attn_lib
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_lib
from repro_torch.launch import collectives
from repro_torch.models import lm
from repro_torch.models.lm import (_AttnShards, _attn_out, _init_attn_core,
                                   _kv_heads_of, _logits, _project_qkv)

# the encoder's plans fold this into the step seed before the layer index
ENCODER_FOLD = 10_000


def init_params(cfg: ArchConfig, seed: int, device="cuda"):
    """Fresh parameters in ``cfg.param_dtype`` on ``device`` with the
    reference's shapes, names and distributions (not its random stream);
    ``device="meta"`` gives the shapes without storage."""
    if str(device) == "meta":
        device, gen = torch.device("meta"), None
    else:
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    dtype = cfg.pdtype

    def enc_block():
        return {"norm1": cm.init_norm(cfg, dtype, device),
                "attn": _init_attn_core(cfg, gen, dtype, device),
                "norm2": cm.init_norm(cfg, dtype, device),
                "mlp": mlp_lib.init_mlp(cfg, gen, dtype, device)}

    def dec_block():
        return {"norm1": cm.init_norm(cfg, dtype, device),
                "attn": _init_attn_core(cfg, gen, dtype, device),
                "norm_x": cm.init_norm(cfg, dtype, device),
                "xattn": _init_attn_core(cfg, gen, dtype, device),
                "norm2": cm.init_norm(cfg, dtype, device),
                "mlp": mlp_lib.init_mlp(cfg, gen, dtype, device)}

    def table(rows):
        return cm.dense_init(gen, (rows, cfg.d_model), dtype, device,
                             scale=0.02)

    return {
        "embed": table(cfg.vocab_size),
        "pos_enc": table(cfg.max_learned_pos),
        "pos_dec": table(cfg.max_learned_pos),
        "encoder": [enc_block() for _ in range(cfg.encoder_layers)],
        "decoder": [dec_block() for _ in range(cfg.n_layers)],
        "enc_norm": cm.init_norm(cfg, dtype, device),
        "final_norm": cm.init_norm(cfg, dtype, device),
    }


def _self_attn(cfg, p, ctx, x, positions, causal):
    q, k, v = _project_qkv(cfg, p, ctx, x, positions)
    o = attn_lib.flash_attention(
        q, k, v, causal=causal, q_block=ctx.policy.flash_block,
        kv_block=ctx.policy.flash_block,
        mode=ctx.policy.flash_mode if causal else "full")
    return _attn_out(cfg, p, ctx, o.reshape(x.shape[0], x.shape[1], -1))


def _cross_q(cfg, p, ctx, x, shards):
    """``xattn_q`` of the decoder rows, (B, S, Hq, Dh): this rank's heads
    (column-parallel), or every head where q's features split through
    heads (all-gathered)."""
    b, s, _ = x.shape
    q = ctx.linear("xattn_q", x, p["wq"],
                   parallel="column" if shards and shards.q else None)
    if shards and shards.q == "features":
        q = collectives.gather_from_model(q, ctx.mesh)
    return q.reshape(b, s, -1, cfg.head_dim)


def _cross_kv_heads(cfg, ctx, shards, hq, k, v):
    """The kv heads (dim 2) this rank's ``hq`` q heads read, where every
    rank holds them all and attends with a part."""
    if shards is None or shards.kv or shards.q != "heads":
        return k, v
    m = collectives.index(ctx.mesh, "model")
    group = cfg.n_heads // cfg.n_kv_heads
    return (_kv_heads_of(m * hq, hq, group, k),
            _kv_heads_of(m * hq, hq, group, v))


def _cross_attn(cfg, p, ctx, x, enc_kv):
    """``xattn_q`` over the decoder rows; ``xattn_k`` and ``xattn_v`` two
    sampled linears (two plans) over the encoder's rows ``enc_kv`` (the
    encoder output, after *f* where the kv heads shard)."""
    b, s, _ = x.shape
    se, dh = enc_kv.shape[1], cfg.head_dim
    shards = _AttnShards.of(cfg, p, ctx.mesh)
    q = _cross_q(cfg, p, ctx, x, shards)
    k = ctx.linear("xattn_k", enc_kv, p["wk"])
    v = ctx.linear("xattn_v", enc_kv, p["wv"])
    if shards is not None and not shards.kv:
        # every rank projects them whole and attends with some heads
        k = collectives.copy_to_model(k, ctx.mesh)
        v = collectives.copy_to_model(v, ctx.mesh)
    k, v = _cross_kv_heads(cfg, ctx, shards, q.shape[2],
                           k.reshape(b, se, -1, dh), v.reshape(b, se, -1, dh))
    o = attn_lib.flash_attention(q, k, v, causal=False,
                                 q_block=ctx.policy.flash_block,
                                 kv_block=ctx.policy.flash_block)
    return _attn_out(cfg, p, ctx, o.reshape(b, s, -1), "xattn_o")


def _cross_input(cfg, params, enc_out, mesh):
    """The encoder output as the cross k / v read it: through *f* once
    where they are column-parallel (see the module doc)."""
    shards = _AttnShards.of(cfg, params["decoder"][0]["xattn"], mesh)
    if shards is not None and shards.kv:
        return collectives.copy_to_model(enc_out, mesh)
    return enc_out


def _positions(h):
    b, s = h.shape[0], h.shape[1]
    return torch.arange(s, device=h.device)[None].expand(b, s)


def encode(cfg, params, frames, ctx):
    """frames: (B, S_enc, D) precomputed embeddings (frontend stub) ->
    the normed encoder output (B, S_enc, D)."""
    s = frames.shape[1]
    h = frames.to(cfg.cdtype) + params["pos_enc"][None, :s].to(cfg.cdtype)
    positions = _positions(h)
    for i, p in enumerate(params["encoder"]):
        sub = ctx.fold(i)
        x = cm.apply_norm(cfg, p["norm1"], h)
        h = h + _self_attn(cfg, p["attn"], sub, x, positions, causal=False)
        x = cm.apply_norm(cfg, p["norm2"], h)
        h = h + mlp_lib.apply_mlp(cfg, p["mlp"], sub, x)
    return cm.apply_norm(cfg, params["enc_norm"], h)


def forward(cfg: ArchConfig, params, batch, policy: cm.Policy,
            key: Optional[int] = None,
            znorms: Optional[Dict[str, torch.Tensor]] = None,
            recorder: Optional[cm.tag_recorder] = None, mesh=None
            ) -> Tuple[torch.Tensor, Dict]:
    """batch: {"frames": (B, S_enc, D), "tokens": (B, S_dec)} -> logits
    (B, S_dec, V), this rank's vocab shard where the head is sharded.
    ``znorms`` is ignored and ``policy.remat`` is not applied, as in the
    reference.  ``mesh``: a model-parallel mesh (module doc)."""
    ctx = cm.Ctx(policy=policy, key=key, znorms=None, recorder=recorder,
                 compute_dtype=cfg.cdtype, mesh=mesh)
    enc_out = encode(cfg, params, batch["frames"], ctx.fold(ENCODER_FOLD))
    enc_kv = _cross_input(cfg, params, enc_out, mesh)
    tokens = batch["tokens"].to(torch.int64)
    s = tokens.shape[1]
    h = lm._lookup(cfg, params, tokens, mesh)
    h = h + params["pos_dec"][None, :s].to(cfg.cdtype)
    positions = _positions(h)
    for i, p in enumerate(params["decoder"]):
        sub = ctx.fold(i)
        x = cm.apply_norm(cfg, p["norm1"], h)
        h = h + _self_attn(cfg, p["attn"], sub, x, positions, causal=True)
        x = cm.apply_norm(cfg, p["norm_x"], h)
        h = h + _cross_attn(cfg, p["xattn"], sub, x, enc_kv)
        x = cm.apply_norm(cfg, p["norm2"], h)
        h = h + mlp_lib.apply_mlp(cfg, p["mlp"], sub, x)
    h = cm.apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h, mesh), {}


def loss(cfg, params, batch, policy, key=None, znorms=None, mesh=None):
    """Decoder cross-entropy over ``batch["labels"]`` (negative =
    masked), in f32; vocab-parallel where the tied head is sharded."""
    logits, aux = forward(cfg, params, batch, policy, key, znorms,
                          mesh=mesh)
    labels = batch["labels"].to(torch.int64)
    out = lm.masked_nll(cfg, logits, labels, mesh)
    aux["ce_loss"] = out
    return out, aux


# ---------------------------------------------------------------------------
# Decode: cached self-attention + precomputed cross K/V
# ---------------------------------------------------------------------------

def decode_state_init(cfg: ArchConfig, batch_size: int, max_len: int,
                      enc_len: int, device="cuda"):
    """{"k", "v": (n_layers, B, max_len, KVH, Dh), "xk", "xv": (n_layers,
    B, enc_len, KVH, Dh)} zeros in the compute dtype; ``xk`` / ``xv`` take
    ``prime_cross_cache``'s output."""
    device = resolve_or_meta(device)
    kvh, dh = cfg.n_kv_heads, cfg.head_dim

    def zeros(length):
        return torch.zeros((cfg.n_layers, batch_size, length, kvh, dh),
                           dtype=cfg.cdtype, device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(enc_len), "xv": zeros(enc_len)}


def prime_cross_cache(cfg, params, frames, policy, mesh=None):
    """Run the encoder once and precompute every layer's cross K/V:
    (xk, xv), each (n_layers, B, S_enc, KVH, Dh) in the compute dtype —
    on a model-parallel ``mesh`` this rank's kv heads where they shard
    (module doc)."""
    ctx = cm.Ctx(policy=policy, key=None, compute_dtype=cfg.cdtype,
                 mesh=mesh)
    enc_out = encode(cfg, params, frames, ctx)
    b, se, _ = enc_out.shape
    dh = cfg.head_dim
    xk, xv = [], []
    for p in params["decoder"]:
        xk.append(ctx.linear("xattn_k", enc_out, p["xattn"]["wk"]).reshape(
            b, se, -1, dh).to(cfg.cdtype))
        xv.append(ctx.linear("xattn_v", enc_out, p["xattn"]["wv"]).reshape(
            b, se, -1, dh).to(cfg.cdtype))
    return torch.stack(xk), torch.stack(xv)


def decode_step(cfg: ArchConfig, params, token, pos, state,
                policy: cm.Policy, mesh=None):
    """token (B,) -> (logits (B, V), state); ``state`` from
    ``decode_state_init`` (+ primed cross caches), its ``k`` / ``v``
    written in place at ``pos``.  ``mesh``: a model-parallel mesh, the
    state this rank's (module doc); the logits are whole.

    ``pos`` must be a shared scalar: enc-dec decode is keyed to one primed
    cross-attention cache per batch, so ragged per-slot positions
    (continuous batching) are not supported — ``ServeSpec`` refuses
    enc-dec archs at construction for this reason."""
    pos = torch.as_tensor(pos)
    if pos.ndim > 0:
        raise NotImplementedError(
            "enc-dec decode takes one shared scalar position (the batch "
            "is aligned to a single primed cross-attention cache); "
            "per-slot ragged positions are a decoder-only-LM feature")
    ctx = cm.Ctx(policy=policy, key=None, compute_dtype=cfg.cdtype,
                 mesh=mesh)
    token = token.to(torch.int64)
    pos = pos.to(device=token.device, dtype=torch.int64)
    b = token.shape[0]
    h = lm._lookup(cfg, params, token, mesh)[:, None, :]
    h = h + params["pos_dec"][pos][None, None].to(cfg.cdtype)
    positions = pos.reshape(1, 1).expand(b, 1)
    rows_pos = pos.reshape(1).expand(b)
    for i, p in enumerate(params["decoder"]):
        xk, xv = state["xk"][i], state["xv"][i]
        x = cm.apply_norm(cfg, p["norm1"], h)
        h = h + lm.cached_self_attention(cfg, p["attn"], ctx, x,
                                         state["k"][i], state["v"][i],
                                         rows_pos, positions)
        x = cm.apply_norm(cfg, p["norm_x"], h)
        shards = _AttnShards.of(cfg, p["xattn"], mesh)
        q = _cross_q(cfg, p["xattn"], ctx, x, shards)
        xk, xv = _cross_kv_heads(cfg, ctx, shards, q.shape[2], xk, xv)
        o = attn_lib.decode_attention(q, xk, xv, xk.shape[1])
        h = h + _attn_out(cfg, p["xattn"], ctx, o.reshape(b, 1, -1),
                          "xattn_o")
        x = cm.apply_norm(cfg, p["norm2"], h)
        h = h + mlp_lib.apply_mlp(cfg, p["mlp"], ctx, x)
    h = cm.apply_norm(cfg, params["final_norm"], h)
    return lm._whole_logits(cfg, params, h, mesh)[:, 0], state
