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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, resolve_or_meta
from repro_torch.models import attention as attn_lib
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.lm import _init_attn_core, _logits, _project_qkv

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
    return ctx.linear("attn_o", o.reshape(x.shape[0], x.shape[1], -1),
                      p["wo"])


def _cross_attn(cfg, p, ctx, x, enc_out):
    """``xattn_q`` over the decoder rows; ``xattn_k`` and ``xattn_v`` two
    sampled linears (two plans) over the encoder's rows."""
    b, s, _ = x.shape
    se = enc_out.shape[1]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = ctx.linear("xattn_q", x, p["wq"]).reshape(b, s, h, dh)
    k = ctx.linear("xattn_k", enc_out, p["wk"]).reshape(b, se, kvh, dh)
    v = ctx.linear("xattn_v", enc_out, p["wv"]).reshape(b, se, kvh, dh)
    o = attn_lib.flash_attention(q, k, v, causal=False,
                                 q_block=ctx.policy.flash_block,
                                 kv_block=ctx.policy.flash_block)
    return ctx.linear("xattn_o", o.reshape(b, s, -1), p["wo"])


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
            recorder: Optional[cm.tag_recorder] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """batch: {"frames": (B, S_enc, D), "tokens": (B, S_dec)} -> logits
    (B, S_dec, V).  ``znorms`` is ignored and ``policy.remat`` is not
    applied, as in the reference."""
    ctx = cm.Ctx(policy=policy, key=key, znorms=None, recorder=recorder,
                 compute_dtype=cfg.cdtype)
    enc_out = encode(cfg, params, batch["frames"], ctx.fold(ENCODER_FOLD))
    tokens = batch["tokens"].to(torch.int64)
    s = tokens.shape[1]
    h = params["embed"][tokens].to(cfg.cdtype)
    h = h + params["pos_dec"][None, :s].to(cfg.cdtype)
    positions = _positions(h)
    for i, p in enumerate(params["decoder"]):
        sub = ctx.fold(i)
        x = cm.apply_norm(cfg, p["norm1"], h)
        h = h + _self_attn(cfg, p["attn"], sub, x, positions, causal=True)
        x = cm.apply_norm(cfg, p["norm_x"], h)
        h = h + _cross_attn(cfg, p["xattn"], sub, x, enc_out)
        x = cm.apply_norm(cfg, p["norm2"], h)
        h = h + mlp_lib.apply_mlp(cfg, p["mlp"], sub, x)
    h = cm.apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h), {}


def loss(cfg, params, batch, policy, key=None, znorms=None):
    """Decoder cross-entropy over ``batch["labels"]`` (negative =
    masked), in f32."""
    logits, aux = forward(cfg, params, batch, policy, key, znorms)
    labels = batch["labels"].to(torch.int64)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    out = torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                         min=1.0)
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


def prime_cross_cache(cfg, params, frames, policy):
    """Run the encoder once and precompute every layer's cross K/V:
    (xk, xv), each (n_layers, B, S_enc, KVH, Dh) in the compute dtype."""
    ctx = cm.Ctx(policy=policy, key=None, compute_dtype=cfg.cdtype)
    enc_out = encode(cfg, params, frames, ctx)
    b, se, _ = enc_out.shape
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    xk, xv = [], []
    for p in params["decoder"]:
        xk.append(ctx.linear("xattn_k", enc_out, p["xattn"]["wk"]).reshape(
            b, se, kvh, dh).to(cfg.cdtype))
        xv.append(ctx.linear("xattn_v", enc_out, p["xattn"]["wv"]).reshape(
            b, se, kvh, dh).to(cfg.cdtype))
    return torch.stack(xk), torch.stack(xv)


def decode_step(cfg: ArchConfig, params, token, pos, state,
                policy: cm.Policy):
    """token (B,) -> (logits (B, V), state); ``state`` from
    ``decode_state_init`` (+ primed cross caches), its ``k`` / ``v``
    written in place at ``pos``.

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
    ctx = cm.Ctx(policy=policy, key=None, compute_dtype=cfg.cdtype)
    token = token.to(torch.int64)
    pos = pos.to(device=token.device, dtype=torch.int64)
    b = token.shape[0]
    hh, dh = cfg.n_heads, cfg.head_dim
    h = params["embed"][token][:, None, :].to(cfg.cdtype)
    h = h + params["pos_dec"][pos][None, None].to(cfg.cdtype)
    positions = pos.reshape(1, 1).expand(b, 1)
    for i, p in enumerate(params["decoder"]):
        k_c, v_c = state["k"][i], state["v"][i]
        xk, xv = state["xk"][i], state["xv"][i]
        x = cm.apply_norm(cfg, p["norm1"], h)
        q, k, v = _project_qkv(cfg, p["attn"], ctx, x, positions)
        k_c[:, pos] = k[:, 0].to(cfg.cdtype)
        v_c[:, pos] = v[:, 0].to(cfg.cdtype)
        o = attn_lib.decode_attention(q, k_c, v_c, pos + 1)
        h = h + ctx.linear("attn_o", o.reshape(b, 1, hh * dh),
                           p["attn"]["wo"])
        x = cm.apply_norm(cfg, p["norm_x"], h)
        q = ctx.linear("xattn_q", x, p["xattn"]["wq"]).reshape(b, 1, hh, dh)
        o = attn_lib.decode_attention(q, xk, xv, xk.shape[1])
        h = h + ctx.linear("xattn_o", o.reshape(b, 1, hh * dh),
                           p["xattn"]["wo"])
        x = cm.apply_norm(cfg, p["norm2"], h)
        h = h + mlp_lib.apply_mlp(cfg, p["mlp"], ctx, x)
    h = cm.apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h)[:, 0], state
