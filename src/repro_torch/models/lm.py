"""Decoder-only LM assembly: block stacking, embeddings, loss.

Parameter tree (plain dicts of tensors, weights (d_in, d_out))::

    {"embed": (V, D),
     "layers": [ {"norm1": {"gamma"}, "attn": {"wq","wk","wv","wo",
                  ["bq","bk","bv"]}, "norm2": {"gamma"},
                  "mlp": {"wi", ["wg"], "wo"}}, ... n_layers ],
     "final_norm": {"gamma"}, ["head": (D, V)]}

The reference stacks the layers of one pattern unit along a leading
repeat axis and scans over it; here the layers are a Python list and the
loop is written out (``repro_torch.convert`` maps between the two).  The
tag prefix is the position inside the pattern unit (``b0/`` for the dense
archs), as in the reference; layers are told apart by folding the layer
index into the seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_lib

_LATER = ("block type {btype!r} is not ported yet (MoE, SSM/recurrent and "
          "shared-attention blocks are later items of ROADMAP.md)")


# ---------------------------------------------------------------------------
# Block init/apply dispatch
# ---------------------------------------------------------------------------

def _init_attn_core(cfg, gen, dtype, device):
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": cm.dense_init(gen, (d, h * dh), dtype, device),
        "wk": cm.dense_init(gen, (d, kvh * dh), dtype, device),
        "wv": cm.dense_init(gen, (d, kvh * dh), dtype, device),
        "wo": cm.dense_init(gen, (h * dh, d), dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", kvh * dh),
                            ("bv", kvh * dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    return p


def init_block(cfg, btype: str, gen, dtype, device):
    if btype != "attn":
        raise NotImplementedError(_LATER.format(btype=btype))
    return {"norm1": cm.init_norm(cfg, dtype, device),
            "attn": _init_attn_core(cfg, gen, dtype, device),
            "norm2": cm.init_norm(cfg, dtype, device),
            "mlp": mlp_lib.init_mlp(cfg, gen, dtype, device)}


def _project_qkv(cfg, p, ctx, x, positions):
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # shared sampling plan + single stored H' for q/k/v (they read the
    # same normed activation) — 3x fewer attention-input residuals
    q, k, v = ctx.linear_shared(
        ("attn_q", "attn_k", "attn_v"), x,
        [p["wq"], p["wk"], p["wv"]],
        biases=[p.get("bq"), p.get("bk"), p.get("bv")])
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kvh, dh)
    v = v.reshape(b, s, kvh, dh)
    if cfg.pos_mode == "rope":
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_mode != "none":
        raise NotImplementedError(
            f"pos_mode {cfg.pos_mode!r} is not ported yet (mrope/learned "
            f"positions come with the VLM / enc-dec models)")
    return q, k, v


def apply_block(cfg, btype: str, p, ctx: cm.Ctx, h, positions
                ) -> Tuple[torch.Tensor, Dict]:
    """Training application of one block.  h: (B, S, D)."""
    if btype != "attn":
        raise NotImplementedError(_LATER.format(btype=btype))
    rs = cfg.residual_scale
    x = cm.apply_norm(cfg, p["norm1"], h)
    q, k, v = _project_qkv(cfg, p["attn"], ctx, x, positions)
    o = attn_lib.flash_attention(
        q, k, v, causal=True, q_block=ctx.policy.flash_block,
        kv_block=ctx.policy.flash_block, mode=ctx.policy.flash_mode)
    o = ctx.linear("attn_o", o.reshape(h.shape[0], h.shape[1], -1),
                   p["attn"]["wo"])
    h = h + rs * o
    x = cm.apply_norm(cfg, p["norm2"], h)
    m = mlp_lib.apply_mlp(cfg, p["mlp"], ctx, x)
    return h + rs * m, {}


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def _check_ported(cfg: ArchConfig) -> None:
    for btype in cfg.pattern:
        if btype != "attn":
            raise NotImplementedError(_LATER.format(btype=btype))
    if cfg.is_encdec or cfg.family == "vlm" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: only dense decoder-only archs are ported so far "
            f"(enc-dec, VLM and MoE are later items of ROADMAP.md)")


def init_params(cfg: ArchConfig, seed: int, device="cuda"):
    """Fresh parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``torch.Generator(device).manual_seed(seed)`` with the reference's
    shapes, names and distributions (not its random stream)."""
    _check_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dtype = cfg.pdtype
    params = {
        "embed": cm.dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                               device, scale=0.02),
        "layers": [init_block(cfg, cfg.pattern[i % len(cfg.pattern)], gen,
                              dtype, device)
                   for i in range(cfg.n_layers)],
        "final_norm": cm.init_norm(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = cm.dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    return params


# ---------------------------------------------------------------------------
# Forward (training)
# ---------------------------------------------------------------------------

def embed_inputs(cfg, params, batch, ctx):
    """Token embedding.  Returns (h, positions)."""
    tokens = batch["tokens"]
    h = params["embed"][tokens.to(torch.int64)].to(cfg.cdtype)
    if cfg.pos_mode not in ("rope", "none"):
        raise NotImplementedError(
            f"pos_mode {cfg.pos_mode!r} is not ported yet")
    b, s = h.shape[0], h.shape[1]
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    return h, positions


def forward(cfg: ArchConfig, params, batch, policy: cm.Policy,
            key: Optional[int] = None,
            znorms: Optional[Dict[str, torch.Tensor]] = None,
            recorder: Optional[cm.tag_recorder] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full forward to logits.  batch: {"tokens": (B,S), ...}; ``key`` an
    integer seed; ``znorms`` maps tag -> (n_repeats, B[, S]) estimates."""
    _check_ported(cfg)
    if policy.remat != "none":
        raise NotImplementedError(
            f"remat={policy.remat!r} is not ported yet (only 'none')")
    ctx = cm.Ctx(policy=policy, key=key, znorms=None, recorder=recorder,
                 compute_dtype=cfg.cdtype)
    h, positions = embed_inputs(cfg, params, batch, ctx)
    n_pat = len(cfg.pattern)
    for i, layer in enumerate(params["layers"]):
        ridx, j = divmod(i, n_pat)
        sub = dataclasses.replace(ctx.fold(ridx).fold(j),
                                  tag_prefix=f"b{j}/")
        if znorms is not None:
            sub = dataclasses.replace(
                sub, znorms={t: z[ridx] for t, z in znorms.items()})
        h, _ = apply_block(cfg, cfg.pattern[j], layer, sub, h, positions)
    h = cm.apply_norm(cfg, params["final_norm"], h)
    if cfg.tie_embeddings:
        logits = torch.matmul(h, params["embed"].t().to(cfg.cdtype))
    else:
        logits = torch.matmul(h, params["head"].to(cfg.cdtype))
    return logits, {"lb_loss": torch.zeros((), dtype=torch.float32,
                                           device=h.device)}


def lm_loss(cfg: ArchConfig, params, batch, policy: cm.Policy,
            key=None, znorms=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy (labels = batch["labels"], negative =
    masked), computed in f32."""
    logits, aux = forward(cfg, params, batch, policy, key, znorms)
    labels = batch["labels"].to(torch.int64)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = logz - gold
    mask = (labels >= 0).to(torch.float32)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    aux["ce_loss"] = loss
    return loss, aux
