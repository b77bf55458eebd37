"""Decoder-only LM assembly: block stacking, embeddings, loss, and the
serving path (prefill through the flash kernel, cached single-token decode).

Parameter tree (plain dicts of tensors, weights (d_in, d_out))::

    {"embed": (V, D),
     "layers": [ {"norm1": {"gamma"}, "attn": {"wq","wk","wv","wo",
                  ["bq","bk","bv"]}, "norm2": {"gamma"},
                  "mlp": {"wi", ["wg"], "wo"}}, ... n_layers ],
     "final_norm": {"gamma"}, ["head": (D, V)], ["vis_proj": (D, D)],
     ["pos_embed": (max_learned_pos, D)]}

A VLM (qwen2-vl-2b) projects its patch embeddings through the sampled
linear ``vis_proj`` ahead of the layer stack and rotates q/k by M-RoPE's
three position streams; learned positions add ``pos_embed``.  The
encoder-decoder archs live in ``models/encdec.py``.

An ``attn_moe`` block holds ``"moe": {"router": (D, E), "wi", "wg":
(E, D, F), "wo": (E, F, D)}`` in place of ``"mlp"``; its load-balancing
loss is summed over the layers into ``forward``'s aux and enters
``lm_loss`` as ``0.01 * lb_loss / n_layers``, as in the reference.
A recurrent block (``mamba``, ``mlstm``, ``slstm``) holds ``"norm1"`` and
its mixer (``models/ssm.py``).  Zamba2's ``shared_attn`` blocks share one
attention block, ``params["shared"]``, and their layer slots are ``{}``
placeholders, as in the reference; each use keeps its own KV cache, draws
its own plans and adds its dW into the one gradient.

The reference stacks the layers of one pattern unit along a leading
repeat axis and scans over it; here the layers are a Python list and the
loop is written out (``repro_torch.convert`` maps between the two).  The
tag prefix is the position inside the pattern unit (``b0/`` for the dense
archs), as in the reference; layers are told apart by folding the layer
index into the seed.  ``Policy.remat`` rematerialises each layer as the
reference rematerialises each unit of its scan (``_RematLayer``).

Tensor and expert parallelism (a mesh whose ``model`` axis holds M
ranks, Megatron's layout): the parameters are this rank's shards
(``launch.sharding.shard_params``) and the code reads what is sharded
from their shapes.  q heads are column-parallel; k / v are too where the
rules shard the kv heads, else every rank projects them whole (their
gradient all-reduced through *f*) and takes the kv heads its q heads
read.  Where the q features shard through head boundaries (minicpm-2b's
36 heads on 16 ranks) q is all-gathered before the scores, every rank
attends over every head and keeps its slice of the output.  The
out-projection is row-parallel.  The embedding is vocab-parallel (a
masked lookup, then an all-reduce), the head column-parallel, and the
loss reduces the max and the sum-exp of the logits across ranks without
gathering them.  Prefill and decode keep each KV cache split on the dim
``launch.sharding.decode_state_shardings`` picks (``kv_cache_spec``), and
decode reads which from the cache's shape: on its sequence, a rank
attends over its positions and the softmax max, its sum and the P·V
product are all-reduced; on ``head_dim``, the partial scores are
all-reduced before the softmax and the ranks' P·V features all-gathered;
on the kv heads, each rank attends with its kv heads and the q heads that
read them, and the heads' outputs are all-gathered.  The recurrent blocks run their own
model-parallel programs (``models/ssm.py``), their states split by heads
or whole as ``launch.sharding.decode_state_specs`` says; Zamba2's shared
block is an attention block like the others, its one parameter set read
by every use.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core import linear as lin
from repro_torch.device import resolve_device, resolve_or_meta
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import collectives
from repro_torch.launch import sharding as shard_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.train import optim as optim_lib

_ATTN = ("attn", "attn_moe", "shared_attn")
BLOCK_TYPES = _ATTN + ssm_lib.RECURRENT
_INIT = {"mamba": ssm_lib.init_mamba, "mlstm": ssm_lib.init_mlstm,
         "slstm": ssm_lib.init_slstm}
_APPLY = {"mamba": ssm_lib.apply_mamba, "mlstm": ssm_lib.apply_mlstm,
          "slstm": ssm_lib.apply_slstm}
_DECODE = {"mamba": ssm_lib.mamba_decode_step,
           "mlstm": ssm_lib.mlstm_decode_step,
           "slstm": ssm_lib.slstm_decode_step}


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
    if btype not in BLOCK_TYPES:
        raise ValueError(btype)
    if btype in _INIT:
        return {"norm1": cm.init_norm(cfg, dtype, device),
                btype: _INIT[btype](cfg, gen, dtype, device)}
    p = {"norm1": cm.init_norm(cfg, dtype, device),
         "attn": _init_attn_core(cfg, gen, dtype, device),
         "norm2": cm.init_norm(cfg, dtype, device)}
    if btype == "attn_moe":
        p["moe"] = mlp_lib.init_moe(cfg, gen, dtype, device)
    else:
        p["mlp"] = mlp_lib.init_mlp(cfg, gen, dtype, device)
    return p


def _rotate(cfg, x, positions):
    if cfg.pos_mode == "rope":
        return cm.apply_rope(x, positions, cfg.rope_theta)
    if cfg.pos_mode == "mrope":
        return cm.apply_mrope(x, positions, cfg.rope_theta)
    return x


@dataclasses.dataclass(frozen=True)
class _AttnShards:
    """How one rank holds an attention block on a model-parallel mesh,
    read off its shards' shapes: ``q`` is ``"heads"`` (whole q heads a
    rank), ``"features"`` (q's features cut through heads) or None
    (replicated); ``kv`` whether the kv heads are sharded."""
    q: Optional[str]
    kv: bool

    @staticmethod
    def of(cfg, p, mesh) -> Optional["_AttnShards"]:
        if mesh is None:
            return None
        q_cols, kv_cols = p["wq"].shape[1], p["wk"].shape[1]
        q = None
        if q_cols < cfg.n_heads * cfg.head_dim:
            q = "heads" if q_cols % cfg.head_dim == 0 else "features"
        kv = kv_cols < cfg.n_kv_heads * cfg.head_dim
        # (wo's rows shard with wq's columns: one logical axis)
        return None if q is None and not kv else _AttnShards(q, kv)


def _kv_heads_of(q0: int, hq: int, group: int, kv: torch.Tensor):
    """The kv heads (dim 2 of ``kv``) q heads [q0, q0 + hq) read, in the
    order the attention's grouping pairs them with those q heads: a slice
    where each is shared by an equal run of them, else one a q head."""
    first, last = q0 // group, (q0 + hq - 1) // group
    n = last - first + 1
    if hq % n == 0 and all((q0 + i) // group == first + i // (hq // n)
                           for i in range(hq)):
        return kv[:, :, first:last + 1]
    rows = torch.tensor([(q0 + i) // group for i in range(hq)],
                        device=kv.device)
    return kv.index_select(2, rows)


def _project_qkv(cfg, p, ctx, x, positions, want_all: bool = False):
    """(q, k, v) with q (B, S, Hq, Dh) and k / v (B, S, KVq, Dh) the heads
    this rank attends with (Hq = KVq · group); all heads without a
    model-parallel mesh.  ``want_all`` (prefill, decode) adds (k, v) of
    every kv head, for the cache."""
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tags = ("attn_q", "attn_k", "attn_v")
    ws = [p["wq"], p["wk"], p["wv"]]
    biases = [p.get("bq"), p.get("bk"), p.get("bv")]
    shards = _AttnShards.of(cfg, p, ctx.mesh)
    if shards is None:
        # shared sampling plan + single stored H' for q/k/v (they read the
        # same normed activation) — 3x fewer attention-input residuals
        q, k, v = ctx.linear_shared(tags, x, ws, biases=biases)
        q = _rotate(cfg, q.reshape(b, s, h, dh), positions)
        k = _rotate(cfg, k.reshape(b, s, kvh, dh), positions)
        v = v.reshape(b, s, kvh, dh)
        return (q, k, v, (k, v)) if want_all else (q, k, v)
    mesh, m = ctx.mesh, collectives.index(ctx.mesh, "model")
    par_q = "column" if shards.q else None
    par_kv = "column" if shards.kv else None
    q, k, v = ctx.linear_shared(tags, x, ws, biases=biases,
                                parallel=(par_q, par_kv, par_kv))
    if not shards.kv:
        # every rank projects the kv heads whole; each attends with some
        # of them, so their gradient sums over the ranks (f)
        k = collectives.copy_to_model(k, mesh)
        v = collectives.copy_to_model(v, mesh)
    if shards.q == "features":
        q = collectives.gather_from_model(q, mesh)
    hq = q.shape[-1] // dh
    q = _rotate(cfg, q.reshape(b, s, hq, dh), positions)
    k = _rotate(cfg, k.reshape(b, s, -1, dh), positions)
    v = v.reshape(b, s, -1, dh)
    every = None
    if want_all:
        every = ((collectives.all_gather(k, mesh, "model", dim=2),
                  collectives.all_gather(v, mesh, "model", dim=2))
                 if shards.kv else (k, v))
    if shards.q == "heads" and not shards.kv:
        group = h // kvh
        k = _kv_heads_of(m * hq, hq, group, k)
        v = _kv_heads_of(m * hq, hq, group, v)
    return (q, k, v, every) if want_all else (q, k, v)


def _attn_out(cfg, p, ctx, o, tag: str = "attn_o"):
    """The out-projection of the (B, S, Hq·Dh) attention output: row-
    parallel on a model-parallel mesh (after keeping this rank's slice of
    the features where q was all-gathered)."""
    shards = _AttnShards.of(cfg, p, ctx.mesh)
    if shards is None:
        return ctx.linear(tag, o, p["wo"])
    rows = p["wo"].shape[0]
    if o.shape[-1] != rows:
        o = o.narrow(-1, collectives.index(ctx.mesh, "model") * rows, rows)
    return ctx.linear(tag, o, p["wo"], parallel="row")


def _ffn(cfg, p, ctx: cm.Ctx, x) -> Tuple[torch.Tensor, Dict]:
    """The block's MLP or MoE on the normed x: (output, aux)."""
    if "moe" in p:
        return mlp_lib.apply_moe(cfg, p["moe"], ctx, x)
    return mlp_lib.apply_mlp(cfg, p["mlp"], ctx, x), {}


def apply_block(cfg, btype: str, p, ctx: cm.Ctx, h, positions,
                shared=None) -> Tuple[torch.Tensor, Dict]:
    """Training application of one block.  h: (B, S, D).  Returns (h,
    aux); an ``attn_moe`` block's aux holds ``lb_loss`` and
    ``drop_frac``.  A ``shared_attn`` block runs ``shared`` (its ``p`` is
    the ``{}`` placeholder)."""
    if btype not in BLOCK_TYPES:
        raise ValueError(btype)
    rs = cfg.residual_scale
    if btype == "shared_attn":
        p = shared
    with tracing.span("block"):
        x = cm.apply_norm(cfg, p["norm1"], h)
        if btype in _APPLY:
            return h + rs * _APPLY[btype](cfg, p[btype], ctx, x), {}
        q, k, v = _project_qkv(cfg, p["attn"], ctx, x, positions)
        with tracing.span("attention"):
            o = attn_lib.flash_attention(
                q, k, v, causal=True, q_block=ctx.policy.flash_block,
                kv_block=ctx.policy.flash_block, mode=ctx.policy.flash_mode)
            tracing.span_backward("attention.bwd", o, (q, k, v))
        o = _attn_out(cfg, p["attn"], ctx,
                      o.reshape(h.shape[0], h.shape[1], -1))
        h = h + rs * o
        x = cm.apply_norm(cfg, p["norm2"], h)
        m, aux = _ffn(cfg, p, ctx, x)
        return h + rs * m, aux


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def _layer(cfg: ArchConfig, params, i: int):
    """(repeat, pattern position, block type, parameters) of layer ``i``:
    a ``shared_attn`` layer's parameters are the shared block's."""
    ridx, j = divmod(i, len(cfg.pattern))
    btype = cfg.pattern[j]
    p = params["shared"] if btype == "shared_attn" else params["layers"][i]
    return ridx, j, btype, p


def init_params(cfg: ArchConfig, seed: int, device="cuda"):
    """Fresh parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``torch.Generator(device).manual_seed(seed)`` with the reference's
    shapes, names and distributions (not its random stream).
    ``device="meta"`` gives the tree's shapes without storage (the tag
    trace of ``train/znorm.py``).  A VLM adds ``vis_proj`` (D, D), the
    projection of the patch stub; learned positions add ``pos_embed``
    (max_learned_pos, D)."""
    if str(device) == "meta":
        device, gen = torch.device("meta"), None
    else:
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    dtype = cfg.pdtype
    params = {
        "embed": cm.dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                               device, scale=0.02),
        "layers": [],
        "final_norm": cm.init_norm(cfg, dtype, device),
    }
    for i in range(cfg.n_layers):
        btype = cfg.pattern[i % len(cfg.pattern)]
        if btype == "shared_attn":
            if "shared" not in params:
                params["shared"] = init_block(cfg, btype, gen, dtype, device)
            params["layers"].append({})  # the parameters live in "shared"
        else:
            params["layers"].append(init_block(cfg, btype, gen, dtype,
                                               device))
    if not cfg.tie_embeddings:
        params["head"] = cm.dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    if cfg.family == "vlm":
        params["vis_proj"] = cm.dense_init(
            gen, (cfg.d_model, cfg.d_model), dtype, device)
    if cfg.pos_mode == "learned":
        params["pos_embed"] = cm.dense_init(
            gen, (cfg.max_learned_pos, cfg.d_model), dtype, device,
            scale=0.02)
    return params


# ---------------------------------------------------------------------------
# Forward (training)
# ---------------------------------------------------------------------------

def _vocab_slice(table: torch.Tensor, cfg, mesh):
    """(first row, rows) of this rank's vocab shard of ``table`` (V, D) or
    None where the table is whole."""
    rows = table.shape[0]
    if mesh is None or rows == cfg.vocab_size:
        return None
    return collectives.index(mesh, "model") * rows, rows


def _lookup(cfg, params, tokens, mesh):
    """Embedding rows of ``tokens``; vocab-parallel, a masked lookup of
    this rank's rows and an all-reduce (each token's row comes from one
    rank, zeros from the others)."""
    table = params["embed"]
    shard = _vocab_slice(table, cfg, mesh)
    tokens = tokens.to(torch.int64)
    if shard is None:
        return table[tokens].to(cfg.cdtype)
    lo, rows = shard
    local = tokens - lo
    inside = (local >= 0) & (local < rows)
    h = table[torch.clamp(local, 0, rows - 1)]
    h = torch.where(inside[..., None], h, torch.zeros((), dtype=h.dtype,
                                                      device=h.device))
    return collectives.reduce_from_model(h, mesh).to(cfg.cdtype)


def embed_inputs(cfg, params, batch, ctx):
    """Token (+modality-stub) embedding.  Returns (h, positions).

    A VLM's patch embeddings (``batch["patches"]``, (B, S_vis, D)) go
    through the sampled linear ``vis_proj`` and come before the text, and
    its positions are ``batch["positions3"]`` (3, B, S); learned positions
    add ``pos_embed``'s first S rows."""
    tokens = batch["tokens"]
    h = _lookup(cfg, params, tokens, ctx.mesh)
    b, s = h.shape[0], h.shape[1]
    if cfg.family == "vlm":
        patches = batch["patches"].to(cfg.cdtype)
        vis = ctx.linear("vis_proj", patches, params["vis_proj"])
        return torch.cat([vis, h], dim=1), batch["positions3"]
    if cfg.pos_mode == "learned":
        h = h + params["pos_embed"][None, :s].to(cfg.cdtype)
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    return h, positions


REMAT_MODES = ("none", "full", "wtacrs_names")


class _RematLayer(torch.autograd.Function):
    """One layer, rematerialised: the forward runs it without recording a
    graph and saves only its inputs (the layer input h, the layer's
    parameters, its znorm slices) and, under ``"wtacrs_names"``, the
    sampled linears' kept (H', idx, scale); the backward runs the layer
    again with grad and back-propagates through that recompute.  The
    recompute is bit-identical to the forward (the same ops on the same
    inputs, a sampled linear's plan drawn from the same seed or taken from
    the stash), so the gradients are those of ``remat="none"``.

    ``run(inputs, stash, recompute)`` applies the layer to the flat
    ``inputs`` (see ``_remat_layer``) and returns its output, or (output,
    load-balancing loss) for an MoE layer — as the reference's checkpointed
    scan unit carries (h, aux_lb) — so the loss and the router's gradient
    through it survive the remat.  A ``shared_attn`` layer's parameter
    inputs are the shared block's tensors: each use gives back its own
    gradient, and autograd sums them into the one leaf in the order
    ``remat="none"`` does."""

    @staticmethod
    def forward(ctx, run, keep_sampled: bool, *inputs):
        stash = lin.RematStash() if keep_sampled else None
        out = run(inputs, stash, False)
        kept = stash.tensors() if stash is not None else []
        ctx.run, ctx.n_inputs = run, len(inputs)
        ctx.keep_sampled = keep_sampled
        ctx.save_for_backward(*inputs, *kept)
        return out

    @staticmethod
    def backward(ctx, *grad_outs):
        saved = ctx.saved_tensors
        inputs = [x.detach().requires_grad_(need) for x, need in zip(
            saved[:ctx.n_inputs], ctx.needs_input_grad[2:])]
        stash = (lin.RematStash(saved[ctx.n_inputs:])
                 if ctx.keep_sampled else None)
        with torch.enable_grad():
            out = ctx.run(inputs, stash, True)
        outs = out if isinstance(out, tuple) else (out,)
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(torch.autograd.grad(outs, wanted, grad_outs,
                                         allow_unused=True))
        return (None, None, *(next(grads) if x.requires_grad else None
                              for x in inputs))


def _remat_layer(cfg, btype, layer, sub, h, positions
                 ) -> Tuple[torch.Tensor, Dict]:
    """``apply_block`` of one layer as a ``_RematLayer``, its inputs the
    layer input ``h``, the layer's parameter leaves (the shared block's
    for a ``shared_attn`` layer) and ``sub``'s znorm slices.  Returns (h,
    aux) with aux's ``lb_loss`` for an MoE layer (its ``drop_frac`` is not
    carried)."""
    weights = []
    optim_lib.tree_map(weights.append, layer)
    tags = sorted(sub.znorms) if sub.znorms is not None else []

    def run(inputs, stash, recompute):
        it = iter(inputs[1:])
        p = optim_lib.tree_map(lambda _: next(it), layer)
        zn = {t: next(it) for t in tags} if tags else None
        # the recompute records no tag a second time
        c = dataclasses.replace(sub, znorms=zn, stash=stash,
                                recorder=None if recompute else sub.recorder)
        out, aux = apply_block(cfg, btype, p, c, inputs[0], positions,
                               shared=p)
        return (out, aux["lb_loss"]) if "lb_loss" in aux else out

    inputs = [h, *weights, *(sub.znorms[t] for t in tags)]
    if not (torch.is_grad_enabled() and any(x.requires_grad
                                            for x in inputs)):
        out = run(inputs, None, False)       # no backward to remat for
    else:
        out = _RematLayer.apply(run, sub.policy.remat == "wtacrs_names",
                                *inputs)
    if isinstance(out, tuple):
        return out[0], {"lb_loss": out[1]}
    return out, {}


def forward(cfg: ArchConfig, params, batch, policy: cm.Policy,
            key: Optional[int] = None,
            znorms: Optional[Dict[str, torch.Tensor]] = None,
            recorder: Optional[cm.tag_recorder] = None, mesh=None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full forward to logits.  batch: {"tokens": (B,S), ...}; ``key`` an
    integer seed; ``znorms`` maps tag -> (n_repeats, B[, S]) estimates.
    Under ``policy.remat`` other than ``"none"`` each layer runs as a
    ``_RematLayer`` (when a backward will follow).  ``mesh``: a
    model-parallel mesh (see the module doc); the logits are then this
    rank's vocab shard where the head is sharded."""
    if policy.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {policy.remat!r}; one of "
                         f"{REMAT_MODES}")
    ctx = cm.Ctx(policy=policy, key=key, znorms=None, recorder=recorder,
                 compute_dtype=cfg.cdtype, mesh=mesh)
    with tracing.span("embed"):
        h, positions = embed_inputs(cfg, params, batch, ctx)
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        ridx, j, btype, layer = _layer(cfg, params, i)
        sub = dataclasses.replace(ctx.fold(ridx).fold(j),
                                  tag_prefix=f"b{j}/")
        if znorms is not None:
            sub = dataclasses.replace(
                sub, znorms={t: z[ridx] for t, z in znorms.items()})
        if policy.remat == "none":
            h, aux = apply_block(cfg, btype, layer, sub, h, positions,
                                 shared=layer)
        else:
            h, aux = _remat_layer(cfg, btype, layer, sub, h, positions)
        if "lb_loss" in aux:
            lb = lb + aux["lb_loss"]
    with tracing.span("head"):
        h = cm.apply_norm(cfg, params["final_norm"], h)
        logits = _logits(cfg, params, h, mesh)
    return logits, {"lb_loss": lb}


def _logits(cfg, params, h, mesh=None):
    """Logits of ``h``; a vocab-sharded head's (column-parallel: h passes
    *f*) are this rank's shard."""
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    if mesh is not None and w.shape[1] != cfg.vocab_size:
        h = collectives.copy_to_model(h, mesh)
    return torch.matmul(h, w.to(cfg.cdtype))


def _whole_logits(cfg, params, h, mesh=None):
    """Logits over the whole vocabulary (serving): a sharded head's are
    all-gathered."""
    logits = _logits(cfg, params, h, mesh)
    if mesh is not None and logits.shape[-1] != cfg.vocab_size:
        logits = collectives.all_gather(logits, mesh, "model", dim=-1)
    return logits


# ---------------------------------------------------------------------------
# Prefill: forward + decode-state emission + last-token logits
# ---------------------------------------------------------------------------

def _flash_prefill(q, k, v):
    """(B,S,H,Dh) q and (B,S,KVH,Dh) k/v through the flash kernel's
    (BH, S, Dh) layout: query head b*H + h reads kv head b*KVH + h//group.
    Returns (B, S, H*Dh)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]

    def heads_first(x):
        return x.permute(0, 2, 1, 3).reshape(-1, s, dh).contiguous()

    o = kernel_ops.flash_attention_fwd(heads_first(q), heads_first(k),
                                       heads_first(v), group=h // kvh,
                                       causal=True)
    return o.reshape(b, h, s, dh).permute(0, 2, 1, 3).reshape(b, s, h * dh)


def _kv_shard(cfg, x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's shard of a whole (B, S, KVH, Dh) cache, on the dim
    ``launch.sharding.kv_cache_spec`` picks."""
    spec = shard_lib.kv_cache_spec(cfg, x.shape[0], x.shape[1], mesh)
    return shard_lib.shard_leaf(x, spec, mesh)


def kv_split(cfg, k_cache: torch.Tensor, mesh) -> Optional[str]:
    """How a rank holds a (B, S, KVH, Dh) KV cache on a model-parallel
    mesh, read off its shape: ``"dh"`` (a slice of ``head_dim``),
    ``"kvh"`` (some kv heads), ``"seq"`` (a slice of the positions) or
    None (whole: the rule splits no dim of a cache of this length)."""
    b, s, kvh, dh = k_cache.shape
    if dh != cfg.head_dim:
        return "dh"
    if kvh != cfg.n_kv_heads:
        return "kvh"
    whole = shard_lib.kv_cache_spec(cfg, b, s, mesh)
    return "seq" if shard_lib.is_sharded(whole) else None


def prefill(cfg: ArchConfig, params, batch, policy: cm.Policy, mesh=None):
    """Run the prompt through the stack, returning (last_logits, states).

    Attention is the ``flash_attention_fwd`` kernel (its plain version on
    the CPU).  ``states`` has ``decode_state_init``'s layout with
    max_len == prompt length: a tuple over ``cfg.pattern`` of dicts
    stacked over repeats — {"k", "v"} (n_repeats, B, S, KVH, Dh) in the
    compute dtype for an attention block (the serving layer adds head-room
    by padding the KV axis), the block's recurrent state after the prompt
    for a recurrent one.  Only the last position goes through the final
    norm and the head.  On a model-parallel ``mesh`` each rank keeps its
    shard of the caches (``kv_cache_spec``'s dim) and the logits are
    whole.
    """
    ctx = cm.Ctx(policy=policy, key=None, znorms=None,
                 compute_dtype=cfg.cdtype, mesh=mesh)
    with tracing.span("embed"):
        h, positions = embed_inputs(cfg, params, batch, ctx)
    caches = [{} for _ in cfg.pattern]
    for i in range(cfg.n_layers):
        ridx, j, btype, p = _layer(cfg, params, i)
        ctx_r = ctx.fold(ridx)
        with tracing.span("block"):
            x = cm.apply_norm(cfg, p["norm1"], h)
            if btype in _APPLY:
                o, st = _APPLY[btype](cfg, p[btype], ctx_r, x,
                                      return_state=True)
                h = h + cfg.residual_scale * o
            else:
                q, k, v, (k_all, v_all) = _project_qkv(
                    cfg, p["attn"], ctx_r, x, positions, want_all=True)
                with tracing.span("attention"):
                    o = _flash_prefill(q, k, v)
                o = _attn_out(cfg, p["attn"], ctx_r, o)
                h = h + cfg.residual_scale * o
                x = cm.apply_norm(cfg, p["norm2"], h)
                h = h + cfg.residual_scale * _ffn(cfg, p, ctx_r, x)[0]
                if mesh is not None:
                    k_all = _kv_shard(cfg, k_all, mesh)
                    v_all = _kv_shard(cfg, v_all, mesh)
                st = {"k": k_all.to(cfg.cdtype), "v": v_all.to(cfg.cdtype)}
            for name, x in st.items():
                caches[j].setdefault(name, []).append(x)
    states = tuple({name: torch.stack(xs) for name, xs in c.items()}
                   for c in caches)
    with tracing.span("head"):
        h = cm.apply_norm(cfg, params["final_norm"], h[:, -1:])
        logits = _whole_logits(cfg, params, h, mesh)[:, 0]
    return logits, states


# ---------------------------------------------------------------------------
# Decode (single-token serve step with per-block state)
# ---------------------------------------------------------------------------

def block_decode_init(cfg, btype, batch_size: int, max_len: int,
                      device="cuda"):
    """Decode state for ONE block type, un-stacked (no repeat axis):
    a (B, max_len, KVH, Dh) KV cache in the compute dtype for attention
    blocks (dense, MoE or shared), the O(1) per-sequence state for
    recurrent ones (``models/ssm.py``).  The serving slot pool builds its
    per-block pools from it."""
    if btype not in BLOCK_TYPES:
        raise ValueError(btype)
    device = resolve_or_meta(device)
    if btype in ssm_lib.RECURRENT:
        return ssm_lib.block_state_init(cfg, btype, batch_size, device)
    shape = (batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def stack_repeats(cfg: ArchConfig, one):
    """A block's un-stacked state with a leading n_repeats axis (a copy a
    repeat)."""
    return {name: x[None].repeat((cfg.n_repeats,) + (1,) * x.ndim)
            for name, x in one.items()}


def decode_state_init(cfg: ArchConfig, batch_size: int, max_len: int,
                      device="cuda"):
    """Decode state of every block in the unit, stacked over repeats:
    a tuple over ``cfg.pattern`` of ``block_decode_init``'s dicts with a
    leading n_repeats axis (KV caches of zeros, recurrent states at their
    initial values)."""
    return tuple(stack_repeats(cfg, block_decode_init(
        cfg, btype, batch_size, max_len, device)) for btype in cfg.pattern)


def cached_self_attention(cfg, p, ctx, x, k_cache, v_cache, pos,
                          positions, kv_positions=None):
    """The cached self-attention of one decode step, out-projected: x
    (B,1,D) normed; k_cache/v_cache: (B, Smax, KVH, Dh) views into the
    stacked states, written IN PLACE at (row, pos[row]); pos: (B,).  On a
    model-parallel mesh the caches are this rank's shards (``kv_split``)
    and q is all-gathered: split on the sequence, the rank holding a
    row's position writes it and ``decode_attention_sharded`` combines
    the ranks' softmax parts; on ``head_dim`` every rank writes its
    features and ``decode_attention_dh`` sums the partial scores; on the
    kv heads every rank writes and attends with its own.
    ``kv_positions``: the absolute position of each entry of a
    sequence-split cache where it is not a contiguous slice (the slot
    pool's pages, ``serve/pool.py``)."""
    b = x.shape[0]
    hh, dh = cfg.n_heads, cfg.head_dim
    rows = torch.arange(b, device=x.device)
    if ctx.mesh is None:
        q, k, v = _project_qkv(cfg, p, ctx, x, positions)
        k_cache[rows, pos] = k[:, 0].to(cfg.cdtype)
        v_cache[rows, pos] = v[:, 0].to(cfg.cdtype)
        o = attn_lib.decode_attention(q, k_cache, v_cache, pos + 1)
        return _attn_out(cfg, p, ctx, o.reshape(b, 1, hh * dh))
    mesh = ctx.mesh
    q, _, _, (k, v) = _project_qkv(cfg, p, ctx, x, positions, want_all=True)
    if q.shape[2] != hh:
        q = collectives.all_gather(q.reshape(b, 1, -1), mesh,
                                   "model").reshape(b, 1, hh, dh)
    k, v = k[:, 0].to(cfg.cdtype), v[:, 0].to(cfg.cdtype)   # (B, KVH, Dh)
    split = ("seq" if kv_positions is not None
             else kv_split(cfg, k_cache, mesh))
    m = collectives.index(mesh, "model")
    if split is None:
        k_cache[rows, pos], v_cache[rows, pos] = k, v
        o = attn_lib.decode_attention(q, k_cache, v_cache, pos + 1)
    elif split == "dh":
        part = k_cache.shape[3]
        lo = m * part
        k_cache[rows, pos] = k[..., lo:lo + part]
        v_cache[rows, pos] = v[..., lo:lo + part]
        o = attn_lib.decode_attention_dh(q, k_cache, v_cache, pos + 1, lo,
                                         mesh)
    elif split == "kvh":
        n = k_cache.shape[2]
        k0, group = m * n, hh // cfg.n_kv_heads
        k_cache[rows, pos] = k[:, k0:k0 + n]
        v_cache[rows, pos] = v[:, k0:k0 + n]
        o = attn_lib.decode_attention(q[:, :, k0 * group:(k0 + n) * group],
                                      k_cache, v_cache, pos + 1)
        o = collectives.all_gather(o.reshape(b, 1, -1), mesh, "model")
    else:
        span = k_cache.shape[1]
        key_pos = (kv_positions if kv_positions is not None else
                   torch.arange(span, device=x.device) + m * span)
        at = torch.clamp(torch.searchsorted(key_pos, pos.contiguous()),
                         max=span - 1)
        mine = (key_pos[at] == pos)[:, None, None]
        for cache, new in ((k_cache, k), (v_cache, v)):
            cache[rows, at] = torch.where(mine, new, cache[rows, at])
        o = attn_lib.decode_attention_sharded(q, k_cache, v_cache, pos + 1,
                                              key_pos, mesh)
    return _attn_out(cfg, p, ctx, o.reshape(b, 1, hh * dh))


def _attn_decode(cfg, p, ctx, h1, k_cache, v_cache, pos, kv_positions=None):
    """One attention block of a decode step (``cached_self_attention``
    and the MLP / MoE); pos: (B,), the position of all three M-RoPE
    streams."""
    b = h1.shape[0]
    x = cm.apply_norm(cfg, p["norm1"], h1)
    positions = pos[:, None]
    if cfg.pos_mode == "mrope":
        positions = pos[None, :, None].expand(3, b, 1)
    o = cached_self_attention(cfg, p["attn"], ctx, x, k_cache, v_cache, pos,
                              positions, kv_positions)
    h1 = h1 + cfg.residual_scale * o
    x = cm.apply_norm(cfg, p["norm2"], h1)
    return h1 + cfg.residual_scale * _ffn(cfg, p, ctx, x)[0]


def decode_step(cfg: ArchConfig, params, token: torch.Tensor, pos, states,
                policy: cm.Policy, mesh=None, kv_positions=None):
    """One serve step: token (B,) integer -> logits (B, V), states.

    ``pos`` is a scalar (every row at the same position) or a (B,) vector
    of per-row positions (continuous batching: each row writes its KV at
    its own offset and attends over its own prefix).  The scalar is
    broadcast, so both share one set of numerics.  Each row's new K/V is
    written into ``states`` in place (no copy of the caches per step), and
    so is each recurrent block's new state (computed whole, then copied
    over the old); the returned states are that same object.  On a
    model-parallel ``mesh`` the caches are each rank's shards (see
    ``cached_self_attention``; ``kv_positions`` the absolute positions of
    a sequence-split cache's entries where they are not a contiguous
    slice) and the logits are whole.
    """
    ctx = cm.Ctx(policy=policy, key=None, znorms=None,
                 compute_dtype=cfg.cdtype, mesh=mesh)
    token = token.to(torch.int64)
    pos = torch.as_tensor(pos, device=token.device).to(torch.int64)
    pos = pos.reshape(-1).expand(token.shape)
    h = _lookup(cfg, params, token, mesh)[:, None, :]
    if cfg.pos_mode == "learned":
        h = h + params["pos_embed"][pos][:, None].to(cfg.cdtype)
    for i in range(cfg.n_layers):
        ridx, j, btype, p = _layer(cfg, params, i)
        if btype in _DECODE:
            x = cm.apply_norm(cfg, p["norm1"], h)
            old = {name: t[ridx] for name, t in states[j].items()}
            o, new = _DECODE[btype](cfg, p[btype], ctx, x, old)
            h = h + cfg.residual_scale * o
            for name, t in old.items():
                t.copy_(new[name])
        else:
            h = _attn_decode(cfg, p, ctx, h, states[j]["k"][ridx],
                             states[j]["v"][ridx], pos, kv_positions)
    h = cm.apply_norm(cfg, params["final_norm"], h)
    return _whole_logits(cfg, params, h, mesh)[:, 0], states


def _vocab_parallel_nll(logits, labels, lo: int, mesh):
    """-log softmax(logits)[label] over a vocab split across the model
    ranks, from this rank's (..., V / M) f32 shard: the max and the sum of
    exponentials are all-reduced, the label's logit comes from the rank
    holding it; the logits are never gathered."""
    rows = logits.shape[-1]
    mx = collectives.all_reduce(torch.amax(logits, dim=-1).detach(), mesh,
                                "model", op="max")
    se = collectives.reduce_from_model(
        torch.sum(torch.exp(logits - mx[..., None]), dim=-1), mesh)
    local = labels - lo
    inside = (labels >= 0) & (local >= 0) & (local < rows)
    gold = torch.gather(logits, -1, torch.clamp(local, 0, rows - 1)[..., None]
                        )[..., 0]
    gold = collectives.reduce_from_model(
        torch.where(inside, gold, torch.zeros_like(gold)), mesh)
    return torch.log(se) + mx - gold


def masked_nll(cfg: ArchConfig, logits, labels, mesh=None) -> torch.Tensor:
    """The mean next-token cross-entropy over the labels that are not
    negative, in f32; vocab-parallel (``_vocab_parallel_nll``) where the
    logits are this rank's vocab shard."""
    logits = logits.to(torch.float32)
    if mesh is not None and logits.shape[-1] != cfg.vocab_size:
        lo = collectives.index(mesh, "model") * logits.shape[-1]
        nll = _vocab_parallel_nll(logits, labels, lo, mesh)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp(labels, min=0)[..., None])[..., 0]
        nll = logz - gold
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def lm_loss(cfg: ArchConfig, params, batch, policy: cm.Policy,
            key=None, znorms=None, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy (labels = batch["labels"], negative =
    masked; a VLM's labels cover the text after its vision prefix),
    computed in f32; an MoE arch adds ``0.01 * lb_loss /
    n_layers``.  As in the reference, ``aux["ce_loss"]`` is the returned
    loss, that term included.  A vocab-sharded head's loss is
    vocab-parallel (``_vocab_parallel_nll``)."""
    logits, aux = forward(cfg, params, batch, policy, key, znorms,
                          mesh=mesh)
    labels = batch["labels"].to(torch.int64)
    if cfg.family == "vlm":
        # only text positions carry labels; the vision prefix has none
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    with tracing.span("loss"):
        loss = masked_nll(cfg, logits, labels, mesh)
    if cfg.n_experts:
        loss = loss + 0.01 * aux["lb_loss"] / cfg.n_layers
    aux["ce_loss"] = loss
    return loss, aux
