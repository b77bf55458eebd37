"""MLP variants and the sort-based MoE layer.

Dense MLPs: SwiGLU shares one sampling plan and one stored H' between its
up and gate projections.

The MoE dispatch is the reference's sort/gather formulation (no (T, E, C)
one-hot): tokens are ranked within their routed expert by a stable sort,
dropped beyond capacity, gathered into (E, C, D) slots, run through the
expert FFNs as batched products (``core/linear.py::expert_linear``, which
WTA-CRS-samples each expert's capacity slots when the policy enables it),
and combined back weighted by the renormalised router probabilities.
Everything is static-shape tensor ops — no ``.item()``, no
``bincount``/``nonzero`` — so the layer runs on the meta device (the tag
trace of ``train/znorm.py``) and never syncs the host in a train step.

Where the reference scatters (``.at[].set`` into slots, ``.at[].add``
back to tokens) the port gathers, in both directions (``_GatherRows``):
each token sums its k expert outputs in increasing expert id, from the
first, in the compute dtype — the order of the reference's expert-major
scatter-add — and the backward sums a token's k slot gradients in the same
order.  No atomic add is involved, so the layer is deterministic on the
card, which the remat legs, the serving pool and resume need.

On a model-parallel mesh (``Ctx.mesh``) the dense MLP's ``wi`` / ``wg``
are column-parallel and ``wo`` row-parallel; an MoE layer is expert
parallel: each rank holds E/M experts and the router whole, every rank
routes every token (the tokens are replicated over ``model``) and runs
its own experts' slots, and the combine is one all-reduce.  The slots'
input and the combine weights pass Megatron's *f*, so the router's
gradient sums every expert's part.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import linear as lin
from repro_torch.launch import collectives
from repro_torch.models import common as cm


def act_fn(kind: str):
    if kind == "swiglu":
        return None  # handled structurally (gated)
    if kind == "gelu":
        # the reference's jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if kind == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(kind)


def init_mlp(cfg, gen: torch.Generator, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": cm.dense_init(gen, (d, f), dtype, device)}
    if cfg.mlp_type == "swiglu":
        p["wg"] = cm.dense_init(gen, (d, f), dtype, device)
    p["wo"] = cm.dense_init(gen, (f, d), dtype, device)
    return p


def apply_mlp(cfg, p, ctx: cm.Ctx, h):
    sharded = ctx.mesh is not None and p["wi"].shape[1] != cfg.d_ff
    col, row = ("column", "row") if sharded else (None, None)
    if cfg.mlp_type == "swiglu":
        # shared plan + single stored H' for wi/wg (same input)
        up, gate = ctx.linear_shared(("mlp_wi", "mlp_wg"), h,
                                     [p["wi"], p["wg"]],
                                     parallel=(col, col))
        z = F.silu(gate) * up
    else:
        up = ctx.linear("mlp_wi", h, p["wi"], parallel=col)
        z = act_fn(cfg.mlp_type)(up)
    return ctx.linear("mlp_wo", z, p["wo"], parallel=row)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def init_moe(cfg, gen: torch.Generator, dtype, device):
    """Router (d, E) and stacked expert weights (E, d, f) / (E, f, d).  As
    in the reference, ``dense_init`` takes the fan-in from the leading
    axis, which for the stacked experts is E."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": cm.dense_init(gen, (d, e), dtype, device, scale=0.02),
        "wi": cm.dense_init(gen, (e, d, f), dtype, device),
        "wg": cm.dense_init(gen, (e, d, f), dtype, device),
        "wo": cm.dense_init(gen, (e, f, d), dtype, device),
    }


def moe_capacity(cfg, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * cfg.moe_top_k * n_tokens
              // cfg.n_experts)
    return max(cap, 1)


def _expert_ffn(cfg, p, ctx: cm.Ctx, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, D) -> (E, C, D), WTA-CRS'd per expert when the policy
    samples ``<prefix>moe_expert`` and a seed is there (``ctx.key``); the
    capacity slots of each expert are ``policy.moe_groups`` sampling
    groups where they divide evenly.  wi/wg share their plans and one
    stored H', wo has its own; every expert's plans are drawn together and
    every expert's dW is one kernel launch a weight."""
    tag = ctx.tag_prefix + "moe_expert"
    if ctx.recorder is not None:
        # two plans: one shared by wi and wg, one for wo
        ctx.recorder.expert_calls.append((tag, (2, 1)))
    cfg_w = ctx.policy.config_for(tag)
    wi, wg, wo = (p[n].to(xs.dtype) for n in ("wi", "wg", "wo"))
    if not cfg_w.is_exact and ctx.key is not None:
        cap = xs.shape[1]
        g = ctx.policy.moe_groups if cap % ctx.policy.moe_groups == 0 else 1
        seed = ctx._key_for(tag)
        if ctx.mesh is not None:
            # each rank's experts draw from their own stream
            seed = cm.fold_seed(seed, collectives.index(ctx.mesh, "model"))
        up, gate = lin.expert_linear(xs, (wi, wg), cm.fold_seed(seed, 0),
                                     cfg_w, g, ctx.stash)
        z = F.silu(gate) * up
        return lin.expert_linear(z, (wo,), cm.fold_seed(seed, 1), cfg_w, g,
                                 ctx.stash)[0]
    z = F.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wi)
    return torch.bmm(z, wo)


def _route(e: int, k: int, cap: int, top_e: torch.Tensor):
    """Capacity routing of G token groups at once: top_e (G, Tg, k) expert
    ids -> per group, over the E*C slots (expert-major), the flat entry
    (token * k + j) each slot holds and whether it is occupied; per entry
    in sorted order whether it was kept; per entry in its own (token, j)
    place its slot, E*C where it was dropped.  An entry's rank within its
    expert is its place in a stable sort by expert id, so tokens fill an
    expert's slots in token order, as in the reference."""
    g, tg, _ = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(g, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts)             # (G, E)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    rank = (torch.arange(tg * k, device=dev)
            - torch.gather(starts, 1, sorted_e))
    keep = rank < cap
    slot_sorted = torch.where(keep, sorted_e * cap + rank,
                              torch.full_like(rank, e * cap))
    r = torch.arange(cap, device=dev)
    occupied = (r < counts[..., None]).reshape(g, e * cap)
    src = torch.clamp(starts[..., None] + r, max=tg * k - 1)
    entry = torch.gather(order, 1, src.reshape(g, e * cap))
    slot_entry = torch.empty_like(slot_sorted).scatter_(1, order,
                                                        slot_sorted)
    return entry, occupied, keep, slot_entry.reshape(g, tg, k)


def _dispatch_group(e: int, k: int, cap: int, x, top_p, top_e):
    """Capacity-dispatch of one token group.  x: (Tg, D); returns
    (xs (E, C, D), tok_of_slot, w_of_slot, occupied, keep) as the
    reference's ``_dispatch_group`` does (``keep`` in sorted order)."""
    entry, occupied, keep, _ = (t[0] for t in _route(e, k, cap,
                                                     top_e[None]))
    tok_of_slot = torch.where(occupied, entry // k,
                              torch.zeros_like(entry)).to(torch.int32)
    w_of_slot = torch.where(occupied, top_p.reshape(-1)[entry],
                            torch.zeros((), dtype=torch.float32,
                                        device=x.device))
    xs = torch.where(occupied[:, None], x[tok_of_slot.to(torch.int64)],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    return (xs.reshape(e, cap, x.shape[1]), tok_of_slot, w_of_slot,
            occupied, keep)


class _GatherRows(torch.autograd.Function):
    """``src`` (N, D) with one zero row appended, gathered at ``fwd`` (any
    shape of indices in [0, N]) -> fwd.shape + (D,).  The backward is a
    gather too: ``bwd`` (N, m) names, for each row of ``src``, the m rows
    of the (flattened) output it went to (the output's row count where
    none), and their gradients are summed in that order, from the first.
    So dispatch and combine need no scatter-add in either direction."""

    @staticmethod
    def forward(ctx, src, fwd, bwd):
        ctx.save_for_backward(bwd)
        padded = torch.cat([src, src.new_zeros((1, src.shape[-1]))])
        return padded[fwd]

    @staticmethod
    def backward(ctx, dout):
        bwd, = ctx.saved_tensors
        flat = dout.reshape(-1, dout.shape[-1])
        rows = torch.cat([flat, flat.new_zeros((1, flat.shape[-1]))])[bwd]
        dsrc = rows[:, 0]
        for j in range(1, rows.shape[1]):
            dsrc = dsrc + rows[:, j]
        return dsrc, None, None


def apply_moe(cfg, p, ctx: cm.Ctx, h) -> Tuple[torch.Tensor, Dict]:
    """h: (B, S, D) -> (B, S, D), plus aux ``lb_loss`` (Switch-style load
    balance) and ``drop_frac``.

    Dispatch is group-local: the tokens split into ``policy.moe_groups``
    groups that each rank and drop against their own capacity (decode,
    S == 1, takes one group with capacity T, so nothing drops and cached
    decode matches the teacher-forced forward).  The router's softmax and
    top-k run in f32 and the top-k weights are renormalised."""
    b, s, d = h.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    g = ctx.policy.moe_groups if (s > 1 and t % ctx.policy.moe_groups == 0
                                  ) else 1
    cap = moe_capacity(cfg, t // g) if s > 1 else t
    tg, n_slots = t // g, e * g * cap
    dev = h.device
    x = h.reshape(t, d)

    logits = ctx.linear("moe_router", x, p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    top_p, top_e = torch.topk(probs, k, dim=-1)                # (T, k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)

    entry, occupied, keep, slot_entry = _route(e, k, cap,
                                               top_e.reshape(g, tg, k))
    # slots in the experts' (E, G, C) layout: group gi's local slot
    # ex * C + r is ex * G * C + gi * C + r
    group = torch.arange(g, device=dev)[:, None]
    local = torch.arange(e * cap, device=dev)[None]
    glob = (local // cap) * (g * cap) + group * cap + local % cap
    tok = torch.where(occupied, group * tg + entry // k,
                      torch.full_like(entry, t))
    fwd_dispatch = tok.reshape(g, e, cap).transpose(0, 1).reshape(-1)
    # each token's k slots in increasing expert id (dropped ones last, as
    # the padding row), and its weights in the same order
    slot_g = torch.where(slot_entry < e * cap,
                         torch.gather(glob, 1, torch.clamp(
                             slot_entry, max=e * cap - 1).reshape(g, -1)
                         ).reshape(g, tg, k),
                         torch.full_like(slot_entry, n_slots))
    slots, perm = torch.sort(slot_g.reshape(t, k), dim=-1)
    weights = torch.gather(top_p, 1, perm)
    # for each slot, the (token, j) row of the combine's gathered output
    flat = slots.reshape(-1)
    spare = n_slots + torch.arange(t * k, device=dev)
    inverse = torch.full((n_slots + t * k,), t * k, dtype=torch.int64,
                         device=dev).scatter_(
        0, torch.where(flat < n_slots, flat, spare),
        torch.arange(t * k, device=dev))[:n_slots, None]

    e_local = p["wi"].shape[0]
    expert_parallel = ctx.mesh is not None and e_local != e
    if expert_parallel:
        # this rank's experts' slots: [lo, hi) of the (E, G*C) layout
        span = e_local * g * cap
        lo = collectives.index(ctx.mesh, "model") * span
        fwd_dispatch = fwd_dispatch[lo:lo + span]
        inverse = inverse[lo:lo + span]
        mine = (slots >= lo) & (slots < lo + span)
        slots = torch.where(mine, slots - lo, torch.full_like(slots, span))
        x = collectives.copy_to_model(x, ctx.mesh)
        weights = collectives.copy_to_model(weights, ctx.mesh)
        n_slots = span
    xs = _GatherRows.apply(x, fwd_dispatch, slots)
    ys = _expert_ffn(cfg, p, ctx, xs.reshape(e_local, g * cap, d))
    parts = _GatherRows.apply(ys.reshape(n_slots, d), slots, inverse)
    w = weights.to(parts.dtype)
    out = parts[:, 0] * w[:, 0, None]
    for j in range(1, k):
        out = out + parts[:, j] * w[:, j, None]
    if expert_parallel:
        out = collectives.reduce_from_model(out, ctx.mesh)

    me = torch.mean(probs, dim=0)
    ce = torch.mean((top_e[:, :1] == torch.arange(e, device=dev)
                     ).to(torch.float32), dim=0)
    aux = {"lb_loss": e * torch.sum(me * ce),
           "drop_frac": 1.0 - torch.mean(keep.to(torch.float32))}
    return out.reshape(b, s, d), aux
