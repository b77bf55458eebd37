"""Dense MLP variants (SwiGLU shares one sampling plan and one stored H'
between its up and gate projections)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    if cfg.mlp_type == "swiglu":
        # shared plan + single stored H' for wi/wg (same input)
        up, gate = ctx.linear_shared(("mlp_wi", "mlp_wg"), h,
                                     [p["wi"], p["wg"]])
        z = F.silu(gate) * up
    else:
        up = ctx.linear("mlp_wi", h, p["wi"])
        z = act_fn(cfg.mlp_type)(up)
    return ctx.linear("mlp_wo", z, p["wo"])
