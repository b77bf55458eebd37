"""LoRA (Hu et al., 2021) as a composable wrapper around (WTA-CRS) linears.

The paper combines WTA-CRS with LoRA (LoRA reduces optimizer-state memory,
WTA-CRS reduces activation memory; the two are orthogonal).  A
LoRA-augmented linear computes

    z = h @ W  +  (alpha / r) * (h @ A) @ B

with W frozen (no gradient) and only A (d_in, r), B (r, d_out) trainable.

The frozen base product runs on ``w.detach()``: no dW is ever formed, so
its backward needs only W itself (for dH) and no activation residual at
all — routing it through the sampled path would store a k-row H' for a
weight gradient that is discarded.  The down-projection ``h @ A`` is the
only product here whose backward needs H, so it alone goes through the
sampled dispatch (seed folded by 1, as the reference folds its key); its
gradient-norm tap is what a znorm cache sees for this layer.

Over a model-parallel weight (``lora_linear_parallel``) the adapters
split as their weight does.  Column-parallel W (split on d_out): B is
split on d_out and A is whole; the base product reads h through
Megatron's *f*, and so does the whole ``down = h A``, so A's gradient
(a partial sum on each rank, each reading its own columns of B) is
summed over the ranks.  Row-parallel W (split on d_in): A is split on
d_in and B is whole; the plan of the sampled ``h A`` is drawn from the
whole rows' norms (the partial squares all-reduced), and the partial
``down`` is summed over ``model`` before ``@ B`` — by *g* where the
output is whole on every rank, by an all-reduce both ways where each
rank keeps its slice of the output (``row_scatter``: B passes *f*, each
rank reading its columns of it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.config import WTACRSConfig
from repro_torch.core.linear import Plan, wtacrs_linear
from repro_torch.core.seeds import fold_seed
from repro_torch.device import resolve_device
from repro_torch.launch import collectives


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 32
    alpha: float = 32.0
    enabled: bool = False

    @property
    def scaling(self) -> float:
        return self.alpha / max(self.rank, 1)


def init_lora_params(seed: int, d_in: int, d_out: int, rank: int,
                     dtype=torch.float32, device="cuda"):
    """A ~ N(0, 1/r), B = 0 (so the adapter starts as identity); A drawn
    from ``torch.Generator(device).manual_seed(seed)`` (the reference's
    distribution, not its random stream)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    a = torch.randn((d_in, rank), generator=gen, dtype=torch.float32,
                    device=device) / math.sqrt(rank)
    b = torch.zeros((rank, d_out), dtype=dtype, device=device)
    return {"lora_a": a.to(dtype), "lora_b": b}


def lora_linear(h: torch.Tensor, w: torch.Tensor, lora_a: torch.Tensor,
                lora_b: torch.Tensor, lora_cfg: LoRAConfig,
                key: Optional[int] = None,
                znorm: Optional[torch.Tensor] = None,
                cfg: WTACRSConfig = WTACRSConfig(),
                bias: Optional[torch.Tensor] = None,
                plan: Optional[Plan] = None) -> torch.Tensor:
    """Frozen base linear + trainable low-rank update, memory-efficient.
    ``plan``: optional ready (idx, scale) for the down-projection (see
    ``wtacrs_linear``)."""
    z = torch.matmul(h, w.detach())
    if bias is not None:
        z = z + bias
    key_a = None if key is None else fold_seed(key, 1)
    down = wtacrs_linear(h, lora_a, key=key_a, znorm=znorm, cfg=cfg,
                         plan=plan)
    return z + torch.matmul(down, lora_b) * lora_cfg.scaling


def lora_linear_parallel(h: torch.Tensor, w: torch.Tensor,
                         lora_a: torch.Tensor, lora_b: torch.Tensor,
                         lora_cfg: LoRAConfig, parallel: str, mesh,
                         key: Optional[int] = None,
                         znorm: Optional[torch.Tensor] = None,
                         cfg: WTACRSConfig = WTACRSConfig(),
                         bias: Optional[torch.Tensor] = None,
                         plan: Optional[Plan] = None) -> torch.Tensor:
    """``lora_linear`` over a weight split across the ``model`` ranks of
    ``mesh`` (module doc): ``parallel`` ``"column"`` (``w`` (d_in, d_out /
    M), ``lora_b`` (r, d_out / M), ``lora_a`` whole, h whole), ``"row"``
    (``w`` (d_in / M, d_out), ``lora_a`` (d_in / M, r), ``lora_b`` whole,
    h this rank's features, the output whole) or ``"row_scatter"`` (as
    ``"row"``, the output this rank's slice of d_out).  ``bias`` is this
    rank's part of the output's.  Every rank draws the same plan."""
    key_a = None if key is None else fold_seed(key, 1)
    if parallel == "column":
        z = torch.matmul(collectives.copy_to_model(h, mesh), w.detach())
        if bias is not None:
            z = z + bias
        down = wtacrs_linear(h, lora_a, key=key_a, znorm=znorm, cfg=cfg,
                             plan=plan)
        down = collectives.copy_to_model(down, mesh)
        return z + torch.matmul(down, lora_b) * lora_cfg.scaling
    if parallel not in ("row", "row_scatter"):
        raise ValueError(f"parallel must be 'column', 'row' or "
                         f"'row_scatter', got {parallel!r}")
    z = torch.matmul(h, w.detach())
    down = wtacrs_linear(h, lora_a, key=key_a, znorm=znorm, cfg=cfg,
                         plan=plan, norm_reduce=lambda sq: (
                             collectives.all_reduce(sq, mesh, "model")))
    if parallel == "row":
        z = collectives.reduce_from_model(z, mesh)
        down = collectives.reduce_from_model(down, mesh)
        b = lora_b
    else:
        z = collectives.scatter_to_model(z, mesh)
        down = collectives.sum_over_model(down, mesh)
        part = z.shape[-1]
        b = collectives.copy_to_model(lora_b, mesh).narrow(
            -1, collectives.index(mesh, "model") * part, part)
    if bias is not None:
        z = z + bias
    return z + torch.matmul(down, b) * lora_cfg.scaling
