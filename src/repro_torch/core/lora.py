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
