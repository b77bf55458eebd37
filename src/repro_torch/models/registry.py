"""Model API dispatch: config lookup, parameter init, the loss and the
serving entry points for every ported architecture (decoder-only LMs:
dense, MoE, SSM and hybrid)."""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import get_config  # noqa: F401  (re-export)
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


def init_params(cfg: ArchConfig, seed: int, device="cuda"):
    return lm.init_params(cfg, seed, device=device)


def forward(cfg, params, batch, policy, key=None, znorms=None):
    return lm.forward(cfg, params, batch, policy, key, znorms)


def loss_fn(cfg, params, batch, policy, key=None, znorms=None):
    return lm.lm_loss(cfg, params, batch, policy, key, znorms)


def prefill(cfg, params, batch, policy):
    return lm.prefill(cfg, params, batch, policy)


def decode_state_init(cfg, batch_size: int, max_len: int, device="cuda"):
    return lm.decode_state_init(cfg, batch_size, max_len, device=device)


def decode_step(cfg, params, token, pos, states, policy):
    """``pos``: scalar (aligned batch) or (B,) per-slot positions
    (continuous batching)."""
    return lm.decode_step(cfg, params, token, pos, states, policy)


def block_decode_init(cfg, btype: str, batch_size: int, max_len: int,
                      device="cuda"):
    """Un-stacked decode state of one block type (serve-pool builder)."""
    return lm.block_decode_init(cfg, btype, batch_size, max_len,
                                device=device)


def serve_compatible(cfg: ArchConfig) -> Tuple[bool, str]:
    """Whether the port's continuous-batching serve path supports this
    arch, with the reason when it does not (surfaced by ``ServeSpec`` at
    construction instead of erroring mid-serve)."""
    if cfg.is_encdec:
        return False, (
            "encoder-decoder arch: decode requires a primed per-batch "
            "cross-attention cache and a shared scalar position, which "
            "the ragged slot pool cannot provide")
    if cfg.family == "vlm" or cfg.pos_mode not in ("rope", "none"):
        return False, (f"{cfg.family} arch with pos_mode {cfg.pos_mode!r}: "
                       f"VLM / learned positions are not ported yet (the "
                       f"next slice, ROADMAP.md Queue A.7)")
    other = sorted(set(cfg.pattern) - set(lm.BLOCK_TYPES))
    if other:
        return False, (f"block types {other} are not ported yet (the "
                       f"next slice, ROADMAP.md Queue A.7)")
    return True, ""
