"""Model API dispatch: config lookup, parameter init and the loss for
every ported architecture (dense decoder-only LMs so far)."""
from __future__ import annotations

from repro_torch.configs import get_config  # noqa: F401  (re-export)
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


def init_params(cfg: ArchConfig, seed: int, device="cuda"):
    return lm.init_params(cfg, seed, device=device)


def forward(cfg, params, batch, policy, key=None, znorms=None):
    return lm.forward(cfg, params, batch, policy, key, znorms)


def loss_fn(cfg, params, batch, policy, key=None, znorms=None):
    return lm.lm_loss(cfg, params, batch, policy, key, znorms)
