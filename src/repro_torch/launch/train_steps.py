"""The eager train step of the port.

``make_train_step`` returns a ``(state, batch) -> (state, metrics)``
function.  There is no jit: the step runs eagerly, the layer stack is a
Python loop, and the optimizer updates the state in place (see
``train/optim.py``), so the returned state is the caller's own object.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.train import optim

_LATER = "{what} is not ported yet (znorm cache, budget statistics, " \
         "scheduled step and microbatches are next in ROADMAP.md)"


def init_train_state(cfg: ArchConfig, seed: int, device="cuda"
                     ) -> Dict[str, Any]:
    """Parameters from ``seed`` on ``device``, zeroed f32 AdamW moments,
    step 0 and the base seed every step's sampling seed derives from."""
    device = resolve_device(device)
    params = registry.init_params(cfg, seed, device=device)
    return {
        "params": params,
        "opt": optim.adamw_init(params),
        "step": 0,
        "base_seed": cm.fold_seed(int(seed), 7),
    }


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    out = {}
    for name, x in batch.items():
        if name == "sample_ids":
            continue
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        out[name] = x.to(device)
    return out


def make_train_step(cfg: ArchConfig, policy: cm.Policy,
                    opt_cfg: optim.AdamWConfig,
                    schedule: Callable[[int], float],
                    use_znorm_cache: bool = False,
                    microbatches: int = 1,
                    device="cuda"):
    """(state, batch) -> (state, metrics).  Paper-faithful WTA-CRS step.

    ``batch`` holds ``tokens`` / ``labels`` as numpy arrays or tensors
    (moved to ``device``); ``metrics`` holds 0-dim tensors ``loss`` and
    ``grad_norm`` (no host sync is forced here) and the float ``lr``.
    Sampling seeds derive from ``(state["base_seed"], state["step"])``,
    so a step is reproducible and steps are independent.
    """
    device = resolve_device(device)
    if use_znorm_cache:
        raise NotImplementedError(_LATER.format(what="use_znorm_cache=True"))
    if microbatches != 1:
        raise NotImplementedError(_LATER.format(what="microbatches > 1"))
    if not isinstance(opt_cfg, optim.AdamWConfig):
        raise NotImplementedError(
            "only the legacy AdamWConfig is ported; optimizer-state "
            "layouts (OptimSpec) are not ported yet")
    # the f32 products here (and every f32 comparison against the
    # reference) assume full-precision matmuls
    torch.backends.cuda.matmul.allow_tf32 = False

    def train_step(state, batch):
        params = state["params"]
        step = int(state["step"])
        key = cm.fold_seed(state["base_seed"], step)
        model_batch = _to_device(batch, device)

        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, _ = registry.loss_fn(cfg, params, model_batch, policy,
                                       key=key)
            flat_g = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)

        lr = schedule(step)
        _, _, om = optim.adamw_update(list(flat_g), state["opt"], leaves,
                                      lr, opt_cfg)
        state["step"] = step + 1
        return state, {"loss": loss.detach(), "lr": lr, **om}

    return train_step
