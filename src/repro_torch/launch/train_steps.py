"""The eager train and serve steps of the port.

``make_train_step`` returns a ``(state, batch) -> (state, metrics)``
function.  There is no jit: the step runs eagerly, the layer stack is a
Python loop, and the optimizer updates the state in place (see
``train/optim.py``), so the returned state is the caller's own object.

The serve and prefill step makers below return eager functions with the
reference's signatures.  Each step enters ``torch.no_grad()`` itself
(grad mode is thread-local and the serving loop runs in its own thread),
and decode steps write the new token's K/V into the caches in place.
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


def _no_tf32() -> None:
    # the f32 products here (and every f32 comparison against the
    # reference) assume full-precision matmuls
    torch.backends.cuda.matmul.allow_tf32 = False


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
    _no_tf32()

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


# ---------------------------------------------------------------------------
# Serving: prefill and cached decode (aligned batch)
# ---------------------------------------------------------------------------

def _tokens(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return torch.as_tensor(x).to(device=device, dtype=torch.int64)


def make_prefill_step(cfg: ArchConfig, policy: cm.Policy, device="cuda"):
    """(params, batch) -> (last_logits (B, V), states): the whole prompt
    through the stack, attention on the ``flash_attention_fwd`` kernel."""
    device = resolve_device(device)
    _no_tf32()

    def prefill_step(params, batch):
        with torch.no_grad():
            return registry.prefill(cfg, params, _to_device(batch, device),
                                    policy)

    return prefill_step


def make_serve_step(cfg: ArchConfig, policy: cm.Policy, device="cuda"):
    """(params, token (B,), pos, states) -> (next_token (B,) int32 greedy,
    logits (B, V), states); ``pos`` scalar or (B,)."""
    device = resolve_device(device)
    _no_tf32()

    def serve_step(params, token, pos, states):
        with torch.no_grad():
            logits, states = registry.decode_step(
                cfg, params, _tokens(token, device), pos, states, policy)
            next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, states

    return serve_step


def make_prefill_chunk_step(cfg: ArchConfig, policy: cm.Policy,
                            chunk_len: int, device="cuda"):
    """(params, tokens (B, chunk_len), start, states) -> states: the chunk
    fed through ``decode_step`` one token at a time from position
    ``start`` (the same steps in the same order as token-by-token decode,
    so the chunk size never changes the caches)."""
    device = resolve_device(device)
    _no_tf32()

    def chunk_step(params, tokens, start, states):
        tokens = _tokens(tokens, device)
        if tokens.shape[1] != chunk_len:
            raise ValueError(f"chunk of {tokens.shape[1]} tokens for a "
                             f"step built for {chunk_len}")
        with torch.no_grad():
            for off in range(chunk_len):
                _, states = registry.decode_step(
                    cfg, params, tokens[:, off], int(start) + off, states,
                    policy)
        return states

    return chunk_step


# ---------------------------------------------------------------------------
# Slot-pool serving steps (continuous batching; see repro_torch.serve)
# ---------------------------------------------------------------------------

def make_slot_serve_step(cfg: ArchConfig, policy: cm.Policy, top_k: int = 0,
                         device="cuda"):
    """One batched decode step over the whole slot pool.

    Gathers every slot's paged KV into contiguous decode-layout caches,
    runs ONE ``decode_step`` with per-slot positions, samples next tokens
    with per-request keys and temperatures, and scatters each row's new
    K/V token back into its own page (inactive rows land on the scratch
    page).

    Signature: ``(params, pool, page_table, token, pos, active, keys,
    n_gen, temperature) -> (next_token, logits, pool)``; ``page_table``,
    ``token``, ``pos`` and ``active`` are host arrays or tensors, ``keys``
    and ``n_gen`` host integers per row, ``temperature`` a host array."""
    from repro_torch.serve import pool as pool_lib
    from repro_torch.serve import sampling as sampling_lib
    device = resolve_device(device)
    _no_tf32()

    def slot_serve_step(params, pool, page_table, token, pos, active, keys,
                        n_gen, temperature):
        page_table = _tokens(page_table, device)
        pos = _tokens(pos, device)
        active = torch.as_tensor(active).to(device=device, dtype=torch.bool)
        with torch.no_grad():
            states = pool_lib.gather_decode_states(cfg, pool, page_table)
            logits, states = registry.decode_step(
                cfg, params, _tokens(token, device), pos, states, policy)
            ks = sampling_lib.step_keys(keys, n_gen)
            next_token = sampling_lib.sample_logits(logits, ks, temperature,
                                                    top_k=top_k)
            pool = pool_lib.scatter_decode_update(cfg, pool, states,
                                                  page_table, pos, active)
        return next_token, logits, pool

    return slot_serve_step


def make_slot_prefill_step(cfg: ArchConfig, policy: cm.Policy,
                           chunk_len: int, fresh: bool, device="cuda"):
    """Prefill ``chunk_len`` prompt tokens for ONE slot of the pool:
    gather the slot's decode-layout state (batch 1), feed the chunk
    through ``decode_step`` token by token (the numerics of token-by-token
    decode, so the chunk size never changes served tokens), scatter the
    state back into the slot's pages.  ``fresh`` marks a request's first
    chunk; attention state needs no reset (stale KV is masked beyond the
    slot's live length)."""
    from repro_torch.serve import pool as pool_lib
    device = resolve_device(device)
    chunk = make_prefill_chunk_step(cfg, policy, chunk_len, device=device)

    def slot_prefill_step(params, pool, page_table_row, slot, tokens, start):
        page_table_row = _tokens(page_table_row, device)
        with torch.no_grad():
            states = pool_lib.gather_slot_states(cfg, pool, page_table_row,
                                                 slot, fresh)
            states = chunk(params, _tokens(tokens, device)[None], start,
                           states)
            return pool_lib.scatter_slot_states(cfg, pool, states,
                                                page_table_row, slot)

    return slot_prefill_step


def make_slot_reset_step(cfg: ArchConfig, device="cuda"):
    """Reset one slot's recurrent state to the block init constants (for
    single-token prompts, which run no prefill chunk).  Attention-only
    archs carry no such state, so the pool comes back as it was."""
    from repro_torch.serve import pool as pool_lib
    device = resolve_device(device)

    def slot_reset_step(pool, page_table_row, slot):
        page_table_row = _tokens(page_table_row, device)
        with torch.no_grad():
            states = pool_lib.gather_slot_states(cfg, pool, page_table_row,
                                                 slot, fresh=True)
            return pool_lib.scatter_slot_states(cfg, pool, states,
                                                page_table_row, slot)

    return slot_reset_step
