"""Slot-based paged cache pools: device layout + host page allocator.

* **Attention KV is paged.**  Every attention layer keeps K/V in a
  ``(n_repeats, total_pages, page_size, KVH, Dh)`` pool; a slot owns a
  row of the page table (``(max_slots, pages_per_slot)`` integers, page
  id 0 = scratch) and its contiguous decode-layout cache is materialized
  by one gather per step.  Pages are the allocation quantum, so a
  finished short request returns its pages to a queued long one at once.

* **Recurrent state is slot-indexed.**  Mamba conv/SSM, mLSTM and sLSTM
  state is O(1) per sequence, so it lives directly at
  ``(n_repeats, max_slots, ...)`` — the slot id is the batch row, no
  paging.  Each slot's share (``models/ssm.py::decode_state_bytes`` a
  block and repeat) is allocated with the pool, so admission charges a
  recurrent request its slot and its KV pages, nothing more.

The gather/scatter helpers are tensor functions used inside the serve
and prefill steps (``launch/train_steps.py::make_slot_serve_step``);
writes into the pool are in place.  :class:`PageAllocator` is the host
free list the scheduler drives admission control with.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm, ssm


def _recurrent(btype: str) -> bool:
    """Whether a pattern entry keeps slot-indexed recurrent state (an
    attention entry keeps KV pages); another block type raises
    ``ValueError``, as ``lm.block_decode_init`` does in both packages."""
    if btype not in lm.BLOCK_TYPES:
        raise ValueError(btype)
    return btype in ssm.RECURRENT


def _pool_shape(cfg: ArchConfig, spec):
    return (cfg.n_repeats, spec.total_pages, spec.page_size,
            cfg.n_kv_heads, cfg.head_dim)


def init_pool(cfg: ArchConfig, spec, device="cuda"):
    """Device pool state: tuple over ``cfg.pattern`` entries, stacked over
    repeats — {"k", "v"} page pools for attention entries, every slot's
    recurrent state (``block_decode_init`` at ``max_slots`` rows) for
    recurrent ones."""
    device = resolve_device(device)
    states = []
    for btype in cfg.pattern:
        if _recurrent(btype):
            states.append(lm.stack_repeats(cfg, lm.block_decode_init(
                cfg, btype, spec.max_slots, 0, device)))
            continue
        shape = _pool_shape(cfg, spec)
        states.append({"k": torch.zeros(shape, dtype=cfg.cdtype,
                                        device=device),
                       "v": torch.zeros(shape, dtype=cfg.cdtype,
                                        device=device)})
    return tuple(states)


def pool_bytes(cfg: ArchConfig, spec) -> int:
    """Total device bytes of the pool, from its shapes (nothing is
    allocated): two page pools an attention entry, ``max_slots`` slots of
    ``decode_state_bytes`` a repeat for a recurrent one."""
    item = torch.finfo(cfg.cdtype).bits // 8
    total = 0
    for btype in cfg.pattern:
        if _recurrent(btype):
            total += (cfg.n_repeats * spec.max_slots
                      * ssm.decode_state_bytes(cfg, btype))
        else:
            total += 2 * math.prod(_pool_shape(cfg, spec)) * item
    return total


# ---------------------------------------------------------------------------
# Batched decode: gather pages -> decode-layout states -> scatter token
# ---------------------------------------------------------------------------

def gather_decode_states(cfg: ArchConfig, pool, page_table: torch.Tensor):
    """Contiguous decode-layout states for all slots (a copy).

    page_table: (S, P) integer tensor.  Attention entries gather their
    pages into (R, S, P*page_size, KVH, Dh); recurrent entries are copied
    whole (their batch dim already IS the slot dim; the decode step
    writes its rows in place, and ``scatter_decode_update`` keeps only the
    active ones)."""
    states = []
    s, p = page_table.shape
    for j, btype in enumerate(cfg.pattern):
        if _recurrent(btype):
            states.append({name: x.clone() for name, x in pool[j].items()})
            continue

        def lin(pages):
            r, _, psz, kvh, dh = pages.shape
            return pages[:, page_table].reshape(r, s, p * psz, kvh, dh)

        states.append({"k": lin(pool[j]["k"]), "v": lin(pool[j]["v"])})
    return tuple(states)


def scatter_decode_update(cfg: ArchConfig, pool, new_states,
                          page_table: torch.Tensor, pos: torch.Tensor,
                          active: torch.Tensor):
    """Write one decode step's state updates back into the pool, in place.

    Each active row's token at its own ``pos`` goes to the owning page;
    inactive rows are redirected to scratch page 0.  Recurrent entries
    take the new state where ``active`` and hold the old one elsewhere: a
    slot mid-prefill must not have its carried state overwritten by the
    decode batch it is not yet part of.  Returns ``pool``."""
    s = page_table.shape[0]
    rows = torch.arange(s, device=page_table.device)
    pos_safe = torch.where(active, pos, torch.zeros_like(pos))
    for j, btype in enumerate(cfg.pattern):
        if _recurrent(btype):
            for name, old in pool[j].items():
                keep = active.reshape((1, s) + (1,) * (old.ndim - 2))
                old.copy_(torch.where(keep, new_states[j][name].to(
                    old.dtype), old))
            continue
        psz = pool[j]["k"].shape[2]
        page_ids = torch.where(active, page_table[rows, pos_safe // psz],
                               torch.zeros_like(pos_safe))
        offs = torch.where(active, pos_safe % psz,
                           torch.zeros_like(pos_safe))
        for name in ("k", "v"):
            tok = new_states[j][name][:, rows, pos_safe]   # (R, S, KVH, Dh)
            pool[j][name][:, page_ids, offs] = tok
    return pool


# ---------------------------------------------------------------------------
# Per-slot chunked prefill: gather one slot -> run the chunk -> scatter back
# ---------------------------------------------------------------------------

def gather_slot_states(cfg: ArchConfig, pool, page_table_row: torch.Tensor,
                       slot: int, fresh: bool):
    """Decode-layout states (batch = 1) for one slot (a copy).

    ``fresh`` marks the first prefill chunk of a newly admitted request:
    recurrent state then starts from the block init constants instead of
    the evicted predecessor's leftovers.  Attention state needs no reset
    (positions beyond the slot's length are masked by
    ``decode_attention`` and overwritten as the prompt advances)."""
    p = page_table_row.shape[0]
    states = []
    for j, btype in enumerate(cfg.pattern):
        if _recurrent(btype):
            if fresh:
                states.append(lm.stack_repeats(cfg, lm.block_decode_init(
                    cfg, btype, 1, 0, page_table_row.device)))
            else:
                states.append({name: x[:, slot:slot + 1].clone()
                               for name, x in pool[j].items()})
            continue

        def lin(pages):
            r, _, psz, kvh, dh = pages.shape
            return pages[:, page_table_row].reshape(r, 1, p * psz, kvh, dh)

        states.append({"k": lin(pool[j]["k"]), "v": lin(pool[j]["v"])})
    return tuple(states)


def scatter_slot_states(cfg: ArchConfig, pool, states,
                        page_table_row: torch.Tensor, slot: int):
    """Write one slot's post-chunk states back into the pool, in place.

    ALL of the slot's pages are written (untouched pages write back their
    just-gathered values; page-table entries beyond the request's
    allocation point at scratch page 0, which absorbs the duplicate
    writes); a recurrent entry writes the slot's row.  Returns
    ``pool``."""
    p = page_table_row.shape[0]
    for j, btype in enumerate(cfg.pattern):
        if _recurrent(btype):
            for name, x in pool[j].items():
                x[:, slot] = states[j][name][:, 0].to(x.dtype)
            continue
        for name in ("k", "v"):
            pages = pool[j][name]
            r, _, psz, kvh, dh = pages.shape
            pages[:, page_table_row] = states[j][name].reshape(
                r, p, psz, kvh, dh)
    return pool


# ---------------------------------------------------------------------------
# Host-side page free list (admission control currency)
# ---------------------------------------------------------------------------

class PageAllocator:
    """Free list over page ids 1..total_pages-1 (0 is scratch).

    The scheduler charges a request ``spec.pages_needed(...)`` pages at
    admission and returns them at eviction; ``can_alloc`` is the
    admission predicate that keeps a full pool from accepting work it
    cannot hold.  LIFO reuse keeps hot pages hot."""

    def __init__(self, total_pages: int):
        if total_pages < 2:
            raise ValueError("need >= 2 pages (scratch + 1 usable)")
        self._free: List[int] = list(range(total_pages - 1, 0, -1))
        self.total_usable = total_pages - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if not self.can_alloc(n):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"(admission control should have gated this request)")
        ids, self._free = self._free[-n:], self._free[:-n]
        return ids

    def free(self, ids: Sequence[int]) -> None:
        for i in ids:
            if i <= 0:
                raise ValueError(f"cannot free scratch/invalid page {i}")
            if i in self._free:
                raise ValueError(f"double free of page {i}")
        self._free.extend(ids)
