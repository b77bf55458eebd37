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

* **Over a model-parallel mesh** (:class:`PoolShards`) each rank holds
  its shard of every slot.  The page pools split as the rule of
  ``launch.sharding.kv_cache_spec`` splits the pool's gathered decode
  layout (``max_slots`` rows of ``slot_len`` positions): on the
  sequence, each page's positions (rank m holds positions [m·q,
  (m+1)·q) of every page, q = page_size / M, and the decode mask is
  taken from the absolute positions of the gathered entries,
  ``kv_positions``); on ``head_dim`` or the kv heads, that dim of every
  page.  A sequence split whose pages do not divide over the ranks
  splits ``head_dim`` instead (else the kv heads, else nothing).
  Recurrent slots split as ``launch.sharding.serving_state_specs``
  splits them.

The gather/scatter helpers are tensor functions used inside the serve
and prefill steps (``launch/train_steps.py::make_slot_serve_step``);
writes into the pool are in place.  :class:`PageAllocator` is the host
free list the scheduler drives admission control with.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch import collectives
from repro_torch.launch import sharding as shard_lib
from repro_torch.models import lm, ssm


def _recurrent(btype: str) -> bool:
    """Whether a pattern entry keeps slot-indexed recurrent state (an
    attention entry keeps KV pages); another block type raises
    ``ValueError``, as ``lm.block_decode_init`` does in both packages."""
    if btype not in lm.BLOCK_TYPES:
        raise ValueError(btype)
    return btype in ssm.RECURRENT


@dataclasses.dataclass(frozen=True)
class PoolShards:
    """How one rank of a model-parallel mesh holds the pool (module doc):
    ``kv`` the page pools' split (``"pages"``, ``"dh"``, ``"kvh"`` or
    None), ``page_size`` the whole page, ``rec_specs`` {"<pattern
    index>/<name>": spec} of the stacked recurrent slots."""
    mesh: object
    kv: Optional[str]
    page_size: int
    rec_specs: Dict[str, tuple]

    @property
    def index(self) -> int:
        return collectives.index(self.mesh, "model")

    @property
    def ways(self) -> int:
        return collectives.axis_size(self.mesh, "model")


def pool_shards(cfg: ArchConfig, spec, mesh) -> Optional[PoolShards]:
    """The pool's split on ``mesh`` (None without a model axis)."""
    if collectives.model_size(mesh) == 1:
        return None
    ways = collectives.axis_size(mesh, "model")
    kv_spec = shard_lib.kv_cache_spec(cfg, spec.max_slots, spec.slot_len,
                                      mesh)
    dims = [i for i, part in enumerate(kv_spec) if part is not None]
    kv = {1: "pages", 2: "kvh", 3: "dh"}.get(dims[0]) if dims else None
    if kv == "pages" and spec.page_size % ways:
        kv = ("dh" if cfg.head_dim % ways == 0 else
              "kvh" if cfg.n_kv_heads % ways == 0 else None)
    whole = tuple(lm.stack_repeats(cfg, lm.block_decode_init(
        cfg, btype, spec.max_slots, 0, "meta")) if _recurrent(btype)
        else {} for btype in cfg.pattern)
    rec = shard_lib.serving_state_specs(cfg, whole, mesh, spec.max_slots)
    return PoolShards(mesh, kv, spec.page_size, rec)


def _pool_shape(cfg: ArchConfig, spec, shards=None):
    shape = [cfg.n_repeats, spec.total_pages, spec.page_size,
             cfg.n_kv_heads, cfg.head_dim]
    if shards is not None and shards.kv is not None:
        shape[{"pages": 2, "kvh": 3, "dh": 4}[shards.kv]] //= shards.ways
    return tuple(shape)


def _shard_slots(shards, j: int, states):
    """This rank's shard of recurrent entry ``j``'s whole stacked slots."""
    if shards is None:
        return states
    return {name: shard_lib.shard_leaf(x, shards.rec_specs[f"{j}/{name}"],
                                       shards.mesh)
            for name, x in states.items()}


def init_pool(cfg: ArchConfig, spec, device="cuda",
              shards: Optional[PoolShards] = None):
    """Device pool state: tuple over ``cfg.pattern`` entries, stacked over
    repeats — {"k", "v"} page pools for attention entries, every slot's
    recurrent state (``block_decode_init`` at ``max_slots`` rows) for
    recurrent ones; with ``shards``, this rank's shard of each."""
    device = resolve_device(device)
    states = []
    for j, btype in enumerate(cfg.pattern):
        if _recurrent(btype):
            states.append(_shard_slots(shards, j, lm.stack_repeats(
                cfg, lm.block_decode_init(cfg, btype, spec.max_slots, 0,
                                          device))))
            continue
        shape = _pool_shape(cfg, spec, shards)
        states.append({"k": torch.zeros(shape, dtype=cfg.cdtype,
                                        device=device),
                       "v": torch.zeros(shape, dtype=cfg.cdtype,
                                        device=device)})
    return tuple(states)


def kv_positions(shards: Optional[PoolShards], pages_per_slot: int,
                 device) -> Optional[torch.Tensor]:
    """The absolute position of each entry of a gathered slot's cache
    where the pages' positions are split (None elsewhere: the gathered
    cache then holds every position)."""
    if shards is None or shards.kv != "pages":
        return None
    q = shards.page_size // shards.ways
    page = torch.arange(pages_per_slot, device=device)[:, None]
    within = torch.arange(q, device=device)[None] + shards.index * q
    return (page * shards.page_size + within).reshape(-1)


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
                          active: torch.Tensor,
                          shards: Optional[PoolShards] = None):
    """Write one decode step's state updates back into the pool, in place.

    Each active row's token at its own ``pos`` goes to the owning page;
    inactive rows are redirected to scratch page 0.  Recurrent entries
    take the new state where ``active`` and hold the old one elsewhere: a
    slot mid-prefill must not have its carried state overwritten by the
    decode batch it is not yet part of.  With ``shards`` splitting the
    pages' positions, only the rank holding a row's position writes it
    (the others write to scratch).  Returns ``pool``."""
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
        psz = pool[j]["k"].shape[2]          # this rank's page positions
        whole = psz if shards is None else shards.page_size
        page, off = pos_safe // whole, pos_safe % whole
        at, here = pos_safe, active
        if whole != psz:
            lo = shards.index * psz
            here = active & (off >= lo) & (off < lo + psz)
            off = torch.clamp(off - lo, 0, psz - 1)
            at = page * psz + off
        zero = torch.zeros_like(pos_safe)
        page_ids = torch.where(here, page_table[rows, page], zero)
        offs = torch.where(here, off, zero)
        for name in ("k", "v"):
            tok = new_states[j][name][:, rows, at]   # (R, S, KVH, Dh)
            pool[j][name][:, page_ids, offs] = tok
    return pool


# ---------------------------------------------------------------------------
# Per-slot chunked prefill: gather one slot -> run the chunk -> scatter back
# ---------------------------------------------------------------------------

def gather_slot_states(cfg: ArchConfig, pool, page_table_row: torch.Tensor,
                       slot: int, fresh: bool,
                       shards: Optional[PoolShards] = None):
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
                states.append(_shard_slots(shards, j, lm.stack_repeats(
                    cfg, lm.block_decode_init(cfg, btype, 1, 0,
                                              page_table_row.device))))
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
