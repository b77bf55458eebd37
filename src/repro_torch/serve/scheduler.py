"""Continuous-batching scheduler: admission control, chunked-prefill /
decode interleaving, eviction.

The :class:`Scheduler` is the synchronous tick engine under
``repro_torch.serve.session.ServeSession``'s async host loop.  One
:meth:`tick` is one scheduling round:

1. **Admit** — FCFS from the queue while a slot AND the request's pages
   are both free (``ServeSpec.pages_needed`` is the admission charge).
2. **Prefill one chunk** — the round-robin-next mid-prefill slot
   advances by ``prefill_chunk`` prompt tokens, so an arriving long
   prompt never stalls in-flight decodes by more than one chunk.
3. **Decode one step** — ONE batched step over every decode-ready slot:
   per-slot positions, per-request sampling seeds, inactive rows masked
   to the scratch page.

A request's generated tokens do not depend on what other sequences are
admitted or evicted around it: every decode step runs at the pool's
fixed geometry (``max_slots`` rows, ``slot_len`` cache positions), each
row's logits depend only on its own row, and its randomness is keyed by
(seed, uid, n_generated), never by batch composition.

Over a model-parallel mesh (``mesh`` with a ``model`` axis of M ranks)
each rank of the model group runs a Scheduler over its shard of the pool
(``serve/pool.py``) and every rank must take the same decisions in the
same order, or the collectives of the steps pair up wrongly.  Model rank
0 decides the admissions of each tick and sends them (the requests
themselves: uid, prompt, max_new, temperature, seed) to the others in
one small all-reduce; every later decision follows from the same slots,
so it agrees.  A rank admits a request it was sent even before its own
``submit`` of that uid (which then returns the admitted request).  Every
rank gets every result; ``agree`` hands every rank model rank 0's view
of a flag (busy, stop), so ``ServeSession``'s inline loops and its async
loop tick in lockstep.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch import collectives
from repro_torch.launch import train_steps
from repro_torch.serve import pool as pool_lib
from repro_torch.serve import sampling
from repro_torch.serve.spec import ServeSpec


class Status(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass
class Request:
    """One serving request and its lifecycle record.

    ``uid`` keys the request's sampling randomness (see
    ``serve.sampling.request_key``)."""

    uid: int
    prompt: np.ndarray
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    status: Status = Status.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


@dataclasses.dataclass
class _Slot:
    idx: int
    req: Optional[Request] = None
    pages: List[int] = dataclasses.field(default_factory=list)
    filled: int = 0          # prompt tokens prefilled so far
    pos: int = 0             # cache position of last_token
    n_gen: int = 0
    last_token: int = 0
    key: int = 0


class Scheduler:
    """See module docstring.  Host state: slots, page table, free list,
    queue; device state: the paged pool.  Step functions are built once
    (decode) or once per distinct (chunk_len, fresh) pair (prefill)."""

    def __init__(self, spec: ServeSpec, params, policy=None, mesh=None):
        self.spec = spec
        self.cfg = spec.config
        self.policy = policy if policy is not None else spec.policy
        self.params = params
        self.mesh = mesh if collectives.model_size(mesh) > 1 else None
        self.shards = (None if self.mesh is None else
                       pool_lib.pool_shards(self.cfg, spec, self.mesh))
        self._adopted: Dict[int, Request] = {}
        self.alloc = pool_lib.PageAllocator(spec.total_pages)
        self.pool = pool_lib.init_pool(self.cfg, spec, device=spec.device,
                                       shards=self.shards)
        self.page_table = np.zeros((spec.max_slots, spec.pages_per_slot),
                                   np.int64)
        self.slots = [_Slot(i) for i in range(spec.max_slots)]
        self.queue: Deque[Request] = deque()
        self.completed: List[Request] = []
        self.stats: Dict[str, float] = {
            "admitted": 0, "evicted": 0, "decode_steps": 0,
            "prefill_chunks": 0, "tokens_generated": 0,
            "occupancy_sum": 0.0}
        self._uid = 0
        self._rr = 0
        self._decode_fn = train_steps.make_slot_serve_step(
            self.cfg, self.policy, spec.top_k, device=spec.device,
            shards=self.shards)
        self._reset_fn = train_steps.make_slot_reset_step(
            self.cfg, device=spec.device, shards=self.shards)
        self._prefill_fns: Dict[Tuple[int, bool], object] = {}

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new: int, temperature: float = 0.0,
               seed: int = 0, uid: Optional[int] = None) -> Request:
        """Queue one request (raises on overflow / impossible geometry —
        backpressure and footguns surface at submit, not mid-serve)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.spec.validate_request(len(prompt), max_new)
        if len(self.queue) >= self.spec.max_queue:
            raise RuntimeError(
                f"admission queue full (max_queue={self.spec.max_queue});"
                f" drain completions before submitting more")
        if uid is None:
            uid = self._uid
        self._uid = max(self._uid, uid) + 1
        if uid in self._adopted:          # model rank 0 admitted it already
            return self._adopted.pop(uid)
        req = Request(uid=uid, prompt=prompt, max_new=int(max_new),
                      temperature=float(temperature), seed=int(seed),
                      t_submit=time.monotonic())
        self.queue.append(req)
        return req

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s.req is not None
                                       for s in self.slots)

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots active per decode step so far."""
        n = self.stats["decode_steps"]
        return self.stats["occupancy_sum"] / n if n else 0.0

    # ------------------------------------------------------------------
    # one scheduling round
    # ------------------------------------------------------------------

    def tick(self) -> bool:
        """Admit, prefill one chunk, run one decode step.  Returns
        whether any device work ran (False + busy == stall)."""
        self._admit()
        did = self._prefill_tick()
        did = self._decode_tick() or did
        return did

    def agree(self, flag: bool) -> bool:
        """Model rank 0's ``flag`` on every rank of the model group (one
        all-reduce); ``flag`` itself without a model axis."""
        if self.mesh is None:
            return flag
        x = torch.tensor([int(flag) if self._rank0 else 0],
                         dtype=torch.int64, device=self.spec.device)
        return bool(collectives.all_reduce_(x, self.mesh, "model")[0])

    @property
    def _rank0(self) -> bool:
        return collectives.index(self.mesh, "model") == 0

    def drain(self) -> List[Request]:
        """Tick until every queued/resident request completes."""
        while self.agree(self.busy):
            if not self.tick():
                raise RuntimeError(
                    "scheduler stalled with work pending: "
                    f"{len(self.queue)} queued, "
                    f"{sum(s.req is not None for s in self.slots)} "
                    f"resident — admission cannot make progress")
        return self.completed

    # ------------------------------------------------------------------

    def _admissible(self) -> List[Request]:
        """The queue's head requests this tick admits (FCFS while a slot
        and the request's pages are free), popped from the queue."""
        out = []
        free = sum(s.req is None for s in self.slots)
        pages = self.alloc.n_free
        while self.queue and len(out) < free:
            req = self.queue[0]
            n_pages = self.spec.pages_needed(len(req.prompt), req.max_new)
            if n_pages > pages:
                break
            pages -= n_pages
            out.append(self.queue.popleft())
        return out

    def _agreed_admissions(self) -> List[Request]:
        """Model rank 0's admissions, sent to every rank of the model group
        as int64 words (uid, prompt length, max_new, seed, temperature's
        bits, the prompt) in one all-reduce against zeros, after a header
        all-reduce of their count and length."""
        mine = self._admissible() if self._rank0 else []
        words = []
        for r in mine:
            words += [r.uid, len(r.prompt), r.max_new, r.seed,
                      int(np.float32(r.temperature).view(np.int32))]
            words += [int(t) for t in r.prompt]
        dev = self.spec.device
        head = torch.tensor([len(mine), len(words)], dtype=torch.int64,
                            device=dev)
        n, size = collectives.all_reduce_(head, self.mesh, "model").tolist()
        if n == 0:
            return []
        body = torch.zeros((size,), dtype=torch.int64, device=dev)
        if self._rank0:
            body.copy_(torch.tensor(words, dtype=torch.int64))
        body = collectives.all_reduce_(body, self.mesh, "model").tolist()
        if self._rank0:
            return mine
        out, i = [], 0
        for _ in range(n):
            uid, n_prompt, max_new, seed, temp = body[i:i + 5]
            prompt = np.asarray(body[i + 5:i + 5 + n_prompt], np.int32)
            i += 5 + n_prompt
            req = next((r for r in self.queue if r.uid == uid), None)
            if req is not None:
                self.queue.remove(req)
            else:
                req = Request(uid=uid, prompt=prompt, max_new=max_new,
                              temperature=float(np.int32(temp).view(
                                  np.float32)), seed=seed,
                              t_submit=time.monotonic())
                self._adopted[uid] = req
            out.append(req)
        return out

    def _admit(self) -> None:
        admitted = (self._admissible() if self.mesh is None
                    else self._agreed_admissions())
        for req in admitted:
            slot = next(s for s in self.slots if s.req is None)
            n_pages = self.spec.pages_needed(len(req.prompt), req.max_new)
            slot.req = req
            slot.pages = self.alloc.alloc(n_pages)
            self.page_table[slot.idx] = 0
            self.page_table[slot.idx, :n_pages] = slot.pages
            slot.filled = 0
            slot.pos = len(req.prompt) - 1
            slot.n_gen = 0
            slot.last_token = int(req.prompt[-1])
            slot.key = sampling.request_key(req.seed, req.uid)
            self.stats["admitted"] += 1
            if len(req.prompt) == 1:
                # no prefill chunks will run: clear the evicted
                # predecessor's recurrent state out of the slot now
                self.pool = self._reset_fn(
                    self.pool, self.page_table[slot.idx], slot.idx)
                req.status = Status.DECODE
            else:
                req.status = Status.PREFILL

    def _prefill_fn(self, chunk_len: int, fresh: bool):
        fn = self._prefill_fns.get((chunk_len, fresh))
        if fn is None:
            fn = train_steps.make_slot_prefill_step(
                self.cfg, self.policy, chunk_len, fresh,
                device=self.spec.device, shards=self.shards)
            self._prefill_fns[(chunk_len, fresh)] = fn
        return fn

    def _prefill_tick(self) -> bool:
        pre = [s for s in self.slots
               if s.req is not None and s.req.status is Status.PREFILL]
        if not pre:
            return False
        # round-robin so one long prompt cannot starve the others
        s = min(pre, key=lambda s: (s.idx - self._rr) % len(self.slots))
        self._rr = (s.idx + 1) % len(self.slots)
        total = len(s.req.prompt) - 1      # last prompt token feeds decode
        n = min(self.spec.prefill_chunk, total - s.filled)
        fn = self._prefill_fn(n, fresh=(s.filled == 0))
        self.pool = fn(self.params, self.pool, self.page_table[s.idx],
                       s.idx, s.req.prompt[s.filled:s.filled + n], s.filled)
        s.filled += n
        self.stats["prefill_chunks"] += 1
        if s.filled >= total:
            s.req.status = Status.DECODE
        return True

    def _decode_tick(self) -> bool:
        dec = [s for s in self.slots
               if s.req is not None and s.req.status is Status.DECODE]
        if not dec:
            return False
        m = self.spec.max_slots
        token = np.zeros(m, np.int64)
        pos = np.zeros(m, np.int64)
        active = np.zeros(m, bool)
        temp = np.zeros(m, np.float32)
        keys = [0] * m
        n_gen = [0] * m
        for s in dec:
            token[s.idx] = s.last_token
            pos[s.idx] = s.pos
            active[s.idx] = True
            temp[s.idx] = s.req.temperature
            keys[s.idx] = s.key
            n_gen[s.idx] = s.n_gen
        next_tok, _, self.pool = self._decode_fn(
            self.params, self.pool, self.page_table, token, pos, active,
            keys, n_gen, temp)
        # One explicit fetch of the whole token vector; per-slot reads
        # below then index host memory instead of re-syncing.
        next_tok = next_tok.cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["occupancy_sum"] += len(dec) / m
        now = time.monotonic()
        for s in dec:
            t = int(next_tok[s.idx])
            if s.req.t_first is None:
                s.req.t_first = now
            s.req.tokens.append(t)
            s.n_gen += 1
            s.pos += 1
            s.last_token = t
            self.stats["tokens_generated"] += 1
            if (s.n_gen >= s.req.max_new
                    or (self.spec.eos_id is not None
                        and t == self.spec.eos_id)):
                self._evict(s)
        return True

    def _evict(self, s: _Slot) -> None:
        req = s.req
        req.status = Status.DONE
        req.t_done = time.monotonic()
        self.alloc.free(s.pages)
        self.page_table[s.idx] = 0
        s.req, s.pages, s.key = None, [], 0
        self.completed.append(req)
        self.stats["evicted"] += 1
