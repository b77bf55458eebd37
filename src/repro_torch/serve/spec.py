"""Declarative serving specification: everything the continuous-batching
decode service needs, in one frozen record.

A :class:`ServeSpec` fixes the static geometry of the slot pool — how
many sequences can be resident (``max_slots``), the KV page quantum
(``page_size``), the per-request length ceiling (``max_len``), the
prefill interleaving granularity (``prefill_chunk``) and the admission
queue depth (``max_queue``) — and validates at CONSTRUCTION time: an
arch the serve path cannot run (encoder-decoder), a bad geometry or a
device that is not there raises here with the reason, not hundreds of
steps into a live service.

``repro_torch.serve.ServeSession`` consumes a ServeSpec.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import registry


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """One declarative record for a serving service.

    Geometry
      * ``max_slots`` — resident sequences; the batched decode step runs
        at this width and ragged requests map onto its rows.
      * ``page_size`` — tokens per KV page.  Every attention layer keeps
        its KV in a shared page pool; a request is charged
        ``ceil((prompt + max_new) / page_size)`` pages at admission and
        returns them on eviction.  Recurrent state (zamba2's Mamba
        layers, xlstm's cells) is O(1) a sequence and lives in the slot:
        ``decode_state_bytes`` a recurrent block and repeat, allocated
        with the pool, so a request's slot is its whole charge for it.
      * ``max_len`` — hard per-request ceiling on prompt + generation
        (fixes the page-table width).
      * ``n_pages`` — pages in the shared pool (per layer).  ``None``
        sizes it so every slot can hold a ``max_len`` request at once
        (admission then only gates on slots); a smaller value makes pages
        the scarce resource admission control guards.  Page id 0 is a
        scratch page that absorbs masked writes from inactive slots, so
        usable pages are ``n_pages - 1``.
      * ``prefill_chunk`` — prompt tokens processed per prefill call;
        the scheduler interleaves one chunk per decode step.
      * ``max_queue`` — admission queue depth; ``submit`` beyond it
        raises (backpressure instead of unbounded host memory).

    Sampling
      * ``top_k`` — static top-k truncation for sampled decode
        (0 = full vocab); per-request temperature/seed live on the
        request.

    ``device`` — where the pool and the steps live (``"cuda"`` unless the
    caller asks for the CPU).  The reference's ``jit`` has no counterpart:
    the port's steps run eagerly.
    """

    arch: str
    reduced: bool = True
    policy: cm.Policy = cm.Policy()

    max_slots: int = 4
    page_size: int = 16
    max_len: int = 128
    n_pages: Optional[int] = None
    prefill_chunk: int = 16
    max_queue: int = 64

    top_k: int = 0
    eos_id: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        ok, reason = registry.serve_compatible(self.config)
        if not ok:
            raise ValueError(
                f"arch {self.arch!r} cannot be served through the slot "
                f"pool: {reason}")
        if self.max_slots < 1:
            raise ValueError("need max_slots >= 1")
        if self.page_size < 1:
            raise ValueError("need page_size >= 1")
        if self.max_len < 2:
            raise ValueError("need max_len >= 2 (one prompt token + one "
                             "generated token)")
        if self.prefill_chunk < 1:
            raise ValueError("need prefill_chunk >= 1")
        if self.max_queue < 1:
            raise ValueError("need max_queue >= 1")
        if self.top_k < 0:
            raise ValueError("need top_k >= 0 (0 = full vocab)")
        if (self.n_pages is not None
                and self.n_pages < self.pages_per_slot + 1):
            raise ValueError(
                f"n_pages={self.n_pages} cannot hold even one max_len "
                f"request ({self.pages_per_slot} pages + 1 scratch)")
        resolve_device(self.device)

    # -- derived geometry ------------------------------------------------

    @property
    def config(self):
        return get_config(self.arch, reduced=self.reduced)

    @property
    def pages_per_slot(self) -> int:
        """Page-table width: pages a max_len request occupies."""
        return -(-self.max_len // self.page_size)

    @property
    def slot_len(self) -> int:
        """Token capacity of one fully-paged slot (>= max_len)."""
        return self.pages_per_slot * self.page_size

    @property
    def total_pages(self) -> int:
        """Pool size per layer including the scratch page (id 0)."""
        if self.n_pages is not None:
            return self.n_pages
        return self.max_slots * self.pages_per_slot + 1

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Pages charged to a request at admission."""
        return -(-(prompt_len + max_new) // self.page_size)

    def validate_request(self, prompt_len: int, max_new: int) -> None:
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("need max_new >= 1")
        if prompt_len + max_new > self.max_len:
            raise ValueError(
                f"request needs {prompt_len + max_new} tokens but "
                f"ServeSpec.max_len is {self.max_len}")
        if self.pages_needed(prompt_len, max_new) > self.total_pages - 1:
            raise ValueError(
                f"request needs {self.pages_needed(prompt_len, max_new)} "
                f"pages but the pool holds {self.total_pages - 1} usable")
