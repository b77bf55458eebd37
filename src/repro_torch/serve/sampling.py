"""Token sampling for decode: temperature / top-k categorical, greedy.

One function, used by both the slot-pool serve step and the solo route.
Determinism contract: the seed of a sampled token depends only on
(seed, request uid, tokens generated so far) — never on batch
composition — so a request served through a churning continuous batch
draws the same randomness as the same request served alone.

Seeds are plain integers derived with ``models/common.py::fold_seed``
(the port's counterpart of ``fold_in``; its streams are not the
reference's): ``request_key(seed, uid)`` then ``step_keys`` folds in the
generated-token count.  Each sampled row draws Gumbel noise from its own
``torch.Generator`` on the logits' device, seeded by that integer.
``temperature == 0`` means greedy argmax for that row (the first maximum,
as in the reference), exact, not a small-temperature limit.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.models.common import fold_seed

NEG_INF = -1e30


def request_key(seed: int, uid: int) -> int:
    """Base seed for one request, independent of slot placement."""
    return fold_seed(int(seed), int(uid))


def step_keys(base_keys: Sequence[int], n_gen: Sequence[int]) -> list:
    """Per-row seed for the ``n_gen``-th generated token of each row."""
    return [fold_seed(int(k), int(n)) for k, n in zip(base_keys, n_gen)]


def sample_logits(logits: torch.Tensor, keys: Sequence[int], temperature,
                  top_k: int = 0) -> torch.Tensor:
    """One token per row.  logits (B, V); keys B integer seeds;
    temperature B host floats (0 = greedy for that row); top_k static
    (0 = full vocab).  Returns (B,) int32 on the logits' device."""
    logits = logits.to(torch.float32)
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = np.asarray(temperature, dtype=np.float32).reshape(-1)
    rows = [r for r in range(logits.shape[0]) if temps[r] > 0]
    if not rows:
        return out
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF),
                             logits)
    for r in rows:
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(int(keys[r]))
        u = torch.rand(logits.shape[-1], generator=gen,
                       device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u))
        out[r] = torch.argmax(logits[r] / float(temps[r]) + gumbel).to(
            torch.int32)
    return out
