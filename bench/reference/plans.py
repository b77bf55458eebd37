"""WTA-CRS plans worked out again, in plain torch, for one sequence at a
time: the seeds every sampled linear draws from and the paper's plan
(Eq. 6, |C| by Theorem 2).

A plan's probabilities come from the reference's own float32 activations;
its uniform draws come from the stream the seed names.  Frozen copies of
the port's seed derivation (src/repro_torch/core/seeds.py:7-19 and
src/repro_torch/models/common.py:224-225, 297-300, 427-430) and of its
plan's arithmetic (src/repro_torch/core/plans.py:77-95, 117-135, 138-173).
"""
from __future__ import annotations

import zlib

import torch

_MASK63 = (1 << 63) - 1
_EPS = 1e-30


def fold_seed(seed: int, data: int) -> int:
    x = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & (2 ** 64 - 1)
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & (2 ** 64 - 1)
    x ^= x >> 31
    return x & _MASK63


def tag_seed(tag: str) -> int:
    return zlib.crc32(tag.encode()) & 0x7FFFFFFF


def step_key(state_seed: int, step: int) -> int:
    """The seed of one optimizer step's draws: the train state's base seed
    (the state seed folded with 7) folded with the step."""
    return fold_seed(fold_seed(int(state_seed), 7), int(step))


def layer_key(key: int, layer: int, period: int) -> int:
    """Layer ``layer``'s seed: its repeat, then its place in the
    pattern."""
    ridx, j = divmod(layer, period)
    return fold_seed(fold_seed(key, ridx), j)


def linear_key(key: int, tags) -> int:
    """A linear's seed from its layer's: the prefixed tag, or the tags of
    a shared plan joined with '+'."""
    return fold_seed(key, tag_seed("+".join(tags)))


def uniforms(key: int, b: int, k: int, device) -> torch.Tensor:
    """The (B, k) uniforms a batch's plans invert, from ``key``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return torch.rand((b, k), generator=gen, device=device,
                      dtype=torch.float32)


def wtacrs_plan(p: torch.Tensor, k: int, u: torch.Tensor):
    """One sequence's plan over its m rows: the |C| most probable rows
    kept whole (scale 1), the other k - |C| slots drawn from the
    renormalised tail by inverting its CDF at ``u`` (k,), each scaled by
    (1 - Σ_C p) / ((k - |C|) p).  Returns (idx (k,), scale (k,))."""
    m = p.shape[0]
    order = torch.argsort(p, descending=True, stable=True)
    ps = p[order]
    csum = torch.cumsum(ps, 0)
    cs = torch.arange(k, device=p.device)
    top = torch.cat([torch.zeros_like(csum[:1]), csum[:k - 1]])
    score = (1.0 - top) / (k - cs).to(csum.dtype)
    c = int(torch.argmin(score))
    det = csum[c - 1] if c > 0 else torch.zeros_like(csum[0])
    resid = torch.clamp(1.0 - det, min=0.0)
    ranks = torch.arange(m, device=p.device)
    w = torch.where(ranks >= c, torch.clamp(ps, min=_EPS),
                    torch.zeros_like(ps))
    cdf = torch.cumsum(w, 0)
    r = torch.searchsorted(cdf, u * cdf[-1], right=True)
    r = torch.clamp(torch.clamp(r, min=c), max=m - 1)
    slots = torch.arange(k, device=p.device)
    det_slot = slots < c
    idx = torch.where(det_slot, order[torch.clamp(slots, max=m - 1)],
                      order[r])
    stoc = resid / (max(k - c, 1) * torch.clamp(ps[r], min=_EPS))
    scale = torch.where(det_slot, torch.ones_like(stoc), stoc)
    return idx, scale


def row_probabilities(x: torch.Tensor) -> torch.Tensor:
    """p ∝ each row's norm (the activation-only distribution, Eq. 3 with
    no cached gradient norms); an all-zero input falls back to uniform."""
    w = torch.linalg.vector_norm(x.to(torch.float32), dim=-1)
    total = w.sum()
    if float(total) > 0:
        return w / torch.clamp(total, min=_EPS)
    return torch.full_like(w, 1.0 / w.shape[0])
