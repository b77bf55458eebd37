"""Column-row sampling plans (Eq. 2-6 of the paper), batched.

A *plan* is a static-shape description of which k column-row pairs of an
m-term contraction participate in the approximated GEMM and with what
scale:

    GEMM(X, Y) = sum_i X[:,i] Y[i,:] ~= sum_t scale_t X[:,idx_t] Y[idx_t,:]

Three plan functions are provided:

  * ``crs_plan``      -- iid sampling from P, scale 1/(k p_i)          (Eq. 5)
  * ``det_topk_plan`` -- top-k by probability, scale 1 (biased;
                         Adelman et al. 2021)
  * ``wtacrs_plan``   -- the paper's Winner-Take-All plan: the |C| largest
                         atoms enter deterministically (scale 1), the
                         remaining k-|C| slots are iid samples from the
                         renormalized tail with scale
                         (1 - sum_C p) / ((k-|C|) p_j)                  (Eq. 6)

|C| is chosen per Theorem 2 to minimize (1 - sum_C p) / (k - |C|).

Every plan function takes ``p`` as (m,) or (B, m) and works on the whole batch
at once — one independent plan per row.  Shapes are static and nothing
synchronises with the host: |C| stays a tensor, realised via masks over
a fixed k slots.  Randomness comes from an explicit ``torch.Generator``
on ``p``'s device; categorical draws are taken by inverting the CDF of
the (descending-sorted) tail, so one ``torch.rand`` call serves the batch.

Each registers itself in ``repro_torch.core.estimator_registry``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import estimator_registry as registry
from repro_torch.core.config import NormSource, WTACRSConfig
from repro_torch.kernels import ops as kernel_ops

_EPS = 1e-30


class SamplePlan(NamedTuple):
    """Static-shape sampling plan over a contraction dimension of size m.

    Leaves carry the batch shape of the ``p`` they were built from: for
    p (B, m) idx/scale are (B, k) and the diagnostics (B,); for p (m,)
    they are (k,) and scalars."""

    idx: torch.Tensor        # (..., k) int32 indices into the contraction dim
    scale: torch.Tensor      # (..., k) f32 per-slot scale factors
    # Diagnostics, useful for tests/benchmarks.
    c_size: torch.Tensor     # |C|: number of deterministic slots (0 for CRS)
    det_mass: torch.Tensor   # sum_{c in C} p_c


def _batched(p: torch.Tensor):
    """p as (B, m) plus the function that restores the caller's rank."""
    if p.ndim == 1:
        return p[None], lambda plan: SamplePlan(*(x[0] for x in plan))
    if p.ndim != 2:
        raise ValueError(f"p must be (m,) or (B, m), got {tuple(p.shape)}")
    return p, lambda plan: plan


def column_row_probabilities(x_col_norms: torch.Tensor,
                             y_row_norms: torch.Tensor) -> torch.Tensor:
    """Optimal CRS distribution (Eq. 3): p_i ∝ ||X_:,i|| * ||Y_i,:||,
    over the last dim."""
    return normalize_weights(x_col_norms * y_row_norms)


def normalize_weights(w: torch.Tensor) -> torch.Tensor:
    """w / sum(w) over the last dim; an all-zero row falls back to uniform
    (still unbiased)."""
    total = torch.sum(w, dim=-1, keepdim=True)
    uniform = torch.full_like(w, 1.0 / w.shape[-1])
    return torch.where(total > 0, w / torch.clamp(total, min=_EPS), uniform)


def _sample_sorted_tail(p_sorted: torch.Tensor, c: torch.Tensor, k: int,
                        gen: torch.Generator) -> torch.Tensor:
    """k iid draws per row from the categorical ∝ max(p, eps) restricted
    to sorted ranks >= c.  Returns ranks (B, k), each in [c, m-1].

    Inverse CDF: the tail is a contiguous suffix in sorted order, so
    after clamping into [c, m-1] every returned rank carries weight."""
    b, m = p_sorted.shape
    ranks = torch.arange(m, device=p_sorted.device)
    w = torch.where(ranks[None, :] >= c[:, None],
                    torch.clamp(p_sorted, min=_EPS),
                    torch.zeros_like(p_sorted))
    cdf = torch.cumsum(w, dim=-1)
    u = torch.rand((b, k), generator=gen, device=p_sorted.device,
                   dtype=p_sorted.dtype)
    r = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
    return torch.clamp(torch.maximum(r, c[:, None]), max=m - 1)


def crs_plan(p: torch.Tensor, k: int, gen: torch.Generator) -> SamplePlan:
    """iid column-row sampling (Eq. 5). Unbiased."""
    p, restore = _batched(p)
    b = p.shape[0]
    zero_c = torch.zeros((b,), dtype=torch.int64, device=p.device)
    idx = _sample_sorted_tail(p, zero_c, k, gen)
    scale = 1.0 / (k * torch.clamp(torch.gather(p, 1, idx), min=_EPS))
    return restore(SamplePlan(idx.to(torch.int32), scale.to(p.dtype),
                              zero_c.to(torch.int32),
                              torch.zeros((b,), dtype=p.dtype,
                                          device=p.device)))


def det_topk_plan(p: torch.Tensor, k: int) -> SamplePlan:
    """Deterministic top-k selection without scaling (Adelman et al.).

    This estimator is *biased*: it simply drops the tail mass.  Included as
    the paper's ablation baseline ("Deterministic" in Fig. 8).  Ties go to
    the lower index (a stable sort), as in the reference.
    """
    p, restore = _batched(p)
    b = p.shape[0]
    idx = torch.argsort(p, dim=-1, descending=True, stable=True)[:, :k]
    scale = torch.ones((b, k), dtype=p.dtype, device=p.device)
    det_mass = torch.sum(torch.gather(p, 1, idx), dim=-1)
    c = torch.full((b,), k, dtype=torch.int32, device=p.device)
    return restore(SamplePlan(idx.to(torch.int32), scale, c, det_mass))


def optimal_c_size(p_sorted_cumsum: torch.Tensor, k: int,
                   cap: float = 1.0) -> torch.Tensor:
    """Theorem 2: |C|* = argmin_{c in 0..k-1} (1 - sum_topc p) / (k - c).

    ``p_sorted_cumsum`` is the cumulative sum of descending-sorted
    probabilities, (m,) or (B, m).  Returns int32 in [0, k-1] per row (at
    least one stochastic slot is kept so the estimator stays well-defined
    and unbiased even when the distribution is fully concentrated).
    """
    csum = p_sorted_cumsum
    cs = torch.arange(k, device=csum.device)
    # mass of the top-c atoms, for c = 0..k-1  (c=0 -> 0 mass)
    zero = torch.zeros_like(csum[..., :1])
    top_mass = torch.cat([zero, csum[..., :k - 1]], dim=-1)
    score = (1.0 - top_mass) / (k - cs).to(csum.dtype)
    c_max = int(max(0, min(k - 1, round(cap * k))))
    score = torch.where(cs <= c_max, score,
                        torch.full_like(score, float("inf")))
    return torch.argmin(score, dim=-1).to(torch.int32)


def wtacrs_plan(p: torch.Tensor, k: int, gen: torch.Generator,
                deterministic_fraction_cap: float = 1.0) -> SamplePlan:
    """Winner-Take-All column-row plan (Eq. 6).  Unbiased, lower variance
    than CRS whenever sum_C p_c > |C|/k (Theorem 2).
    """
    p, restore = _batched(p)
    m = p.shape[1]
    order = torch.argsort(p, dim=-1, descending=True, stable=True)
    p_sorted = torch.gather(p, 1, order)
    csum = torch.cumsum(p_sorted, dim=-1)
    c_star = optimal_c_size(csum, k, cap=deterministic_fraction_cap)
    c64 = c_star.to(torch.int64)
    det_mass = torch.where(
        c64 == 0, torch.zeros_like(csum[:, 0]),
        torch.gather(csum, 1, torch.clamp(c64 - 1, min=0)[:, None])[:, 0])
    resid = torch.clamp(1.0 - det_mass, min=0.0)

    ranks = _sample_sorted_tail(p_sorted, c64, k, gen)         # (B, k)
    sampled = torch.gather(order, 1, ranks)
    p_sampled = torch.gather(p_sorted, 1, ranks)

    slots = torch.arange(k, device=p.device)
    det_slot = slots[None, :] < c64[:, None]
    top = order[:, torch.clamp(slots, max=m - 1)]
    idx = torch.where(det_slot, top, sampled)

    n_stoc = torch.clamp(k - c64, min=1).to(p.dtype)
    stoc_scale = resid[:, None] / (n_stoc[:, None]
                                   * torch.clamp(p_sampled, min=_EPS))
    scale = torch.where(det_slot, torch.ones_like(stoc_scale), stoc_scale)
    return restore(SamplePlan(idx.to(torch.int32), scale.to(p.dtype),
                              c_star, det_mass.to(p.dtype)))


# ---------------------------------------------------------------------------
# Registry entries + dispatch
# ---------------------------------------------------------------------------

@registry.register_estimator("crs", needs_key=True, biased=False)
def _crs_entry(p, k, gen, cfg=None) -> SamplePlan:
    return crs_plan(p, k, gen)


@registry.register_estimator("det_topk", needs_key=False, biased=True)
def _det_topk_entry(p, k, gen, cfg=None) -> SamplePlan:
    return det_topk_plan(p, k)


@registry.register_estimator("wta_crs", needs_key=True, biased=False)
def _wtacrs_entry(p, k, gen, cfg=None) -> SamplePlan:
    cap = 1.0 if cfg is None else cfg.deterministic_fraction_cap
    return wtacrs_plan(p, k, gen, cap)


def batched_row_weights(h: torch.Tensor, znorm: Optional[torch.Tensor],
                        cfg, norm_reduce=None) -> torch.Tensor:
    """Unnormalized sampling weights over rows: h (B, S, D) -> (B, S).

    The ||H_b,s|| factor of Eq. 3 — through the ``row_norms`` kernel on
    the card — times the cached gradient-norm term when
    ``cfg.norm_source == CACHED_GRAD`` (the config is authoritative —
    under ACTIVATION_ONLY a supplied znorm is ignored).

    ``norm_reduce``: where ``h`` holds one shard of each row's features
    (the input of a row-parallel weight), the all-reduce of the partial
    squares over the shards; a row's norm is the square root of the
    reduced f32 sum of squares (the squares are reduced, never the
    norms), the same on every shard.
    """
    flat = h.reshape(-1, h.shape[-1])
    if not flat.is_contiguous():
        flat = flat.contiguous()
    h_norms = kernel_ops.row_norms(flat)
    if norm_reduce is not None:
        h_norms = torch.sqrt(norm_reduce(h_norms * h_norms))
    h_norms = h_norms.reshape(h.shape[:-1])
    if znorm is not None and cfg.norm_source == NormSource.CACHED_GRAD:
        return h_norms * znorm.to(torch.float32)
    return h_norms


def build_batched_plans(p: torch.Tensor, k: int,
                        gen: Optional[torch.Generator], cfg) -> SamplePlan:
    """Per-sample plans: p (B, m) -> SamplePlan with (B, k) idx/scale
    leaves, one independent plan per batch element — the layout the
    ``fused_sampled_dw`` kernel consumes directly."""
    spec = registry.get_estimator(cfg.kind)
    if spec.needs_key and gen is None:
        raise ValueError(f"estimator {spec.name!r} requires a generator")
    return spec.build(p, k, gen if spec.needs_key else None, cfg)


def build_plan(kind, p: torch.Tensor, k: int,
               gen: Optional[torch.Generator],
               deterministic_fraction_cap: float = 1.0,
               cfg=None) -> SamplePlan:
    """Dispatch by estimator name through the registry.

    ``kind`` is an EstimatorKind or any registered name; ``cfg`` (optional)
    is forwarded to the plan function so custom estimators can read their knobs.
    When ``cfg`` is omitted a minimal one carrying
    ``deterministic_fraction_cap`` is synthesized.
    """
    if registry.is_exact(kind):
        raise ValueError(f"no sampling plan for estimator kind {kind}")
    spec = registry.get_estimator(kind)
    if cfg is None:
        cfg = WTACRSConfig(kind=registry.kind_name(kind),
                           deterministic_fraction_cap=
                           deterministic_fraction_cap)
    return spec.build(p, k, gen if spec.needs_key else None, cfg)
