"""Estimators beyond the paper, registered through the estimator registry.

This module is deliberately OUTSIDE the core dispatch path
(``plans.build_plan`` / ``linear._make_plans`` never mention these
names): it exists to prove that a new estimator plugs in purely via
``@register_estimator`` and is then reachable from ``WTACRSConfig(kind=
"stratified_crs")`` or a per-layer ``PolicyRules`` rule.

``stratified_crs`` — stratified (systematic) column-row sampling.  The
unit interval is split into k equal strata and one uniform draw is taken
per stratum; indices come from inverting the CDF of p.  With the CRS
scale 1/(k p_i) the estimator is unbiased: the expected number of copies
of atom i is exactly k p_i, so

    E[sum_t X_{i_t} Y_{i_t} / (k p_{i_t})] = sum_i (k p_i)/(k p_i) X_i Y_i
                                           = XY.

Variance is never worse than iid CRS under the same p (stratification is
a variance-reduction technique; atoms with p_i >= 1/k are hit at least
floor(k p_i) times deterministically, which recovers much of WTA-CRS's
winner-take-all behaviour without the explicit |C| search).
"""
from __future__ import annotations

import torch

from repro_torch.core.estimator_registry import register_estimator
from repro_torch.core.plans import SamplePlan

_EPS = 1e-30


@register_estimator("stratified_crs", needs_key=True, biased=False)
def stratified_crs_plan(p: torch.Tensor, k: int, gen: torch.Generator,
                        cfg=None) -> SamplePlan:
    """One CDF-inverted draw per stratum [t/k, (t+1)/k); CRS scaling.
    ``p`` is (m,) or (B, m), one plan per row."""
    single = p.ndim == 1
    p2 = p[None] if single else p
    b, m = p2.shape
    u = torch.rand((b, k), generator=gen, device=p.device, dtype=p.dtype)
    points = (torch.arange(k, device=p.device, dtype=p.dtype) + u) / k
    cdf = torch.cumsum(p2, dim=-1)
    idx = torch.clamp(torch.searchsorted(cdf, points, right=False),
                      0, m - 1)
    scale = 1.0 / (k * torch.clamp(torch.gather(p2, 1, idx), min=_EPS))
    plan = SamplePlan(idx.to(torch.int32), scale.to(p.dtype),
                      torch.zeros((b,), dtype=torch.int32, device=p.device),
                      torch.zeros((b,), dtype=p.dtype, device=p.device))
    return SamplePlan(*(x[0] for x in plan)) if single else plan
