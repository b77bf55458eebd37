"""Approximated GEMM estimators built on sampling plans.

These are the pure "math" entry points used by tests, benchmarks and the
variance analysis.  The production integration (activation sub-sampling in
the backward pass of a linear layer) lives in ``repro_torch.core.linear``.
Randomness comes from an explicit ``torch.Generator`` where the reference
takes a key.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import estimator_registry as registry
from repro_torch.core import plans as plans_lib
from repro_torch.core.config import WTACRSConfig


def exact_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, y)


def apply_plan(x: torch.Tensor, y: torch.Tensor,
               plan: plans_lib.SamplePlan) -> torch.Tensor:
    """sum_t scale_t * X[:, i_t] Y[i_t, :]  ==  (X[:,idx]*scale) @ Y[idx,:]."""
    idx = plan.idx.to(torch.int64)
    x_sub = x[:, idx] * plan.scale[None, :].to(x.dtype)
    return torch.matmul(x_sub, y[idx, :])


def approx_matmul(x: torch.Tensor, y: torch.Tensor, cfg: WTACRSConfig,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Estimate X @ Y with cfg.kind using the optimal distribution (Eq. 3).

    ``cfg.kind`` may be any name in the estimator registry."""
    if registry.is_exact(cfg.kind):
        return exact_matmul(x, y)
    m = x.shape[1]
    k = cfg.budget_rows(m)
    x_norms = torch.linalg.vector_norm(x.to(torch.float32), dim=0)
    y_norms = torch.linalg.vector_norm(y.to(torch.float32), dim=1)
    p = plans_lib.column_row_probabilities(x_norms, y_norms)
    plan = plans_lib.build_plan(cfg.kind, p, k, gen, cfg=cfg)
    return apply_plan(x, y, plan)


# ---------------------------------------------------------------------------
# Theory utilities (used by the Fig. 3 / Theorem 2 analyses + tests)
# ---------------------------------------------------------------------------

def crs_variance(x: torch.Tensor, y: torch.Tensor, p: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Closed-form total variance of the CRS estimator (Appendix C.1):

        Var[g] = (1/k) [ sum_i ||X_:,i||^2 ||Y_i,:||^2 / p_i  -  ||XY||_F^2 ]
    """
    x32, y32 = x.to(torch.float32), y.to(torch.float32)
    xn2 = torch.sum(x32 * x32, dim=0)
    yn2 = torch.sum(y32 * y32, dim=1)
    first = torch.sum(xn2 * yn2 / torch.clamp(p, min=1e-30))
    fro2 = torch.sum(torch.matmul(x32, y32) ** 2)
    return (first - fro2) / k


def _det_mass(p: torch.Tensor, k: int):
    """(c_star, det_mass) at the Theorem-2 optimal |C| for (m,) ``p``."""
    order = torch.argsort(p, descending=True, stable=True)
    csum = torch.cumsum(p[order], dim=0)
    c_star = plans_lib.optimal_c_size(csum, k)
    det_mass = torch.where(c_star == 0, torch.zeros_like(csum[0]),
                           csum[torch.clamp(c_star.to(torch.int64) - 1,
                                            min=0)])
    return c_star, det_mass


def wtacrs_variance_bound(x: torch.Tensor, y: torch.Tensor, p: torch.Tensor,
                          k: int) -> torch.Tensor:
    """Eq. (20) bound: Var[ĝ] <= (1-sum_C p)/(k-|C|) * k * Var[g]."""
    c_star, det_mass = _det_mass(p, k)
    factor = (1.0 - det_mass) / torch.clamp(k - c_star, min=1).to(p.dtype)
    return factor * k * crs_variance(x, y, p, k)


def theorem2_condition(p: torch.Tensor, k: int):
    """Eq. (7): whether sum_C p_c > |C|/k at the optimal |C|.

    Returns (holds, c_star, det_mass) for experimental analysis (Fig. 3).
    """
    c_star, det_mass = _det_mass(p, k)
    holds = det_mass > c_star.to(p.dtype) / k
    return holds, c_star, det_mass


def empirical_estimator_stats(x: torch.Tensor, y: torch.Tensor,
                              cfg: WTACRSConfig, gen: torch.Generator,
                              n_trials: int = 64):
    """Monte-Carlo mean/variance of an estimator; used in property tests.
    The ``n_trials`` estimates draw in turn from ``gen``."""
    samples = torch.stack([approx_matmul(x, y, cfg, gen)
                           for _ in range(n_trials)])
    mean = torch.mean(samples, dim=0)
    var = torch.sum(torch.var(samples, dim=0, unbiased=False))
    return mean, var
