"""Estimator core of the port: configs, registry, plans, the sampled
linear and the per-layer policy."""
from repro_torch.core.config import (EXACT_CONFIG, EstimatorKind, NormSource,
                                     WTACRSConfig)
from repro_torch.core.estimator_registry import (get_estimator,
                                                 register_estimator,
                                                 registered_estimators)
from repro_torch.core.kernel_config import KernelConfig
from repro_torch.core.linear import (read_grad_norm_tap, wtacrs_linear,
                                     wtacrs_linear_shared)
from repro_torch.core.plans import (SamplePlan, batched_row_weights,
                                    build_batched_plans, build_plan,
                                    column_row_probabilities, crs_plan,
                                    det_topk_plan, optimal_c_size,
                                    wtacrs_plan)
from repro_torch.core.policy import BudgetSchedule, PolicyRules, Rule

__all__ = [
    "EXACT_CONFIG", "EstimatorKind", "NormSource", "WTACRSConfig",
    "KernelConfig", "get_estimator", "register_estimator",
    "registered_estimators", "read_grad_norm_tap", "wtacrs_linear",
    "wtacrs_linear_shared", "SamplePlan", "batched_row_weights",
    "build_batched_plans", "build_plan", "column_row_probabilities",
    "crs_plan", "det_topk_plan", "optimal_c_size", "wtacrs_plan",
    "BudgetSchedule", "PolicyRules", "Rule",
]
