"""Estimator core of the port: configs, registry, plans, estimators, the
sampled linear and its LoRA wrapper, the per-layer policy and the adaptive
budget controllers.

Plan builders register by name in ``estimator_registry`` (built-ins in
``plans``, extras in ``estimators_extra``, imported here so they are
registered)."""
from repro_torch.core import estimators_extra as _estimators_extra  # noqa: F401
from repro_torch.core.config import (EXACT_CONFIG, EstimatorKind, NormSource,
                                     WTACRSConfig)
from repro_torch.core.controller import (BudgetController, ConditionRate,
                                         ESSProportional, FixedSchedule,
                                         RankController, TagStats)
from repro_torch.core.estimator_registry import (EstimatorSpec, get_estimator,
                                                 register_estimator,
                                                 registered_estimators)
from repro_torch.core.estimators import (apply_plan, approx_matmul,
                                         crs_variance,
                                         empirical_estimator_stats,
                                         exact_matmul, theorem2_condition,
                                         wtacrs_variance_bound)
from repro_torch.core.kernel_config import KernelConfig
from repro_torch.core.linear import (read_grad_norm_tap, wtacrs_linear,
                                     wtacrs_linear_shared)
from repro_torch.core.lora import LoRAConfig, init_lora_params, lora_linear
from repro_torch.core.plans import (SamplePlan, batched_row_weights,
                                    build_batched_plans, build_plan,
                                    column_row_probabilities, crs_plan,
                                    det_topk_plan, optimal_c_size,
                                    wtacrs_plan)
from repro_torch.core.policy import (BudgetSchedule, PolicyRules,
                                     RankSchedule, Rule)

__all__ = [
    "EXACT_CONFIG", "EstimatorKind", "NormSource", "WTACRSConfig",
    "KernelConfig", "EstimatorSpec", "get_estimator", "register_estimator",
    "registered_estimators", "read_grad_norm_tap", "wtacrs_linear",
    "wtacrs_linear_shared", "LoRAConfig", "init_lora_params",
    "lora_linear", "SamplePlan", "batched_row_weights",
    "build_batched_plans", "build_plan", "column_row_probabilities",
    "crs_plan", "det_topk_plan", "optimal_c_size", "wtacrs_plan",
    "approx_matmul", "apply_plan", "exact_matmul", "crs_variance",
    "wtacrs_variance_bound", "theorem2_condition",
    "empirical_estimator_stats",
    "BudgetSchedule", "PolicyRules", "RankSchedule", "Rule",
    "BudgetController", "ConditionRate", "ESSProportional", "FixedSchedule",
    "RankController", "TagStats",
]
