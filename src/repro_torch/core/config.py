"""Configuration for the WTA-CRS estimator family.

The paper (Liu & Wang et al., NeurIPS 2023) proposes WTA-CRS, an unbiased
estimator for GEMM with reduced variance, used to sub-sample the activation
matrix stored for the weight-gradient GEMM (Eq. 1c).  This module holds the
configuration shared by the plan functions, the autograd linear layer and
the model integration layer.

``kind`` accepts either an :class:`EstimatorKind` member or any plain
string registered in :mod:`repro_torch.core.estimator_registry`.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Union

from repro_torch.core.kernel_config import (DEFAULT_KERNEL_CONFIG,
                                            KernelConfig)


class EstimatorKind(str, enum.Enum):
    """Built-in estimators for the backward weight-gradient GEMM."""

    EXACT = "exact"          # no approximation (full fine-tuning baseline)
    CRS = "crs"              # iid column-row sampling, Drineas et al. (Eq. 5)
    DET_TOPK = "det_topk"    # deterministic top-k, Adelman et al. (biased)
    WTA_CRS = "wta_crs"      # the paper's estimator (Eq. 6)


class NormSource(str, enum.Enum):
    """Where the `z` term of the column-row probability (Eq. 3) comes from.

    The optimal probability is p_i ∝ ||H_i,:|| * ||∇Z_i,:||, but ∇Z is not
    available during the forward pass when the sub-sampling decision must be
    made.  The paper caches per-sample gradient norms from the previous
    optimizer step (Algorithm 1).  ``ACTIVATION_ONLY`` uses p_i ∝ ||H_i,:||
    which requires no cache and is also unbiased.

    This field is authoritative: with ``ACTIVATION_ONLY`` a supplied
    ``znorm`` is ignored for the sampling probabilities (the gradient-norm
    tap still flows back through the znorm argument).
    """

    ACTIVATION_ONLY = "activation_only"
    CACHED_GRAD = "cached_grad"


@dataclasses.dataclass(frozen=True)
class WTACRSConfig:
    """Static configuration for approximated linear layers.

    Attributes:
      kind: which estimator to use in the backward pass — an
        ``EstimatorKind`` or the name of any registered estimator.
      budget: normalized column-row pair budget k/|D| in (0, 1].
      norm_source: see NormSource.
      min_rows: never sample below this many rows (keeps tiny layers exact).
      deterministic_fraction_cap: upper bound on |C|/k.  1.0 reproduces the
        paper exactly (|C| chosen by Theorem 2).
      kernel: tiling of the hand-written kernels (:class:`KernelConfig`).
    """

    kind: Union[EstimatorKind, str] = EstimatorKind.WTA_CRS
    budget: float = 0.3
    norm_source: Union[NormSource, str] = NormSource.ACTIVATION_ONLY
    min_rows: int = 8
    deterministic_fraction_cap: float = 1.0
    kernel: KernelConfig = DEFAULT_KERNEL_CONFIG

    def __post_init__(self):
        # kind is open (any registered name; validated at dispatch), but
        # norm_source is a closed set — reject typos here instead of
        # letting them silently disable the gradient-norm cache.
        object.__setattr__(self, "norm_source", NormSource(self.norm_source))

    @property
    def kind_name(self) -> str:
        """The estimator name as a plain string (registry key)."""
        return str(getattr(self.kind, "value", self.kind))

    @property
    def is_exact(self) -> bool:
        return self.kind_name == EstimatorKind.EXACT.value

    def budget_rows(self, n_rows: int) -> int:
        """Concrete k for a contraction dimension of size ``n_rows``."""
        if self.is_exact:
            return n_rows
        k = int(round(self.budget * n_rows))
        k = max(self.min_rows, k)
        return min(k, n_rows)

    def with_kind(self, kind: Union[EstimatorKind, str]) -> "WTACRSConfig":
        return dataclasses.replace(self, kind=kind)

    def with_budget(self, budget: float) -> "WTACRSConfig":
        return dataclasses.replace(self, budget=budget)

    def with_kernel(self, kernel: KernelConfig) -> "WTACRSConfig":
        return dataclasses.replace(self, kernel=kernel)


EXACT_CONFIG = WTACRSConfig(kind=EstimatorKind.EXACT, budget=1.0)
