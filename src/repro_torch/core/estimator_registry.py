"""Estimator registry: sampling-plan functions keyed by name.

The paper studies a *family* of unbiased GEMM estimators (EXACT / CRS /
DET_TOPK / WTA-CRS, Eq. 5-6).  This module makes that family open: a
plan function registers itself under a string name with a declared
signature, and every dispatch site (``plans.build_plan``,
``plans.build_batched_plans``, the autograd linear's ``_make_plans``)
resolves through the registry.  Adding an estimator therefore never touches core files:

    from repro_torch.core.estimator_registry import register_estimator

    @register_estimator("gumbel_topk", needs_key=True, biased=False)
    def gumbel_topk_plan(p, k, gen, cfg=None) -> SamplePlan:
        ...

and ``WTACRSConfig(kind="gumbel_topk")`` (or a ``PolicyRules`` rule)
dispatches to it by name.

Plan-function contract: ``fn(p, k, gen, cfg) -> SamplePlan`` where ``p`` is a
(B, m) batch of probability vectors (one plan per row — the batch
dimension is written out, there is no vmap), ``k`` the static slot
budget, ``gen`` a ``torch.Generator`` on ``p``'s device (``None`` when
``needs_key=False``) and ``cfg`` the resolving ``WTACRSConfig`` (may be
``None``; plan functions must default any knob they read from it).  The
returned leaves are (B, k) / (B,).  Plan functions keep static output shapes
and never synchronise with the host (no ``.item()``): a data-dependent
size such as |C| is realised through masks over the k fixed slots.

``"exact"`` is deliberately NOT a registry entry — it is the absence of
a sampling plan, short-circuited by dispatch sites via ``is_exact``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict


def kind_name(kind) -> str:
    """Normalize an EstimatorKind enum member or plain string to a name."""
    return str(getattr(kind, "value", kind))


def is_exact(kind) -> bool:
    return kind_name(kind) == "exact"


@dataclasses.dataclass(frozen=True)
class EstimatorSpec:
    """A registered plan function plus its declared signature.

    Attributes:
      name: registry key; ``WTACRSConfig.kind`` values resolve to this.
      build: the plan function (see module docstring for the contract).
      needs_key: whether the function draws from a generator.  Keyless
        functions (deterministic selections) are callable without one.
      biased: True if E[estimate] != XY (e.g. det_topk drops tail mass).
        Surfaced so tests/benchmarks can sweep "all unbiased estimators".
      supports_shared: whether one plan from this function may be reused
        across several weights consuming the same activation
        (the shared-plan residual optimization in ``core.linear``).
    """

    name: str
    build: Callable
    needs_key: bool = True
    biased: bool = False
    supports_shared: bool = True


_REGISTRY: Dict[str, EstimatorSpec] = {}


def register_estimator(name: str, *, needs_key: bool = True,
                       biased: bool = False, supports_shared: bool = True,
                       overwrite: bool = False):
    """Decorator registering a plan function under ``name``."""
    if is_exact(name):
        raise ValueError("'exact' is not a plan function; dispatch sites "
                         "short-circuit it (see module docstring)")

    def deco(fn):
        if name in _REGISTRY and not overwrite:
            raise ValueError(f"estimator {name!r} already registered "
                             f"(pass overwrite=True to replace)")
        _REGISTRY[name] = EstimatorSpec(name=name, build=fn,
                                        needs_key=needs_key, biased=biased,
                                        supports_shared=supports_shared)
        return fn

    return deco


def _ensure_builtins() -> None:
    # The built-in plan functions live in repro_torch.core.plans, which imports this
    # module to register them; import lazily to break the cycle.
    from repro_torch.core import plans  # noqa: F401


def get_estimator(kind) -> EstimatorSpec:
    """Resolve an EstimatorKind / name to its spec.  KeyError if unknown."""
    _ensure_builtins()
    name = kind_name(kind)
    spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(
            f"unknown estimator {name!r}; registered: "
            f"{sorted(_REGISTRY)} (register via "
            f"repro_torch.core.estimator_registry.register_estimator)")
    return spec


def registered_estimators() -> Dict[str, EstimatorSpec]:
    """Snapshot of the registry (name -> spec)."""
    _ensure_builtins()
    return dict(_REGISTRY)
