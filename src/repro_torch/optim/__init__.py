"""Factored + low-rank optimizer-state subsystem.

``OptimSpec`` (per-leaf state layouts by glob rule — dense | factored
CAME | low-rank projected moments) stands beside the legacy
``train.optim.AdamWConfig``; ``RankSchedule``/``RankController`` drive
the low-rank subspace size through the same plateau-quantized,
signature-keyed step cache that drives sampling budgets.  See
``optim.spec`` and ``optim.layouts``.

Legacy ``AdamWConfig`` runs are untouched: every step maker accepts
either type, and an all-dense spec is bit-identical to the old path.
``state_shardings`` gives the state's specs on a mesh
(``launch/sharding.py``).
"""
from repro_torch.core.controller import RankController  # noqa: F401
from repro_torch.core.policy import RankSchedule  # noqa: F401
from repro_torch.optim.layouts import (dense_adamw_bytes, from_legacy_adamw,
                                       init, init_rank_stats, memory_report,
                                       migrate_ranks, reference_groups,
                                       state_shardings, tree_bytes, update,
                                       update_rank_stats)
from repro_torch.optim.spec import (KNOWN_LAYOUTS, LayoutRule, OptimSpec,
                                    as_spec, is_rank_stat_key, rank_stat_key)

__all__ = [
    "OptimSpec", "LayoutRule", "KNOWN_LAYOUTS", "as_spec",
    "RankSchedule", "RankController",
    "init", "update", "migrate_ranks", "from_legacy_adamw",
    "init_rank_stats", "update_rank_stats", "state_shardings",
    "reference_groups",
    "rank_stat_key", "is_rank_stat_key",
    "tree_bytes", "dense_adamw_bytes", "memory_report",
]
