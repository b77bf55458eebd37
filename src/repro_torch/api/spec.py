"""Declarative run specification: everything a WTA-CRS training/serving
session needs, in one frozen record.

The low-level layer (``launch.train_steps``, ``train.znorm``,
``train.checkpoint``) is a kit of parts the caller must keep mutually
consistent: a ``CACHED_GRAD`` policy needs the znorm cache initialized
AND ``use_znorm_cache=True`` AND ``sample_ids`` in every batch; a
stats-driven budget controller additionally needs ``budget_stats=True``.
:class:`RunSpec` replaces that hand-wiring — it derives the cache/stats
requirements by inspecting the policy and rejects the known footguns at
CONSTRUCTION time, with the reference's fields, defaults and messages.

``repro_torch.api.Run`` consumes a RunSpec; the step makers it composes
remain public for callers that need the low level.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.core.kernel_config import KernelConfig
from repro_torch.core.policy import PolicyRules  # noqa: F401  (re-export)
from repro_torch.models import common as cm
from repro_torch.optim import OptimSpec
from repro_torch.serve.spec import ServeSpec  # noqa: F401  (re-export)
from repro_torch.train import data as data_lib
from repro_torch.train import optim, znorm


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Synthetic corpus spec (``train.data.SyntheticLM``).  ``n_samples``
    also sizes the dataset-dimension of the znorm cache (Algorithm 1
    keys the gradient-norm cache per dataset sample)."""

    seq_len: int = 32
    n_samples: int = 128
    seed: int = 0
    branching: int = 2
    kind: str = "synthetic_lm"

    def __post_init__(self):
        if self.kind != "synthetic_lm":
            raise ValueError(f"unknown data kind {self.kind!r}; "
                             f"only 'synthetic_lm' is built in — pass "
                             f"your own dataset to Run.fit(dataset=...)")
        if self.seq_len < 2 or self.n_samples < 1:
            raise ValueError("need seq_len >= 2 and n_samples >= 1")

    def build(self, cfg) -> data_lib.SyntheticLM:
        return data_lib.SyntheticLM(vocab_size=cfg.vocab_size,
                                    seq_len=self.seq_len,
                                    n_samples=self.n_samples,
                                    seed=self.seed,
                                    branching=self.branching)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One declarative record for a full run.

    ``znorm_cache`` / ``budget_stats``: tri-state.  ``None`` (default)
    derives the right value from the policy
    (``train.znorm.policy_requirements``): a reachable ``CACHED_GRAD``
    config or a stats-driven budget controller turns the cache on, a
    stats-driven controller turns stats tracking on.  ``True`` forces
    the feature on (e.g. to warm a cache under ``ACTIVATION_ONLY``);
    ``False`` forces it off and is REJECTED here when the policy cannot
    work without it.

    ``microbatches`` > 1 accumulates gradients over equal slices of the
    batch, each gathering/scattering its own cache columns, with ONE
    statistics update per optimizer step.

    ``kernel``: optional :class:`~repro_torch.core.kernel_config.KernelConfig`
    applied to EVERY estimator config the policy can resolve to
    (``Policy.with_kernel``): the sampled-dW tile pin (``dw_tile``) and
    the file of the tuning table measured on the card that chooses an
    unpinned one (``table_path``).  ``None`` keeps whatever each config
    already carries.

    ``optimizer``: a legacy ``AdamWConfig`` or an ``OptimSpec``
    (per-leaf factored / low-rank state layouts with rank control).

    ``mesh``: ``None`` runs on one device; ``"host"`` runs data parallel
    over the ranks of the initialised ``torch.distributed`` process group
    (``launch.mesh.make_host_mesh``; one rank without one), each rank on
    its slice of every ``batch_size`` batch, with ``data_axes`` (default:
    the mesh's) carrying the batch.  ``model_parallel`` M above 1 (tensor /
    expert parallelism; it needs ``mesh="host"``) groups the ranks into a
    (W / M, M) mesh whose model groups each hold the shards of one copy of
    the parameters and optimizer state; values below 1 are refused.  The
    reference's ``jit`` has no counterpart: the port's steps run eagerly.
    """

    arch: str
    policy: cm.Policy = cm.Policy()
    kernel: Optional[KernelConfig] = None
    reduced: bool = True
    seed: int = 0

    steps: int = 100
    batch_size: int = 8
    microbatches: int = 1

    # a legacy AdamWConfig (dense AdamWState, the bit-identical default)
    # or an repro_torch.optim.OptimSpec (per-leaf factored/low-rank state
    # layouts with policy-driven rank control)
    optimizer: Union[optim.AdamWConfig, OptimSpec] = optim.AdamWConfig()
    lr: float = 3e-3
    lr_schedule: str = "constant"
    warmup: int = 5

    data: DataSpec = DataSpec()

    znorm_cache: Optional[bool] = None
    budget_stats: Optional[bool] = None

    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0          # 0 = only explicit Run.save()
    checkpoint_keep: int = 3

    mesh: Optional[str] = None         # None | "host"
    model_parallel: int = 1
    data_axes: Optional[Tuple[str, ...]] = None

    prefill_chunk: int = 16            # prompt tokens per prefill call

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError("need steps >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("need prefill_chunk >= 1")
        if self.batch_size < 1 or self.microbatches < 1:
            raise ValueError("need batch_size >= 1 and microbatches >= 1")
        if self.batch_size % self.microbatches:
            raise ValueError(
                f"batch_size {self.batch_size} must divide evenly into "
                f"microbatches {self.microbatches}")
        if self.lr_schedule not in optim.SCHEDULES:
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}; "
                             f"one of {sorted(optim.SCHEDULES)}")
        if self.checkpoint_every and not self.checkpoint_dir:
            raise ValueError("checkpoint_every > 0 needs checkpoint_dir")
        if self.mesh not in (None, "host"):
            raise ValueError(f"unknown mesh {self.mesh!r}; None or 'host'")
        if self.batch_size > self.data.n_samples:
            raise ValueError(
                f"batch_size {self.batch_size} exceeds data.n_samples "
                f"{self.data.n_samples}")
        if self.model_parallel < 1:
            raise ValueError(f"model_parallel must be >= 1, got "
                             f"{self.model_parallel}")

        if self.budget_stats is True and self.znorm_cache is False:
            raise ValueError(
                "budget_stats=True needs the znorm cache (the stats are "
                "EMA'd from its gradient-norm tap); don't force "
                "znorm_cache=False with it")
        needs = znorm.policy_requirements(self.policy)
        if needs["cached_grad"] and self.znorm_cache is False:
            raise ValueError(
                "policy resolves some tag to norm_source=CACHED_GRAD but "
                "znorm_cache=False: without the dataset gradient-norm "
                "cache those layers silently fall back to "
                "activation-only sampling for the whole run.  Leave "
                "znorm_cache=None (auto) or drop CACHED_GRAD from the "
                "policy.")
        if needs["stats_controllers"]:
            if self.znorm_cache is False:
                raise ValueError(
                    "policy carries stats-driven budget controllers but "
                    "znorm_cache=False: the tap statistics they feed on "
                    "only update through the znorm cache.  Leave "
                    "znorm_cache=None (auto) or use FixedSchedule "
                    "controllers.")
            if self.budget_stats is False:
                raise ValueError(
                    "policy carries stats-driven budget controllers but "
                    "budget_stats=False: without state['budget_stats'] "
                    "every controller holds at its initial budget "
                    "forever.  Leave budget_stats=None (auto).")

    # -- derived wiring (what the hand-wired path kept in sync by hand) --

    def requirements(self) -> dict:
        return znorm.policy_requirements(self.policy)

    @property
    def use_znorm_cache(self) -> bool:
        if self.znorm_cache is not None:
            return self.znorm_cache
        n = self.requirements()
        return n["cached_grad"] or n["stats_controllers"]

    @property
    def track_budget_stats(self) -> bool:
        if self.budget_stats is not None:
            return self.budget_stats
        return self.requirements()["stats_controllers"]

    def make_lr_schedule(self):
        return optim.make_schedule(self.lr_schedule, self.lr,
                                   total_steps=self.steps,
                                   warmup=self.warmup)
