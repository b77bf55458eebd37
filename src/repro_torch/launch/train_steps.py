"""The eager train and serve steps of the port.

``make_train_step`` returns a ``(state, batch) -> (state, metrics)``
function.  There is no jit: the step runs eagerly, the layer stack is a
Python loop, and the optimizer updates the parameters in place (see
``train/optim.py``); the znorm cache and budget statistics come back as
new tensors in the same state dict, which is the caller's own object.
``make_scheduled_train_step`` drives budget schedules and adaptive
budget controllers on top of it (Algorithm 1's whole loop), and the rank
schedules and controllers of an ``OptimSpec``'s low-rank layouts.

Data parallelism: given a live host mesh (``launch/mesh.py``) whose data
axes span several ranks, each rank runs the step on its own slice of the
batch (``launch.sharding.shard_batch``) with the same replicated
parameters and optimizer state, and the gradients are all-reduced
(``train/compression.py``) before the identical update on every rank.
``make_shardmap_dp_step`` is the reference's explicit data-parallel step
(gradient compression, no znorm cache); ``make_train_step(mesh=...)``
computes what the reference's sharded step computes over the global
batch, the znorm cache and budget statistics included.  The backend is
the caller's: whatever ``torch.distributed`` group the mesh carries.

Tensor and expert parallelism: a live host mesh whose ``model`` axis
holds M ranks runs Megatron's program (``models/lm.py``): each rank of a
model group holds its shards of the parameters and of the optimizer
state (``shard_train_state``), the same batch slice, and draws the same
plans; the gradients are reduced over the data axes only, and the legacy
AdamW updates each shard in place (it is elementwise; the gradient norm
sums the sharded leaves' squares over ``model``), as do an
``OptimSpec``'s layouts, whose factored and low-rank statistics span the
shards (``optim/layouts.py``).  ``gather_train_state`` rebuilds the whole
state for a checkpoint and ``shard_train_state`` splits it again.

The serve and prefill step makers below return eager functions with the
reference's signatures.  Each step enters ``torch.no_grad()`` itself
(grad mode is thread-local and the serving loop runs in its own thread),
and decode steps write the new token's K/V into the caches in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import optim as optim_lib
from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core import controller as controller_lib
from repro_torch.device import resolve_device, resolve_or_meta
from repro_torch.launch import collectives
from repro_torch.launch import cost as cost_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.train import compression, optim, znorm


def init_train_state(cfg: ArchConfig, seed: int, znorm_tags=None,
                     n_dataset: int = 0, budget_stats: bool = False,
                     device="cuda", params=None, opt=None,
                     opt_ranks=None) -> Dict[str, Any]:
    """Parameters from ``seed`` on ``device`` (or ``params``, already
    drawn from ``seed`` there), zeroed f32 optimizer state, step 0 and the
    base seed every step's sampling seed derives from.

    ``znorm_tags`` (from ``znorm.collect_linear_tags``): also carry the
    dataset gradient-norm cache over ``n_dataset`` samples; with
    ``budget_stats`` the per-tag controller statistics too (only useful —
    and only paid for — when the policy carries adaptive budget
    controllers; see ``repro_torch.core.controller``).

    ``opt``: ``None``/``AdamWConfig`` keeps the legacy ``AdamWState``; an
    ``repro_torch.optim.OptimSpec`` initializes the path-keyed layout
    state (its rank-controller statistics ride ``budget_stats`` whatever
    the znorm flags — they come from the optimizer update, not the znorm
    tap).  ``opt_ranks``: current rank per dynamic rule (a resumed run's
    band positions)."""
    device = resolve_device(device)
    if params is None:
        params = registry.init_params(cfg, seed, device=device)
    legacy = opt is None or isinstance(opt, optim.AdamWConfig)
    state = {
        "params": params,
        "opt": (optim.adamw_init(params) if legacy
                else optim_lib.init(opt, params, ranks=opt_ranks)),
        "step": 0,
        "base_seed": cm.fold_seed(int(seed), 7),
    }
    if znorm_tags:
        state["znorm"] = znorm.init_cache(cfg, znorm_tags, n_dataset,
                                          device=device)
        if budget_stats:
            state["budget_stats"] = znorm.init_stats(znorm_tags,
                                                     device=device)
    if not legacy:
        rank_stats = optim_lib.init_rank_stats(opt, device=device)
        if rank_stats:
            state.setdefault("budget_stats", {}).update(rank_stats)
    return state


def abstract_train_state(cfg: ArchConfig, znorm_tags=None,
                         n_dataset: int = 0, budget_stats: bool = False,
                         opt=None, opt_ranks=None):
    """(``init_train_state``'s tree on the ``meta`` device, the
    parameters' logical axes) without allocation; ``step`` and
    ``base_seed`` are the host integers they are in a live state."""
    params, axes = registry.abstract_params(cfg)
    # parameters on meta put the optimizer state there too; the rank
    # statistics (a few floats) are re-made there below
    state = init_train_state(cfg, 0, device="cpu", params=params, opt=opt,
                             opt_ranks=opt_ranks)
    meta = lambda shape: torch.empty(shape, dtype=torch.float32,
                                     device="meta")
    stats = {}
    if znorm_tags:
        state["znorm"] = {t: meta((cfg.n_repeats, n_dataset))
                          for t in znorm_tags}
        if budget_stats:
            stats = {t: meta((znorm.N_STATS,)) for t in znorm_tags}
    stats.update({k: meta(tuple(v.shape))
                  for k, v in state.get("budget_stats", {}).items()})
    if stats:
        state["budget_stats"] = stats
    return state, axes


def train_state_shardings(cfg, state, axes, mesh):
    """Specs for the whole train state (``launch/sharding.py``): the
    parameters by the arch's rules, the optimizer state mirroring them,
    everything else replicated."""
    rules = shard_lib.arch_rules(cfg, mesh)
    p_sh = shard_lib.param_shardings(axes, state["params"], mesh,
                                     rules=rules)
    rep = shard_lib.replicated(mesh)
    sh = {
        "params": p_sh,
        "opt": (optim.AdamWState(rep, p_sh, p_sh)
                if isinstance(state["opt"], optim.AdamWState)
                else optim_lib.state_shardings(
                    state["opt"], state["params"], p_sh, rep)),
        "step": rep,
        "base_seed": rep,
    }
    if "znorm" in state:
        sh["znorm"] = {t: rep for t in state["znorm"]}
    if "budget_stats" in state:
        sh["budget_stats"] = {t: rep for t in state["budget_stats"]}
    return sh


def train_state_specs(shardings) -> Dict[str, tuple]:
    """``train_state_shardings``' specs as one flat {state path: spec}
    dict (``launch.sharding.shard_tree``'s paths: ``params/<leaf>``,
    ``opt/m/<leaf>`` / ``opt/v/<leaf>`` of an ``AdamWState``,
    ``opt/leaves/<reference path>/<slot>`` of an ``OptimSpec``'s state;
    the znorm cache and statistics, replicated, are left out)."""
    out = {f"params/{p}": s for p, s in shardings["params"].items()}
    opt = shardings["opt"]
    if isinstance(opt, optim.AdamWState):
        for slot in ("m", "v"):
            out.update({f"opt/{slot}/{p}": s
                        for p, s in getattr(opt, slot).items()})
    else:
        out.update({f"opt/leaves/{ref}/{slot}": spec
                    for ref, slots in opt["leaves"].items()
                    for slot, spec in slots.items()})
    return out


def shard_train_state(state, shardings, mesh):
    """This rank's shard of a whole train state (``init_train_state``'s or
    ``abstract_train_state``'s) under ``train_state_shardings``: the
    parameters and the optimizer slots sliced by their specs, the rest as
    it is.  On ``meta`` tensors, fresh ``meta`` tensors of the shard
    shapes."""
    return shard_lib.shard_tree(state, train_state_specs(shardings), mesh)


def gather_train_state(state, shardings, mesh):
    """The whole train state from every rank's shards: the inverse of
    ``shard_train_state`` (every rank gets it; a checkpoint's tree has a
    one-rank state's keys, shapes and dtypes)."""
    return shard_lib.gather_tree(state, train_state_specs(shardings), mesh)


def model_param_specs(cfg, mesh) -> Dict[str, tuple]:
    """{leaf path: spec} of ``cfg``'s whole parameters on ``mesh`` under
    the arch's rules (``train_state_shardings``' parameter specs, without
    allocating anything)."""
    params, axes = registry.abstract_params(cfg)
    return shard_lib.param_shardings(
        axes, params, mesh, rules=shard_lib.arch_rules(cfg, mesh))


def _whole_shapes(cfg) -> List[tuple]:
    """The whole parameters' shapes, ``tree_leaves`` order."""
    whole, _ = registry.abstract_params(cfg)
    return [tuple(w.shape) for w in optim.tree_leaves(whole)]


def _model_parallel_norm(grads, sharded, mesh) -> torch.Tensor:
    """The global gradient norm over a model group: the sharded leaves'
    squares summed over ``model``, the replicated ones counted once."""
    def part(flags):
        sq = [torch.sum(torch.square(g.to(torch.float32)))
              for g, f in zip(grads, sharded) if f == flags]
        return (torch.stack(sq).sum() if sq else
                torch.zeros((), dtype=torch.float32, device=grads[0].device))
    return torch.sqrt(collectives.all_reduce(part(True), mesh, "model")
                      + part(False))


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    out = {}
    for name, x in batch.items():
        if name == "sample_ids":
            continue
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        out[name] = x.to(device)
    return out


def _no_tf32() -> None:
    # the f32 products here (and every f32 comparison against the
    # reference) assume full-precision matmuls
    torch.backends.cuda.matmul.allow_tf32 = False


def _data_parallel(mesh, data_axes):
    """(ranks, this rank's index) over the data axes of ``mesh``: (1, 0)
    without a mesh.  The data axes must span the mesh's process group."""
    if mesh is None:
        return 1, 0
    axes = mesh_lib.data_axes(mesh) if data_axes is None else tuple(data_axes)
    unknown = [a for a in axes if a not in mesh.axis_names]
    if unknown:
        raise ValueError(f"data_axes {axes} name axes {unknown} that the "
                         f"mesh {mesh.axis_names} does not have")
    world = mesh_lib.mesh_size(mesh, axes)
    if world != compression.world_size(mesh):
        raise ValueError(
            f"the data axes {axes} of mesh {dict(mesh.shape)} hold {world} "
            f"ranks but its process group has "
            f"{compression.world_size(mesh)}: give a live mesh "
            f"(launch.mesh.make_host_mesh)")
    return world, mesh_lib.data_index(mesh)


def _gather_rows(mesh, world: int, index: int, x: torch.Tensor, dim: int):
    """Every rank's ``x`` side by side along ``dim``, in rank order: one
    all_reduce of a zero-padded buffer (exact: each entry is one rank's
    value plus zeros)."""
    b = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = b * world
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, index * b, b).copy_(x)
    return collectives.all_reduce_(out, mesh, mesh_lib.data_axes(mesh))


def _grads_of(cfg, policy, params, leaves, zn, batch, key, mesh=None):
    """Loss, parameter gradients and (with a cache) the tap of every cache
    tag — zeros for a tag whose linear took no znorm."""
    zn_leaves = []
    if zn is not None:
        zn = {t: z.detach().requires_grad_(True) for t, z in zn.items()}
        zn_leaves = list(zn.values())
    for p in leaves:
        p.requires_grad_(True)
    try:
        with tracing.span("forward"):
            loss, _ = registry.loss_fn(cfg, params, batch, policy, key=key,
                                       znorms=zn, mesh=mesh)
        with tracing.span("backward"):
            grads = torch.autograd.grad(loss, leaves + zn_leaves,
                                        allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves + zn_leaves)]
    taps = (None if zn is None else
            dict(zip(zn, grads[len(leaves):])))
    return loss.detach(), grads[:len(leaves)], taps


def _check_opt(opt_cfg) -> bool:
    """Whether ``opt_cfg`` is an ``OptimSpec`` (else an ``AdamWConfig``)."""
    layouts = isinstance(opt_cfg, optim_lib.OptimSpec)
    if not layouts and not isinstance(opt_cfg, optim.AdamWConfig):
        raise TypeError(f"expected OptimSpec or AdamWConfig, got "
                        f"{type(opt_cfg).__name__}")
    return layouts


def make_train_step(cfg: ArchConfig, policy: cm.Policy, opt_cfg,
                    schedule: Callable[[int], float],
                    use_znorm_cache: bool = False,
                    microbatches: int = 1,
                    device="cuda", mesh=None, data_axes=None,
                    compress: Optional[compression.Mode] = None):
    """(state, batch) -> (state, metrics).  Paper-faithful WTA-CRS step.

    ``batch`` holds ``tokens`` / ``labels`` (and ``sample_ids``; a VLM's
    ``patches`` and ``positions3``, an encoder-decoder's ``frames``; see
    ``registry.train_batch_specs``) as numpy arrays or tensors (moved to
    ``device``); ``metrics`` holds 0-dim tensors ``loss`` and
    ``grad_norm`` (no host sync is forced here) and the float ``lr``.  Sampling seeds derive from
    ``(state["base_seed"], state["step"])``, so a step is reproducible and
    steps are independent.

    With ``use_znorm_cache`` the batch must carry ``sample_ids`` and the
    state a ``znorm`` cache; gradient-norm taps refresh it every step
    (Algorithm 1), and ``budget_stats``, where the state has them, take
    one update a step.  Configure the sampled layers with
    ``norm_source=NormSource.CACHED_GRAD`` so the cache drives the
    probabilities (ACTIVATION_ONLY ignores it but still warms it).
    ``microbatches`` > 1 accumulates the gradients in f32 over that many
    equal slices of the batch (activation memory for 4 bytes a
    parameter), each with its own seed ``fold_seed(step seed, i)``; with
    the cache each slice gathers and scatters its own sample ids, and the
    statistics still take ONE update per optimizer step, over the whole
    batch's taps.

    ``opt_cfg``: a legacy ``optim.AdamWConfig`` (``AdamWState``) or an
    ``repro_torch.optim.OptimSpec`` (path-keyed layout state;
    rank-controller statistics land in ``state["budget_stats"]`` under
    ``optim:rank:*`` keys).

    This builder runs ONE policy resolution (``policy.step`` as given);
    ``make_scheduled_train_step`` re-resolves schedules and controllers
    per step.

    ``mesh``: a live host mesh (``launch.mesh.make_host_mesh``) whose
    ``data_axes`` (default: the mesh's) carry the batch.  Each rank calls
    the step with its own slice of the global batch
    (``launch.sharding.shard_batch``; with microbatches, each rank splits
    its slice) and the same state; one step then computes what one rank
    computes on the global batch, up to the order of the sums: the
    gradients and the loss are all-reduced to their global means before
    the update, and with the cache every rank's ``(sample_ids, taps)`` are
    gathered, so every rank scatters the whole batch's columns and the
    statistics take ONE update over the whole batch's taps (they are not
    linear in the taps, so they are gathered, not averaged).  A rank's
    taps come from its own slice's mean loss, W times the global loss's
    share at W ranks, so they are divided by W² (a tap is a squared
    norm).  Each rank draws its own plans, from the step seed folded with
    its data index, so under a random estimator the step is the global
    batch's in distribution; where plans draw nothing (exact, ``det_topk``)
    it is the global batch's step.  The batch must split evenly: the loss
    is the mean of the ranks' means (an MoE's load-balancing loss is each
    rank's own).  With one rank, or no mesh, nothing is reduced.

    ``compress`` (``make_shardmap_dp_step``'s): reduce the gradients
    through ``reduce_gradients`` in that mode and fold the data index into
    the seed at every world size, one rank included.

    A ``model`` axis above 1 (tensor and expert parallelism, see the
    module doc): every rank of a model group calls the step with its
    shard of the state (``shard_train_state``) and the same batch slice;
    the reduction runs over the data axes only, and an ``OptimSpec``'s
    factored and low-rank layouts take their whole-leaf statistics across
    the shards (``optim/layouts.py``).  A ``meta`` mesh
    (``launch.mesh.meta_mesh``) with ``device="meta"`` runs one rank's
    step without peers, for the dry run.
    """
    device = resolve_or_meta(device)
    model_mesh = registry.model_parallel_mesh(mesh)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if compress is not None and compress not in compression.MODES:
        raise ValueError(f"unknown compress {compress!r}; one of "
                         f"{compression.MODES}")
    layouts = _check_opt(opt_cfg)
    world, index = _data_parallel(mesh, data_axes)
    # the explicit data-parallel step reduces (and rounds) even at world 1
    reduce = world > 1 or compress is not None
    # the update only reports captured-energy statistics when the spec
    # carries rank-controller rules
    track_rank_energy = layouts and bool(opt_cfg.controller_rule_indices())
    _no_tf32()

    # the whole shapes, to tell a shard from a replicated leaf, and the
    # parameters' specs, which the optimizer's layouts read their split
    # dims from (taken here, outside any cost counter: the meta
    # parameters are whole-size)
    whole = _whole_shapes(cfg) if model_mesh is not None else None
    p_specs = (model_param_specs(cfg, model_mesh)
               if model_mesh is not None and layouts else None)

    def train_step(state, batch):
        with tracing.span("train_step"):
            return step_body(state, batch)

    def step_body(state, batch):
        params = state["params"]
        step = int(state["step"])
        key = cm.fold_seed(state["base_seed"], step)
        if reduce:
            key = cm.fold_seed(key, index)
        model_batch = _to_device(batch, device)
        leaves = optim.tree_leaves(params)
        cache = state.get("znorm") if use_znorm_cache else None
        if use_znorm_cache:
            if cache is None or "sample_ids" not in batch:
                raise ValueError(
                    "use_znorm_cache=True needs a state with a 'znorm' "
                    "cache (init_train_state(znorm_tags=...)) and a batch "
                    "with 'sample_ids'")
            ids = _tokens(batch["sample_ids"], device)
            active = znorm.sampling_active_tags(
                policy, cache, seq_len=model_batch["tokens"].shape[-1])

        if microbatches == 1:
            zn = znorm.gather(cache, ids) if use_znorm_cache else None
            loss, grads, taps = _grads_of(cfg, policy, params, leaves, zn,
                                          model_batch, key, model_mesh)
            if use_znorm_cache and world == 1:
                cache = znorm.scatter(cache, ids, taps, active_tags=active)
        else:
            b = model_batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            mb = b // microbatches
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            tap_parts = []
            # a cost counter may trace one microbatch for all of them
            for i in cost_lib.loop(microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                # M-RoPE's positions3 is (3, B, S): its batch is dim 1
                mb_batch = {n: x[:, rows] if n == "positions3" else x[rows]
                            for n, x in model_batch.items()}
                zn = (znorm.gather(cache, ids[rows]) if use_znorm_cache
                      else None)
                loss_i, g_i, taps_i = _grads_of(
                    cfg, policy, params, leaves, zn, mb_batch,
                    cm.fold_seed(key, i), model_mesh)
                for acc, g in zip(grads, g_i):
                    acc.add_(g.to(torch.float32) / microbatches)
                del g_i
                loss = loss + loss_i / microbatches
                if use_znorm_cache:
                    # each microbatch gathers its own columns and scatters
                    # its own tap; sample ids within a batch are disjoint,
                    # so this equals gathering everything up front
                    if world == 1:
                        cache = znorm.scatter(cache, ids[rows], taps_i,
                                              active_tags=active)
                    tap_parts.append(taps_i)
            if use_znorm_cache:
                taps = {t: torch.cat([p[t] for p in tap_parts], dim=1)
                        for t in tap_parts[0]}
        if reduce:
            with tracing.span("grad_reduce"):
                grads = reduce_gradients(grads, params, mesh,
                                         compress or "none")
                loss = compression.pmean_tree(loss, mesh)
            if use_znorm_cache and taps:
                names = list(taps)
                local = torch.stack([taps[t] for t in names]) / (world * world)
                taps = dict(zip(names, _gather_rows(
                    mesh, world, index, local, dim=2)))
                ids = _gather_rows(mesh, world, index, ids, dim=0)
            if use_znorm_cache:
                cache = znorm.scatter(cache, ids, taps, active_tags=active)

        lr = schedule(step)
        gnorm = None
        if model_mesh is not None:
            sharded = [tuple(p.shape) != w for p, w in zip(leaves, whole)]
            gnorm = _model_parallel_norm(grads, sharded, model_mesh)
        with tracing.span("optimizer"):
            if layouts:
                _, _, om, rank_energy = optim_lib.update(
                    grads, state["opt"], params, lr, opt_cfg, gnorm=gnorm,
                    mesh=model_mesh, param_specs=p_specs)
            else:
                _, _, om = optim.adamw_update(grads, state["opt"], leaves,
                                              lr, opt_cfg, gnorm=gnorm)
        state["step"] = step + 1
        if use_znorm_cache:
            state["znorm"] = cache
            if "budget_stats" in state:
                # ONE update per optimizer step over the whole batch's taps
                # (the stat atoms are normalized, so the per-microbatch
                # loss normalization cancels)
                budgets = {t: policy.config_for(t).budget
                           for t in state["budget_stats"]
                           if not optim_lib.is_rank_stat_key(t)}
                state["budget_stats"] = znorm.update_stats(
                    state["budget_stats"], taps, budgets, active_tags=active)
        if track_rank_energy and "budget_stats" in state:
            state["budget_stats"] = optim_lib.update_rank_stats(
                state["budget_stats"], rank_energy)
        return state, {"loss": loss, "lr": lr, **om}

    return train_step


@dataclasses.dataclass
class ScheduleState:
    """Host-side, checkpointable state of the scheduled train step.

    Everything the scheduled step accumulates across steps lives here — the
    controller-pinned budget per rule (the hysteresis band position),
    the re-plan counter, and the budget trajectory log — so a run
    restored through :func:`make_scheduled_train_step`'s
    ``schedule_state`` argument continues its budget trajectory exactly
    where it stopped.  ``to_json``/``from_json`` round-trip the
    reference's record (version 2: ``ranks`` pins the rank of every
    dynamic ``OptimSpec`` rule, ``rank_trajectory`` logs its changes;
    both empty for ``AdamWConfig`` and static specs).
    """

    VERSION = 2

    budgets: Dict[int, float] = dataclasses.field(default_factory=dict)
    replans: int = 0
    trajectory: List[dict] = dataclasses.field(default_factory=list)
    ranks: Dict[int, int] = dataclasses.field(default_factory=dict)
    rank_trajectory: List[dict] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return {"version": self.VERSION,
                "budgets": {str(i): float(b)
                            for i, b in self.budgets.items()},
                "replans": int(self.replans),
                "trajectory": [dict(r) for r in self.trajectory],
                "ranks": {str(i): int(r)
                          for i, r in self.ranks.items()},
                "rank_trajectory": [dict(r)
                                    for r in self.rank_trajectory]}

    @classmethod
    def from_json(cls, d: dict) -> "ScheduleState":
        v = d.get("version")
        if v not in (1, cls.VERSION):
            raise ValueError(
                f"schedule-state record version {v!r} is not "
                f"{cls.VERSION}; this checkpoint was written by an "
                f"incompatible scheduled step")
        return cls(budgets={int(i): float(b)
                            for i, b in d["budgets"].items()},
                   replans=int(d["replans"]),
                   trajectory=[dict(r) for r in d["trajectory"]],
                   ranks={int(i): int(r)
                          for i, r in d.get("ranks", {}).items()},
                   rank_trajectory=[dict(r) for r
                                    in d.get("rank_trajectory", [])])


class ScheduledStepFn:
    """(state, batch) -> (state, metrics) with budget schedules AND
    adaptive budget controllers resolved against the live step counter.

    Budgets fix the plan shapes, so the policy is re-resolved at the step
    read from ``state["step"]`` and one step function is kept per
    resolved schedule signature (eagerly, a new signature costs only new
    plan shapes; the cache keeps the reference's bookkeeping).
    Controller-carrying rules additionally read the per-tag statistics
    the cached step accumulates in ``state["budget_stats"]`` — ONE host
    read a step for all tags — and a decision is pinned into the policy
    via ``with_rule_budgets``; re-planning happens exactly when a
    controller crosses its hysteresis band.

    All cross-step state lives in ``self.schedule_state`` (a
    :class:`ScheduleState`).  Introspection:

      * ``step_fn.compiled``           — signature -> step function
      * ``step_fn.replans``            — controller-driven budget changes
      * ``step_fn.budget_trajectory``  — [{step, rule, budget, prev}, ...]
        (initial pins carry ``prev=None``, are logged on the first
        invocation at whatever step that is, and do not count as
        re-plans)
      * ``step_fn.owned_tags``         — controller rule -> the stat tags
        it governs under first-match-wins

    An ``OptimSpec``'s rank schedules and rank controllers resolve the
    same way, before each step: a new rank migrates the low-rank slots
    (``optim.migrate_ranks``), counts as a re-plan and enters the
    signature.
    """

    def __init__(self, cfg: ArchConfig, policy: cm.Policy, opt_cfg,
                 schedule: Callable[[int], float],
                 schedule_state: Optional[ScheduleState] = None,
                 device="cuda", **train_step_kwargs):
        self._cfg = cfg
        self._policy = policy
        self._opt_cfg = opt_cfg
        self._schedule = schedule
        self._device = resolve_device(device)
        self._train_step_kwargs = train_step_kwargs
        self.compiled: Dict[tuple, Callable] = {}

        rules = policy.rules.rules if policy.rules is not None else ()
        self._rules = rules
        self._ctrl_idx = (policy.rules.controller_rule_indices()
                          if policy.rules is not None else ())
        # same default-first base config as PolicyRules.resolve/signature
        base_cfg = (policy.rules.default
                    if policy.rules is not None
                    and policy.rules.default is not None else policy.wtacrs)
        self.schedule_state = (schedule_state if schedule_state is not None
                               else ScheduleState())
        if not self.schedule_state.budgets:
            self.schedule_state.budgets = {
                i: rules[i].controller.initial_budget(
                    rules[i].static_budget(base_cfg))
                for i in self._ctrl_idx}
        elif set(self.schedule_state.budgets) != set(self._ctrl_idx):
            raise ValueError(
                f"restored schedule state pins budgets for controller "
                f"rules {sorted(self.schedule_state.budgets)} but the "
                f"policy's controller rules are "
                f"{sorted(self._ctrl_idx)}; the policy changed between "
                f"save and restore")
        self._stats_needed = any(
            getattr(rules[i].controller, "needs_stats", True)
            for i in self._ctrl_idx)
        if self._stats_needed and not train_step_kwargs.get(
                "use_znorm_cache"):
            # without the cache the tap never refreshes budget_stats:
            # every count stays 0, controllers hold forever, and the
            # "adaptive" run silently trains at its initial budget
            raise ValueError(
                "policy has stats-driven budget-controller rules; pass "
                "use_znorm_cache=True (and init the state with "
                "znorm_tags and budget_stats=True) so the tap "
                "statistics they feed on actually update")
        # tags GOVERNED by each controller rule under first-match-wins;
        # stat keys are fixed per state structure, so resolve once
        self.owned_tags: Dict[int, list] = {}

        # --- optimizer rank dynamics (repro_torch.optim.OptimSpec) -------
        spec = (opt_cfg if isinstance(opt_cfg, optim_lib.OptimSpec)
                else None)
        self._opt_spec = spec
        self._rank_dyn = (spec.dynamic_rule_indices()
                          if spec is not None else ())
        self._rank_ctrl = (spec.controller_rule_indices()
                           if spec is not None else ())
        if not self.schedule_state.ranks:
            if self._rank_dyn:
                self.schedule_state.ranks = dict(spec.initial_ranks())
        elif set(self.schedule_state.ranks) != set(self._rank_dyn):
            raise ValueError(
                f"restored schedule state pins ranks for optimizer "
                f"rules {sorted(self.schedule_state.ranks)} but the "
                f"spec's dynamic rank rules are "
                f"{sorted(self._rank_dyn)}; the optimizer spec changed "
                f"between save and restore")

    @property
    def replans(self) -> int:
        return self.schedule_state.replans

    @property
    def budget_trajectory(self) -> List[dict]:
        return self.schedule_state.trajectory

    def _owned(self, stats_keys):
        if not self.owned_tags:
            self.owned_tags.update({i: [] for i in self._ctrl_idx})
            for t in stats_keys:
                for i, r in enumerate(self._rules):
                    if r.matches(t):
                        if i in self.owned_tags:
                            self.owned_tags[i].append(t)
                        break
        return self.owned_tags

    def __call__(self, state, batch):
        step = int(state["step"])
        st = self.schedule_state
        rule_budgets = None
        stats_host = None
        if self._ctrl_idx or self._rank_ctrl:
            stats_host = {}
            names = list(state.get("budget_stats", {}))
            if names:
                # one device-to-host read for every tag's vector
                vecs = torch.stack([state["budget_stats"][t]
                                    for t in names]).cpu().numpy()
                stats_host = dict(zip(names, vecs))
        if self._ctrl_idx:
            if self._stats_needed and "budget_stats" not in state:
                raise ValueError(
                    "policy has stats-driven budget-controller rules "
                    "but the train state carries no 'budget_stats'; "
                    "init the state with znorm_tags and "
                    "budget_stats=True (the controllers feed on the "
                    "znorm cache's tap statistics) and pass "
                    "use_znorm_cache=True")
            owned = self._owned([t for t in stats_host
                                 if not optim_lib.is_rank_stat_key(t)])
            for i in self._ctrl_idx:
                r = self._rules[i]
                agg = controller_lib.TagStats.aggregate(stats_host,
                                                        tags=owned[i])
                nb = float(r.controller.propose(agg, st.budgets[i], step))
                if not any(rec["rule"] == i for rec in st.trajectory):
                    # initial pin, logged on the FIRST invocation
                    st.trajectory.append(
                        {"step": step, "rule": i, "pattern": r.pattern,
                         "budget": st.budgets[i], "prev": None})
                if nb != st.budgets[i]:
                    st.replans += 1
                    st.trajectory.append(
                        {"step": step, "rule": i, "pattern": r.pattern,
                         "budget": nb, "prev": st.budgets[i]})
                    st.budgets[i] = nb
            rule_budgets = tuple(st.budgets.get(i)
                                 for i in range(len(self._rules)))
        state = self._apply_rank_dynamics(state, step, stats_host)
        pol = self._policy.at_step(step)
        if rule_budgets is not None:
            pol = pol.with_rule_budgets(rule_budgets)
        sig = pol.schedule_signature()
        if st.ranks:
            sig = sig + tuple(sorted(st.ranks.items()))
        fn = self.compiled.get(sig)
        if fn is None:
            fn = make_train_step(self._cfg, pol, self._opt_cfg,
                                 self._schedule, device=self._device,
                                 **self._train_step_kwargs)
            self.compiled[sig] = fn
        return fn(state, batch)

    def _apply_rank_dynamics(self, state, step: int, stats_host):
        """Resolve rank schedules/controllers at the concrete step and
        migrate the optimizer state on band crossings (pad/truncate the
        low-rank subspaces; one new step function per change through the
        signature-keyed cache, like a budget re-plan)."""
        if not self._rank_dyn:
            return state
        spec, st = self._opt_spec, self.schedule_state
        changed: Dict[int, int] = {}
        for i in self._rank_dyn:
            rule = spec.rules[i]
            if rule.schedule is not None:
                want = int(rule.schedule.rank_at(step))
            else:
                vec = (stats_host or {}).get(optim_lib.rank_stat_key(i))
                agg = (controller_lib.TagStats.from_vector(vec)
                       if vec is not None else None)
                want = int(rule.controller.propose(agg, st.ranks[i], step))
            if not any(rec["rule"] == i for rec in st.rank_trajectory):
                st.rank_trajectory.append(
                    {"step": step, "rule": i, "pattern": rule.pattern,
                     "rank": st.ranks[i], "prev": None})
            if want != st.ranks[i]:
                st.replans += 1
                st.rank_trajectory.append(
                    {"step": step, "rule": i, "pattern": rule.pattern,
                     "rank": want, "prev": st.ranks[i]})
                changed[i] = want
                st.ranks[i] = want
        if changed:
            state["opt"] = optim_lib.migrate_ranks(
                spec, state["opt"], state["params"], changed)
        return state


def make_scheduled_train_step(cfg: ArchConfig, policy: cm.Policy, opt_cfg,
                              schedule: Callable[[int], float],
                              schedule_state: Optional[ScheduleState] = None,
                              device="cuda",
                              **train_step_kwargs) -> ScheduledStepFn:
    """Build a :class:`ScheduledStepFn` (see its docstring).

    ``schedule_state``: a restored :class:`ScheduleState` (e.g.
    ``ScheduleState.from_json`` of the reference's record) to resume a
    controller-carrying run; ``None`` starts fresh at every controller's
    initial budget.  ``train_step_kwargs`` go to ``make_train_step``
    (``use_znorm_cache``, ``microbatches``, ``mesh``, ``data_axes``: under
    data parallelism every rank updates the statistics from the same
    gathered taps, so every rank's controllers take the same decisions).
    """
    return ScheduledStepFn(cfg, policy, opt_cfg, schedule,
                           schedule_state=schedule_state, device=device,
                           **train_step_kwargs)


# ---------------------------------------------------------------------------
# Serving: prefill and cached decode (aligned batch)
# ---------------------------------------------------------------------------

def _tokens(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return torch.as_tensor(x).to(device=device, dtype=torch.int64)


def make_prefill_step(cfg: ArchConfig, policy: cm.Policy, device="cuda",
                      mesh=None):
    """(params, batch) -> (last_logits (B, V), states): the whole prompt
    through the stack, attention on the ``flash_attention_fwd`` kernel (a
    VLM's batch also carries ``patches`` and ``positions3``).  An
    encoder-decoder arch raises, as in the reference: its prefill is
    ``encdec.prime_cross_cache`` and the decode loop.  ``mesh``: a
    model-parallel mesh (``params`` this rank's shards): the states are
    this rank's shards of the caches, on the dim
    ``launch.sharding.kv_cache_spec`` picks (``models/lm.py``)."""
    device = resolve_or_meta(device)
    mesh = registry.model_parallel_mesh(mesh)
    _no_tf32()

    def prefill_step(params, batch):
        with torch.no_grad(), tracing.span("prefill_step"):
            batch = _to_device(batch, device)
            return registry.prefill(cfg, params, batch, policy, mesh=mesh)

    return prefill_step


def make_serve_step(cfg: ArchConfig, policy: cm.Policy, device="cuda",
                    mesh=None):
    """(params, token (B,), pos, states) -> (next_token (B,) int32 greedy,
    logits (B, V), states); ``pos`` scalar or (B,).  ``mesh``: a
    model-parallel mesh, the states each rank's shards (see
    ``make_prefill_step``)."""
    device = resolve_or_meta(device)
    mesh = registry.model_parallel_mesh(mesh)
    _no_tf32()

    def serve_step(params, token, pos, states):
        with torch.no_grad():
            logits, states = registry.decode_step(
                cfg, params, _tokens(token, device), pos, states, policy,
                mesh=mesh)
            next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, states

    return serve_step


def make_prefill_chunk_step(cfg: ArchConfig, policy: cm.Policy,
                            chunk_len: int, device="cuda", mesh=None):
    """(params, tokens (B, chunk_len), start, states[, kv_positions]) ->
    states: the chunk fed through ``decode_step`` one token at a time
    from position ``start`` (the same steps in the same order as
    token-by-token decode, so the chunk size never changes the caches).
    ``mesh``: a model-parallel mesh, ``params`` and ``states`` this
    rank's shards (``make_serve_step``)."""
    device = resolve_device(device)
    mesh = registry.model_parallel_mesh(mesh)
    _no_tf32()

    def chunk_step(params, tokens, start, states, kv_positions=None):
        tokens = _tokens(tokens, device)
        if tokens.shape[1] != chunk_len:
            raise ValueError(f"chunk of {tokens.shape[1]} tokens for a "
                             f"step built for {chunk_len}")
        with torch.no_grad():
            for off in range(chunk_len):
                _, states = registry.decode_step(
                    cfg, params, tokens[:, off], int(start) + off, states,
                    policy, mesh=mesh, kv_positions=kv_positions)
        return states

    return chunk_step


# ---------------------------------------------------------------------------
# Slot-pool serving steps (continuous batching; see repro_torch.serve)
# ---------------------------------------------------------------------------

def make_slot_serve_step(cfg: ArchConfig, policy: cm.Policy, top_k: int = 0,
                         device="cuda", shards=None):
    """One batched decode step over the whole slot pool.

    Gathers every slot's paged KV into contiguous decode-layout caches,
    runs ONE ``decode_step`` with per-slot positions, samples next tokens
    with per-request keys and temperatures, and scatters each row's new
    K/V token back into its own page (inactive rows land on the scratch
    page).

    Signature: ``(params, pool, page_table, token, pos, active, keys,
    n_gen, temperature) -> (next_token, logits, pool)``; ``page_table``,
    ``token``, ``pos`` and ``active`` are host arrays or tensors, ``keys``
    and ``n_gen`` host integers per row, ``temperature`` a host array.
    ``shards``: the pool's split over a model-parallel mesh
    (``serve.pool.PoolShards``; ``params`` this rank's shards); the
    logits, and so the tokens, are whole on every rank."""
    from repro_torch.serve import pool as pool_lib
    from repro_torch.serve import sampling as sampling_lib
    device = resolve_device(device)
    mesh = None if shards is None else shards.mesh
    _no_tf32()

    def slot_serve_step(params, pool, page_table, token, pos, active, keys,
                        n_gen, temperature):
        page_table = _tokens(page_table, device)
        pos = _tokens(pos, device)
        active = torch.as_tensor(active).to(device=device, dtype=torch.bool)
        with torch.no_grad():
            states = pool_lib.gather_decode_states(cfg, pool, page_table)
            logits, states = registry.decode_step(
                cfg, params, _tokens(token, device), pos, states, policy,
                mesh=mesh, kv_positions=pool_lib.kv_positions(
                    shards, page_table.shape[1], device))
            ks = sampling_lib.step_keys(keys, n_gen)
            next_token = sampling_lib.sample_logits(logits, ks, temperature,
                                                    top_k=top_k)
            pool = pool_lib.scatter_decode_update(cfg, pool, states,
                                                  page_table, pos, active,
                                                  shards)
        return next_token, logits, pool

    return slot_serve_step


def make_slot_prefill_step(cfg: ArchConfig, policy: cm.Policy,
                           chunk_len: int, fresh: bool, device="cuda",
                           shards=None):
    """Prefill ``chunk_len`` prompt tokens for ONE slot of the pool:
    gather the slot's decode-layout state (batch 1), feed the chunk
    through ``decode_step`` token by token (the numerics of token-by-token
    decode, so the chunk size never changes served tokens), scatter the
    state back into the slot's pages.  ``fresh`` marks a request's first
    chunk; attention state needs no reset (stale KV is masked beyond the
    slot's live length).  ``shards``: as ``make_slot_serve_step``'s."""
    from repro_torch.serve import pool as pool_lib
    device = resolve_device(device)
    chunk = make_prefill_chunk_step(
        cfg, policy, chunk_len, device=device,
        mesh=None if shards is None else shards.mesh)

    def slot_prefill_step(params, pool, page_table_row, slot, tokens, start):
        page_table_row = _tokens(page_table_row, device)
        with torch.no_grad():
            states = pool_lib.gather_slot_states(cfg, pool, page_table_row,
                                                 slot, fresh, shards)
            states = chunk(params, _tokens(tokens, device)[None], start,
                           states, pool_lib.kv_positions(
                               shards, page_table_row.shape[0], device))
            return pool_lib.scatter_slot_states(cfg, pool, states,
                                                page_table_row, slot)

    return slot_prefill_step


def make_slot_reset_step(cfg: ArchConfig, device="cuda", shards=None):
    """Reset one slot's recurrent state to the block init constants (for
    single-token prompts, which run no prefill chunk, so nothing else
    clears the evicted predecessor's conv/SSM/mLSTM/sLSTM state out of
    the slot).  Attention-only archs carry no such state, so their pool
    comes back as it was."""
    from repro_torch.serve import pool as pool_lib
    device = resolve_device(device)

    def slot_reset_step(pool, page_table_row, slot):
        page_table_row = _tokens(page_table_row, device)
        with torch.no_grad():
            states = pool_lib.gather_slot_states(cfg, pool, page_table_row,
                                                 slot, fresh=True,
                                                 shards=shards)
            return pool_lib.scatter_slot_states(cfg, pool, states,
                                                page_table_row, slot)

    return slot_reset_step


# ---------------------------------------------------------------------------
# The data-parallel step with an explicit (compressed) gradient all-reduce
# ---------------------------------------------------------------------------

def reduce_gradients(grads, params, mesh, compress: compression.Mode
                     = "none"):
    """The mean over the ranks of ``grads`` (the list of ``params``'s
    leaves' gradients, consumed), through ``compression.pmean_tree``.  The
    reference reduces its stacked leaves, so under ``int8`` the layers of
    one stacked leaf share one scale here too: they are stacked for the
    reduction (a copy of the gradients, each layer freed once stacked)."""
    if compress != "int8":
        return compression.pmean_tree(grads, mesh, compress)
    groups = optim_lib.reference_groups(params)
    stacked = []
    for idx in groups:
        stacked.append(torch.stack([grads[i] for i in idx]))
        for i in idx:
            grads[i] = None
    stacked = compression.pmean_tree(stacked, mesh, compress)
    for idx, g in zip(groups, stacked):
        for j, i in enumerate(idx):
            grads[i] = g[j]
    return grads


def make_shardmap_dp_step(cfg: ArchConfig, policy: cm.Policy, opt_cfg,
                          schedule: Callable[[int], float], mesh,
                          compress: compression.Mode = "none",
                          device="cuda"):
    """Pure data-parallel step with the gradient reduction written out
    (``compression.pmean_tree`` under ``compress``: ``none``, ``bf16`` or
    ``int8``; ``reduce_gradients``), the reference's
    ``make_shardmap_dp_step``: ``make_train_step`` on ``mesh`` without the
    znorm cache or microbatches.

    ``mesh``: a live host mesh.  Parameters and optimizer state are
    replicated: every rank calls ``(state, batch) -> (state, metrics)``
    with the same state and its own slice of the batch
    (``launch.sharding.shard_batch``; ``sample_ids`` are ignored).  A
    rank's sampling seed is ``fold_seed(fold_seed(base_seed, step),
    data_index)``, so the ranks' plans decorrelate; its loss is
    ``loss_fn`` over its slice.  The gradients are averaged over the ranks
    through the compression, the loss is all-reduced to its mean
    uncompressed, and the update is AdamW or an ``OptimSpec``'s layouts.
    At one rank the compression still rounds, as on the reference's
    one-device mesh."""
    return make_train_step(cfg, policy, opt_cfg, schedule, device=device,
                           mesh=mesh, compress=compress)
