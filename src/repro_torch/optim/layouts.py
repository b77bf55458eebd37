"""Per-leaf optimizer-state algebra: init / update / rank migration.

State structure: the reference's, path-keyed by ITS leaves::

    {"count": int,                                  # optimizer steps taken
     "leaves": {"unit/0/mlp/wi": {"m": ..., "v": ...},            # dense
                "unit/0/attn/wq": {"proj": ..., "m": ..., "v": ...},
                "embed": {"v_row": ..., "v_col": ...},
                ...}}

The reference stacks the layers of each position of the pattern unit into
one leaf (``unit/<j>/mlp/wi`` of shape (n_repeats, n, m)); the port holds
one parameter tensor a layer (``layers/<i>/mlp/wi``, layer i being repeat
i // P of position i % P of a P-block pattern), and zamba2's shared block
(``shared/...``) is one unstacked leaf in both.  An encoder-decoder's
``encoder/<i>/...`` and ``decoder/<i>/...`` belong to the reference's
stacked ``encoder/...`` and ``decoder/...`` leaves the same way.  Its
state keeps the reference's stacked slots, so one ``OptimSpec`` resolves,
sizes and counts (``memory_report``) exactly as there: every port leaf
belongs to the stacked leaf ``reference_path`` names, and

  * a layer of a stacked MATRIX leaf is updated on its own, through views
    into the stacked slots (the reference's updates act on the last two
    axes, layer by layer), except for the two quantities the reference
    takes over the WHOLE stacked leaf: the factored update's RMS clip
    (``sqrt(mean(u * u))``) and the low-rank captured energy (one ratio
    of sums, then averaged over the rule's leaves), which are taken over
    the group of layers;
  * a stacked VECTOR leaf (a norm gain or bias, (n_repeats, d) in the
    reference) is a matrix to the reference's layouts — factored or
    projected ACROSS layers — so its layers' gradients and parameters are
    stacked (they are small) and updated as that matrix.

The layout of a leaf is carried by its slot names, not re-derived from
the spec at update time.  Numerics (f32 moments whatever the parameter
dtype; the parameter computed in f32 and rounded once):

  * dense — ``train.optim.adamw_leaf_update``, the legacy AdamW's own
    per-leaf function (elementwise, so stacking changes no bit): an
    all-dense spec is bit-identical to ``adamw_update``.
  * factored — Adafactor row/col second moments (EMA of the squared
    gradient's row/col means, rank-1 reconstruction
    ``v_row x v_col / mean(v_row)``), RMS-clipped normalized update;
    ``momentum=True`` adds CAME's confidence factors (the instability
    ``(u - m)^2`` factored the same way divides the momentum step).
  * lowrank — moments in a rank-r column subspace.  The projection
    (top-r left singular vectors of the gradient, ``torch.linalg.svd``)
    is refreshed on step 1 and every ``refresh_every`` steps after, the
    running moments rotated into the new basis (``t = P_new^T P_old``,
    ``m <- t m``, ``v <- (t*t) v``).  An SVD fixes each singular vector
    up to its sign, which differs between libraries: the parameter
    update, ``v`` and the energy do not depend on those signs, ``proj``
    and ``m`` do.

Over a model-parallel mesh (``update``'s ``mesh`` and ``param_specs``)
each rank holds its shards of the parameters and of the slots that have
their parameter's shape (dense m / v, CAME's momentum), and the whole
factored vectors and low-rank ``proj`` / ``m`` / ``v`` — what
``state_shardings`` says, as the reference's GSPMD program holds them.
The split dim of each stacked leaf comes from its spec (``leaf_specs``),
and every rank computes the whole statistics GSPMD computes across
shards:

  * factored — the row / column means of g² along the split dim are
    local sums all-reduced over ``model``; along the other dim each rank
    computes its part and the parts are all-gathered into the replicated
    ``v_row`` / ``v_col`` (an expert stack split on E keeps its experts'
    means local and gathers them).  The RMS clip's sum of squares is
    reduced once a stacked leaf.  Each rank reconstructs only its own
    shard of v̂ (and of CAME's instability estimate).
  * lowrank — ``projᵀ g`` is summed over ``model`` for a row-split g and
    all-gathered by columns for a column-split one; the energy's
    denominator is summed; ``proj @ step_r`` is formed for the rank's
    shard only.  A refresh SVDs the whole gradient, all-gathered on
    refresh steps only: model rank 0 decomposes it and the others take
    its singular vectors (an all-reduce against zeros), so every rank
    holds bit-identical replicated slots.

Updates run under ``no_grad`` and write parameters and slots in place,
with at most two temporaries the size of a layer's parameter (a
full-width embedding leaf is 6 GB in f32), except that a factored stacked
leaf holds each layer's normalized update until the whole leaf's RMS is
known.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from repro_torch.launch import collectives
from repro_torch.launch import sharding as shard_lib
from repro_torch.optim.spec import LayoutRule, OptimSpec, rank_stat_key
from repro_torch.train import optim as adamw_lib
from repro_torch.train.znorm import N_STATS, STATS_DECAY

_TINY = 1e-30


# the port's per-layer lists that the reference stacks into one leaf
# without a pattern position: an encoder-decoder's two stacks
_LAYER_STACKS = ("encoder", "decoder")


def reference_path(path: str, n_pattern: int = 1) -> str:
    """The reference's path of the stacked leaf a port leaf belongs to:
    ``layers/<i>/...`` -> ``unit/<i % n_pattern>/...`` (layer i is a
    repeat of block i % n_pattern), ``encoder/<i>/...`` ->
    ``encoder/...`` and ``decoder/<i>/...`` -> ``decoder/...``; other
    paths (``shared/...``, ``embed``, ...) are the same in both
    packages."""
    parts = path.split("/")
    if parts[0] == "layers":
        return "/".join(["unit", str(int(parts[1]) % n_pattern)]
                        + parts[2:])
    if parts[0] in _LAYER_STACKS:
        return "/".join(parts[:1] + parts[2:])
    return path


def _is_stacked(ref: str) -> bool:
    """Whether the reference's leaf ``ref`` stacks layers on a leading
    axis (a pattern unit's, or an encoder-decoder stack's)."""
    return ref.split("/")[0] in ("unit",) + _LAYER_STACKS


def pattern_len(params) -> int:
    """The length P of the pattern unit, read off the layer list: the
    smallest P dividing the depth such that layer i holds the same block
    kind (its top-level keys; ``{}`` at a shared position) as layer
    i % P.  Every ported pattern is its own smallest period (("attn",),
    ("attn_moe",), ("mlstm", "slstm"), five "mamba" and a "shared_attn"),
    so this is ``len(cfg.pattern)``."""
    kinds = [tuple(sorted(layer)) for layer in params.get("layers", [])]
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)):
            return p
    return 1


def _groups(params, leaves=None) -> Dict[str, list]:
    """reference path -> the port leaves of that stacked leaf, in layer
    order (``leaves``: tensors aligned with the params' leaves, e.g. the
    gradients, paired in as a second element)."""
    named = adamw_lib.named_leaves(params)
    others = [None] * len(named) if leaves is None else leaves
    n_pat = pattern_len(params)
    out: Dict[str, list] = {}
    for (path, p), x in zip(named, others):
        out.setdefault(reference_path(path, n_pat), []).append((p, x))
    return out


def reference_groups(params) -> List[List[int]]:
    """Indices (in ``named_leaves`` order) of the port leaves that make up
    each of the reference's leaves, in layer order: the layers of a
    stacked leaf together, every other leaf alone."""
    n_pat = pattern_len(params)
    out: Dict[str, List[int]] = {}
    for i, (path, _) in enumerate(adamw_lib.named_leaves(params)):
        out.setdefault(reference_path(path, n_pat), []).append(i)
    return list(out.values())


def _stacked_shape(ref: str, members) -> tuple:
    """The shape of the reference's leaf: (n_repeats,) + the layer's shape
    for a unit leaf, the parameter's own shape otherwise."""
    shape = tuple(members[0][0].shape)
    return (len(members),) + shape if _is_stacked(ref) else shape


def _effective_rank(rank: int, shape) -> int:
    """Leaf-level rank clamp: a subspace must be strictly smaller than
    the matrix (rank >= min extent would cost MORE than dense)."""
    return min(int(rank), min(shape[-2], shape[-1]) - 1)


def _slot_shapes(shape, rule: Optional[LayoutRule], rank: int
                 ) -> Dict[str, tuple]:
    """Slot name -> shape of one stacked leaf's state (all f32)."""
    shape = tuple(shape)
    layout = rule.layout if rule is not None else "dense"
    if layout == "factored" and len(shape) >= 2:
        row, col = shape[:-1], shape[:-2] + (shape[-1],)
        slots = {"v_row": row, "v_col": col}
        if rule.momentum:
            slots.update({"m": shape, "u_row": row, "u_col": col})
        return slots
    if layout == "lowrank" and len(shape) >= 2:
        r = _effective_rank(rank, shape)
        if r >= 1:
            lead, (n, m) = shape[:-2], shape[-2:]
            return {"proj": lead + (n, r), "m": lead + (r, m),
                    "v": lead + (r, m)}
    # dense default + fallback (vectors, degenerate ranks)
    return {"m": shape, "v": shape}


def _group_slot_shapes(spec: OptimSpec, params,
                       ranks: Optional[Dict[int, int]]):
    """[(reference path, members, stacked shape, {slot: shape})]."""
    eff = dict(spec.initial_ranks())
    if ranks:
        eff.update({int(i): int(r) for i, r in ranks.items()})
    out = []
    for ref, members in _groups(params).items():
        idx, rule = spec.resolve_with_index(ref)
        rank = eff.get(idx, rule.rank if rule else 0)
        shape = _stacked_shape(ref, members)
        out.append((ref, members, shape, _slot_shapes(shape, rule, rank)))
    return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(spec: OptimSpec, params,
         ranks: Optional[Dict[int, int]] = None) -> Dict:
    """Optimizer state for ``params`` under ``spec``: zeroed f32 slots, the
    reference's shapes, on the parameters' device.

    ``ranks``: rank per dynamic-rule index (the scheduled step's current
    band positions); defaults to ``spec.initial_ranks()``."""
    leaves = {}
    for ref, members, _, shapes in _group_slot_shapes(spec, params, ranks):
        device = members[0][0].device
        leaves[ref] = {name: torch.zeros(shape, dtype=torch.float32,
                                         device=device)
                       for name, shape in shapes.items()}
    return {"count": 0, "leaves": leaves}


def from_legacy_adamw(adamw_state, params) -> Dict:
    """Convert a legacy ``train.optim.AdamWState`` (count, m, v trees)
    into the path-keyed dense structure (a unit leaf's layers stacked) —
    the restore path for old-format checkpoints under an all-dense
    spec."""
    flat_m = adamw_lib.tree_leaves(adamw_state.m)
    flat_v = adamw_lib.tree_leaves(adamw_state.v)
    leaves = {}
    for ref, members in _groups(params, list(zip(flat_m, flat_v))).items():
        if _is_stacked(ref):
            leaves[ref] = {"m": torch.stack([m for _, (m, _) in members]),
                           "v": torch.stack([v for _, (_, v) in members])}
        else:
            (_, (m, v)), = members
            leaves[ref] = {"m": m, "v": v}
    return {"count": int(adamw_state.count), "leaves": leaves}


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------

def _stacked_spec(ref: str, spec):
    """A layer's spec behind the stacked leaf's replicated layer dim (the
    reference's ``layers`` axis maps to no mesh axis)."""
    if not _is_stacked(ref):
        return spec
    parts = (None,) + tuple(spec)
    if isinstance(spec, shard_lib.Segmented):
        return shard_lib.Segmented(parts, spec.dim + 1, spec.widths,
                                   spec.group)
    return parts


def leaf_specs(params, param_shardings) -> Dict[str, tuple]:
    """{reference path: spec of the reference's leaf}, from
    ``param_shardings`` ({port leaf path: spec}): a stacked leaf takes
    its layers' spec behind its layer dim.  ``state_shardings`` gives a
    slot its leaf's spec where their shapes match; ``update`` reads the
    split dim of each leaf from it."""
    specs = [param_shardings[path]
             for path, _ in adamw_lib.named_leaves(params)]
    return {ref: _stacked_spec(ref, members[0][1])
            for ref, members in _groups(params, specs).items()}


class _Shards:
    """How a rank holds one matrix the layouts update (a layer of a
    stacked leaf, a stacked vector leaf, or an unstacked leaf): its
    ``spec`` (one entry a dim, leading dims included) and ``whole`` shape
    on ``mesh``.  None stands for a matrix every rank holds whole."""

    def __init__(self, mesh, spec, whole):
        self.mesh, self.spec, self.whole = mesh, spec, tuple(whole)
        nd = len(self.whole)
        lead = list(range(nd - 2))
        self.row_spec = shard_lib.sub_spec(spec, lead + [nd - 2])
        self.col_spec = shard_lib.sub_spec(spec, lead + [nd - 1])
        # (..., n, r) and (..., r, m): the low-rank projection and moments
        self.proj_spec = shard_lib.sub_spec(spec, lead + [nd - 2, nd])
        self.red_spec = shard_lib.sub_spec(spec, lead + [nd, nd - 1])
        parts = tuple(spec) + (None,) * nd
        self.rows_split = shard_lib.is_sharded(parts[nd - 2:nd - 1])
        self.cols_split = shard_lib.is_sharded(parts[nd - 1:nd])

    def gather(self, x, spec):
        return shard_lib.gather_leaf(x, spec, self.mesh)

    def local(self, x, spec):
        return shard_lib.shard_leaf(x, spec, self.mesh)

    def sum(self, x):
        return collectives.all_reduce(x, self.mesh, "model")


def _matrix_specs(ref, members, specs, stack_vectors: bool):
    """The spec of each matrix ``update`` hands the layouts for one
    reference leaf: the stacked leaf's for a stacked vector leaf (one
    matrix), a layer's (the stacked spec without its layer dim) for a
    stacked matrix leaf, the leaf's own otherwise; None where nothing is
    split."""
    spec = specs.get(ref) if specs is not None else None
    if spec is None or not shard_lib.is_sharded(tuple(spec)):
        return [None] * (1 if stack_vectors or not _is_stacked(ref)
                         else len(members))
    if stack_vectors or not _is_stacked(ref):
        return [spec]
    layer = shard_lib.sub_spec(spec, range(1, len(tuple(spec))))
    return [layer] * len(members)


@torch.no_grad()
def update(grads, state: Dict, params, lr: float, spec: OptimSpec,
           gnorm=None, mesh=None, param_specs=None):
    """Updates ``params`` and ``state`` in place; returns (params, state,
    metrics, rank_energy).

    ``grads``: a tree like ``params`` or the list of its leaves in
    ``train.optim.tree_leaves`` order.  ``rank_energy``: {controller-rule
    index: captured-energy 0-dim tensor} averaged over the rule's stacked
    leaves — what ``update_rank_stats`` folds into ``budget_stats`` for
    the scheduled step's ``RankController``.  Empty for specs without
    controller rules.  ``gnorm``: the gradient norm where the leaves are
    shards (a model-parallel step); by default theirs.  ``mesh`` and
    ``param_specs`` ({port leaf path: spec}, ``launch.sharding.
    param_shardings`` of the whole parameters): a model-parallel mesh
    whose ranks hold ``params`` and ``state`` as ``state_shardings``
    shards them (module doc)."""
    if gnorm is None:
        gnorm = adamw_lib.global_norm(grads)
    flat_g = adamw_lib.tree_leaves(grads)
    if spec.grad_clip_norm > 0:
        scale = torch.clamp(spec.grad_clip_norm
                            / torch.clamp(gnorm, min=1e-12), max=1.0)
        flat_g = [g * scale.to(g.dtype) for g in flat_g]
    state["count"] += 1
    count = state["count"]
    bc1 = 1.0 - spec.b1 ** count
    bc2 = 1.0 - spec.b2 ** count
    ctrl_idx = set(spec.controller_rule_indices())
    specs = None
    if param_specs is not None and collectives.model_size(mesh) > 1:
        specs = leaf_specs(params, param_specs)

    energies: Dict[int, list] = {}
    for ref, members in _groups(params, flat_g).items():
        idx, rule = spec.resolve_with_index(ref)
        slots = state["leaves"][ref]
        stack = _is_stacked(ref) and members[0][0].dim() == 1
        if stack:
            # a stacked vector leaf is one matrix to the layouts
            layers = [(slots, torch.stack([p for p, _ in members]),
                       torch.stack([g for _, g in members]))]
        elif _is_stacked(ref):
            layers = [({name: t[i] for name, t in slots.items()}, p, g)
                      for i, (p, g) in enumerate(members)]
        else:
            (p, g), = members
            layers = [(slots, p, g)]
        mspecs = _matrix_specs(ref, members, specs, stack)
        if "proj" in slots:
            energy = _lowrank_update(layers, lr, spec, rule, bc1, bc2,
                                     count, with_energy=idx in ctrl_idx,
                                     mesh=mesh, specs=mspecs)
            if idx in ctrl_idx:
                energies.setdefault(idx, []).append(energy)
        elif "v_row" in slots:
            _factored_update(layers, lr, spec, rule, bc2, mesh=mesh,
                             specs=mspecs)
        else:
            for s, p, g in layers:
                adamw_lib.adamw_leaf_update(g, s["m"], s["v"], p, lr, spec,
                                            bc1, bc2)
        if stack:
            for i, (p, _) in enumerate(members):
                p.copy_(layers[0][1][i])
    rank_energy = {i: torch.mean(torch.stack(es))
                   for i, es in energies.items()}
    return params, state, {"grad_norm": gnorm}, rank_energy


def _rank1(row, col, out=None, sh: Optional[_Shards] = None):
    """Outer-product second-moment estimate, normalized by the row mean
    (Adafactor eq. 4): row (..., n), col (..., m) -> (..., n, m); with
    ``sh`` the whole row and col give this rank's shard of it."""
    denom = torch.clamp(torch.mean(row, dim=-1, keepdim=True), min=_TINY)
    row = row / denom
    if sh is not None:
        row, col = sh.local(row, sh.row_spec), sh.local(col, sh.col_spec)
    return torch.mul(row[..., :, None], col[..., None, :], out=out)


def _ema_(acc, decay: float, x) -> None:
    """acc <- decay * acc + (1 - decay) * x, in place (x is consumed)."""
    acc.mul_(decay).add_(x.mul_(1 - decay))


def _mean_sq_stats(x, sh: Optional[_Shards]):
    """(row means, column means) of ``x`` (..., n, m) over the whole
    matrix, whole on every rank: along a split dim the local sums are
    summed over ``model``, along the other the ranks' parts gathered."""
    if sh is None:
        return torch.mean(x, dim=-1), torch.mean(x, dim=-2)
    row, col = torch.sum(x, dim=-1), torch.sum(x, dim=-2)
    if sh.cols_split:
        row = sh.sum(row)
    if sh.rows_split:
        col = sh.sum(col)
    row = sh.gather(row / sh.whole[-1], sh.row_spec)
    col = sh.gather(col / sh.whole[-2], sh.col_spec)
    return row, col


def _factored_update(layers, lr, spec: OptimSpec, rule: LayoutRule, bc2,
                     mesh=None, specs=None):
    """``layers``: (slots, param, grad) of each layer of one stacked leaf
    (or the leaf itself); ``specs``: each one's spec on ``mesh`` (None:
    whole)."""
    specs = specs or [None] * len(layers)
    shards = [None if sp is None else
              _Shards(mesh, sp, tuple(s["v_row"].shape)
                      + (s["v_col"].shape[-1],))
              for (s, _, _), sp in zip(layers, specs)]
    # pass 1: second moments and the normalized update of every layer,
    # whose RMS over the whole stacked leaf sets the clip
    us, sq, n = [], 0.0, 0
    for (s, p, g), sh in zip(layers, shards):
        g32 = g.to(torch.float32)
        g2 = g32 * g32
        row, col = _mean_sq_stats(g2, sh)
        del g2
        _ema_(s["v_row"], spec.b2, row)
        _ema_(s["v_col"], spec.b2, col)
        u = _rank1(s["v_row"] / bc2, s["v_col"] / bc2, sh=sh)
        u.sqrt_().add_(spec.eps)
        torch.div(g32, u, out=u)
        sq = sq + torch.linalg.vector_norm(u).square()
        n += u.numel() if sh is None else math.prod(sh.whole)
        us.append(u)
    if shards[0] is not None:
        sq = shards[0].sum(sq)           # once a stacked leaf
    clip = torch.clamp(torch.sqrt(sq / n) / spec.clip_threshold, min=1.0)
    # pass 2: clip, CAME's confidence-guided momentum, the parameter
    for i, ((s, p, _), sh) in enumerate(zip(layers, shards)):
        u, us[i] = us[i], None
        u.div_(clip)
        if rule.momentum:
            m = s["m"]
            t = u * (1 - spec.b1)
            m.mul_(spec.b1).add_(t)
            instab = torch.sub(u, m, out=t).square_()
            del u
            row, col = _mean_sq_stats(instab, sh)
            _ema_(s["u_row"], spec.b3, row)
            _ema_(s["u_col"], spec.b3, col)
            step = _rank1(s["u_row"], s["u_col"], out=instab, sh=sh)
            step.sqrt_().add_(spec.eps)
            step = torch.div(m, step, out=step)
        else:
            step = u
        adamw_lib.apply_step(p, step, lr, spec.weight_decay)


def _top_left(g32, r: int):
    """The top-``r`` left singular vectors of ``g32`` (..., n, m)."""
    return torch.linalg.svd(g32, full_matrices=False).U[..., :, :r]


def _rotate(p_new, proj, m, v):
    t = p_new.transpose(-1, -2) @ proj                       # (..., r, r)
    return p_new, t @ m, (t * t) @ v


def refresh_subspace(g32, proj, m, v):
    """One low-rank leaf's subspace refresh: the projection becomes the
    top-r left singular vectors of the gradient (``torch.linalg.svd``),
    the moments are rotated into it (``t = P_new^T P_old``, ``m <- t m``,
    ``v <- (t*t) v``).  Returns (proj, m, v), new tensors."""
    return _rotate(_top_left(g32, proj.shape[-1]), proj, m, v)


def _refresh_sharded(g32, proj, m, v, sh: _Shards):
    """``refresh_subspace`` of a sharded gradient: the whole gradient
    all-gathered, model rank 0's singular vectors taken by every rank
    (the others contribute zeros to an all-reduce), so the replicated
    slots stay bit-identical across the ranks."""
    whole = sh.gather(g32, sh.spec)
    if collectives.index(sh.mesh, "model") == 0:
        p_new = _top_left(whole, proj.shape[-1]).contiguous()
    else:
        p_new = torch.zeros_like(proj)
    del whole
    p_new = collectives.all_reduce_(p_new, sh.mesh, "model")
    return _rotate(p_new, proj, m, v)


def _lowrank_update(layers, lr, spec: OptimSpec, rule: LayoutRule,
                    bc1, bc2, count: int, with_energy: bool, mesh=None,
                    specs=None):
    """Returns the captured energy of the stacked leaf (``None`` unless
    ``with_energy``): one ratio of sums over all its layers.  ``specs``:
    each layer's spec on ``mesh`` (None: whole)."""
    specs = specs or [None] * len(layers)
    refresh_every = rule.refresh_every if rule is not None else 1
    refresh = (count - 1) % refresh_every == 0
    num = den = 0.0
    sharded = False
    for (s, p, g), sp in zip(layers, specs):
        g32 = g.to(torch.float32)
        proj, m, v = s["proj"], s["m"], s["v"]
        # the whole matrix: proj (..., n, r), m (..., r, m)
        sh = (None if sp is None else _Shards(
            mesh, sp, tuple(proj.shape[:-1]) + (m.shape[-1],)))
        sharded = sharded or sh is not None
        if refresh:
            p_new, m, v = (refresh_subspace(g32, proj, m, v) if sh is None
                           else _refresh_sharded(g32, proj, m, v, sh))
            proj.copy_(p_new)
            del p_new
        if sh is None:
            g_r = proj.transpose(-1, -2) @ g32               # (..., r, m)
        else:
            g_r = sh.local(proj, sh.proj_spec).transpose(-1, -2) @ g32
            if sh.rows_split:
                g_r = sh.sum(g_r)
            g_r = sh.gather(g_r, sh.red_spec)
        if with_energy:
            num = num + torch.sum(g_r * g_r)
            den = den + torch.linalg.vector_norm(g32).square()
        m_new = spec.b1 * m + (1 - spec.b1) * g_r
        v_new = spec.b2 * v + (1 - spec.b2) * g_r * g_r
        step_r = (m_new / bc1) / (torch.sqrt(v_new / bc2) + spec.eps)
        if sh is None:
            step = proj @ step_r
        else:
            step = (sh.local(proj, sh.proj_spec)
                    @ sh.local(step_r, sh.red_spec))
        adamw_lib.apply_step(p, step, lr, spec.weight_decay)
        s["m"].copy_(m_new)
        s["v"].copy_(v_new)
    if not with_energy:
        return None
    if sharded:
        den = collectives.all_reduce(den, mesh, "model")
    return num / torch.clamp(den, min=_TINY)


# ---------------------------------------------------------------------------
# rank migration (the scheduled step re-plans: pad/truncate the subspace)
# ---------------------------------------------------------------------------

def migrate_ranks(spec: OptimSpec, state: Dict, params,
                  new_ranks: Dict[int, int]) -> Dict:
    """Re-size the low-rank leaves governed by the re-planned rules.

    Rank DOWN keeps the leading columns (singular vectors are
    energy-ordered, so truncation keeps the dominant subspace); rank UP
    zero-pads (the next ``refresh_every`` boundary re-orthogonalizes).
    Leaves that fell back to dense at init stay dense.  Returns a new
    state dict (the resized slots are new tensors)."""
    leaves = dict(state["leaves"])
    for ref, members in _groups(params).items():
        idx, _ = spec.resolve_with_index(ref)
        if idx not in new_ranks:
            continue
        slots = leaves[ref]
        if "proj" not in slots:
            continue
        r_new = max(_effective_rank(new_ranks[idx],
                                    _stacked_shape(ref, members)), 1)
        r_old = slots["proj"].shape[-1]
        if r_new == r_old:
            continue
        proj, m, v = slots["proj"], slots["m"], slots["v"]
        if r_new < r_old:
            proj = proj[..., :r_new].contiguous()
            m = m[..., :r_new, :].contiguous()
            v = v[..., :r_new, :].contiguous()
        else:
            pad = r_new - r_old
            proj = torch.nn.functional.pad(proj, (0, pad))
            m = torch.nn.functional.pad(m, (0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        leaves[ref] = {"proj": proj, "m": m, "v": v}
    return {"count": state["count"], "leaves": leaves}


# ---------------------------------------------------------------------------
# rank statistics (budget_stats plumbing for RankController)
# ---------------------------------------------------------------------------

def init_rank_stats(spec: OptimSpec, device="cuda"
                    ) -> Dict[str, torch.Tensor]:
    """Neutral (energy=1, count=0) stat vectors, one per
    controller-carrying rule — the znorm tag stats' shape and decay
    contract, so they ride ``state['budget_stats']`` unchanged."""
    base = torch.zeros((N_STATS,), dtype=torch.float32, device=device)
    base[0] = 1.0
    base[2] = 1.0
    return {rank_stat_key(i): base.clone()
            for i in spec.controller_rule_indices()}


def update_rank_stats(stats: Dict[str, torch.Tensor],
                      rank_energy: Dict[int, torch.Tensor],
                      decay: float = STATS_DECAY
                      ) -> Dict[str, torch.Tensor]:
    """EMA the fresh captured-energy fractions into the running vectors
    (alpha=1 at count 0, like ``znorm.update_stats``); new tensors.  The
    energy lands in the ``ess`` slot — the one RankController reads."""
    out = dict(stats)
    for i, e in rank_energy.items():
        k = rank_stat_key(i)
        prev = out.get(k)
        if prev is None:
            continue
        x = torch.stack([e, 1.0 - e, e])
        cnt = prev[N_STATS - 1]
        alpha = torch.where(cnt > 0, 1.0 - decay, 1.0)
        ema = prev[:N_STATS - 1] + alpha * (x - prev[:N_STATS - 1])
        out[k] = torch.cat([ema, (cnt + 1.0)[None]])
    return out


# ---------------------------------------------------------------------------
# shardings + memory accounting
# ---------------------------------------------------------------------------

def state_shardings(state: Dict, params, param_shardings, replicated):
    """Shardings for the path-keyed state: a slot inherits its stacked
    parameter's sharding when shapes match (dense m/v, factored momentum)
    and is replicated otherwise (factored vectors, low-rank subspace
    moments — all tiny).  ``param_shardings``: {leaf path: spec} of the
    whole ``params`` (``launch.sharding.param_shardings``); the stacked
    leaf of a layer group takes its layers' spec behind a replicated
    layer dim (``leaf_specs``), as the reference's ``layers`` axis maps
    to no mesh axis."""
    specs = leaf_specs(params, param_shardings)
    leaves = {}
    for ref, members in _groups(params).items():
        shape = _stacked_shape(ref, members)
        leaves[ref] = {
            slot: (specs[ref] if tuple(arr.shape) == shape else replicated)
            for slot, arr in state["leaves"][ref].items()}
    return {"count": replicated, "leaves": leaves}


def tree_bytes(tree) -> int:
    """Total bytes of the tensors of a nested dict/list tree; an int leaf
    (the step counter, an int32 in the reference's state) counts 4."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, int):
        return 4
    if isinstance(tree, dict):
        return sum(tree_bytes(x) for x in tree.values())
    return sum(tree_bytes(x) for x in tree)


def dense_adamw_bytes(params) -> int:
    """What plain AdamW would hold for ``params``: two f32 moments per
    element + the step counter."""
    return sum(2 * 4 * p.numel() for p in adamw_lib.tree_leaves(params)) + 4


def memory_report(spec: OptimSpec, params,
                  ranks: Optional[Dict[int, int]] = None) -> Dict:
    """Allocation-free per-layout byte accounting over the reference's
    stacked leaves (``params`` may live on the meta device).

    Returns ``{"rows": [{layout, leaves, params, state_bytes,
    dense_bytes}], "state_bytes", "dense_bytes", "ratio"}`` — the
    §Optimizer memory record of ``launch.report``, the reference's field
    for field."""
    per_layout: Dict[str, Dict] = {}
    total = 4                                   # the step counter
    for _, _, shape, slots in _group_slot_shapes(spec, params, ranks):
        layout = ("lowrank" if "proj" in slots
                  else "factored" if "v_row" in slots else "dense")
        row = per_layout.setdefault(
            layout, {"layout": layout, "leaves": 0, "params": 0,
                     "state_bytes": 0, "dense_bytes": 0})
        nbytes = sum(4 * math.prod(s) for s in slots.values())
        row["leaves"] += 1
        row["params"] += math.prod(shape)
        row["state_bytes"] += nbytes
        row["dense_bytes"] += 2 * 4 * math.prod(shape)
        total += nbytes
    dense = dense_adamw_bytes(params)
    return {"rows": sorted(per_layout.values(),
                           key=lambda r: -r["state_bytes"]),
            "state_bytes": total, "dense_bytes": dense,
            "ratio": dense / max(total, 1)}
