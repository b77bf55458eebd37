"""Logical-axis -> mesh-axis rules (t5x-style) + state/batch shardings.

The models annotate every parameter with logical axis names
(``models/registry.py``, ``abstract_params``).  This module maps them onto
a mesh, with the reference's rules:

    vocab / mlp / qheads / kvheads / experts / ssm_inner  -> "model"
    embed / layers / scalars                              -> replicated
    batch                                                 -> ("pod","data")

A logical dim falls back to replication when its size does not divide
the mesh axis.

A spec is a tuple with one entry a dim: a mesh axis name, a tuple of
names, or None (replicated); ``()`` replicates the whole tensor.  A tuple
of one name is written as the name, as the reference's ``PartitionSpec``
normalizes it, so the two compare equal.  The shardings of a tree are a
flat ``{leaf path: spec}`` dict (``train.optim.named_leaves``'s paths)
where the reference returns a twin tree.  ``shard_batch`` hands each
rank its slice of the batch; ``shard_tree`` (``shard_params``) slices each
leaf of a tree to this rank's shard under its spec, and ``gather_tree``
(``gather_params``) is its inverse: on a whole train state (parameters,
optimizer slots, znorm cache and statistics) they serve checkpoints,
``shard_leaf`` / ``gather_leaf`` / ``sub_spec`` the optimizer's
statistics over shards (``optim/layouts.py``).  Weights cross to a model-parallel
rank as ``convert.params_from_jax`` followed by ``shard_params``.

Fused projections (Mamba2's ``in_proj`` [z | x | B | C | dt] and its conv
[x | B | C], mLSTM's ``up`` [xs | z]) are split segment by segment: their
logical axes and specs are ``Segmented`` tuples, equal to the plain ones
(so the specs are the reference's) and carrying the segment widths, and
a rank holds its 1/M of each segment in order, so that its shard is a
whole column-parallel slice of each part (``models/ssm.py``).
``decode_state_specs`` shards the port's decode states as its model code
splits them; ``serving_mesh`` is the model-only view every serving path
takes the KV caches' rule from (a model group serves its batch whole).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.launch import collectives
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.train.optim import named_leaves

DEFAULT_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "mlp": "model",
    "qheads": "model",
    "kvheads": "model",
    "experts": "model",
    "ssm_inner": "model",
    "embed": None,
    "layers": None,
}

REPLICATED: Tuple = ()


def _part(names: Tuple[str, ...]):
    """The spec entry of a dim sharded over ``names``."""
    return names[0] if len(names) == 1 else tuple(names)


def _names(part) -> Tuple[str, ...]:
    """The mesh axes of a spec entry."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


class Segmented(tuple):
    """Logical axes, or a spec, equal to its plain tuple and carrying the
    segments of dim ``dim``: ``widths`` side by side.  A spec is
    ``Segmented`` where that dim is sharded and every width of ``group``
    (the block's one decision for its fused leaves) divides the mesh
    axis; a rank then holds its 1/M of each segment, in order."""

    def __new__(cls, parts, dim: Optional[int] = None, widths=(),
                group=()):
        out = super().__new__(cls, parts)
        out.dim, out.widths, out.group = dim, tuple(widths), tuple(group)
        return out


def _spec_for_axes(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                   mesh, rules: Dict[str, Optional[str]]) -> Tuple:
    parts = []
    used = set()
    for name, dim in zip(axes, shape):
        phys = rules.get(name) if name else None
        if phys is not None and dim % mesh.shape[phys] != 0:
            phys = None                       # non-divisible -> replicate
        if phys is not None and phys in used:
            phys = None                       # a mesh axis shards one dim
        if phys is not None:
            used.add(phys)
        parts.append(phys)
    if isinstance(axes, Segmented) and parts[axes.dim] is not None:
        n = mesh_lib.mesh_size(mesh, _names(parts[axes.dim]))
        if all(w % n == 0 for w in axes.group):
            return Segmented(parts, axes.dim, axes.widths, axes.group)
    return tuple(parts)


def arch_rules(cfg, mesh) -> Dict[str, Optional[str]]:
    """Head-aware overrides: shard the kv head dims over "model" only when
    the kv head count divides the axis (a divisible (heads * dh) dim whose
    head count does not divide is sliced through head boundaries, and
    every score contraction then needs a reduction; replicating the small
    kv projections is cheaper).  q heads stay sharded either way, as in
    the reference."""
    msize = mesh.shape["model"]
    rules: Dict[str, Optional[str]] = {}
    if cfg.n_kv_heads % msize != 0:
        rules["kvheads"] = None
    return rules


def param_shardings(axes: Dict[str, Tuple], params, mesh,
                    rules: Optional[Dict[str, Optional[str]]] = None):
    """{leaf path: spec} of ``params``, from ``axes`` ({leaf path:
    logical axes}, ``registry.abstract_params``)."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    return {path: _spec_for_axes(axes[path], tuple(p.shape), mesh, rules)
            for path, p in named_leaves(params)}


def replicated(mesh) -> Tuple:
    return REPLICATED


def _batch_dim(name: str) -> int:
    return 1 if name == "positions3" else 0


def batch_shardings(batch, mesh) -> Dict[str, Tuple]:
    """Shard each entry's batch dim over (pod, data) (``positions3`` has
    its batch dim second); a batch that does not divide the data axes
    (e.g. global_batch=1 long-context decode) replicates."""
    dnames = mesh_lib.data_axes(mesh)
    dsize = mesh_lib.mesh_size(mesh, dnames)
    out = {}
    for name, x in batch.items():
        bdim = _batch_dim(name)
        if x.shape[bdim] % dsize != 0:
            out[name] = REPLICATED
            continue
        parts = [None] * len(x.shape)
        parts[bdim] = _part(dnames)
        out[name] = tuple(parts)
    return out


def decode_state_shardings(states, mesh, batch_size: int):
    """Heuristic shardings for decode states (KV caches, SSM states).

    Rule per leaf: shard the dim whose size == batch_size over the data
    axes (if divisible); then shard the largest remaining dim (except
    dim 0, the stacked-layer axis) over "model" if divisible.
    """
    dnames = mesh_lib.data_axes(mesh)
    dsize = mesh_lib.mesh_size(mesh, dnames)
    msize = mesh.shape["model"]

    def one(x):
        shape = tuple(x.shape)
        parts = [None] * len(shape)
        bdim = None
        for i, d in enumerate(shape):
            if i >= 1 and d == batch_size and d % dsize == 0:
                parts[i] = _part(dnames)
                bdim = i
                break
        best, best_size = None, 0
        for i, d in enumerate(shape):
            if i == 0 or i == bdim:
                continue
            if d % msize == 0 and d > best_size:
                best, best_size = i, d
        if best is not None:
            if bdim is None and best_size % (msize * dsize) == 0:
                # batch can't use the data axes (e.g. B=1 long-context
                # decode): fold them into the cache's sequence dim
                parts[best] = _part(dnames + ("model",))
            else:
                parts[best] = "model"
        return tuple(parts)

    return {path: one(x) for path, x in named_leaves(states)}


def decode_state_specs(cfg, states, mesh, batch_size: int):
    """{leaf path: spec} of the port's decode states (``registry.
    decode_state_init``'s tree) on ``mesh``, as its model code splits
    them: a KV cache by ``decode_state_shardings``, on whichever dim it
    picks — the sequence, ``head_dim`` (a cache of fewer positions than
    ``head_dim``, or of an odd number) or the kv heads (``models/lm.py``
    decodes over each); a recurrent block's state by heads on the heads path
    (``models/ssm.py::splits_heads``), Mamba2's conv state by its
    [x | B | C] segments, and whole on every model rank on the gathered
    path; an encoder-decoder's cross caches by heads where the kv heads
    shard, else whole.  The batch dim takes the data axes as
    ``decode_state_shardings`` gives them."""
    heuristic = decode_state_shardings(states, mesh, batch_size)
    dnames = mesh_lib.data_axes(mesh)
    dsize = mesh_lib.mesh_size(mesh, dnames)
    msize = mesh.shape["model"]
    leaves = dict(named_leaves(states))

    def by_heads(x, dim, split, widths=None):
        parts = [None] * x.ndim
        if x.shape[1] == batch_size and batch_size % dsize == 0:
            parts[1] = _part(dnames)
        if split:
            parts[dim] = "model"
            if widths is not None:
                return Segmented(parts, dim, widths, widths)
        return tuple(parts)

    out = {}
    for path, spec in heuristic.items():
        x, (block, _, name) = leaves[path], path.partition("/")
        if cfg.is_encdec and block in ("xk", "xv"):
            out[path] = by_heads(x, 3, cfg.n_kv_heads % msize == 0)
            continue
        btype = None if cfg.is_encdec else cfg.pattern[int(block)]
        if btype not in ssm_lib.RECURRENT:
            out[path] = spec
            continue
        split = ssm_lib.splits_heads(cfg, btype, msize)
        if name == "conv":
            widths = ssm_lib.segments(cfg, btype, "conv_w")[0]
            out[path] = by_heads(x, 3, split, widths)
        else:
            out[path] = by_heads(x, 2, split)
    return out


def serving_mesh(mesh):
    """The (1, M) view of ``mesh``'s model axis that the serving paths
    take the KV caches' rule from: each model group serves its batch
    whole, its data ranks replicas of one another."""
    return mesh_lib.make_mesh((1, mesh.shape["model"]), ("data", "model"))


def _model_only(spec):
    """``spec`` with every part but ``"model"`` replicated."""
    parts = tuple(p if p == "model" else None for p in spec)
    if isinstance(spec, Segmented) and parts[spec.dim] is not None:
        return Segmented(parts, spec.dim, spec.widths, spec.group)
    return parts


def serving_state_specs(cfg, states, mesh, batch_size: int):
    """{leaf path: spec} of decode states as one model group serves them
    (``decode_state_specs`` on ``serving_mesh``, over ``model`` only):
    the specs of ``Run.prefill`` / ``Run.generate``'s caches and of the
    slot pool's recurrent slots."""
    specs = decode_state_specs(cfg, states, serving_mesh(mesh), batch_size)
    return {path: _model_only(spec) for path, spec in specs.items()}


def kv_cache_spec(cfg, batch_size: int, length: int, mesh) -> Tuple:
    """The spec, over ``model`` only, of one layer's (B, S, KVH, Dh) KV
    cache of ``length`` positions: the dim ``decode_state_shardings``
    picks on ``serving_mesh`` — the sequence, ``head_dim`` or the kv
    heads — or none."""
    x = torch.empty((1, batch_size, length, cfg.n_kv_heads, cfg.head_dim),
                    device="meta")
    spec = decode_state_shardings({"k": x}, serving_mesh(mesh),
                                  batch_size)["k"]
    return _model_only(spec)[1:]


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape one rank holds of a tensor of ``shape`` under ``spec``."""
    out = list(shape)
    for i, part in enumerate(spec):
        n = mesh_lib.mesh_size(mesh, _names(part))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {part!r} ({n} ranks)")
        out[i] //= n
    return tuple(out)


def shard_batch(batch, mesh):
    """This rank's part of a batch (numpy arrays or tensors): its
    contiguous slice along each entry's batch dim where
    ``batch_shardings`` shards it over the data axes, the whole entry
    where it replicates.  The port's ``apply_shardings`` for data
    parallelism."""
    index = mesh_lib.data_index(mesh)
    specs = batch_shardings(batch, mesh)
    out = {}
    for name, x in batch.items():
        spec = specs[name]
        if spec == REPLICATED:
            out[name] = x
            continue
        bdim = _batch_dim(name)
        b = shard_shape(x.shape, spec, mesh)[bdim]
        rows = slice(index * b, (index + 1) * b)
        out[name] = x[:, rows] if bdim == 1 else x[rows]
    return out


def _rank_slice(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of ``x`` under ``spec``: a fresh tensor of
    ``shard_shape`` (an empty one on ``meta``, a copy otherwise)."""
    shape = shard_shape(tuple(x.shape), spec, mesh)
    if x.device.type == "meta":
        return torch.empty(shape, dtype=x.dtype, device="meta")
    out = x
    for dim, part in enumerate(spec):
        names = _names(part)
        if not names:
            continue
        i, n = collectives.index(mesh, names), shape[dim]
        if isinstance(spec, Segmented) and dim == spec.dim:
            m = mesh_lib.mesh_size(mesh, names)
            out = torch.cat([seg.narrow(dim, i * (w // m), w // m)
                             for seg, w in zip(out.split(spec.widths, dim),
                                               spec.widths)], dim)
        else:
            out = out.narrow(dim, i * n, n)
    return out.clone() if out is x else out.contiguous().clone()


def _unsegment(x: torch.Tensor, spec: "Segmented", m: int) -> torch.Tensor:
    """The whole leaf from the ``m`` ranks' segmented shards laid side by
    side along ``spec.dim`` (rank order): each segment's parts joined."""
    dim, local = spec.dim, [w // m for w in spec.widths]
    ranks = [r.split(local, dim) for r in x.chunk(m, dim)]
    return torch.cat([r[s] for s in range(len(local)) for r in ranks], dim)


def _rebuild(tree, fn, prefix=""):
    """``tree`` (nested dicts / lists / tuples / dataclasses) with
    ``fn(path, leaf)`` at each tensor leaf, paths as ``named_leaves``
    spells them (a dataclass's by its field names)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), fn,
                             f"{prefix}{f.name}/")
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(prefix[:-1], tree)
    return tree


def sub_spec(spec, dims) -> Tuple:
    """The spec of the dims ``dims`` (in that order) of a tensor under
    ``spec``: what a reduction over the other dims keeps.  A Segmented
    spec stays Segmented where its segmented dim is kept."""
    dims = tuple(dims)
    parts = tuple(spec[d] if d < len(spec) else None for d in dims)
    if isinstance(spec, Segmented) and spec.dim in dims:
        return Segmented(parts, dims.index(spec.dim), spec.widths,
                         spec.group)
    return parts


def is_sharded(spec) -> bool:
    """Whether ``spec`` splits any dim."""
    return any(_names(part) for part in spec)


def shard_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` under ``spec`` (a
    copy)."""
    return _rank_slice(x, spec, mesh)


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's shard ``x`` under ``spec``
    (all-gathered over its axes, a Segmented dim's segments rejoined)."""
    for dim, part in enumerate(spec):
        names = _names(part)
        if names:
            x = collectives.all_gather(x, mesh, names, dim=dim)
            if isinstance(spec, Segmented) and dim == spec.dim:
                x = _unsegment(x, spec, mesh_lib.mesh_size(mesh, names))
    return x


def shard_tree(tree, specs: Dict[str, Tuple], mesh):
    """Each tensor leaf of ``tree`` sliced to this rank's shard under
    ``specs`` ({leaf path: spec}, the paths of ``named_leaves``; a
    dataclass's fields by name); a leaf without a spec is kept as it
    is."""
    return _rebuild(tree, lambda path, x: (
        _rank_slice(x, specs[path], mesh) if path in specs else x))


def gather_tree(tree, specs: Dict[str, Tuple], mesh):
    """The inverse of ``shard_tree``: each sharded leaf all-gathered over
    its spec's axes (every rank gets the whole tensor)."""
    return _rebuild(tree, lambda path, x: gather_leaf(
        x, specs.get(path, ()), mesh))


def shard_params(params, specs: Dict[str, Tuple], mesh):
    """This rank's shard of every parameter (``param_shardings``' specs)."""
    return shard_tree(params, specs, mesh)


def gather_params(params, specs: Dict[str, Tuple], mesh):
    """The whole parameters from every rank's shards."""
    return gather_tree(params, specs, mesh)
