"""Gradient compression for the cross-rank reduction.

Used by the data-parallel step (``launch/train_steps.py``,
``make_shardmap_dp_step``) to shrink the all-reduce payload, op for op as
the reference writes it:

  * ``bf16``: cast the f32 gradients to bf16, sum in bf16, cast back.
  * ``int8``: a SUM of each rank's per-tensor ``max|g|`` sets a shared
    scale ``max(amax, 1e-12) / 127``; ``clip(round(g / scale), -127,
    127)`` is cast to int8, then to int32, summed, and dequantized.

Two properties of the reference's ``int8`` mode that the port mirrors
(ROADMAP Queue C): the payload is the int32 cast, 4 bytes an element as
in ``none``, not an int8 one; and the shared scale is the sum of the
ranks' maxima, not their max, so at W ranks each rank's values use about
1/W of the int8 range.

``mesh_or_group``: a live ``launch.mesh.Mesh``, a ``torch.distributed``
process group, or None for one rank without a group.  One rank still
quantizes and dequantizes, so its numerics are the reference's one-device
mesh.  Trees are nested dicts / lists / tuples of tensors (or a list of
leaves).  The collectives go through ``launch/collectives.py``,
on whatever backend the group was built with: NCCL when each rank has
its own card, gloo on the CPU (or on one card shared by several ranks,
through host memory); on a ``meta`` mesh they are recorded (the dry
run).
"""
from __future__ import annotations

from typing import Literal

import torch
import torch.distributed as dist

from repro_torch.launch import collectives
from repro_torch.train.optim import tree_leaves, tree_map

Mode = Literal["none", "bf16", "int8"]
MODES = ("none", "bf16", "int8")


def _data_axes(mesh_or_group):
    names = getattr(mesh_or_group, "axis_names", None)
    if names is None:
        return "data"
    return tuple(a for a in names if a in ("pod", "data"))


def world_size(mesh_or_group) -> int:
    """Ranks the reduction spans: a live mesh's data group, a ``meta``
    mesh's data axes, a process group's ranks (1 for None)."""
    if getattr(mesh_or_group, "is_meta", False):
        return collectives.axis_size(mesh_or_group,
                                     _data_axes(mesh_or_group))
    group = getattr(mesh_or_group, "group", mesh_or_group)
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce_(x: torch.Tensor, mesh_or_group) -> torch.Tensor:
    """SUM over the data ranks, in place, through ``launch/collectives.py``
    (nothing to do for one rank)."""
    if world_size(mesh_or_group) == 1:
        return x
    return collectives.all_reduce_(x, mesh_or_group,
                                   _data_axes(mesh_or_group))


def psum_tree(tree, mesh_or_group, mode: Mode = "none"):
    """All-reduce (sum) a gradient tree across the ranks.  Under ``none``
    the leaves of ``tree`` are reduced in place and returned; the other
    modes return new f32 tensors."""
    group = mesh_or_group          # a mesh, a process group or None
    if mode == "none":
        return tree_map(lambda g: _all_reduce_(g, group), tree)
    if mode == "bf16":
        return tree_map(lambda g: _all_reduce_(
            g.to(torch.bfloat16), group).to(torch.float32), tree)
    if mode == "int8":
        def q(g):
            amax = _all_reduce_(torch.max(torch.abs(g)), group)   # shared
            scale = torch.clamp(amax, min=1e-12) / 127.0
            qg = torch.clamp(torch.round(g / scale), -127, 127).to(
                torch.int8)
            summed = _all_reduce_(qg.to(torch.int32), group)
            return summed.to(torch.float32) * scale
        return tree_map(q, tree)
    raise ValueError(mode)


def pmean_tree(tree, mesh_or_group, mode: Mode = "none"):
    """``psum_tree`` divided by the number of ranks."""
    n = world_size(mesh_or_group)
    summed = psum_tree(tree, mesh_or_group, mode)
    return tree_map(lambda g: g.div_(n), summed)


def payload_bytes(tree, mode: Mode = "none") -> int:
    """Bytes each rank hands to ``all_reduce`` for one ``psum_tree`` of
    ``tree``: the leaves as they are (``none``), in bf16 (``bf16``), or as
    the int32 cast plus one maximum a leaf (``int8``)."""
    leaves = tree_leaves(tree)
    if mode == "none":
        return sum(g.numel() * g.element_size() for g in leaves)
    if mode == "bf16":
        return sum(2 * g.numel() for g in leaves)
    if mode == "int8":
        return sum(4 * g.numel() + g.element_size() for g in leaves)
    raise ValueError(mode)
