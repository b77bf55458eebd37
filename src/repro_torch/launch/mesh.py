"""Meshes: named axes over ranks.

A :class:`Mesh` is an ordered mapping of axis name to size.  An abstract
mesh (``make_mesh``, ``make_production_mesh``) only carries the shape, which
is all the sharding rules (``launch/sharding.py``) read.  A live mesh
(``make_host_mesh``) also carries the ``torch.distributed`` process group
its ranks reduce over and the rank's device: its ``data`` axis is the
group's world size, and the step makers of ``launch/train_steps.py`` run
data parallelism over it.  The reference's single pod is (data 16, model
16) and its multi-pod mesh puts a leading ``pod`` axis before them — the
outermost data-parallel dimension, whose links carry the gradient
all-reduce only.

A live mesh of W ranks at ``model_parallel`` M is a (W/M, M) grid: rank
r has data index r // M and model index r % M, so the ranks that share a
data index form one model group (tensor and expert parallelism run over
it, ``launch/collectives.py``) and the ranks that share a model index one
data group (the gradient all-reduce runs over it).

A ``meta`` mesh (``meta_mesh``) is an abstract mesh seen from one rank
(coordinates 0 by default): the dry run (``launch/dryrun.py``) runs that
rank's program on ``meta`` tensors, whose collectives are recorded
rather than sent.

The reference's ``use_mesh`` (entering a mesh as a context) has no
counterpart: every step maker takes its mesh as an argument.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: axis -> size, in ``axis_names`` order.  ``group``,
    ``model_group`` and ``device``: the data and model process groups and
    this rank's device of a live mesh (a group is None where its axis
    holds one rank).  ``coords``: this rank's index along each axis of a
    ``meta`` mesh."""

    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    group: Optional[object] = None
    device: Optional[torch.device] = None
    model_group: Optional[object] = None
    coords: Optional[Dict[str, int]] = None

    @property
    def is_meta(self) -> bool:
        return self.device is not None and self.device.type == "meta"


def make_mesh(shape, axes) -> Mesh:
    """An abstract mesh of ``shape`` over ``axes``."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    return Mesh(dict(zip(axes, shape)), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model_parallel: int = 1, device="cuda",
                   group=None) -> Mesh:
    """A live (data, model) mesh over ``group``, or over the default
    process group when one is initialised; with neither, one rank on
    ``device``.  ``model_parallel`` M must divide the group's W ranks: the
    mesh is (W / M, M), rank r at data index r // M, model index r % M.
    A process launched as one of several ranks (``WORLD_SIZE`` above 1)
    that has not initialised its process group raises rather than train
    alone."""
    device = resolve_device(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        launched = int(os.environ.get("WORLD_SIZE", "1"))
        if launched > 1:
            raise RuntimeError(
                f"WORLD_SIZE={launched} but no process group is "
                f"initialised; call torch.distributed.init_process_group "
                f"first or pass group=")
        world = 1
    else:
        world = dist.get_world_size(group)
    m = int(model_parallel)
    if m < 1 or world % m:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the {world} ranks of the process group")
    d = world // m
    data_group = model_group = None
    if m == 1:
        data_group = group
    elif d == 1:
        model_group = group
    else:
        # every rank creates every subgroup, in the same order
        ranks = [dist.get_global_rank(group, i) for i in range(world)]
        me = dist.get_rank(group)
        for i in range(d):
            g = dist.new_group([ranks[i * m + j] for j in range(m)])
            if me // m == i:
                model_group = g
        for j in range(m):
            g = dist.new_group([ranks[i * m + j] for i in range(d)])
            if me % m == j:
                data_group = g
    return Mesh({"data": d, "model": m}, ("data", "model"),
                group=data_group, device=device, model_group=model_group)


def meta_mesh(mesh: Mesh, coords: Optional[Dict[str, int]] = None) -> Mesh:
    """``mesh``'s shape seen from the rank at ``coords`` (0 on every axis
    by default) on the ``meta`` device: collectives record, never send."""
    coords = dict.fromkeys(mesh.axis_names, 0) if coords is None else coords
    return Mesh(dict(mesh.shape), tuple(mesh.axis_names),
                device=torch.device("meta"), coords=dict(coords))


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def mesh_size(mesh, names) -> int:
    size = 1
    for n in names:
        size *= mesh.shape[n]
    return size


def data_index(mesh) -> int:
    """This rank's index over the data axes of a live or ``meta`` mesh
    (0 without a group)."""
    if mesh.coords is not None:
        i = 0
        for a in data_axes(mesh):
            i = i * mesh.shape[a] + mesh.coords.get(a, 0)
        return i
    return 0 if mesh.group is None else dist.get_rank(mesh.group)


def model_index(mesh) -> int:
    """This rank's index along ``model`` (0 without a model group)."""
    if mesh is None:
        return 0
    if mesh.coords is not None:
        return mesh.coords.get("model", 0)
    return 0 if mesh.model_group is None else dist.get_rank(
        mesh.model_group)


def model_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` where its ``model`` axis holds several ranks, else None:
    what the model code is handed (None runs the one-rank program)."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh
