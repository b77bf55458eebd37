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

The reference's ``use_mesh`` (entering a mesh as a context) has no
counterpart: nothing here is traced, and every step maker takes its mesh
as an argument.  A ``model`` axis above 1 (tensor / expert parallelism)
waits for ROADMAP Queue A.9.
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
    """``shape``: axis -> size, in ``axis_names`` order.  ``group`` and
    ``device``: the process group and this rank's device of a live mesh
    (``group`` is None for one rank without a process group)."""

    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    group: Optional[object] = None
    device: Optional[torch.device] = None


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
    """A live (data, model) mesh: ``data`` is the world size of ``group``,
    or of the default process group when one is initialised; with neither,
    one rank on ``device``.  A process launched as one of several ranks
    (``WORLD_SIZE`` above 1) that has not initialised its process group
    raises rather than train alone."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor and expert "
            f"parallelism are not ported yet (ROADMAP Queue A.9); the "
            f"host mesh is data parallel only")
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
    return Mesh({"data": world, "model": 1}, ("data", "model"),
                group=group, device=device)


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
    """This rank's index over the data axes of a live mesh (its rank in
    the group; 0 without one)."""
    return 0 if mesh.group is None else dist.get_rank(mesh.group)
