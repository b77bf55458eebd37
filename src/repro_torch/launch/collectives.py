"""The port's one door to ``torch.distributed``: collectives over a named
mesh axis, Megatron's two autograd functions, and a recording mode.

``all_reduce``, ``all_gather`` and ``reduce_scatter`` run over one axis of
a live mesh (``launch/mesh.py``): ``"model"`` is the mesh's model group,
``"data"`` (or the data axes as a tuple, ``("pod", "data")``) its data
group.  An axis of one rank is the identity and communicates nothing.

Megatron's pair (arXiv:1909.08053, §3):

* ``copy_to_model`` (*f*): the identity forward, an all-reduce of the
  gradient over ``model`` in the backward.  It stands before a
  column-parallel product, whose input is replicated and whose input
  gradient is a partial sum on each rank.
* ``reduce_from_model`` (*g*): an all-reduce over ``model`` forward, the
  identity backward.  It stands after a row-parallel product, whose
  output is a partial sum on each rank.

``gather_from_model`` all-gathers a tensor's last dim over ``model`` (its
backward keeps this rank's slice of the summed gradient: a
reduce-scatter), for a tensor each rank then reads in part;
``gather_replicated`` all-gathers it for a computation every rank runs
whole (its backward keeps this rank's slice of the gradient, which is
the same on every rank).  ``scatter_to_model`` reduce-scatters a
row-parallel product's partial sums onto its last dim (backward: an
all-gather).  ``sum_over_model`` all-reduces both ways: the forward sums
the ranks' parts, and the backward sums the ranks' gradients, for a sum
each rank reads for its own share of the output (a norm over features
that are split across the ranks).

Recording: inside ``recording()`` every collective adds ``(op, axis,
bytes, count)`` to the recorder, with the reference's byte convention
(``repro/launch/dryrun.py::collective_bytes``: the output's bytes — the
whole gathered tensor for an all-gather, the scattered part for a
reduce-scatter).  A collective on a ``meta`` tensor communicates nothing
and returns a tensor of the right shape: that is how the dry run
(``launch/dryrun.py``) records one rank's collectives without peers.
With ``timed=True`` a live collective is also timed on the host clock,
the card synchronised on both sides.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")


class Recorder:
    """What the collectives issued inside ``recording()`` moved."""

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.calls: List[Tuple[str, str, int]] = []   # (op, axis, bytes)
        self.ms: Dict[Tuple[str, str], float] = {}
        self.scale = 1                 # trip count of an enclosing loop

    def add(self, op: str, axis: str, nbytes: int, ms: float = 0.0) -> None:
        for _ in range(self.scale):
            self.calls.append((op, axis, int(nbytes)))
        key = (op, axis)
        self.ms[key] = self.ms.get(key, 0.0) + ms * self.scale

    @property
    def counts(self) -> Dict[str, int]:
        out = dict.fromkeys(OPS, 0)
        for op, _, _ in self.calls:
            out[op] += 1
        return out

    @property
    def bytes(self) -> Dict[str, int]:
        out = dict.fromkeys(OPS, 0)
        for op, _, n in self.calls:
            out[op] += n
        return out

    @property
    def total_bytes(self) -> int:
        return sum(n for _, _, n in self.calls)

    def by_axis(self) -> Dict[Tuple[str, str], dict]:
        """{(op, axis): {"count", "bytes", "ms"}}."""
        out: Dict[Tuple[str, str], dict] = {}
        for op, axis, n in self.calls:
            r = out.setdefault((op, axis), {"count": 0, "bytes": 0,
                                            "ms": self.ms.get((op, axis),
                                                              0.0)})
            r["count"] += 1
            r["bytes"] += n
        return out


_RECORDERS: List[Recorder] = []


@contextlib.contextmanager
def recording(timed: bool = False):
    """Record every collective issued inside the block."""
    rec = Recorder(timed=timed)
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _axis_name(axis) -> str:
    return axis if isinstance(axis, str) else "+".join(axis)


def _data_like(axis) -> bool:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return all(n in ("pod", "data") for n in names)


def axis_size(mesh, axis) -> int:
    """Ranks along ``axis`` (a name or a tuple of names) of ``mesh``; a
    raw process group (or None) stands for the data axis."""
    if mesh is None:
        return 1
    if not hasattr(mesh, "shape"):
        return dist.get_world_size(mesh)
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    n = 1
    for a in names:
        n *= mesh.shape.get(a, 1)
    return n


def _group(mesh, axis):
    if not hasattr(mesh, "shape"):
        return mesh                    # a raw process group
    return mesh.group if _data_like(axis) else mesh.model_group


def _record(op: str, axis, nbytes: int, ms: float = 0.0) -> None:
    for rec in _RECORDERS:
        rec.add(op, _axis_name(axis), nbytes, ms)


def _timed_call(fn, x):
    timed = any(r.timed for r in _RECORDERS) and x.is_cuda
    if timed:
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
    fn()
    if timed:
        torch.cuda.synchronize(x.device)
        return 1e3 * (time.perf_counter() - t0)
    return 0.0


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_(x: torch.Tensor, mesh, axis="model",
                op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over ``axis`` in place and return it."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    nbytes = x.numel() * x.element_size()
    if x.device.type == "meta":
        _record("all-reduce", axis, nbytes)
        return x
    group = _group(mesh, axis)
    ms = _timed_call(lambda: dist.all_reduce(x, op=_REDUCE_OPS[op],
                                             group=group), x)
    _record("all-reduce", axis, nbytes, ms)
    return x


def all_reduce(x: torch.Tensor, mesh, axis="model",
               op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``axis``, out of place."""
    if axis_size(mesh, axis) == 1:
        return x
    return all_reduce_(x.clone(), mesh, axis, op)


def all_gather(x: torch.Tensor, mesh, axis="model",
               dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, side by side along ``dim`` in
    rank order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    dim = dim % x.ndim
    shape = list(x.shape)
    shape[dim] *= n
    nbytes = x.numel() * x.element_size() * n
    if x.device.type == "meta":
        _record("all-gather", axis, nbytes)
        return x.new_empty(shape)
    group = _group(mesh, axis)
    xc = x.contiguous()
    parts = [torch.empty_like(xc) for _ in range(n)]
    ms = _timed_call(lambda: dist.all_gather(parts, xc, group=group), x)
    _record("all-gather", axis, nbytes, ms)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, mesh, axis="model",
                   dim: int = -1) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, this rank's ``1/n`` slice of it
    along ``dim``.  (An all-reduce and a slice: gloo has no
    reduce-scatter; the record counts the scattered output.)"""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    dim = dim % x.ndim
    part = x.shape[dim] // n
    nbytes = x.numel() * x.element_size() // n
    if x.device.type == "meta":
        _record("reduce-scatter", axis, nbytes)
        return x.narrow(dim, 0, part).clone()
    group = _group(mesh, axis)
    full = x.contiguous().clone()
    ms = _timed_call(lambda: dist.all_reduce(full, group=group), x)
    _record("reduce-scatter", axis, nbytes, ms)
    return full.narrow(dim, index(mesh, axis) * part, part).contiguous()


def index(mesh, axis) -> int:
    """This rank's index along ``axis``."""
    if axis_size(mesh, axis) == 1:
        return 0
    coords = getattr(mesh, "coords", None)
    if coords is not None:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        i = 0
        for a in names:
            i = i * mesh.shape[a] + coords.get(a, 0)
        return i
    return dist.get_rank(_group(mesh, axis))


# ---------------------------------------------------------------------------
# Megatron's f and g, and the all-gather of a feature-sharded tensor
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return all_reduce(dx.contiguous(), ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous(), mesh, "model")

    @staticmethod
    def backward(ctx, dz):
        return dz, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather(x, mesh, "model", dim=-1)

    @staticmethod
    def backward(ctx, dz):
        return reduce_scatter(dz, ctx.mesh, "model", dim=-1), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.part = mesh, x.shape[-1]
        return all_gather(x, mesh, "model", dim=-1)

    @staticmethod
    def backward(ctx, dz):
        lo = index(ctx.mesh, "model") * ctx.part
        return dz.narrow(-1, lo, ctx.part).contiguous(), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return reduce_scatter(x, mesh, "model", dim=-1)

    @staticmethod
    def backward(ctx, dz):
        return all_gather(dz, ctx.mesh, "model", dim=-1), None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x.contiguous(), mesh, "model")

    @staticmethod
    def backward(ctx, dz):
        return all_reduce(dz.contiguous(), ctx.mesh, "model"), None


def model_size(mesh) -> int:
    return 1 if mesh is None else axis_size(mesh, "model")


def copy_to_model(x: Optional[torch.Tensor], mesh):
    """*f*: identity forward, gradient all-reduced over ``model``."""
    if x is None or model_size(mesh) == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """*g*: all-reduce over ``model`` forward, identity backward."""
    if model_size(mesh) == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The last dim all-gathered over ``model``; backward: the summed
    gradient's slice of this rank."""
    if model_size(mesh) == 1:
        return x
    return _GatherFromModel.apply(x, mesh)


def gather_replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """The last dim all-gathered over ``model`` for a computation every
    rank runs whole; backward: this rank's slice of the gradient (the
    same on every rank, so nothing is summed)."""
    if model_size(mesh) == 1:
        return x
    return _GatherReplicated.apply(x, mesh)


def scatter_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ``model`` of a partial product, this rank's slice of
    its last dim (a reduce-scatter); backward: the slices' gradients
    all-gathered."""
    if model_size(mesh) == 1:
        return x
    return _ScatterToModel.apply(x, mesh)


def sum_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-reduce over ``model`` forward, and all-reduce of the gradient
    backward: a sum each rank reads for its own part of the output."""
    if model_size(mesh) == 1:
        return x
    return _SumOverModel.apply(x, mesh)
