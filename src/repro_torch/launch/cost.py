"""What one rank's step costs, counted while it runs on ``meta`` tensors:
the port's counterpart of ``repro/launch/hlo_cost.py::module_cost``.

The reference walks a compiled XLA module.  The port has no compiled
program: eager mode is its program, so ``CostCounter`` is a
``TorchDispatchMode`` that watches every aten op of the step and counts

* **flops**: exact for the matmul family, as ``torch.utils.flop_counter``
  reckons them (2·M·N·K a product; the other ops count none, as in the
  reference's walker, which counts dots);
* **bytes accessed**: the inputs plus the outputs of each aten op, the
  unit eager mode materialises (a view moves nothing and counts nothing,
  nor does an allocation);
* **peak live bytes**: storages from their allocation to their release
  (autograd's saved tensors included: a storage lives as long as
  anything holds it), on top of the storages ``track`` names as the
  step's arguments;
* **collectives**, by op, through ``launch/collectives.py``'s recording
  mode;
* **each hand-written kernel** called on ``meta`` through its wrapper's
  meta path: the kernel's own flops and bytes (``kernels/costs.py``) and
  a meta launch, whatever route would run it.

``loop(n)``: a loop whose ``n`` trips are the same program (the
microbatches of a train step) runs once under a counter that folds
loops, its flops, bytes, collectives and launches counted ``n`` times;
its peak is not multiplied.  Without a counter it is ``range(n)``.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import costs as kernel_costs
from repro_torch.launch import collectives
from repro_torch.train.optim import tree_leaves

_aten = torch.ops.aten
# ops that allocate without reading or writing data
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default,
                _aten.empty_like.default, _aten.new_empty.default,
                _aten.new_empty_strided.default}
_ACTIVE = []


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts the flops, bytes, peak live bytes, collectives and kernel
    launches of the code run inside it (see the module doc).  ``fold_loops``:
    trace one trip of each ``loop(n)`` and count it ``n`` times."""

    def __init__(self, fold_loops: bool = True):
        super().__init__()
        self.fold_loops = fold_loops
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.launches: Dict[str, int] = {}
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.scale = 1
        self._storages: Dict[int, tuple] = {}
        self._arguments = set()
        self._stack = None
        self.collectives: Optional[collectives.Recorder] = None

    # -- storages -------------------------------------------------------
    def _see(self, t: torch.Tensor, argument: bool = False) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        nb = st.nbytes()

        def release(_, key=key, nb=nb):
            if self._storages.pop(key, None) is not None:
                self.live -= nb

        self._storages[key] = (weakref.ref(st, release), nb)
        self.live += nb
        self.peak = max(self.peak, self.live)
        if argument:
            self._arguments.add(key)
            self.argument_bytes += nb

    def track(self, *trees) -> None:
        """Name the tensors of ``trees`` as the step's arguments: live
        from the start, counted in ``argument_bytes``."""
        for tree in trees:
            for t in _tensors(_as_tree(tree)):
                self._see(t, argument=True)

    def bytes_of(self, *trees):
        """(bytes of the storages of ``trees``, the part of them that are
        arguments): the output and alias bytes of a step's result."""
        seen, total, alias = set(), 0, 0
        for tree in trees:
            for t in _tensors(_as_tree(tree)):
                st = t.untyped_storage()
                if st._cdata in seen:
                    continue
                seen.add(st._cdata)
                total += st.nbytes()
                if st._cdata in self._arguments:
                    alias += st.nbytes()
        return total, alias

    # -- the dispatch hook ---------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += self.scale * flop_registry[packet](
                *args, **kwargs, out_val=out)
        moved = not (func.is_view or func in _ALLOCATIONS
                     or packet is _aten.detach)
        if moved:
            nb = sum(_nbytes(t) for t in _tensors((args, kwargs)))
            nb += sum(_nbytes(t) for t in _tensors(out))
            self.bytes_accessed += self.scale * nb
        for t in _tensors(out):
            self._see(t)
        return out

    def _charge(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += self.scale * flops
        self.bytes_accessed += self.scale * nbytes
        self.kernel_flops += self.scale * flops
        self.kernel_bytes += self.scale * nbytes
        self.launches[name] = self.launches.get(name, 0) + self.scale

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self.collectives = self._stack.enter_context(
            collectives.recording())
        kernel_costs.sinks.append(self._charge)
        _ACTIVE.append(self)
        self._t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self.seconds = time.perf_counter() - self._t0
        _ACTIVE.remove(self)
        kernel_costs.sinks.remove(self._charge)
        self._stack.close()
        return out

    @contextlib.contextmanager
    def scaled(self, n: int):
        """Count everything inside ``n`` times (one traced trip of ``n``)."""
        old, old_c = self.scale, self.collectives.scale
        self.scale, self.collectives.scale = old * n, old_c * n
        try:
            yield
        finally:
            self.scale, self.collectives.scale = old, old_c


def _as_tree(tree):
    """Tensors of a train state / batch / metrics tree (dicts, lists,
    tuples, the optimizer's dataclass states)."""
    if hasattr(tree, "__dataclass_fields__"):
        return [_as_tree(getattr(tree, f)) for f in tree.__dataclass_fields__]
    if isinstance(tree, dict):
        return {k: _as_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_tree(v) for v in tree]
    return tree


def active() -> Optional[CostCounter]:
    return _ACTIVE[-1] if _ACTIVE else None


def loop(n: int):
    """``range(n)``, or under a counter that folds loops, one trip counted
    ``n`` times (see the module doc)."""
    counter = active()
    if counter is None or not counter.fold_loops or n <= 1:
        yield from range(n)
        return
    with counter.scaled(n):
        yield 0


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree."""
    return sum(_nbytes(t) for t in tree_leaves(tree))
