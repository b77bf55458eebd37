"""Spans of the port: an in-memory recorder on the profiler's clock.

Off unless a caller turns it on; nothing reads the environment or a
config for it.  A benchmark or an operator wraps the steps it wants
attributed::

    from repro_torch import tracing
    tracing.enable()
    for batch in batches:
        state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    spans = tracing.drain()
    tracing.disable()

``drain()`` returns the spans recorded since the last drain, oldest
first, as plain dicts of ints and strings (never a tensor):

* ``name``, ``id`` (from 1), ``parent`` (the id of the span open around
  it, 0 for none), ``caused_by`` (for a backward span, the forward span
  whose autograd node opened it; 0 otherwise) and ``thread``
  (``threading.get_native_id()``);
* ``start_ns`` / ``end_ns``: ``time.time_ns()``, nanoseconds since the
  epoch, the clock ``torch.profiler`` stamps its host events with (the
  CUDA runtime's calls included), so a profiled device operation maps to
  the span that was open when its launch was issued; ``end_ns`` is None
  while the span is open;
* ``mem_start`` / ``mem_end``: the bytes ``torch.cuda.memory_allocated()``
  gives, at both ends, where CUDA was initialised when ``enable()`` ran.

A span opened on a thread with nothing open (autograd's device thread,
which runs a CUDA backward while the caller waits) is a child of the
newest span open on another thread: the caller's ``backward``.

The spans, by module:

* ``launch/train_steps.py``: ``train_step`` (one call of
  ``make_train_step``'s step) holding ``forward`` (``registry.loss_fn``)
  and ``backward`` (``torch.autograd.grad``), once a microbatch,
  ``grad_reduce`` (only where the step reduces the gradients over data
  ranks) and ``optimizer`` (the AdamW or ``OptimSpec`` update);
  ``prefill_step`` (``make_prefill_step``'s step).
* ``models/lm.py``: ``embed``, ``block`` (one layer, in the training
  forward and in prefill; under a remat policy the recompute's own
  ``block`` opens again inside ``backward``), ``head`` (the final norm
  and the logits), ``loss`` (``masked_nll``), ``attention`` (the
  training attention call of a block; the flash kernel in prefill) and
  ``attention.bwd`` (from the gradient of the attention's output to the
  gradients of q, k and v: its backward, the checkpointed recompute
  included).
* ``core/linear.py``: ``linear`` (a dense sampled linear's forward, the
  exact short-circuit included) holding ``plan`` (the plans) and
  ``gather`` (H'); ``linear.bwd`` (its backward) holding ``dx``,
  ``dw`` (the ``fused_sampled_dw`` launch alone, not the cast of its f32
  result; an MoE layer's experts' too) and ``tap`` (the gradient-norm
  tap) per weight.

Off, ``span()`` returns one shared no-op context and no autograd hook is
registered: a boundary costs a call and a module-global read.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Sequence

import torch

_on = False
_mem = None                       # the allocated bytes' reader, or None
_ids = itertools.count(1)
_spans: List[Dict] = []           # every span since the last drain
_stacks: Dict[int, List[Dict]] = {}   # thread -> its open spans
_OFF = contextlib.nullcontext()


def _allocated_bytes():
    """``torch.cuda.memory_allocated()`` of the current device without its
    flattening of every allocator statistic (15 against 150 us a call on
    an H100 machine's host)."""
    device, stats = torch.cuda.current_device(), torch._C._cuda_memoryStats
    return lambda: stats(device)["allocated_bytes"]["all"]["current"]


def enable() -> None:
    """Record spans from now on (the process's every thread)."""
    global _on, _mem
    _mem = _allocated_bytes() if torch.cuda.is_initialized() else None
    _on = True


def disable() -> None:
    """Record no more spans; those recorded stay until ``drain()``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> List[Dict]:
    """The spans recorded since the last drain, oldest first; forgets
    them.  Spans still open are among them, their ``end_ns`` None."""
    out = list(_spans)
    del _spans[:len(out)]
    return out


def current() -> int:
    """The id of the innermost span open on this thread, 0 for none."""
    stack = _stacks.get(threading.get_native_id()) if _on else None
    return stack[-1]["id"] if stack else 0


def begin(name: str, caused_by: int = 0) -> Dict:
    """Open a span on this thread; returns the token ``end`` takes."""
    thread = threading.get_native_id()
    stack = _stacks.setdefault(thread, [])
    if stack:
        parent = stack[-1]["id"]
    else:
        parent = max((s[-1]["id"] for t, s in _stacks.items()
                      if s and t != thread), default=0)
    rec = {"name": name, "id": next(_ids), "parent": parent,
           "caused_by": caused_by, "thread": thread,
           "start_ns": time.time_ns(), "end_ns": None}
    if _mem is not None:
        rec["mem_start"] = _mem()
    stack.append(rec)
    _spans.append(rec)
    return rec


def end(token: Dict) -> None:
    """Close the span ``begin`` opened (from any thread)."""
    if _mem is not None:
        token["mem_end"] = _mem()
    token["end_ns"] = time.time_ns()
    stack = _stacks.get(token["thread"], [])
    if stack and stack[-1] is token:
        stack.pop()
    elif token in stack:
        stack.remove(token)


class _Span:
    __slots__ = ("name", "caused_by", "token")

    def __init__(self, name: str, caused_by: int):
        self.name, self.caused_by = name, caused_by

    def __enter__(self):
        self.token = begin(self.name, self.caused_by)

    def __exit__(self, *exc):
        end(self.token)


def span(name: str, caused_by: int = 0):
    """A context manager recording one span while tracing is on; the
    shared no-op context while it is off."""
    return _Span(name, caused_by) if _on else _OFF


def span_backward(name: str, output: torch.Tensor,
                  inputs: Sequence[torch.Tensor]) -> None:
    """While tracing is on, record a span ``name`` over the backward
    from ``output``'s gradient to those of ``inputs`` (every backward
    that reaches them), caused by the span open now."""
    if not (_on and output.requires_grad):
        return
    cause = current()
    tokens: List[Dict] = []

    def opened(_grad):
        tokens.append(begin(name, cause))

    def closed(_grads):
        if tokens:
            end(tokens.pop())

    output.register_hook(opened)
    torch.autograd.graph.register_multi_grad_hook(
        [x for x in inputs if x.requires_grad], closed)
