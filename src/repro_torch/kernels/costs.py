"""What each hand-written kernel costs: its flops and the bytes it must
move, from one formula a kernel, whatever route runs it.

These are the work terms of the bounds ``chip_smoke.py`` holds each kernel
to (each input read once, each output written once; the flops the
function needs), and what a kernel called on a ``meta`` tensor charges the
dry run's counter (``launch/cost.py``).  A plan's distinct rows depend on
its data; on ``meta`` they are unknown, and the count is B·k rows, each
read once.

A wrapper called on ``meta`` tensors returns an empty output of the right
shape and dtype, adds one to its ``meta_launches`` (the real ``launches``
are left alone) and hands ``charge`` its name, flops and bytes; the
sinks registered with ``sinks`` (the active cost counters) take them.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

# Callables (name, flops, bytes) that take what a meta launch charges.
sinks: List[Callable[[str, float, float], None]] = []


def charge(fn, flops: float, nbytes: float) -> None:
    """One meta launch of kernel ``fn`` (its wrapper): counted on
    ``fn.meta_launches`` and handed to every sink."""
    fn.meta_launches += 1
    for sink in sinks:
        sink(fn.__name__, flops, nbytes)


def row_norms(n: int, d: int, itemsize: int) -> Tuple[float, float]:
    """(flops, bytes): a square and an add an element, x read once and
    the (n,) f32 norms written once."""
    return 2.0 * n * d, float(n * d * itemsize + 4 * n)


def gather_scale(b: int, k: int, d: int, itemsize: int,
                 distinct: Optional[int] = None) -> Tuple[float, float]:
    """(flops, bytes): one multiply an output element; the ``distinct``
    source rows read once (B·k where unknown), the (B, k, d) output
    written once, idx and scale read once."""
    rows = b * k if distinct is None else distinct
    return float(b * k * d), float(itemsize * d * (rows + b * k) + 8 * b * k)


def sampled_dw(e: int, b: int, k: int, d_in: int, d_out: int, itemsize: int,
               distinct: Optional[int] = None) -> Tuple[float, float]:
    """(flops, bytes) of the sampled weight gradient over E experts
    (E = 1 without an expert axis): 2·E·B·k·d_in·d_out flops on the
    unpadded k; H' and the plan's ``distinct`` dZ rows (E·B·k where
    unknown) read once, idx / scale read once, the f32 dW written once."""
    rows = e * b * k if distinct is None else distinct
    nbytes = (itemsize * (e * b * k * d_in + rows * d_out) + 8 * e * b * k
              + 4 * e * d_in * d_out)
    return 2.0 * e * b * k * d_in * d_out, float(nbytes)


def flash_visible(sq: int, skv: int, causal: bool) -> int:
    """Keys a query sees, summed over the queries (the causal mask is
    aligned at position 0)."""
    if not causal:
        return sq * skv
    if sq <= skv:
        return sq * (sq + 1) // 2
    return skv * (skv + 1) // 2 + (sq - skv) * skv


def flash(bh: int, bkvh: int, sq: int, skv: int, dh: int, causal: bool,
          itemsize: int) -> Tuple[float, float]:
    """(flops, bytes) of the attention forward: two products over the
    visible keys of every query; q, k, v read once, the output written
    once."""
    flops = 4.0 * bh * dh * flash_visible(sq, skv, causal)
    nbytes = (2 * bh * sq + 2 * bkvh * skv) * dh * itemsize
    return flops, float(nbytes)


def flash_bwd(bh: int, bkvh: int, sq: int, skv: int, dh: int, causal: bool,
              itemsize: int) -> Tuple[float, float]:
    """(flops, bytes) of the attention backward: twice the forward's
    products (dV, dP, dK, dQ over the visible keys; the kernels' own
    recomputes of S and dP and the second half of dS are not counted);
    q, k, v, dO read once, dQ, dK, dV written once."""
    flops = 8.0 * bh * dh * flash_visible(sq, skv, causal)
    nbytes = (3 * bh * sq + 4 * bkvh * skv) * dh * itemsize
    return flops, float(nbytes)
