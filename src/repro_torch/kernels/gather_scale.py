"""The row gather that builds H' — the CUDA kernels' wrapper, its plain
PyTorch version and its launch counters.

    out[b, t, :] = (x[b, idx[b, t], :] in f32 * scale[b, t]) rounded once
                   to x.dtype

Replaces the TPU kernel ``repro/kernels/gather_scale.py::gather_scale``
(and the ``block_d`` column padding ``repro/kernels/ops.py`` wrapped
around it).  The kernels are in ``csrc/gather_scale.cu``; ``gather_route``
picks one of two routes for a call:

* ``bulk`` (a row of ``d * itemsize`` bytes a multiple of 16, ``x`` and the
  output 16-byte aligned — every main-path shape): the output is cut into
  items of at most 4 KB (whole narrow rows, or equal pieces of a wide one),
  sized by bytes, and a persistent grid of as many blocks as fit on each
  SM strides over them; each block keeps two items in flight as 1-D bulk async copies
  into a two-stage shared-memory ring, then scales each arrived stage and
  stores it with 16-byte vectors.
* ``warp`` (any other width or alignment): one warp per output row,
  16-byte loads and stores, an element-wise loop where a ragged ``d``
  breaks the alignment.

On an H100 both are bound by bytes — the distinct source rows read once
and the ``B*k`` output rows written once (``2*B*k*d*itemsize + 8*B*k`` at
most) against 3.35 TB/s.  ``gather_scale.launches`` counts launches,
``.launches_by_route`` splits them by route.

This is the forward half of WTA-CRS: every sampled linear builds its
stored H' through it with unit scale (``core/linear.py``), which is
bit-for-bit the plain row gather since ``x * 1.0f`` rounds back exactly.
Plans sample with replacement, so ``idx`` may repeat rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs

# C route codes are the positions (csrc/gather_scale.cu: enum Route)
ROUTES = ("warp", "bulk")


def gather_route(d: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The one kernel route a call takes: ``bulk`` when a row of ``d``
    elements of ``dtype`` is a whole number of 16-byte chunks and ``x`` and
    the output start on a 16-byte boundary (``aligned``; the bulk copies
    need both), ``warp`` otherwise."""
    if (d * dtype.itemsize) % 16 == 0 and aligned:
        return "bulk"
    return "warp"


def gather_scale_plain(x: torch.Tensor, idx: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in tensor ops on the batched form: gather,
    scale in f32, round once to ``x.dtype``."""
    b, k = idx.shape
    rows = idx.to(torch.int64)[:, :, None].expand(b, k, x.shape[2])
    sub = torch.gather(x, 1, rows)
    return (sub.to(torch.float32) * scale[:, :, None]).to(x.dtype)


def launch(x: torch.Tensor, idx: torch.Tensor, scale: torch.Tensor,
           route: str) -> torch.Tensor:
    """Route ``route``'s kernel on the batched form's checked CUDA operands
    -> (B, k, d).  Raises if the launch is refused (``bulk`` on a ragged
    width or a misaligned ``x``).  Counts nothing: ``gather_scale`` does."""
    b, n, d = x.shape
    k = idx.shape[1]
    out = torch.empty((b, k, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = _build.library().repro_gather_scale(
            x.data_ptr(), idx.data_ptr(), scale.data_ptr(), out.data_ptr(),
            b, n, k, d, _build.DTYPE_CODES[x.dtype], ROUTES.index(route),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, f"gather_scale ({route} route)")
    return out


def gather_scale(x: torch.Tensor, idx: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x (n, d), idx (k,), scale (k,) -> (k, d); or the batched form
    x (B, n, d), idx (B, k), scale (B, k) -> (B, k, d).  ``x`` is
    f32/bf16/f16, ``idx`` int32 rows of ``x``, ``scale`` f32; the result
    has ``x``'s dtype.

    A CUDA tensor launches the kernel (or raises); only tensors that lie
    on the CPU take the plain version; ``meta`` tensors charge the dry
    run's counter (``kernels/costs.py``).  An index outside [0, n) raises:
    on the CPU at once, on the card as a device-side assert at the next
    synchronisation.
    """
    if x.ndim not in (2, 3) or idx.ndim != x.ndim - 1:
        raise ValueError(f"gather_scale wants x (n, d) with idx (k,) or x "
                         f"(B, n, d) with idx (B, k), got {tuple(x.shape)} / "
                         f"{tuple(idx.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"gather_scale takes float32/bfloat16/float16, "
                        f"got {x.dtype}")
    single = x.ndim == 2
    x3, idx2, scale2 = (x[None], idx[None], scale[None]) if single \
        else (x, idx, scale)
    b, n, d = x3.shape
    k = idx2.shape[1]
    if min(b, n, d, k) < 1:
        raise ValueError("gather_scale wants non-empty operands")
    dev = x.device
    _build.check_operand("x", x3)
    _build.check_operand("idx", idx2, dtype=torch.int32, shape=(b, k),
                         device=dev)
    _build.check_operand("scale", scale2, dtype=torch.float32, shape=(b, k),
                         device=dev)
    if dev.type == "meta":
        costs.charge(gather_scale, *costs.gather_scale(b, k, d,
                                                       x.element_size()))
        out = torch.empty((b, k, d), dtype=x.dtype, device="meta")
        return out[0] if single else out
    if dev.type == "cpu":
        out = gather_scale_plain(x3, idx2, scale2)
        return out[0] if single else out
    if not x.is_cuda:
        raise ValueError(f"gather_scale runs on cuda or cpu, not {dev}")
    # the output comes from torch.empty, which starts on a 16-byte boundary
    route = gather_route(d, x.dtype, _build.aligned16(x3))
    out = launch(x3, idx2, scale2, route)
    gather_scale.launches += 1
    gather_scale.launches_by_route[route] += 1
    return out[0] if single else out


gather_scale.launches = 0
gather_scale.meta_launches = 0
gather_scale.launches_by_route = dict.fromkeys(ROUTES, 0)
