"""Per-row L2 norms of an (n, d) matrix — the CUDA kernel's wrapper, its
plain PyTorch version and its launch counter.

Replaces the TPU kernel ``repro/kernels/row_norms.py::row_norms`` (and
the host padding ``repro/kernels/ops.py`` wrapped around it).  The
kernel is ``csrc/row_norms.cu``: one warp per row, 16-byte loads, f32
square-and-add, shuffle reduction.  It is bound by bytes on an H100 —
``n*d*itemsize`` read against 3.35 TB/s — so the design only has to keep
every load wide and coalesced; ragged ``n``/``d`` are masked in the
kernel, nothing is padded here.

Feeds the column-row sampling probabilities (Eq. 3) on every sampled
linear's forward (``core/plans.py::batched_row_weights``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs


def row_norms_plain(x: torch.Tensor) -> torch.Tensor:
    """The definition: ``sqrt(sum_d x[n, d]^2)`` accumulated in f32."""
    x32 = x.to(torch.float32)
    return torch.sqrt(torch.sum(x32 * x32, dim=-1))


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """(n, d) bf16/f16/f32 -> (n,) f32.

    A CUDA tensor launches the kernel (or raises); only a tensor that
    lies on the CPU takes the plain version; a ``meta`` tensor charges
    the dry run's counter (``kernels/costs.py``).
    """
    if x.ndim != 2:
        raise ValueError(f"row_norms wants (n, d), got {tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"row_norms takes float32/bfloat16/float16, "
                        f"got {x.dtype}")
    _build.check_operand("x", x)
    n, d = x.shape
    if n < 1 or d < 1:
        raise ValueError(f"row_norms wants a non-empty matrix, got ({n}, {d})")
    if x.device.type == "meta":
        costs.charge(row_norms, *costs.row_norms(n, d, x.element_size()))
        return torch.empty((n,), dtype=torch.float32, device="meta")
    if x.device.type == "cpu":
        return row_norms_plain(x)
    if not x.is_cuda:
        raise ValueError(f"row_norms runs on cuda or cpu, not {x.device}")
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _build.library().repro_row_norms(
            x.data_ptr(), out.data_ptr(), n, d, _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "row_norms")
    row_norms.launches += 1
    return out


row_norms.launches = 0
row_norms.meta_launches = 0
