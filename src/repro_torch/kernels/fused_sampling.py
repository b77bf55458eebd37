"""The fused sampled weight-gradient — the CUDA kernel's wrapper, its plain
PyTorch version and its launch counter.

    dW (d_in, d_out) f32 = sum_b hsub_b^T @ (dz_b[idx_b] * scale_b)

and, with a leading expert axis (an MoE layer's experts, each with its own
weight and plans), dW[e] of every expert in ONE launch: hsub (E, B, k,
d_in), dz (E, B, n, d_out), idx/scale (E, B, k) -> (E, d_in, d_out).  The
reference gets that axis from ``jax.vmap`` over its experts
(``repro/models/mlp.py::_expert_ffn``), which batches its Pallas call.

Replaces the TPU kernel
``repro/kernels/fused_sampling.py::fused_sampled_dw`` (and the idx/scale
padding and divisor-tiling of ``repro/kernels/ops.py`` around it).  The
kernels are in ``csrc/fused_sampled_dw.cu``: one block per (BM, BN) tile
of dW looping over every (b, k-block) with the f32 sum in registers, the
dz rows gathered by the block's own idx slice, scale applied in f32 and
rounded once to the input dtype in shared memory; the gathered dZ' is
never written to device memory.  ``dw_route`` (``kernels/autotune.py``,
with the tile) picks one of three routes for a shape: ``wgmma`` (bf16/f16 with d_in and d_out multiples of 8 and
16-byte-aligned hsub/dz: H' by TMA, dZ' by cp.async, a four-stage ring,
warp-specialised wgmma), ``wmma`` (other bf16/f16) or ``fma`` (f32).
``fused_sampled_dw.launches`` counts launches, ``.launches_by_route``
splits them by route, ``.launches_by_tile`` by the tile launched.  On an
H100 in bf16 it is bound by operations at the wide projections
(``2*B*k*d_in*d_out`` flops against 989 TFLOP/s) and by bytes at the
narrow ones (``2*(B*k*d_in + B*k*d_out) + 4*d_in*d_out`` against 3.35 TB/s).  Any
positive shape is taken: the k tail and the d_in/d_out edges are
predicated in the kernel.

This is the backward of every sampled linear (``core/linear.py``), the
expert axis that of the MoE experts' (``core/linear.py::expert_linear``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, autotune, costs
from repro_torch.kernels.autotune import dw_route

TILES = (64, 128)
# the wmma and fma routes put the expert on blockIdx.z
MAX_EXPERTS = 65535
# C route codes are the positions (csrc/fused_sampled_dw.cu: enum Route)
ROUTES = ("fma", "wmma", "wgmma")


def fused_sampled_dw_plain(hsub: torch.Tensor, dz: torch.Tensor,
                           idx: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in tensor ops: gather, scale in f32,
    round once to the input dtype, contract over (b, k) in f32; with an
    expert axis, the same for each expert in turn."""
    if hsub.ndim == 4:
        return torch.stack([fused_sampled_dw_plain(*xs) for xs in
                            zip(hsub, dz, idx, scale)])
    b, k, _ = hsub.shape
    rows = idx.to(torch.int64)[:, :, None].expand(b, k, dz.shape[2])
    dz_sub = torch.gather(dz, 1, rows)
    dz_sub = (dz_sub.to(torch.float32) * scale[:, :, None]).to(dz.dtype)
    return torch.einsum("bki,bkj->ij", hsub.to(torch.float32),
                        dz_sub.to(torch.float32))


def fused_sampled_dw(hsub: torch.Tensor, dz: torch.Tensor,
                     idx: torch.Tensor, scale: torch.Tensor, *,
                     tile: Optional[int] = None) -> torch.Tensor:
    """hsub (B, k, d_in), dz (B, n, d_out) of one float dtype; idx (B, k)
    int32 rows of dz; scale (B, k) f32 -> (d_in, d_out) f32.  With a
    leading expert axis — hsub (E, B, k, d_in), dz (E, B, n, d_out),
    idx/scale (E, B, k) — every expert's dW in one launch, (E, d_in,
    d_out); E = 1 gives the 3-D call's result bit for bit.

    ``tile`` pins the bf16/f16 output tile (64 or 128); ``None`` takes
    the packaged tuning table's entry for the shape, else the shape rule
    (``autotune.tile_for``, as ``sampled_matmul``).  A CUDA
    tensor launches the kernel (or raises); only tensors that lie on the
    CPU take the plain version; ``meta`` tensors charge the dry run's
    counter (``kernels/costs.py``).  An index outside [0, n) raises: on the
    CPU at once, on the card as a device-side assert at the next
    synchronisation.
    """
    if hsub.ndim not in (3, 4) or dz.ndim != hsub.ndim:
        raise ValueError(f"fused_sampled_dw wants hsub ([E,] B, k, d_in) and "
                         f"dz ([E,] B, n, d_out), got {tuple(hsub.shape)} / "
                         f"{tuple(dz.shape)}")
    if hsub.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_sampled_dw takes float32/bfloat16/float16, "
                        f"got {hsub.dtype}")
    if tile is not None and tile not in TILES:
        raise ValueError(f"tile must be one of {TILES} or None, got {tile!r}")
    lead = tuple(hsub.shape[:-3])             # () or (E,)
    e = lead[0] if lead else 1
    b, k, d_in = hsub.shape[-3:]
    n, d_out = dz.shape[-2], dz.shape[-1]
    if min(e, b, k, d_in, n, d_out) < 1:
        raise ValueError("fused_sampled_dw wants non-empty operands")
    if e > MAX_EXPERTS:
        raise ValueError(f"fused_sampled_dw takes at most {MAX_EXPERTS} "
                         f"experts, got {e}")
    dev = hsub.device
    _build.check_operand("hsub", hsub)
    _build.check_operand("dz", dz, dtype=hsub.dtype,
                         shape=lead + (b, n, d_out), device=dev)
    _build.check_operand("idx", idx, dtype=torch.int32, shape=lead + (b, k),
                         device=dev)
    _build.check_operand("scale", scale, dtype=torch.float32,
                         shape=lead + (b, k), device=dev)
    if dev.type == "meta":
        costs.charge(fused_sampled_dw, *costs.sampled_dw(
            e, b, k, d_in, d_out, hsub.element_size()))
        return torch.empty(lead + (d_in, d_out), dtype=torch.float32,
                           device="meta")
    if dev.type == "cpu":
        return fused_sampled_dw_plain(hsub, dz, idx, scale)
    if not hsub.is_cuda:
        raise ValueError(f"fused_sampled_dw runs on cuda or cpu, not {dev}")
    route = dw_route(d_in, d_out, hsub.dtype, _build.aligned16(hsub, dz))
    if tile is None:
        tile = autotune.tile_for(None, "fused_sampled_dw", hsub, dz)
    out = torch.empty(lead + (d_in, d_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _build.library().repro_fused_sampled_dw(
            hsub.data_ptr(), dz.data_ptr(), idx.data_ptr(), scale.data_ptr(),
            out.data_ptr(), e, b, k, n, d_in, d_out,
            _build.DTYPE_CODES[hsub.dtype], tile, ROUTES.index(route),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, f"fused_sampled_dw ({route} route)")
    fused_sampled_dw.launches += 1
    fused_sampled_dw.launches_by_route[route] += 1
    fused_sampled_dw.launches_by_tile[tile] += 1
    return out


fused_sampled_dw.launches = 0
fused_sampled_dw.meta_launches = 0
fused_sampled_dw.launches_by_route = dict.fromkeys(ROUTES, 0)
fused_sampled_dw.launches_by_tile = dict.fromkeys(TILES, 0)
