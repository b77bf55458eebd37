"""The even-tiled sampled weight-gradient — the CUDA kernel's wrapper (host
padding included), its plain PyTorch version and its launch counter.

    dW (d_in, d_out) f32 = sum_b hsub_b^T @ (dz_b[idx_b] * scale_b)

Replaces the TPU kernel ``repro/kernels/sampled_matmul.py::sampled_matmul``
and keeps its contract, padding included (``repro/kernels/ops.py``): the
wrapper pads H' (k rows, d_in columns) and dZ (d_out columns) with zeros
to block multiples, pads idx/scale with idx 0 and scale 0 (padded slots
contribute nothing), runs the kernel on the padded operands and slices
the result back.  The kernel is ``csrc/sampled_matmul.cu``: one block per
(tile, tile) piece of dW looping over every (b, k-block), the k-block's dz
rows gathered by idx into shared memory with the scale applied in f32 and
rounded once to the input dtype; it takes only evenly tiled shapes.  On an
H100 in bf16 it is bound by operations at the wide projections
(``2*B*k*d_in*d_out`` on the unpadded k against 989 TFLOP/s).

The reference keeps this kernel as the unfused baseline the fused kernel
(``fused_sampling.py``) is measured against: ``row_norms -> plan ->
gather_scale -> sampled_matmul``.  Nothing on the train path calls it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, fused_sampling

# contraction slots per tile: mma tiles of 32 for bf16/f16, FMA tiles of 16
# for f32 (csrc/sampled_matmul.cu)
BK = {torch.bfloat16: 32, torch.float16: 32, torch.float32: 16}
F32_TILE = 64


# The same function as the fused kernel computes, hence its plain version:
# gather, scale in f32, round once to the input dtype, contract over (b, k)
# in f32.
sampled_matmul_plain = fused_sampling.fused_sampled_dw_plain


def choose_tile(dtype: torch.dtype, d_in: int, d_out: int,
                sms: Optional[int]) -> int:
    """The output tile the operands are padded to: 64 for f32; for
    bf16/f16 128 when that still gives every SM a tile, else 64 (the
    same rule as ``fused_sampled_dw``).  ``sms=None`` (no card) takes 64."""
    if dtype == torch.float32:
        return F32_TILE
    if sms is None:
        return 64
    tiles128 = -(-d_in // 128) * -(-d_out // 128)
    return 128 if tiles128 >= sms else 64


def pad_operands(hsub, dz, idx, scale, tile: int, bk: int):
    """Zero-pad H' to (B, k', d_in') and dZ to (B, n, d_out'), multiples of
    (bk, tile, tile); pad idx/scale to k' slots with idx 0, scale 0."""
    _, k, d_in = hsub.shape
    d_out = dz.shape[2]
    pk, pi, po = (-k) % bk, (-d_in) % tile, (-d_out) % tile
    if pk or pi:
        hsub = F.pad(hsub, (0, pi, 0, pk))
    if po:
        dz = F.pad(dz, (0, po))
    if pk:
        idx = F.pad(idx, (0, pk))
        scale = F.pad(scale, (0, pk))
    return hsub, dz, idx, scale


def sampled_matmul(hsub: torch.Tensor, dz: torch.Tensor, idx: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """hsub (k, d_in), dz (n, d_out), idx/scale (k,); or the batched form
    hsub (B, k, d_in), dz (B, n, d_out), idx/scale (B, k) -> (d_in, d_out)
    f32.  One float dtype for hsub and dz, idx int32 rows of dz, scale f32.

    The operands are padded to the tiling ``choose_tile`` picks on either
    device; then a CUDA tensor launches the kernel (or raises) and only
    tensors that lie on the CPU take the plain version.  An index outside
    [0, n) raises: on the CPU at once, on the card as a device-side assert
    at the next synchronisation.
    """
    if hsub.ndim not in (2, 3) or dz.ndim != hsub.ndim:
        raise ValueError(f"sampled_matmul wants hsub (k, d_in) / dz "
                         f"(n, d_out) or their batched (B, ...) forms, got "
                         f"{tuple(hsub.shape)} / {tuple(dz.shape)}")
    if hsub.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"sampled_matmul takes float32/bfloat16/float16, "
                        f"got {hsub.dtype}")
    if hsub.ndim == 2:
        hsub, dz, idx, scale = hsub[None], dz[None], idx[None], scale[None]
    b, k, d_in = hsub.shape
    n, d_out = dz.shape[1], dz.shape[2]
    if min(b, k, d_in, n, d_out) < 1:
        raise ValueError("sampled_matmul wants non-empty operands")
    dev = hsub.device
    _build.check_operand("hsub", hsub)
    _build.check_operand("dz", dz, dtype=hsub.dtype, shape=(b, n, d_out),
                         device=dev)
    _build.check_operand("idx", idx, dtype=torch.int32, shape=(b, k),
                         device=dev)
    _build.check_operand("scale", scale, dtype=torch.float32, shape=(b, k),
                         device=dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sampled_matmul runs on cuda or cpu, not {dev}")
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else None)
    tile = choose_tile(hsub.dtype, d_in, d_out, sms)
    hp, zp, ip, sp = pad_operands(hsub, dz, idx, scale, tile, BK[hsub.dtype])
    if dev.type == "cpu":
        return sampled_matmul_plain(hp, zp, ip, sp)[:d_in, :d_out]
    out = torch.empty((hp.shape[2], zp.shape[2]), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        code = _build.library().repro_sampled_matmul(
            hp.data_ptr(), zp.data_ptr(), ip.data_ptr(), sp.data_ptr(),
            out.data_ptr(), b, hp.shape[1], n, hp.shape[2], zp.shape[2],
            _build.DTYPE_CODES[hsub.dtype], tile,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "sampled_matmul")
    sampled_matmul.launches += 1
    return out[:d_in, :d_out]


sampled_matmul.launches = 0
