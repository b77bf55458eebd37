"""The even-tiled sampled weight-gradient — the CUDA kernel's wrapper (host
planning included), its plain PyTorch version and its launch counter.

    dW (d_in, d_out) f32 = sum_b hsub_b^T @ (dz_b[idx_b] * scale_b)

Replaces the TPU kernel ``repro/kernels/sampled_matmul.py::sampled_matmul``
and keeps its contract: padded plan slots are idx 0, scale 0 and
contribute nothing (``repro/kernels/ops.py``).  The kernels are in
``csrc/sampled_matmul.cu``; ``smm_route`` picks one route, tile and
cluster for a shape, from the tile ``autotune.tile_for`` gives (a pin,
else the tuning table's entry, else the shape rule
``autotune.default_blocks``):

* ``wgmma`` (bf16/f16, d_in and d_out multiples of 8, hsub and dz
  16-byte aligned): the Hopper kernel.  256 x 128 dW tiles, two blocks
  along d_out sharing one H' tile by TMA multicast (tile 256; the rule's
  pick where that still gives half the SMs a block), or 64 x 64 tiles
  without a cluster (tile 64).  Nothing is padded or copied: TMA reads H'
  past k and d_in as zeros, the kernel fetches plan slots past k as idx
  0, scale 0 and predicates the d_out edge.
* ``wmma`` (other bf16/f16) and ``fma`` (f32): even tiles only; the
  wrapper pads H' (k rows, d_in columns) and dZ (d_out columns) with
  zeros to the tile (``pad_operands``) and slices the result back.

``sampled_matmul.launches`` counts launches, ``.launches_by_route`` splits
them by route, ``.launches_by_tile`` by the tile launched.  On an H100 in bf16 it is bound by
operations at the wide projections (``2*B*k*d_in*d_out`` on the unpadded
k against 989 TFLOP/s).

The reference keeps this kernel as the unfused baseline the fused kernel
(``fused_sampling.py``) is measured against: ``row_norms -> plan ->
gather_scale -> sampled_matmul``.  Nothing on the train path calls it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, autotune, costs, fused_sampling

# contraction slots per tile of the even-tiled routes: mma tiles of 32 for
# bf16/f16, FMA tiles of 16 for f32 (csrc/sampled_matmul.cu)
BK = {torch.bfloat16: 32, torch.float16: 32, torch.float32: 16}
F32_TILE = 64
# C route codes are the positions (csrc/sampled_matmul.cu: enum Route)
ROUTES = ("fma", "wmma", "wgmma")


class SmmRoute(NamedTuple):
    """One kernel configuration: the route, the dW tile of a block (rows
    along d_in, columns along d_out) and how many blocks along d_out share
    one H' tile (a thread block cluster)."""
    route: str
    tile_m: int
    tile_n: int
    cluster: int


# The same function as the fused kernel computes, hence its plain version:
# gather, scale in f32, round once to the input dtype, contract over (b, k)
# in f32.
sampled_matmul_plain = fused_sampling.fused_sampled_dw_plain


def choose_tile(dtype: torch.dtype, d_in: int, d_out: int,
                sms: Optional[int]) -> int:
    """The square output tile the shape rule gives the ``wmma`` / ``fma``
    routes, which the operands are padded to: 64 for f32; for bf16/f16 128
    when that still gives every SM a tile, else 64 (the same rule as
    ``fused_sampled_dw``).  ``sms=None`` takes 64."""
    if dtype == torch.float32:
        return F32_TILE
    if sms is None:
        return 64
    return autotune.default_blocks("sampled_matmul", "wmma", d_in, d_out,
                                   sms=sms)


def smm_route(d_in: int, d_out: int, dtype: torch.dtype,
              aligned: bool = True, sms: int = autotune.H100_SMS,
              tile: Optional[int] = None) -> SmmRoute:
    """The one kernel configuration a shape takes: ``fma`` (64 x 64) for
    float32; ``wgmma`` for bfloat16/float16 when d_in and d_out are
    multiples of 8 and hsub and dz start on a 16-byte boundary
    (``aligned``; TMA's strides and base and the 16-byte dZ' chunks need
    it); ``wmma`` for the other bfloat16/float16 shapes.  ``tile`` (a
    candidate of the route, ``autotune.candidate_blocks``, else
    ``ValueError``) sets the tile; ``None`` takes the shape rule's
    (``autotune.default_blocks``): on ``wgmma`` 256 x 128 tiles in
    clusters of two along d_out when that gives at least half of the
    ``sms`` SMs a block, else 64 x 64 tiles without a cluster; on ``wmma``
    ``choose_tile``'s square tile."""
    route = autotune.dw_route(d_in, d_out, dtype, aligned)
    if tile is None:
        tile = autotune.default_blocks("sampled_matmul", route, d_in, d_out,
                                       sms=sms)
    elif tile not in autotune.candidate_blocks("sampled_matmul", route):
        raise ValueError(
            f"sampled_matmul's {route} route takes the tiles "
            f"{autotune.candidate_blocks('sampled_matmul', route)}, not "
            f"{tile!r}")
    if tile == 256:
        return SmmRoute(route, 256, 128, 2)
    return SmmRoute(route, tile, tile, 1)


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


def plan_operands(hsub, dz, idx, scale, r: SmmRoute):
    """The operands route ``r``'s kernel is handed.  ``wgmma``: all four as
    they are — TMA reads H' past k and d_in as zeros and the kernel fetches
    the plan's slots past k as idx 0, scale 0, so nothing is copied.
    ``wmma`` / ``fma``: ``pad_operands`` to the tile, each operand then
    starting on a 16-byte boundary (a misaligned view is copied)."""
    if r.route == "wgmma":
        return hsub, dz, idx, scale
    padded = pad_operands(hsub, dz, idx, scale, r.tile_m, BK[hsub.dtype])
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in padded)


def launch(hsub, dz, idx, scale, r: SmmRoute) -> torch.Tensor:
    """Route ``r``'s kernel on ``plan_operands``' output (CUDA tensors):
    the padded (d_in', d_out') f32 result.  Raises if the launch is
    refused; counts the launch, by route and by tile."""
    b, k, d_in = hsub.shape
    n, d_out = dz.shape[1], dz.shape[2]
    out = torch.empty((d_in, d_out), dtype=torch.float32, device=hsub.device)
    with torch.cuda.device(hsub.device):
        code = _build.library().repro_sampled_matmul(
            hsub.data_ptr(), dz.data_ptr(), idx.data_ptr(), scale.data_ptr(),
            out.data_ptr(), b, k, n, d_in, d_out,
            _build.DTYPE_CODES[hsub.dtype], r.tile_m,
            ROUTES.index(r.route), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, f"sampled_matmul ({r.route} route)")
    sampled_matmul.launches += 1
    sampled_matmul.launches_by_route[r.route] += 1
    sampled_matmul.launches_by_tile[r.tile_m] += 1
    return out


def sampled_matmul(hsub: torch.Tensor, dz: torch.Tensor, idx: torch.Tensor,
                   scale: torch.Tensor, *,
                   tile: Optional[int] = None) -> torch.Tensor:
    """hsub (k, d_in), dz (n, d_out), idx/scale (k,); or the batched form
    hsub (B, k, d_in), dz (B, n, d_out), idx/scale (B, k) -> (d_in, d_out)
    f32.  One float dtype for hsub and dz, idx int32 rows of dz, scale f32.

    ``tile`` pins the tile (a candidate of the route the operands take,
    else ``ValueError``); ``None`` takes the packaged tuning table's entry
    for this shape (the 2-D form as B = 1), else the shape rule
    (``autotune.tile_for``, as ``fused_sampled_dw``).  ``smm_route`` picks the kernel
    configuration and ``plan_operands`` prepares its operands on either
    device (on the CPU too the tile sets the padding); then a CUDA tensor
    launches the kernel (or raises) and only tensors that lie on the CPU
    take the plain version; ``meta`` tensors charge the dry run's counter
    (``kernels/costs.py``).  An index outside [0, n) raises: on the CPU at
    once, on the card as a device-side assert at the next
    synchronisation.
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
    if dev.type == "meta":
        costs.charge(sampled_matmul, *costs.sampled_dw(
            1, b, k, d_in, d_out, hsub.element_size()))
        return torch.empty((d_in, d_out), dtype=torch.float32,
                           device="meta")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sampled_matmul runs on cuda or cpu, not {dev}")
    if tile is None:
        tile = autotune.tile_for(None, "sampled_matmul", hsub, dz)
    r = smm_route(d_in, d_out, hsub.dtype, _build.aligned16(hsub, dz),
                  tile=tile)
    planned = plan_operands(hsub, dz, idx, scale, r)
    if dev.type == "cpu":
        return sampled_matmul_plain(*planned)[:d_in, :d_out]
    return launch(*planned, r)[:d_in, :d_out]


sampled_matmul.launches = 0
sampled_matmul.meta_launches = 0
sampled_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
sampled_matmul.launches_by_tile = dict.fromkeys((256, 128, 64), 0)
