"""Fused flash attention, forward only — the CUDA kernel's wrapper, its
plain PyTorch version and its launch counter.

    q (BH, Sq, Dh), k/v (BKVH, Skv, Dh), BH = BKVH * group
    out[h] = softmax(q[h] k[h // group]^T / sqrt(Dh), causal) v[h // group]

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_fwd`` (and its even-tiling requirement).  The kernels are
in ``csrc/flash_attention_fwd.cu``: one block per (bh, q tile) walking the
kv tiles up to the causal bound with the online-softmax state
``(m, l, acc)`` in f32 registers; kv head ``h // group`` is read in place,
no repeated K/V copy is made.  ``flash_route`` picks one of three routes
for a shape: ``wgmma`` (bf16/f16 at any Dh up to 128 with 16-byte-aligned
q/k/v: TMA ring, warp-specialised wgmma over a 64- or 128-column tile
whose columns past Dh are zeros), ``mma`` (other bf16/f16: Dh over 128
or a misaligned base; mma.sync) or ``fma`` (f32).  Every bf16/f16 route
rounds p once to the input dtype before P V with f32 statistics, as
``models/attention.py`` does; the f32 route keeps p in f32.
``flash_attention_fwd.launches`` counts launches, ``.launches_by_route``
splits them by route.  On an H100 it is bound by
operations: ``4 * BH * Dh * sum_i(#visible keys)`` flops against
989 TFLOP/s (bf16/f16) or 67 TFLOP/s (f32), with bytes
``(2 * BH * Sq + 2 * BKVH * Skv) * Dh * itemsize`` far below at the
prefill shapes.  Any ``Sq, Skv >= 1`` is taken; ``Dh`` is a multiple of 8
up to 256.

This is the attention of ``models/lm.py::prefill`` (the serving path).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, costs

NEG_INF = -1e30
MAX_HEAD_DIM = 256
# C route codes are the positions (csrc/flash_attention_fwd.cu: enum Route)
ROUTES = ("fma", "mma", "wgmma")
WGMMA_MAX_HEAD_DIM = 128


def flash_route(dh: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The one kernel route a shape takes: ``fma`` for float32, ``wgmma``
    for bfloat16/float16 at a head dim (a multiple of 8) up to
    ``WGMMA_MAX_HEAD_DIM`` with every operand starting on a 16-byte
    boundary (``aligned``), ``mma`` for the other bfloat16/float16 shapes:
    a head dim over 128 or a misaligned operand."""
    if dtype == torch.float32:
        return "fma"
    if dh <= WGMMA_MAX_HEAD_DIM and aligned:
        return "wgmma"
    return "mma"


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, group: int = 1,
                              causal: bool = True) -> torch.Tensor:
    """The definition, O(S^2) in f32: scores and softmax in f32 with the
    causal mask aligned at position 0, the product with v in f32, one
    rounding to ``q.dtype`` (``repro.kernels.ref.flash_attention_fwd_ref``
    in torch)."""
    sq, dh = q.shape[1], q.shape[2]
    kk = torch.repeat_interleave(k, group, dim=0).to(torch.float32)
    vv = torch.repeat_interleave(v, group, dim=0).to(torch.float32)
    s = torch.einsum("hqd,hkd->hqk", q.to(torch.float32), kk) / math.sqrt(dh)
    if causal:
        mask = torch.tril(torch.ones((sq, kk.shape[1]), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vv).to(q.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, group: int = 1,
                        causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, Dh), k/v (BKVH, Skv, Dh) of one float dtype with
    BH = BKVH * group -> (BH, Sq, Dh) in ``q.dtype``.

    A CUDA tensor launches the kernel (or raises); only tensors that lie
    on the CPU take the plain version; ``meta`` tensors charge the dry
    run's counter (``kernels/costs.py``).
    """
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"flash_attention_fwd wants q (BH, Sq, Dh) and k/v "
                         f"(BKVH, Skv, Dh), got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention_fwd takes float32/bfloat16/float16, "
                        f"got {q.dtype}")
    bh, sq, dh = q.shape
    bkvh, skv = k.shape[0], k.shape[1]
    if group < 1 or bkvh * group != bh:
        raise ValueError(f"q has {bh} heads but k/v have {bkvh} with "
                         f"group={group}; BH must be BKVH * group")
    if sq < 1 or skv < 1:
        raise ValueError("flash_attention_fwd wants non-empty sequences")
    if dh % 8 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {dh}")
    dev = q.device
    _build.check_operand("q", q)
    _build.check_operand("k", k, dtype=q.dtype, shape=(bkvh, skv, dh),
                         device=dev)
    _build.check_operand("v", v, dtype=q.dtype, shape=(bkvh, skv, dh),
                         device=dev)
    if dev.type == "meta":
        costs.charge(flash_attention_fwd, *costs.flash(
            bh, bkvh, sq, skv, dh, causal, q.element_size()))
        return torch.empty_like(q)
    if dev.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, group=group, causal=causal)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, not {dev}")
    route = flash_route(dh, q.dtype, _build.aligned16(q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        code = _build.library().repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, bkvh, sq, skv, dh, int(causal), _build.DTYPE_CODES[q.dtype],
            ROUTES.index(route), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, f"flash_attention_fwd ({route} route)")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[route] += 1
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.meta_launches = 0
flash_attention_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)
