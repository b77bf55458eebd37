"""Fused flash attention — the CUDA kernels' wrappers, their plain
PyTorch versions, their launch counters, and the training attention's
``torch.autograd.Function`` over them.

    q (BH, Sq, Dh), k/v (BKVH, Skv, Dh), BH = BKVH * group
    out[h] = softmax(q[h] k[h // group]^T / sqrt(Dh), causal) v[h // group]

``flash_attention_fwd`` replaces the TPU kernel ``repro/kernels/
flash_attention.py::flash_attention_fwd`` (and its even-tiling
requirement).  The kernels are in ``csrc/flash_attention_fwd.cu``: one
block per (bh, q tile) walking the kv tiles up to the causal bound with
the online-softmax state ``(m, l, acc)`` in f32 registers; kv head
``h // group`` is read in place, no repeated K/V copy is made.
``flash_route`` picks one of three routes for a shape: ``wgmma``
(bf16/f16 at any Dh up to 128 with 16-byte-aligned q/k/v: TMA ring,
warp-specialised wgmma over a 64- or 128-column tile whose columns past
Dh are zeros), ``mma`` (other bf16/f16: Dh over 128 or a misaligned
base; mma.sync) or ``fma`` (f32).  Every bf16/f16 route rounds p once to
the input dtype before P V with f32 statistics, as ``models/
attention.py`` does; the f32 route keeps p in f32.
``flash_attention_fwd.launches`` counts launches,
``.launches_by_route`` splits them by route.  On an H100 it is bound by
operations: ``4 * BH * Dh * sum_i(#visible keys)`` flops against
989 TFLOP/s (bf16/f16) or 67 TFLOP/s (f32), with bytes
``(2 * BH * Sq + 2 * BKVH * Skv) * Dh * itemsize`` far below at the
prefill shapes.  Any ``Sq, Skv >= 1`` is taken; ``Dh`` is a multiple of 8
up to 256.

``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``, bf16/f16, the
``wgmma`` route's shapes) gives dq, dk, dv from q, k, v and dO,
recomputing the scores and each row's log-sum-exp; it replaces no TPU
kernel (the reference differentiates jnp code).  ``FlashAttention`` is
the pair behind one ``autograd.Function`` in the model's (B, S, H, Dh)
layout, saving q, k and v alone, which ``models/attention.py::
flash_attention`` takes for the shapes ``train_route`` accepts.

The forward alone is the attention of ``models/lm.py::prefill`` (the
serving path).
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


def _causal_mask(sq: int, skv: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: key j visible to query i iff i >= j."""
    return torch.tril(torch.ones((sq, skv), dtype=torch.bool, device=device))


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
        mask = _causal_mask(sq, kk.shape[1], q.device)
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vv).to(q.dtype)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor,
                              group: int = 1, causal: bool = True):
    """The backward kernel's arithmetic in f32: the scores recomputed
    (s = q k^T * scale), each row's log-sum-exp lse over its visible keys,
    P = exp(s - lse), dP = dO v^T, D = rowsum(P * dP), dS = P * (dP - D);
    dV from P rounded once to the input dtype (as the forward's P V), dK
    and dQ from dS's two halves in the input dtype (hi = round(dS), lo =
    round(dS - hi); f32 inputs: hi is dS, lo 0), each product summed in
    f32; dK and dV summed over the group's heads; each gradient rounded
    once to ``q.dtype``.  Returns (dq (BH, Sq, Dh), dk, dv (BKVH, Skv,
    Dh))."""
    bh, sq, dh = q.shape
    bkvh, skv = k.shape[0], k.shape[1]
    f32, dt = torch.float32, q.dtype
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=f32))
    q32, do32 = q.to(f32), do.to(f32)
    kk = torch.repeat_interleave(k, group, dim=0).to(f32)
    vv = torch.repeat_interleave(v, group, dim=0).to(f32)
    s = torch.einsum("hqd,hkd->hqk", q32, kk) * scale
    if causal:
        s = torch.where(_causal_mask(sq, skv, q.device)[None], s,
                        torch.full_like(s, -math.inf))
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dp = torch.einsum("hqd,hkd->hqk", do32, vv)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    hi = ds.to(dt).to(f32)
    lo = (ds - hi).to(dt).to(f32)

    def by_kv_head(x):
        return x.reshape(bkvh, group, skv, dh).sum(1)

    dv = by_kv_head(torch.einsum("hqk,hqd->hkd", p.to(dt).to(f32), do32))
    dk = by_kv_head(torch.einsum("hqk,hqd->hkd", hi, q32)
                    + torch.einsum("hqk,hqd->hkd", lo, q32)) * scale
    dq = (torch.einsum("hqk,hkd->hqd", hi, kk)
          + torch.einsum("hqk,hkd->hqd", lo, kk)) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_qkv(name: str, q, k, v, group: int):
    """The shape, dtype, group and operand checks both wrappers make;
    returns (bh, sq, dh, bkvh, skv)."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"{name} wants q (BH, Sq, Dh) and k/v "
                         f"(BKVH, Skv, Dh), got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name} takes float32/bfloat16/float16, "
                        f"got {q.dtype}")
    bh, sq, dh = q.shape
    bkvh, skv = k.shape[0], k.shape[1]
    if group < 1 or bkvh * group != bh:
        raise ValueError(f"q has {bh} heads but k/v have {bkvh} with "
                         f"group={group}; BH must be BKVH * group")
    if sq < 1 or skv < 1:
        raise ValueError(f"{name} wants non-empty sequences")
    if dh % 8 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {dh}")
    _build.check_operand("q", q)
    _build.check_operand("k", k, dtype=q.dtype, shape=(bkvh, skv, dh),
                         device=q.device)
    _build.check_operand("v", v, dtype=q.dtype, shape=(bkvh, skv, dh),
                         device=q.device)
    return bh, sq, dh, bkvh, skv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, group: int = 1,
                        causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, Dh), k/v (BKVH, Skv, Dh) of one float dtype with
    BH = BKVH * group -> (BH, Sq, Dh) in ``q.dtype``.

    A CUDA tensor launches the kernel (or raises); only tensors that lie
    on the CPU take the plain version; ``meta`` tensors charge the dry
    run's counter (``kernels/costs.py``).
    """
    bh, sq, dh, bkvh, skv = _check_qkv("flash_attention_fwd", q, k, v, group)
    dev = q.device
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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, group: int = 1,
                        causal: bool = True):
    """The gradients (dq (BH, Sq, Dh), dk, dv (BKVH, Skv, Dh)) in
    ``q.dtype`` of ``flash_attention_fwd`` at q, k, v, given the output's
    gradient ``do`` (BH, Sq, Dh).

    A CUDA tensor launches ``csrc/flash_attention_bwd.cu`` (bf16/f16 on
    the ``wgmma`` route's shapes, else it raises); only tensors that lie
    on the CPU take the plain version; ``meta`` tensors charge the dry
    run's counter.
    """
    bh, sq, dh, bkvh, skv = _check_qkv("flash_attention_bwd", q, k, v, group)
    dev = q.device
    _build.check_operand("do", do, dtype=q.dtype, shape=(bh, sq, dh),
                         device=dev)
    if dev.type == "meta":
        costs.charge(flash_attention_bwd, *costs.flash_bwd(
            bh, bkvh, sq, skv, dh, causal, q.element_size()))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, group=group,
                                         causal=causal)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {dev}")
    route = flash_route(dh, q.dtype, _build.aligned16(q, k, v, do))
    if route != "wgmma":
        raise ValueError(f"flash_attention_bwd runs the wgmma route's shapes "
                         f"(bf16/f16, Dh up to {WGMMA_MAX_HEAD_DIM}, 16-byte "
                         f"aligned), not {q.dtype} at Dh {dh} ({route})")
    # scratch: each row's lse and D, rows padded to whole 128-row tiles
    stats = torch.empty((2, bh, -(-sq // 128) * 128), dtype=torch.float32,
                        device=dev)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    with torch.cuda.device(dev):
        code = _build.library().repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, bkvh, sq, skv, dh, int(causal),
            _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "flash_attention_bwd (wgmma route)")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route["wgmma"] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.meta_launches = 0
flash_attention_bwd.launches_by_route = {"wgmma": 0}


def train_route(q: torch.Tensor, k: torch.Tensor, q_offset: int = 0) -> bool:
    """Whether the training attention of (B, S, H, Dh) q and (B, Skv, KVH,
    Dh) k takes ``FlashAttention``: tensors on the card (or on ``meta``,
    the dry run of the card), the ``wgmma`` route's dtype and head dim
    (the Function makes its own aligned copies), the causal mask aligned
    at position 0.  Everything else keeps the eager blockwise path
    (``models/attention.py``): CPU tensors, float32, a head dim over 128,
    a chunk's ``q_offset``."""
    dh = q.shape[-1]
    return (q.device.type in ("cuda", "meta") and q_offset == 0
            and k.dtype == q.dtype and dh % 8 == 0
            and flash_route(dh, q.dtype) == "wgmma")


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) -> contiguous (B*H, S, Dh)."""
    b, s, h, dh = x.shape
    return x.transpose(1, 2).contiguous().view(b * h, s, dh)


def _heads_last(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B*H, S, Dh) -> a (B, S, H, Dh) view."""
    bh, s, dh = x.shape
    return x.view(b, bh // b, s, dh).transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """Attention of q (B, Sq, H, Dh) over k, v (B, Skv, KVH, Dh) ->
    (B, Sq, H, Dh): ``flash_attention_fwd`` forward, ``flash_attention_bwd``
    backward.  It saves the heads-first copies of q, k, v (the kernels'
    layout; the caller's tensors are not kept) and nothing else: no
    output, no statistics, no probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        b, h = q.shape[0], q.shape[2]
        group = h // k.shape[2]
        qh, kh, vh = _heads_first(q), _heads_first(k), _heads_first(v)
        out = flash_attention_fwd(qh, kh, vh, group=group, causal=causal)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(qh, kh, vh)
        ctx.group, ctx.causal, ctx.b = group, causal, b
        return _heads_last(out, b).contiguous()

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(qh, kh, vh, _heads_first(do),
                                         group=ctx.group, causal=ctx.causal)
        b = ctx.b
        return _heads_last(dq, b), _heads_last(dk, b), _heads_last(dv, b), \
            None
