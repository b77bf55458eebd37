"""GQA attention: the training path and the cached decode path (the
prefill of the serving path runs the ``flash_attention_fwd`` kernel, see
``models/lm.py::prefill``).

``flash_attention`` takes the hand-written kernels'
``autograd.Function`` (``kernels/flash_attention.py::FlashAttention``:
the prefill's ``flash_attention_fwd`` kernel forward, a wgmma backward
that recomputes the softmax statistics) where ``train_route`` accepts the
call: CUDA (or meta) bf16/f16 tensors, a head dim a multiple of 8 up to
128, no ``q_offset``.  Everything else (CPU tensors, float32, a head dim
over 128) runs the eager blockwise version below, the plain one.

Online softmax over KV blocks with the reference's block numerics:
scores and softmax statistics in f32 (q and k upcast before the score
product), UNNORMALIZED probabilities rounded to the input dtype before
the PV product, normalization by l afterwards.  Each q-row of blocks runs
under ``torch.utils.checkpoint``, so the (bq, bk) probability blocks are
recomputed in the backward and activation memory stays O(S * block)
instead of O(S^2).

``mode="full"`` visits every (q-block, kv-block) pair and masks;
``mode="triangular"`` walks only the causal lower triangle of block
pairs — the skipped blocks contribute exact zeros, so numerics are
identical.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as flash_kernels
from repro_torch.launch import collectives

NEG_INF = -1e30


def _attend_block(qc, kc, vc, q0: int, k0: int, causal: bool, scale: float,
                  m, l, acc):
    """One online-softmax step.  qc: (B,bq,KVH,G,Dh), kc/vc: (B,bk,KVH,Dh);
    q0/k0: absolute positions of the blocks' first rows."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qc.to(torch.float32),
                     kc.to(torch.float32)) * scale
    if causal:
        qpos = torch.arange(qc.shape[1], device=qc.device) + q0
        kpos = torch.arange(kc.shape[1], device=qc.device) + k0
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    # probabilities ride in the input dtype; softmax stats stay f32
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(qc.dtype),
                      vc).to(torch.float32)
    acc_new = acc * corr[..., None] + pv
    return m_new, l_new, acc_new


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_block: int = 512,
                    kv_block: int = 512, mode: str = "full",
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Skv, KVH, Dh).  Returns (B, Sq, H, Dh).

    ``q_offset``: absolute position of q[0] (for chunked prefill).  The
    kernels' Function takes any Sq, Skv and ignores the blocks and the
    mode; the eager path needs the lengths to tile by the blocks.
    """
    if mode not in ("full", "triangular"):
        raise ValueError(f"unknown flash mode {mode!r}")
    if flash_kernels.train_route(q, k, q_offset):
        return flash_kernels.FlashAttention.apply(q, k, v, causal)
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    if sq % q_block or skv % kv_block:
        raise ValueError(f"sequence lengths ({sq}, {skv}) must tile by the "
                         f"blocks ({q_block}, {kv_block})")
    nq, nk = sq // q_block, skv // kv_block
    scale = 1.0 / math.sqrt(dh)
    qr = q.reshape(b, sq, kvh, g, dh)

    def q_row(qc, k, v, qi: int):
        m = torch.full((b, kvh, g, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kvh, g, q_block), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, kvh, g, q_block, dh), dtype=torch.float32,
                          device=q.device)
        q0 = qi * q_block + q_offset
        n_visit = nk
        if causal and mode == "triangular":
            # kv blocks that start after this q block's last position
            # are wholly masked
            n_visit = min(nk, (q0 + q_block - 1) // kv_block + 1)
        for kj in range(n_visit):
            ks = slice(kj * kv_block, (kj + 1) * kv_block)
            m, l, acc = _attend_block(qc, k[:, ks], v[:, ks], q0,
                                      kj * kv_block, causal, scale,
                                      m, l, acc)
        return acc / torch.clamp(l, min=1e-30)[..., None]

    rows = []
    for qi in range(nq):
        qc = qr[:, qi * q_block:(qi + 1) * q_block]
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            o = checkpoint(q_row, qc, k, v, qi, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            o = q_row(qc, k, v, qi)
        rows.append(o)                               # (B,KVH,G,bq,Dh)
    o = torch.cat(rows, dim=3)                       # (B,KVH,G,Sq,Dh)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)
    return o.to(q.dtype)


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """Single-token attention against a (B, Smax, KVH, Dh) KV cache.

    q1: (B, 1, H, Dh).  ``cache_len``: an int, a 0-dim or a (B,) tensor of
    valid positions (the new token's K/V already written at
    cache_len - 1).  The block numerics of ``flash_attention``: scores
    and softmax statistics in f32, UNNORMALIZED probabilities rounded to
    q1's dtype before the PV product, normalization by l afterwards;
    masked positions contribute exact zeros, whatever the cache holds
    there.
    """
    b, _, h, dh = q1.shape
    smax, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qr = q1.reshape(b, kvh, g, dh).to(torch.float32)
    s = torch.einsum("bhgd,bkhd->bhgk", qr,
                     k_cache.to(torch.float32)) * scale
    cache_len = torch.as_tensor(cache_len, device=q1.device)
    valid = (torch.arange(smax, device=q1.device)[None]
             < cache_len.reshape(-1, 1))
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)
    pv = torch.einsum("bhgk,bkhd->bhgd", p.to(q1.dtype),
                      v_cache).to(torch.float32)
    o = pv / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, 1, h, dh).to(q1.dtype)


def decode_attention_sharded(q1: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len, key_pos,
                             mesh) -> torch.Tensor:
    """``decode_attention`` over a cache whose positions are split across
    the ``model`` ranks: entry j of this rank's cache holds absolute
    position ``key_pos[j]`` (a (Smax_local,) tensor, increasing: a
    contiguous slice of the sequence, or each page's share of its
    positions in the slot pool), or the positions from ``key_pos`` on
    where it is an int.  The softmax max is all-reduced first, so every
    rank exponentiates against the global max as the one-rank version
    does; then the sums and the P·V products (each rounded to q1's dtype,
    as there, then f32) are all-reduced."""
    b, _, h, dh = q1.shape
    span, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qr = q1.reshape(b, kvh, g, dh).to(torch.float32)
    s = torch.einsum("bhgd,bkhd->bhgk", qr,
                     k_cache.to(torch.float32)) * scale
    cache_len = torch.as_tensor(cache_len, device=q1.device)
    if isinstance(key_pos, int):
        key_pos = torch.arange(span, device=q1.device) + key_pos
    valid = key_pos[None] < cache_len.reshape(-1, 1)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    m = collectives.all_reduce(torch.amax(s, dim=-1, keepdim=True), mesh,
                               "model", op="max")
    p = torch.exp(s - m)
    l = collectives.all_reduce(torch.sum(p, dim=-1), mesh, "model")
    pv = collectives.all_reduce(
        torch.einsum("bhgk,bkhd->bhgd", p.to(q1.dtype),
                     v_cache).to(torch.float32), mesh, "model")
    o = pv / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, 1, h, dh).to(q1.dtype)


def decode_attention_dh(q1: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, cache_len, lo: int,
                        mesh) -> torch.Tensor:
    """``decode_attention`` over a cache whose ``head_dim`` is split across
    the ``model`` ranks: this rank holds features [lo, lo + Dh_local) of
    every position and head.  q1 (B, 1, H, Dh) is whole; each rank's
    partial scores are all-reduced (f32) before the softmax, which every
    rank then takes whole with ``decode_attention``'s numerics (f32
    statistics, UNNORMALIZED probabilities rounded to q1's dtype before
    P·V); P·V gives this rank's features, all-gathered into the whole
    (B, 1, H, Dh) output."""
    b, _, h, dh = q1.shape
    smax, kvh, part = k_cache.shape[1], k_cache.shape[2], k_cache.shape[3]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qr = q1.reshape(b, kvh, g, dh)[..., lo:lo + part].to(torch.float32)
    s = collectives.all_reduce(torch.einsum(
        "bhgd,bkhd->bhgk", qr, k_cache.to(torch.float32)), mesh,
        "model") * scale
    cache_len = torch.as_tensor(cache_len, device=q1.device)
    valid = (torch.arange(smax, device=q1.device)[None]
             < cache_len.reshape(-1, 1))
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)
    pv = torch.einsum("bhgk,bkhd->bhgd", p.to(q1.dtype),
                      v_cache).to(torch.float32)
    o = (pv / torch.clamp(l, min=1e-30)[..., None]).to(q1.dtype)
    o = collectives.all_gather(o.reshape(b, h, part), mesh, "model", dim=-1)
    return o.reshape(b, 1, h, dh)


def attention_reference(q, k, v, *, causal=True, q_offset: int = 0):
    """O(S^2)-memory oracle for flash_attention (tests only)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qr = q.reshape(b, sq, kvh, g, dh).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.to(torch.float32))
    s = s / math.sqrt(dh)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)
    return o.to(q.dtype)
