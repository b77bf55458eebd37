"""State-space and recurrent blocks: Mamba2 (SSD), mLSTM, sLSTM.

Mamba2 uses the chunked SSD formulation (quadratic only within a chunk,
linear across chunks via a carried state): the intra-chunk work is
batched products, the inter-chunk recurrence a short loop over L/chunk
steps.

mLSTM/sLSTM (xLSTM, arXiv:2405.04517) use exponential gating with the
log-space max-stabilizer m_t.  Training runs an outer loop over sequence
chunks, each chunk under ``torch.utils.checkpoint``, so the backward
stores only chunk-boundary states (the reference wraps each chunk's scan
in ``jax.checkpoint``).  The inner loop is a Python loop over time steps.

All in/out projections route through ``ctx.linear`` and are therefore
WTA-CRS-compressible; the recurrences themselves are not weight GEMMs and
keep exact gradients (the paper's scope, Fig. 4).  The numerics mirror
the reference's: the conv sums its taps in order and adds the bias before
the cast, bf16 x f32 promotes to f32 at the same points, Mamba's conv
state stays in the compute dtype and its SSM state in f32, and the ``m``
stabilizers start at -1e30.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def mamba_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    return di, nh, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba(cfg, gen, dtype, device):
    d = cfg.d_model
    di, nh, hd, n = mamba_dims(cfg)
    conv_dim = di + 2 * n
    return {
        "in_proj": cm.dense_init(gen, (d, 2 * di + 2 * n + nh), dtype,
                                 device),
        "conv_w": cm.dense_init(gen, (cfg.ssm_conv, conv_dim), dtype,
                                device, scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.arange(1, nh + 1, dtype=_F32,
                                        device=device)),
        "d_skip": torch.ones((nh,), dtype=_F32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=_F32, device=device),
        "norm_g": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": cm.dense_init(gen, (di, d), dtype, device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B, L, C), w: (K, C).  Returns (y, state):
    the K taps summed in order (x in its dtype times the f32 weight
    promotes to f32), the bias added, then one cast to x's dtype; the
    state is the last K-1 inputs in x's dtype."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(k))
    return (y + b).to(x.dtype), new_state


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk: int):
    """Chunked SSD.  xh: (B,L,H,P), dt: (B,L,H), a: (H,) negative,
    bmat/cmat: (B,L,N), all f32.  Returns (y: (B,L,H,P), final_state
    (B,H,N,P)).  L must be a multiple of ``chunk`` when it is longer."""
    b, l, h, p = xh.shape
    n = bmat.shape[-1]
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"SSD chunk {chunk} does not divide the sequence "
                         f"length {l}; use a chunk that does")
    nc = l // chunk
    xc = xh.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)

    da = dtc * a[None, None, None, :]                    # (B,nc,c,H) <= 0
    seg = torch.cumsum(da, dim=2)                        # decay from chunk
    total = seg[:, :, -1, :]                             # (B,nc,H)

    # intra-chunk: Y[t] = sum_{s<=t} exp(seg_t - seg_s) (C_t.B_s) dt_s x_s
    scores = torch.einsum("bqtn,bqsn->bqts", cc, bc)     # (B,nc,c,c)
    decay = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B,nc,t,s,H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()[None, None, :, :, None]
    # double-where: never exp() masked (positive) decays, else backward
    # produces 0 * inf = NaN through the mask
    lmat = torch.where(causal, torch.exp(torch.where(causal, decay, 0.0)),
                       0.0)
    # "bqts,bqtsh,bqsh,bqshp->bqthp" contracted pairwise, s last: the two
    # (t, s) factors multiply into one (B,nc,t,s,H) tensor, the two s-side
    # factors into one (B,nc,s,H,P), and one batched product over (b,q,h)
    # contracts s — no 6-D tensor is formed
    w_ts = scores[..., None] * lmat                      # (B,nc,t,s,H)
    u = dtc[..., None] * xc                              # (B,nc,s,H,P)
    y_intra = torch.einsum("bqtsh,bqshp->bqthp", w_ts, u)

    # chunk summaries: S_q = sum_s exp(total - seg_s) dt_s B_s x_s^T
    w_end = torch.exp(total[:, :, None, :] - seg)        # (B,nc,c,H)
    s_q = torch.einsum("bqsn,bqshp->bqhnp", bc,
                       (w_end * dtc)[..., None] * xc)    # (B,nc,H,N,P)

    # inter-chunk recurrence over q: h_q = exp(total_q) h_{q-1} + S_q
    hprev = xh.new_zeros((b, h, n, p))
    before = []
    for q in range(nc):
        before.append(hprev)                             # state BEFORE q
        hprev = torch.exp(total[:, q])[..., None, None] * hprev + s_q[:, q]
    h_before = torch.stack(before, dim=1)                # (B,nc,H,N,P)

    y_inter = (torch.einsum("bqtn,bqhnp->bqthp", cc, h_before)
               * torch.exp(seg)[..., None])
    y = (y_intra + y_inter).reshape(b, l, h, p)
    return y, hprev


def apply_mamba(cfg, p, ctx: cm.Ctx, h, chunk: int = 256,
                return_state: bool = False):
    """h: (B, L, D) -> (B, L, D) [, decode state]."""
    bsz, l, d = h.shape
    di, nh, hd, n = mamba_dims(cfg)
    proj = ctx.linear("mamba_in", h, p["in_proj"])
    z, xbc_raw, dt_raw = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    xbc, conv_state = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc)
    x, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)

    dt = F.softplus(dt_raw.to(_F32) + p["dt_bias"][None, None, :])
    a = -torch.exp(p["a_log"].to(_F32))
    xh = x.reshape(bsz, l, nh, hd).to(_F32)
    y, ssm_state = _ssd_chunked(xh, dt, a, bmat.to(_F32), cmat.to(_F32),
                                chunk)
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(bsz, l, di).to(h.dtype)
    y = cm.rms_norm(y, p["norm_g"], cfg.norm_eps) * F.silu(z)
    out = ctx.linear("mamba_out", y, p["out_proj"])
    if return_state:
        return out, {"conv": conv_state, "ssm": ssm_state}
    return out


def mamba_decode_init(cfg, batch: int, dtype, device):
    di, nh, hd, n = mamba_dims(cfg)
    conv_dim = di + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, n, hd), dtype=_F32, device=device),
    }


def mamba_decode_step(cfg, p, ctx: cm.Ctx, h1, state):
    """h1: (B, 1, D) -> (B, 1, D); O(1) state update (new tensors)."""
    bsz = h1.shape[0]
    di, nh, hd, n = mamba_dims(cfg)
    proj = ctx.linear("mamba_in", h1, p["in_proj"])
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state["conv"])
    xbc = F.silu(xbc)
    x, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)

    dt = F.softplus(dt_raw.to(_F32)
                    + p["dt_bias"][None, None, :])[:, 0]        # (B,H)
    a = -torch.exp(p["a_log"].to(_F32))
    xh = x.reshape(bsz, nh, hd).to(_F32)
    da = torch.exp(dt * a[None, :])                             # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, bmat[:, 0].to(_F32), xh)
    ssm = da[..., None, None] * state["ssm"] + upd
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].to(_F32), ssm)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(h1.dtype)
    y = cm.rms_norm(y, p["norm_g"], cfg.norm_eps) * F.silu(z)
    out = ctx.linear("mamba_out", y, p["out_proj"])
    return out, {"conv": conv_state, "ssm": ssm}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, exponential gating)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    nh = cfg.n_heads
    return di, nh, di // nh


def init_mlstm(cfg, gen, dtype, device):
    d = cfg.d_model
    di, nh, dh = mlstm_dims(cfg)
    return {
        "up": cm.dense_init(gen, (d, 2 * di), dtype, device),
        "wq": cm.dense_init(gen, (di, di), dtype, device),
        "wk": cm.dense_init(gen, (di, di), dtype, device),
        "wv": cm.dense_init(gen, (di, di), dtype, device),
        "w_if": cm.dense_init(gen, (di, 2 * nh), dtype, device, scale=0.02),
        "if_bias": torch.cat([torch.zeros((nh,), dtype=_F32, device=device),
                              torch.full((nh,), 3.0, dtype=_F32,
                                         device=device)]),
        "down": cm.dense_init(gen, (di, d), dtype, device),
    }


def _mlstm_cell_step(state, qkvif):
    """One stabilized mLSTM step.  state: (C (B,H,dh,dh), n (B,H,dh),
    m (B,H)).  qkvif: q,k,v (B,H,dh), i_raw,f_raw (B,H)."""
    q, k, v, i_raw, f_raw = qkvif
    return _mlstm_scaled_step(state, (q, k / math.sqrt(q.shape[-1]), v,
                                      i_raw, -F.softplus(-f_raw)))


def _mlstm_scaled_step(state, xs):
    """``_mlstm_cell_step`` on k already scaled by 1/sqrt(dh) and on
    logf = log sigmoid(f_raw): the elementwise work that does not depend
    on the state, which the sequence path does once for all steps (the
    same values, so the same results)."""
    c, n, m = state
    q, k_sc, v, i_raw, logf = xs
    lm = logf + m
    m_new = torch.maximum(lm, i_raw)
    fg = torch.exp(lm - m_new)[..., None]
    ig = torch.exp(i_raw - m_new)[..., None]
    c_new = fg[..., None] * c + (ig * v)[..., None, :] * k_sc[..., :, None]
    n_new = fg * n + ig * k_sc
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)),
                        torch.exp(-m_new))[..., None]
    h = num / den
    return (c_new, n_new, m_new), h


def _scan(cell_step, state, xs):
    """The cell over the leading time axis of every tensor in ``xs``:
    (final state, stacked outputs)."""
    ys = []
    for t in range(xs[0].shape[0]):
        state, y = cell_step(state, tuple(x[t] for x in xs))
        ys.append(y)
    return state, torch.stack(ys)


def _recurrent_over_chunks(cell_step, state, xs_seq, chunk: int):
    """The cell over chunks of the time axis, each chunk rematerialized
    (non-reentrant ``torch.utils.checkpoint``) when a backward will
    follow, so only the chunk-boundary states are stored.

    xs_seq: tuple of tensors with a leading (L, ...) time axis; ``cell_step``
    takes a state tuple and a tuple of per-step slices and returns (state,
    y).  Returns (state, ys (L, ...))."""
    l = xs_seq[0].shape[0]
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"recurrent chunk {chunk} does not divide the "
                         f"sequence length {l}; use a chunk that does")
    n_state = len(state)

    def run(*flat):
        st, ys = _scan(cell_step, tuple(flat[:n_state]), flat[n_state:])
        return (*st, ys)

    outs = []
    for c0 in range(0, l, chunk):
        xs = tuple(x[c0:c0 + chunk] for x in xs_seq)
        if torch.is_grad_enabled():
            out = checkpoint(run, *state, *xs, use_reentrant=False)
        else:
            out = run(*state, *xs)
        state, ys = tuple(out[:n_state]), out[n_state]
        outs.append(ys)
    return state, torch.cat(outs)


def apply_mlstm(cfg, p, ctx: cm.Ctx, h, chunk: int = 256,
                return_state: bool = False):
    bsz, l, d = h.shape
    di, nh, dh = mlstm_dims(cfg)
    up = ctx.linear("mlstm_up", h, p["up"])
    xs, z = torch.chunk(up, 2, dim=-1)
    q = ctx.linear("mlstm_q", xs, p["wq"]).reshape(bsz, l, nh, dh)
    k = ctx.linear("mlstm_k", xs, p["wk"]).reshape(bsz, l, nh, dh)
    v = ctx.linear("mlstm_v", xs, p["wv"]).reshape(bsz, l, nh, dh)
    gif = (ctx.linear("mlstm_if", xs, p["w_if"]).to(_F32)
           + p["if_bias"][None, None, :])
    i_raw, f_raw = torch.chunk(gif, 2, dim=-1)          # (B,L,H)

    def to_seq(x):
        return torch.movedim(x.to(_F32), 1, 0)

    init = mlstm_decode_init(cfg, bsz, h.device)
    (cs, ns, ms), hs = _recurrent_over_chunks(
        _mlstm_scaled_step, (init["c"], init["n"], init["m"]),
        (to_seq(q), to_seq(k) / math.sqrt(dh), to_seq(v), to_seq(i_raw),
         -F.softplus(-to_seq(f_raw))), chunk)
    hs = torch.movedim(hs, 0, 1).reshape(bsz, l, di)    # (B,L,di)
    y = hs.to(h.dtype) * F.silu(z)
    out = ctx.linear("mlstm_down", y, p["down"])
    if return_state:
        return out, {"c": cs, "n": ns, "m": ms}
    return out


def mlstm_decode_init(cfg, batch: int, device):
    di, nh, dh = mlstm_dims(cfg)
    return {"c": torch.zeros((batch, nh, dh, dh), dtype=_F32, device=device),
            "n": torch.zeros((batch, nh, dh), dtype=_F32, device=device),
            "m": torch.full((batch, nh), -1e30, dtype=_F32, device=device)}


def mlstm_decode_step(cfg, p, ctx: cm.Ctx, h1, state):
    bsz = h1.shape[0]
    di, nh, dh = mlstm_dims(cfg)
    up = ctx.linear("mlstm_up", h1, p["up"])
    xs, z = torch.chunk(up, 2, dim=-1)
    q = ctx.linear("mlstm_q", xs, p["wq"]).reshape(bsz, nh, dh)
    k = ctx.linear("mlstm_k", xs, p["wk"]).reshape(bsz, nh, dh)
    v = ctx.linear("mlstm_v", xs, p["wv"]).reshape(bsz, nh, dh)
    gif = (ctx.linear("mlstm_if", xs, p["w_if"]).to(_F32)
           + p["if_bias"][None, None, :])[:, 0]
    i_raw, f_raw = torch.chunk(gif, 2, dim=-1)
    st = (state["c"], state["n"], state["m"])
    (c, n, m), h_out = _mlstm_cell_step(
        st, (q.to(_F32), k.to(_F32), v.to(_F32), i_raw, f_raw))
    y = h_out.reshape(bsz, 1, di).to(h1.dtype) * F.silu(z)
    out = ctx.linear("mlstm_down", y, p["down"])
    return out, {"c": c, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent head-mixing)
# ---------------------------------------------------------------------------

def slstm_dims(cfg):
    nh = cfg.n_heads
    return cfg.d_model, nh, cfg.d_model // nh


def init_slstm(cfg, gen, dtype, device):
    d, nh, dh = slstm_dims(cfg)
    return {
        "w_in": cm.dense_init(gen, (d, 4 * d), dtype, device),
        # recurrent block-diagonal per-head mixing for the 4 gates
        "r": cm.dense_init(gen, (nh, dh, 4 * dh), dtype, device, scale=0.02),
        "bias": torch.cat([torch.zeros((2 * d,), dtype=_F32, device=device),
                           torch.full((d,), 3.0, dtype=_F32, device=device),
                           torch.zeros((d,), dtype=_F32, device=device)]),
        "down": cm.dense_init(gen, (d, d), dtype, device),
    }


def _slstm_cell_step_factory(p, nh, dh):
    r = p["r"].to(_F32)
    bias = p["bias"]

    def step(state, xs):
        c, n, m, h_prev = state                      # (B,H,dh) each
        (x_t,) = xs
        rec = torch.einsum("bhd,hde->bhe", h_prev, r)  # (B,H,4dh)
        gates = (x_t.reshape((-1, nh, 4 * dh)) + rec
                 + bias.reshape((1, nh, 4 * dh)))
        zr, ir, fr, orr = torch.chunk(gates, 4, dim=-1)
        logf = -F.softplus(-fr)
        m_new = torch.maximum(logf + m, ir)
        fg = torch.exp(logf + m - m_new)
        ig = torch.exp(ir - m_new)
        zt = torch.tanh(zr)
        c_new = fg * c + ig * zt
        n_new = fg * n + ig
        h_new = torch.sigmoid(orr) * c_new / torch.clamp(n_new, min=1.0)
        return (c_new, n_new, m_new, h_new), h_new

    return step


def apply_slstm(cfg, p, ctx: cm.Ctx, h, chunk: int = 256,
                return_state: bool = False):
    bsz, l, d = h.shape
    _, nh, dh = slstm_dims(cfg)
    x = ctx.linear("slstm_in", h, p["w_in"]).to(_F32)
    xs = torch.movedim(x, 1, 0)                      # (L,B,4d)
    init = slstm_decode_init(cfg, bsz, h.device)
    step = _slstm_cell_step_factory(p, nh, dh)
    (c, n, m, hh), hs = _recurrent_over_chunks(
        step, (init["c"], init["n"], init["m"], init["h"]), (xs,), chunk)
    hs = torch.movedim(hs, 0, 1).reshape(bsz, l, d)
    out = ctx.linear("slstm_down", hs.to(h.dtype), p["down"])
    if return_state:
        return out, {"c": c, "n": n, "m": m, "h": hh}
    return out


def slstm_decode_init(cfg, batch: int, device):
    _, nh, dh = slstm_dims(cfg)
    z = torch.zeros((batch, nh, dh), dtype=_F32, device=device)
    return {"c": z, "n": z.clone(), "m": z - 1e30, "h": z.clone()}


def slstm_decode_step(cfg, p, ctx: cm.Ctx, h1, state):
    bsz = h1.shape[0]
    _, nh, dh = slstm_dims(cfg)
    x = ctx.linear("slstm_in", h1, p["w_in"]).to(_F32)[:, 0]
    step = _slstm_cell_step_factory(p, nh, dh)
    st = (state["c"], state["n"], state["m"], state["h"])
    (c, n, m, hh), h_out = step(st, (x,))
    out = ctx.linear("slstm_down",
                     h_out.reshape(bsz, 1, cfg.d_model).to(h1.dtype),
                     p["down"])
    return out, {"c": c, "n": n, "m": m, "h": hh}


# ---------------------------------------------------------------------------
# state size
# ---------------------------------------------------------------------------

RECURRENT = ("mamba", "mlstm", "slstm")


def block_state_init(cfg, btype: str, batch: int, device):
    """Decode state of one recurrent block type (no repeat axis)."""
    if btype == "mamba":
        return mamba_decode_init(cfg, batch, cfg.cdtype, device)
    if btype == "mlstm":
        return mlstm_decode_init(cfg, batch, device)
    if btype == "slstm":
        return slstm_decode_init(cfg, batch, device)
    raise ValueError(f"not a recurrent block type: {btype!r}")


def decode_state_bytes(cfg, btype: str) -> int:
    """Per-slot decode-state footprint (bytes) of one recurrent block.

    Unlike a KV cache this is O(1) in sequence length, which is why the
    serving pool keeps recurrent state slot-indexed while KV is paged:
    admission control charges a request pages for its KV but a flat
    per-slot quantum for conv/SSM state.  Multiply by ``cfg.n_repeats``
    (and pattern multiplicity) for the whole stack."""
    state = block_state_init(cfg, btype, 1, "meta")
    return sum(x.numel() * x.element_size() for x in state.values())
