"""The plain reference: the configuration's language model in float32
torch, one sequence at a time, with no kernel, cache or batching, and
imports nothing of the program.

What it covers: the embedding, GQA attention with rotary positions and a
causal softmax (exact, every score formed), the squared-ReLU or SwiGLU
MLP, LayerNorm / RMSNorm, Mamba2 (causal depthwise conv, softplus step,
the SSD in the chunked "minimal" form of the Mamba2 paper, the D skip,
the gated RMSNorm), a shared attention block read by several layers,
the untied head and the next-token loss; and, for training, the WTA-CRS
weight gradient of every linear the estimator samples (``plans.py``).

``Arith("fp8")`` is the control: every product's operands rounded to
float8 e4m3 (a per-tensor scale to its largest magnitude), in the forward
and in both products of the backward, everything else as in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from reference.plans import (layer_key, linear_key, row_probabilities,
                              step_key, uniforms, wtacrs_plan)

F32 = torch.float32
_FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = torch.amax(torch.abs(x)).clamp(min=1e-30)
    s = amax / _FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class _MM8(torch.autograd.Function):
    """a @ b with every operand rounded to e4m3, both ways."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_fp8(a), _fp8(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = _fp8(g)
        return (torch.matmul(g8, _fp8(b).transpose(-1, -2)),
                torch.matmul(_fp8(a).transpose(-1, -2), g8))


class Arith:
    """The precision of every product: ``"f32"`` (TF32 off) or ``"fp8"``
    (the control)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def mm(self, a, b):
        if self.precision == "fp8":
            return _MM8.apply(a, b)
        return torch.matmul(a, b)

    def q(self, x):
        return _fp8(x) if self.precision == "fp8" else x


class _Sampled(torch.autograd.Function):
    """Linears reading one input x (S, d_in) through one plan: the outputs
    exact; dX exact; each dW = x[idx]ᵀ · (dZ[idx] · scale)."""

    @staticmethod
    def forward(ctx, x, idx, scale, arith, *ws):
        ctx.save_for_backward(x[idx], idx, scale, *ws)
        ctx.arith = arith
        return tuple(arith.q(x) @ arith.q(w) for w in ws)

    @staticmethod
    def backward(ctx, *dzs):
        xs, idx, scale, *ws = ctx.saved_tensors
        q = ctx.arith.q
        dx, dws = None, []
        for dz, w in zip(dzs, ws):
            d = q(dz) @ q(w).t()
            dx = d if dx is None else dx + d
            dws.append(q(xs).t() @ q(dz[idx] * scale[:, None]))
        return (dx, None, None, None, *dws)


class Seq:
    """What one sequence's sampled linears need: the step's seed, the
    sequence's row of the batch, the budget and the estimator."""

    def __init__(self, conf: Dict, cell: Dict, state_seed: int, step: int,
                 row: int, device, train: bool = True):
        self.period = len(conf["pattern"])
        self.key = step_key(state_seed, step)
        self.row, self.batch = row, cell["batch"]
        self.sampled = train and cell.get("estimator", "exact") != "exact"
        s = cell["seq"]
        self.k = max(8, int(round(cell.get("budget", 1.0) * s)))
        self.k = min(self.k, s)
        if self.k >= s:
            self.sampled = False
        self.device = device
        self._u: Dict[int, torch.Tensor] = {}

    def plan(self, layer: int, tags, x):
        key = linear_key(layer_key(self.key, layer, self.period), tags)
        if key not in self._u:
            self._u[key] = uniforms(key, self.batch, self.k, self.device)
        u = self._u[key][self.row]
        return wtacrs_plan(row_probabilities(x.detach()), self.k, u)


def linears(x, ws: List[torch.Tensor], seq: Optional[Seq], layer: int,
            tags, arith: Arith):
    """One group of linears on the same input (one plan when sampled)."""
    if seq is None or not seq.sampled:
        return [arith.mm(x, w) for w in ws]
    idx, scale = seq.plan(layer, tags, x)
    return list(_Sampled.apply(x, idx, scale, arith, *ws))


def norm(conf, p: Dict, prefix: str, x):
    eps = conf["norm_eps"]
    if conf["norm_type"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + eps) * p[prefix + "/gamma"] \
            + p[prefix + "/beta"]
    return rms(x, p[prefix + "/gamma"], eps)


def rms(x, g, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x, theta: float):
    """Rotary positions 0.. of x (S, H, Dh), halves rotated together."""
    s, _, dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=F32,
                                       device=x.device) / dh)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attention(q, k, v, arith: Arith, heads_at_once: int = 16):
    """Causal softmax attention: q (S, H, Dh), k / v (S, KVH, Dh), query
    head h reading kv head h // (H / KVH).  Returns (S, H·Dh)."""
    s, h, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    outs = []
    for h0 in range(0, h, heads_at_once):
        sl = slice(h0, h0 + heads_at_once)
        sc = arith.mm(q[:, sl].transpose(0, 1),
                      k[:, sl].permute(1, 2, 0)) / math.sqrt(dh)
        sc = sc.masked_fill(~mask, float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        outs.append(arith.mm(pr, v[:, sl].transpose(0, 1)))
    return torch.cat(outs, 0).transpose(0, 1).reshape(s, h * dh)


def attn_block(conf, p, pre: str, h, layer: int, seq, arith, kv=None):
    d_h = conf.get("d_head") or conf["d_model"] // conf["n_heads"]
    s = h.shape[0]
    x = norm(conf, p, pre + "/norm1", h)
    q, k, v = linears(x, [p[pre + "/attn/wq"], p[pre + "/attn/wk"],
                          p[pre + "/attn/wv"]], seq, layer,
                      _tags(conf, layer, ("attn_q", "attn_k", "attn_v")),
                      arith)
    q = rope(q.reshape(s, -1, d_h), conf["rope_theta"])
    k = rope(k.reshape(s, -1, d_h), conf["rope_theta"])
    v = v.reshape(s, -1, d_h)
    if kv is not None:
        kv.append((k.detach(), v.detach()))
    o = attention(q, k, v, arith)
    h = h + linears(o, [p[pre + "/attn/wo"]], seq, layer,
                    _tags(conf, layer, ("attn_o",)), arith)[0]
    x = norm(conf, p, pre + "/norm2", h)
    if conf["mlp_type"] == "swiglu":
        up, gate = linears(x, [p[pre + "/mlp/wi"], p[pre + "/mlp/wg"]], seq,
                           layer, _tags(conf, layer, ("mlp_wi", "mlp_wg")),
                           arith)
        z = F.silu(gate) * up
    else:
        up = linears(x, [p[pre + "/mlp/wi"]], seq, layer,
                     _tags(conf, layer, ("mlp_wi",)), arith)[0]
        z = torch.relu(up) ** 2
    return h + linears(z, [p[pre + "/mlp/wo"]], seq, layer,
                       _tags(conf, layer, ("mlp_wo",)), arith)[0]


def _tags(conf, layer: int, names):
    j = layer % len(conf["pattern"])
    return tuple(f"b{j}/{n}" for n in names)


def segsum(x):
    """x (..., T) -> (..., T, T): the sum of x over (s, t] below the
    diagonal, -inf above it."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd(xdt, adt, b, c, chunk: int):
    """The SSD (Mamba2) of one sequence: xdt (L, H, P) = x·dt, adt (L, H)
    = A·dt, b / c (L, N).  Returns y (L, H, P)."""
    ln, h, p = xdt.shape
    ch = min(chunk, ln)
    nc = ln // ch
    x = xdt.reshape(nc, ch, h, p)
    a = adt.reshape(nc, ch, h).permute(2, 0, 1)                 # (H,nc,c)
    b = b.reshape(nc, ch, -1)
    c = c.reshape(nc, ch, -1)
    acs = torch.cumsum(a, dim=-1)
    lmat = torch.exp(segsum(a))                                 # (H,nc,c,c)
    cb = torch.einsum("qtn,qsn->qts", c, b)
    y_diag = torch.einsum("hqts,qshp->qthp", cb[None] * lmat, x)
    decay = torch.exp(acs[..., -1:] - acs)                      # (H,nc,c)
    states = torch.einsum("qsn,qshp->qhpn", b,
                          x * decay.permute(1, 2, 0)[..., None])
    states = torch.cat([torch.zeros_like(states[:1]), states], 0)
    dchunk = torch.exp(segsum(F.pad(acs[..., -1], (1, 0))))    # (H,nc+1,nc+1)
    states = torch.einsum("hzq,qhpn->zhpn", dchunk, states)[:-1]
    y_off = torch.einsum("qtn,qhpn->qthp", c, states) \
        * torch.exp(acs).permute(1, 2, 0)[..., None]
    return (y_diag + y_off).reshape(ln, h, p)


def mamba_block(conf, p, pre: str, h, layer: int, seq, arith):
    d = conf["d_model"]
    di = conf["ssm_expand"] * d
    hp, n = conf["ssm_head_dim"], conf["ssm_state"]
    nh = di // hp
    ln = h.shape[0]
    x = norm(conf, p, pre + "/norm1", h)
    m = pre + "/mamba/"
    proj = linears(x, [p[m + "in_proj"]], seq, layer,
                   _tags(conf, layer, ("mamba_in",)), arith)[0]
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    w = p[m + "conv_w"]                                         # (K, C)
    kk = w.shape[0]
    xbc = F.conv1d(F.pad(xbc.t()[None], (kk - 1, 0)), w.t()[:, None, :],
                   p[m + "conv_b"], groups=w.shape[1])[0].t()
    xbc = F.silu(xbc)
    xs, bm, cm = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt + p[m + "dt_bias"])
    a = -torch.exp(p[m + "a_log"])
    xh = xs.reshape(ln, nh, hp)
    y = ssd(xh * dt[..., None], dt * a, bm, cm, conf.get("ssd_chunk", 256))
    y = (y + p[m + "d_skip"][:, None] * xh).reshape(ln, di)
    y = rms(y, p[m + "norm_g"], conf["norm_eps"]) * F.silu(z)
    return h + linears(y, [p[m + "out_proj"]], seq, layer,
                       _tags(conf, layer, ("mamba_out",)), arith)[0]


def hidden(conf, p, tokens, seq, arith, kv=None):
    """The final-normed hidden states of one sequence (S, D); ``kv``
    collects each attention layer's (k, v)."""
    h = p["embed"][tokens.long()]
    pattern = conf["pattern"]
    for i in range(conf["n_layers"]):
        btype = pattern[i % len(pattern)]
        if btype == "mamba":
            h = mamba_block(conf, p, f"layers/{i}", h, i, seq, arith)
        else:
            pre = "shared" if btype == "shared_attn" else f"layers/{i}"
            h = attn_block(conf, p, pre, h, i, seq, arith, kv)
    return norm(conf, p, "final_norm", h)


def head(conf, p):
    return p["embed"].t() if conf["tie_embeddings"] else p["head"]


def seq_loss(conf, p, tokens, labels, seq, arith, n_total: int):
    """This sequence's share of the batch's mean next-token loss."""
    logits = arith.mm(hidden(conf, p, tokens, seq, arith), head(conf, p))
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.long()[:, None])[:, 0]
    return nll.sum() / n_total


@torch.no_grad()
def prefill_seq(conf, p, tokens, arith):
    """(last position's logits (V,), [(k, v) of each attention layer])."""
    kv: List = []
    h = hidden(conf, p, tokens, None, arith, kv)
    return arith.mm(h[-1:], head(conf, p))[0], kv
