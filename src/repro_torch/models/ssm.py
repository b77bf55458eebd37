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

Over a model-parallel mesh (``Ctx.mesh``, M ranks; the parameters this
rank's shards, ``launch.sharding.shard_params``) a block runs one of two
programs, chosen by its shapes (``splits_heads``):

* heads: each rank runs nh/M heads and keeps their states.  The fused
  projections are sharded segment by segment (``segments``: Mamba2's
  ``in_proj`` as [z_r | x_r | B_r | C_r | dt_r], its conv as [x_r | B_r |
  C_r], mLSTM's ``up`` as [xs_r | z_r]), so the input projections are
  column-parallel and the depthwise conv local.  Mamba2 all-gathers B and
  C after the conv (every head reads all of them) and all-reduces the
  gated RMSNorm's sum of squares both ways (``sum_over_model``).  mLSTM's
  q / k / v are row-parallel on xs_r, reduce-scattered onto the rank's
  heads; its gate product is row-parallel and all-reduced, each rank
  reading its heads' i and f columns.  sLSTM's ``w_in`` is head-major, so
  its contiguous column split is whole heads.  The replicated per-head
  leaves (``a_log``, ``d_skip``, ``dt_bias``, ``if_bias``, ``r``,
  ``bias``) pass Megatron's *f* and are sliced to the rank's heads, so
  their gradient sums the ranks' parts.
* gathered, where the heads (or Mamba2's state width) do not divide M:
  the block's projected inputs are gathered whole (column-parallel
  outputs all-gathered, row-parallel ones all-reduced), every rank runs
  every head, and the cell output passes *f* before the rank keeps its
  slice for the row-parallel out-projection: the gradient upstream of it
  is then whole and the same on every rank, as on one rank.

The out-projection is row-parallel in both.  Every collective sits
outside the recurrence over time, so a chunk's recompute under
``torch.utils.checkpoint`` issues none.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import collectives
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


# ---------------------------------------------------------------------------
# The model axis
# ---------------------------------------------------------------------------

def segments(cfg, btype: str, leaf: str):
    """(widths, group) of a fused projection leaf of a ``btype`` block, or
    None: ``widths`` are the segments side by side in its last dim, and
    where every width of ``group`` (the block's one decision for all its
    fused leaves) divides the model axis, a rank holds its 1/M of each
    segment in order (``launch/sharding.py``); else the leaf splits
    contiguously, as the reference's rules split it."""
    if btype == "mamba" and leaf in ("in_proj", "conv_w", "conv_b"):
        di, nh, _, n = mamba_dims(cfg)
        group = (di, di, n, n, nh)
        return (group if leaf == "in_proj" else (di, n, n)), group
    if btype == "mlstm" and leaf == "up":
        di = mlstm_dims(cfg)[0]
        return (di, di), (di, di)
    return None


def splits_heads(cfg, btype: str, m: int) -> bool:
    """Whether a ``btype`` block over ``m`` model ranks runs nh/m heads a
    rank (its head count, and Mamba2's state width, divide ``m``); else it
    takes the gathered path (module doc)."""
    if btype == "mamba":
        _, nh, _, n = mamba_dims(cfg)
        return nh % m == 0 and n % m == 0
    return cfg.n_heads % m == 0


@dataclasses.dataclass(frozen=True)
class _Shards:
    """How this rank runs one recurrent block: ``m`` model ranks, this
    rank's index ``r`` and the path, ``"heads"`` or ``"gathered"`` (None:
    one rank)."""
    m: int = 1
    r: int = 0
    path: Optional[str] = None
    mesh: Optional[object] = None

    @staticmethod
    def of(cfg, btype: str, mesh) -> "_Shards":
        m = collectives.model_size(mesh)
        if m == 1:
            return _Shards()
        path = "heads" if splits_heads(cfg, btype, m) else "gathered"
        return _Shards(m, collectives.index(mesh, "model"), path, mesh)

    @property
    def heads(self) -> bool:
        return self.path == "heads"

    def local(self, n: int) -> int:
        """This rank's part of a width split by heads."""
        return n // self.m if self.heads else n

    def head_slice(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's heads of a replicated per-head leaf (heads along
        ``dim``) on the heads path, its gradient summed over the ranks
        (*f*); the leaf itself otherwise."""
        if not self.heads:
            return x
        part = x.shape[dim] // self.m
        return collectives.copy_to_model(x, self.mesh).narrow(
            dim, self.r * part, part)

    def whole(self, x: torch.Tensor, full: int) -> torch.Tensor:
        """``x`` with its last dim whole on the gathered path: a sharded
        leaf or a column-parallel output all-gathered (its gradient, the
        same on every rank, sliced back)."""
        if self.path != "gathered" or x.shape[-1] == full:
            return x
        return collectives.gather_replicated(x, self.mesh)

    def project(self, ctx, tag, h, w, full: int) -> torch.Tensor:
        """An input projection of ``full`` output features: column-
        parallel where ``w`` is sharded (this rank's segments on the heads
        path, gathered whole on the gathered one)."""
        if self.path is None or w.shape[-1] == full:
            return ctx.linear(tag, h, w)
        return self.whole(ctx.linear(tag, h, w, parallel="column"), full)

    def rank_part(self, y: torch.Tensor, rows: int) -> torch.Tensor:
        """The features of the cell output ``y`` a row-parallel weight of
        ``rows`` rows reads on this rank: on the gathered path ``y`` is
        whole, passes *f* and this rank keeps its slice."""
        if y.shape[-1] == rows:
            return y
        y = collectives.copy_to_model(y, self.mesh)
        return y.narrow(-1, self.r * rows, rows)

    def out(self, ctx, tag, y, w, full: int) -> torch.Tensor:
        """The out-projection of the cell output ``y`` (``full`` rows
        whole): row-parallel where ``w`` is sharded."""
        if self.path is None or w.shape[0] == full:
            return ctx.linear(tag, y, w)
        return ctx.linear(tag, self.rank_part(y, w.shape[0]), w,
                          parallel="row")

    # Mamba2

    def mamba_dims(self, cfg):
        di, nh, hd, n = mamba_dims(cfg)
        return self.local(di), self.local(nh), hd, self.local(n)

    def mamba_leaves(self, cfg, p):
        """The Mamba2 leaves as this rank computes with them: the head
        leaves sliced on the heads path, the sharded conv and norm leaves
        whole on the gathered one."""
        if self.path is None:
            return p
        di, _, _, n = mamba_dims(cfg)
        q = dict(p)
        for name in ("a_log", "d_skip", "dt_bias"):
            q[name] = self.head_slice(p[name])
        for name, full in (("conv_w", di + 2 * n), ("conv_b", di + 2 * n),
                           ("norm_g", di)):
            q[name] = self.whole(p[name], full)
        return q

    def whole_bc(self, bmat, cmat):
        """B and C whole on the heads path: this rank's parts of both,
        all-gathered in one collective (backward: the ranks' partial
        gradients reduce-scattered)."""
        if not self.heads:
            return bmat, cmat
        n = bmat.shape[-1]
        bc = collectives.gather_from_model(torch.cat([bmat, cmat], -1),
                                           self.mesh)
        bc = bc.reshape(*bc.shape[:-1], self.m, 2, n)
        return (bc[..., 0, :].flatten(-2), bc[..., 1, :].flatten(-2))

    def rms_norm(self, y, gamma, eps):
        """RMSNorm over the whole inner width; on the heads path its sum
        of squares is all-reduced both ways over the ranks' features."""
        if not self.heads:
            return cm.rms_norm(y, gamma, eps)
        nrm = torch.linalg.vector_norm(y, dim=-1, keepdim=True,
                                       dtype=_F32)
        ms = collectives.sum_over_model(nrm * nrm, self.mesh) / (
            y.shape[-1] * self.m)
        inv = torch.rsqrt(ms + eps).to(y.dtype)
        return y * inv * gamma.to(y.dtype)


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
    sh = _Shards.of(cfg, "mamba", ctx.mesh)
    p = sh.mamba_leaves(cfg, p)
    di, nh, hd, n = sh.mamba_dims(cfg)
    proj = sh.project(ctx, "mamba_in", h, p["in_proj"],
                      sum(segments(cfg, "mamba", "in_proj")[0]))
    z, xbc_raw, dt_raw = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    xbc, conv_state = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc)
    x, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    bmat, cmat = sh.whole_bc(bmat, cmat)

    dt = F.softplus(dt_raw.to(_F32) + p["dt_bias"][None, None, :])
    a = -torch.exp(p["a_log"].to(_F32))
    xh = x.reshape(bsz, l, nh, hd).to(_F32)
    y, ssm_state = _ssd_chunked(xh, dt, a, bmat.to(_F32), cmat.to(_F32),
                                chunk)
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(bsz, l, di).to(h.dtype)
    y = sh.rms_norm(y, p["norm_g"], cfg.norm_eps) * F.silu(z)
    out = sh.out(ctx, "mamba_out", y, p["out_proj"], mamba_dims(cfg)[0])
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
    sh = _Shards.of(cfg, "mamba", ctx.mesh)
    p = sh.mamba_leaves(cfg, p)
    di, nh, hd, n = sh.mamba_dims(cfg)
    proj = sh.project(ctx, "mamba_in", h1, p["in_proj"],
                      sum(segments(cfg, "mamba", "in_proj")[0]))
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state["conv"])
    xbc = F.silu(xbc)
    x, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    bmat, cmat = sh.whole_bc(bmat, cmat)

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
    y = sh.rms_norm(y, p["norm_g"], cfg.norm_eps) * F.silu(z)
    out = sh.out(ctx, "mamba_out", y, p["out_proj"], mamba_dims(cfg)[0])
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


def _mlstm_inputs(cfg, p, ctx: cm.Ctx, sh: _Shards, h):
    """(q, k, v (B, L, H, dh), i_raw, f_raw (B, L, H) in f32, z) of this
    rank's H heads: on the heads path q / k / v are reduce-scattered onto
    the rank's heads and the gate product all-reduced (each rank reads its
    heads' i and f columns, so its gradient sums over the ranks); on the
    gathered path all of them are whole."""
    bsz, l, _ = h.shape
    di, nh, dh = mlstm_dims(cfg)
    sharded = sh.path is not None and p["up"].shape[-1] != 2 * di
    up = ctx.linear("mlstm_up", h, p["up"],
                    parallel="column" if sharded else None)
    if sharded and di % sh.m:
        up = sh.whole(up, 2 * di)       # not split [xs_r | z_r]
    xs, z = torch.chunk(up, 2, dim=-1)
    row = None
    if p["wq"].shape[0] != di:
        row = "row_scatter" if sh.heads else "row"
    hl = sh.local(nh)
    q, k, v = (ctx.linear(f"mlstm_{n}", xs, p[w], parallel=row).reshape(
        bsz, l, hl, dh) for n, w in (("q", "wq"), ("k", "wk"), ("v", "wv")))
    gif = ctx.linear("mlstm_if", xs, p["w_if"],
                     parallel="row" if row else None).to(_F32)
    gif = gif + p["if_bias"][None, None, :]
    if sh.heads:
        gif = collectives.copy_to_model(gif, sh.mesh).reshape(
            bsz, l, 2, nh).narrow(-1, sh.r * hl, hl).reshape(bsz, l, 2 * hl)
    i_raw, f_raw = torch.chunk(gif, 2, dim=-1)          # (B,L,H)
    return q, k, v, i_raw, f_raw, z


def apply_mlstm(cfg, p, ctx: cm.Ctx, h, chunk: int = 256,
                return_state: bool = False):
    bsz, l, d = h.shape
    di, nh, dh = mlstm_dims(cfg)
    sh = _Shards.of(cfg, "mlstm", ctx.mesh)
    q, k, v, i_raw, f_raw, z = _mlstm_inputs(cfg, p, ctx, sh, h)

    def to_seq(x):
        return torch.movedim(x.to(_F32), 1, 0)

    init = mlstm_decode_init(cfg, bsz, h.device, heads=q.shape[2])
    (cs, ns, ms), hs = _recurrent_over_chunks(
        _mlstm_scaled_step, (init["c"], init["n"], init["m"]),
        (to_seq(q), to_seq(k) / math.sqrt(dh), to_seq(v), to_seq(i_raw),
         -F.softplus(-to_seq(f_raw))), chunk)
    hs = torch.movedim(hs, 0, 1).reshape(bsz, l, -1)    # (B,L,H·dh)
    y = sh.rank_part(hs.to(h.dtype), z.shape[-1]) * F.silu(z)
    out = sh.out(ctx, "mlstm_down", y, p["down"], di)
    if return_state:
        return out, {"c": cs, "n": ns, "m": ms}
    return out


def mlstm_decode_init(cfg, batch: int, device, heads: Optional[int] = None):
    """The mLSTM state of ``heads`` heads (all by default)."""
    di, nh, dh = mlstm_dims(cfg)
    nh = nh if heads is None else heads
    return {"c": torch.zeros((batch, nh, dh, dh), dtype=_F32, device=device),
            "n": torch.zeros((batch, nh, dh), dtype=_F32, device=device),
            "m": torch.full((batch, nh), -1e30, dtype=_F32, device=device)}


def mlstm_decode_step(cfg, p, ctx: cm.Ctx, h1, state):
    bsz = h1.shape[0]
    di, nh, dh = mlstm_dims(cfg)
    sh = _Shards.of(cfg, "mlstm", ctx.mesh)
    q, k, v, i_raw, f_raw, z = _mlstm_inputs(cfg, p, ctx, sh, h1)
    st = (state["c"], state["n"], state["m"])
    (c, n, m), h_out = _mlstm_cell_step(
        st, (q[:, 0].to(_F32), k[:, 0].to(_F32), v[:, 0].to(_F32),
             i_raw[:, 0], f_raw[:, 0]))
    y = sh.rank_part(h_out.reshape(bsz, 1, -1).to(h1.dtype),
                     z.shape[-1]) * F.silu(z)
    out = sh.out(ctx, "mlstm_down", y, p["down"], di)
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


def _slstm_local(cfg, p, ctx: cm.Ctx, sh: _Shards, h):
    """(the input projection (B, L, 4·dh·H) in f32, the cell's leaves,
    H) for this rank's H heads: ``w_in`` is head-major, so its column
    split is whole heads; ``r`` and ``bias`` are sliced to them (*f*).
    On the gathered path the projection is gathered whole."""
    _, nh, dh = slstm_dims(cfg)
    x = sh.project(ctx, "slstm_in", h, p["w_in"], 4 * cfg.d_model)
    leaves = {"r": sh.head_slice(p["r"]),
              "bias": sh.head_slice(p["bias"].reshape(nh, 4 * dh)
                                    ).reshape(-1)}
    return x.to(_F32), leaves, sh.local(nh)


def apply_slstm(cfg, p, ctx: cm.Ctx, h, chunk: int = 256,
                return_state: bool = False):
    bsz, l, d = h.shape
    _, nh, dh = slstm_dims(cfg)
    sh = _Shards.of(cfg, "slstm", ctx.mesh)
    x, leaves, hl = _slstm_local(cfg, p, ctx, sh, h)
    xs = torch.movedim(x, 1, 0)                      # (L,B,4·dh·H)
    init = slstm_decode_init(cfg, bsz, h.device, heads=hl)
    step = _slstm_cell_step_factory(leaves, hl, dh)
    (c, n, m, hh), hs = _recurrent_over_chunks(
        step, (init["c"], init["n"], init["m"], init["h"]), (xs,), chunk)
    hs = torch.movedim(hs, 0, 1).reshape(bsz, l, hl * dh)
    out = sh.out(ctx, "slstm_down", hs.to(h.dtype), p["down"], d)
    if return_state:
        return out, {"c": c, "n": n, "m": m, "h": hh}
    return out


def slstm_decode_init(cfg, batch: int, device, heads: Optional[int] = None):
    """The sLSTM state of ``heads`` heads (all by default)."""
    _, nh, dh = slstm_dims(cfg)
    nh = nh if heads is None else heads
    z = torch.zeros((batch, nh, dh), dtype=_F32, device=device)
    return {"c": z, "n": z.clone(), "m": z - 1e30, "h": z.clone()}


def slstm_decode_step(cfg, p, ctx: cm.Ctx, h1, state):
    bsz = h1.shape[0]
    _, nh, dh = slstm_dims(cfg)
    sh = _Shards.of(cfg, "slstm", ctx.mesh)
    x, leaves, hl = _slstm_local(cfg, p, ctx, sh, h1)
    step = _slstm_cell_step_factory(leaves, hl, dh)
    st = (state["c"], state["n"], state["m"], state["h"])
    (c, n, m, hh), h_out = step(st, (x[:, 0],))
    out = sh.out(ctx, "slstm_down",
                 h_out.reshape(bsz, 1, hl * dh).to(h1.dtype), p["down"],
                 cfg.d_model)
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
