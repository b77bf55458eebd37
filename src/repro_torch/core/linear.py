"""WTA-CRS linear layer: exact forward, sub-sampled weight-gradient backward.

This implements the paper's core mechanism (Sec. 3.2, Algorithm 1):

    forward:   Z = H @ W                         (exact -> unbiased network)
    backward:  dH = dZ @ W^T                     (exact)
               dW = H'^T @ (dZ[idx] * scale)     (WTA-CRS estimate of H^T dZ)

Only the sub-sampled H' (k rows of H), the k indices and the k scales are
saved for the backward pass, instead of the full H.  This is where the
activation-memory reduction comes from.

Sampling is PER-SAMPLE — each batch element draws its own k = budget*S
column-row pairs over its S token rows; the contraction sum decomposes
over batch elements, each estimated unbiasedly.

The column-row distribution (Eq. 3) is p_i ∝ ||H_i,:|| * ||dZ_i,:||.  dZ
is unknown at forward time, so the caller may supply ``znorm`` — cached
per-token gradient-norm estimates from the previous step (Algorithm 1's
Cache).  The cached term enters the probabilities only when
``cfg.norm_source == NormSource.CACHED_GRAD``; with ``ACTIVATION_ONLY``
the supplied znorm is ignored for sampling but the *gradient-norm tap*
still flows: the gradient returned for ``znorm`` is the SQUARED per-token
norm of dZ rather than a true derivative (sampling probabilities are
treated as non-differentiable, exactly as in the paper).

Randomness: ``key`` is a plain integer seed.  The dispatch builds one
``torch.Generator`` on the activation's device from it, so the same key
gives the same plan (also on a recomputed forward) and different keys
give independent plans.  Tests may inject a ready ``plan=(idx, scale)``
instead, e.g. one built by the JAX reference.

On a CUDA tensor the row norms and the H' gather of the forward and the
dW of the backward go through the hand-written kernels
(``repro_torch.kernels.ops``); the large exact products stay
``torch.matmul``.

An MoE layer's experts run as one batched linear (``expert_linear``): the
(E, C, D) capacity slots of E experts against stacked (E, D, F) weights,
each expert's C slots sampled as G plans of C/G rows, and every expert's
dW from one launch of the ``fused_sampled_dw`` kernel's expert axis — the
counterpart of the reference's ``jax.vmap`` over its experts' sampled
linears (``repro/models/mlp.py::_expert_ffn``).

Rematerialisation (``Policy.remat="wtacrs_names"``) keeps exactly the
tensors the reference names ``wtacrs_saved`` — H', idx and scale — across
a layer's recompute: a :class:`RematStash` handed to the sampled linears
records them in the layer's forward and gives them back, in call order,
when the backward runs the layer again, so the recompute neither rebuilds
the plans nor gathers H' a second time.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import tracing
from repro_torch.core import estimator_registry as registry
from repro_torch.core import plans
from repro_torch.core.config import WTACRSConfig
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as kernel_ops

Plan = Tuple[torch.Tensor, torch.Tensor]     # (idx (B,k) int32, scale (B,k))


def _make_plans(h, znorm, gen, cfg: WTACRSConfig, k: int,
                norm_reduce=None) -> Plan:
    """Per-sample plans.  h: (B,S,D), znorm: (B,S) -> idx/scale (B,k).

    Dispatches to the registered plan function for ``cfg.kind``.  The
    znorm term enters the probabilities only under CACHED_GRAD.  All-zero
    rows fall back to the uniform distribution.  ``norm_reduce``: see
    ``plans.batched_row_weights`` (a feature-sharded H).
    """
    weights = plans.batched_row_weights(h, znorm, cfg,
                                        norm_reduce)          # (B, S)
    p = plans.normalize_weights(weights)
    plan = plans.build_batched_plans(p, k, gen, cfg)
    return plan.idx, plan.scale


@functools.lru_cache(maxsize=32)
def _unit_scale(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """One read-only f32 tensor of ones per plan shape and device, so a
    step's H' gathers allocate and fill no scale of their own."""
    return torch.ones(shape, dtype=torch.float32, device=device)


def _rowgather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, S, D)[B, k] -> (B, k, D): H' through the ``gather_scale``
    kernel at unit scale (x * 1.0f in f32 rounds back exactly, so H' is
    the plain row gather bit for bit)."""
    return kernel_ops.gather_scale(x.contiguous(), idx,
                                   _unit_scale(tuple(idx.shape), x.device))


def _sampled_dw(h_sub, dz, idx, scale, cfg: WTACRSConfig, out_dtype):
    """dW = sum_b H'_b^T @ (dZ_b[idx_b] * scale_b): one launch of the
    fused kernel, f32 out, cast to the (compute-dtype) weight's dtype.
    Its tile: ``cfg.kernel.dw_tile``, else the entry of
    ``cfg.kernel.table_path``'s tuning table for the shape, else the shape
    rule (``autotune.tile_for``).  With a leading expert axis on every
    operand, each expert's dW in the same one launch, its tile pinned or
    the shape rule's (the table's key has no expert count)."""
    tile = autotune.tile_for(cfg.kernel, "fused_sampled_dw", h_sub, dz)
    with tracing.span("dw"):
        dw = kernel_ops.fused_sampled_dw(h_sub, dz, idx, scale, tile=tile)
    return dw.to(out_dtype)


class RematStash:
    """(H', idx, scale) of every sampled linear of one layer, in call
    order.  A recording stash (``RematStash()``) keeps them as the layer's
    forward makes them; a replaying one (``RematStash(saved)``, the flat
    list ``tensors()`` gave) hands them back to the recompute."""

    def __init__(self, saved=None):
        self.replay = saved is not None
        flat = list(saved) if saved is not None else []
        self.kept = [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]
        self._next = 0

    def keep(self, h_sub, idx, scale) -> None:
        self.kept.append((h_sub, idx, scale))

    def take(self):
        if self._next >= len(self.kept):
            raise RuntimeError("the recompute ran more sampled linears than "
                               "the forward recorded")
        self._next += 1
        return self.kept[self._next - 1]

    def tensors(self) -> list:
        return [t for triple in self.kept for t in triple]


def _kept(h, znorm, cfg, gen, plan, stash, norm_reduce=None):
    """(H', idx, scale) of a sampled linear: built from ``h`` (and kept in
    a recording ``stash``), or taken from a replaying one."""
    if stash is not None and stash.replay:
        return stash.take()
    k = cfg.budget_rows(h.shape[1])
    if plan is None:
        with tracing.span("plan"):
            plan = _make_plans(h, znorm, gen, cfg, k, norm_reduce)
    idx, scale = plan
    with tracing.span("gather"):
        h_sub = _rowgather(h, idx)
    if stash is not None:
        stash.keep(h_sub, idx, scale)
    return h_sub, idx, scale


def _sq_norm_tap(dz):
    # Gradient-norm tap: NOT a derivative (see module doc).  Squared norms
    # so per-sample caches broadcast over positions sum correctly.
    return torch.linalg.vector_norm(dz, dim=-1, dtype=torch.float32) ** 2


class _SampledLinear(torch.autograd.Function):
    """(B, S, D) x (D, E) with a per-sample plan; saves (H', idx, scale, w)."""

    @staticmethod
    def forward(ctx, h, w, znorm, cfg, gen, plan, stash, norm_reduce):
        z = torch.matmul(h, w)
        ctx.save_for_backward(*_kept(h, znorm, cfg, gen, plan, stash,
                                     norm_reduce), w)
        ctx.cfg, ctx.span = cfg, tracing.current()
        return z

    @staticmethod
    def backward(ctx, dz):
        h_sub, idx, scale, w = ctx.saved_tensors
        tap = None
        with tracing.span("linear.bwd", ctx.span):
            dz = dz.contiguous()
            with tracing.span("dx"):
                dh = torch.matmul(dz, w.t()).to(h_sub.dtype)
            dw = _sampled_dw(h_sub, dz, idx, scale, ctx.cfg, w.dtype)
            if ctx.needs_input_grad[2]:
                with tracing.span("tap"):
                    tap = _sq_norm_tap(dz)
        return dh, dw, tap, None, None, None, None, None


class _SampledLinearShared(torch.autograd.Function):
    """Several weights consuming the SAME activation (q/k/v, SwiGLU wi/wg)
    share one plan and ONE stored H'.  Beyond-paper memory optimization:
    sharing cuts attention-input residuals 3x and gated-MLP 2x at
    identical unbiasedness (each dW_i is the Eq. 6 estimator under the
    same, valid plan; only the variance coupling across the estimates
    changes, not any mean)."""

    @staticmethod
    def forward(ctx, h, znorm, cfg, gen, plan, stash, *ws):
        zs = tuple(torch.matmul(h, w) for w in ws)
        ctx.save_for_backward(*_kept(h, znorm, cfg, gen, plan, stash), *ws)
        ctx.cfg, ctx.span = cfg, tracing.current()
        return zs

    @staticmethod
    def backward(ctx, *dzs):
        h_sub, idx, scale, *ws = ctx.saved_tensors
        dh = None
        tap = None
        dws = []
        with tracing.span("linear.bwd", ctx.span):
            for dz, w in zip(dzs, ws):
                dz = dz.contiguous()
                with tracing.span("dx"):
                    d = torch.matmul(dz, w.t())
                    dh = d if dh is None else dh + d
                dws.append(_sampled_dw(h_sub, dz, idx, scale, ctx.cfg,
                                       ws[0].dtype))
                if ctx.needs_input_grad[1]:
                    with tracing.span("tap"):
                        t = _sq_norm_tap(dz)
                        tap = t if tap is None else tap + t
            dh = dh.to(h_sub.dtype)
        return (dh, tap, None, None, None, None, *dws)


# ---------------------------------------------------------------------------
# Unified internal dispatch + thin public wrappers
# ---------------------------------------------------------------------------

def generator(device: torch.device, key: int) -> torch.Generator:
    """A generator seeded with ``key`` on ``device``; on ``meta`` (the dry
    run, where no draw is ever read) a CPU one."""
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(int(key))
    return gen


def _dispatch_sampled_dense(h: torch.Tensor, ws: Sequence[torch.Tensor],
                            key: Optional[int],
                            znorm: Optional[torch.Tensor],
                            cfg: WTACRSConfig,
                            biases: Optional[Sequence] = None,
                            shared: bool = False,
                            plan: Optional[Plan] = None,
                            stash: Optional[RematStash] = None,
                            norm_reduce=None
                            ) -> Tuple[torch.Tensor, ...]:
    """The single sampled-dense path every public wrapper routes through.

    Handles: leading-dim reshape to (B, S, D), the exact short-circuit
    (EXACT kind or budget covering all rows), znorm normalization, key
    requirements from the registered estimator's signature, and the
    shared-plan vs per-weight choice.  Returns one output per weight.
    ``stash``: see :class:`RematStash`; ``norm_reduce``: see
    ``plans.batched_row_weights``.
    """
    with tracing.span("linear"):
        lead = h.shape[:-1]
        squeeze = h.ndim == 2
        h3 = h[None] if squeeze else h.reshape((-1,) + h.shape[-2:])
        b, s = h3.shape[0], h3.shape[1]

        if cfg.is_exact or cfg.budget_rows(s) >= s:
            zs = tuple(torch.matmul(h, w) for w in ws)
        else:
            spec = registry.get_estimator(cfg.kind)
            gen = None
            if plan is None and spec.needs_key:
                if key is None:
                    raise ValueError(
                        f"estimator {cfg.kind_name!r} requires a key")
                gen = generator(h.device, key)
            if plan is not None:
                k = cfg.budget_rows(s)
                idx, scale = plan
                if tuple(idx.shape) != (b, k) or tuple(scale.shape) != (b, k):
                    raise ValueError(
                        f"injected plan must be ({b}, {k}), got "
                        f"{tuple(idx.shape)} / {tuple(scale.shape)}")
                plan = (idx.to(torch.int32).contiguous(),
                        scale.to(torch.float32).contiguous())
            # Without a caller's znorm there is nobody to read the tap: the
            # placeholder carries no grad and the backward skips the tap.
            zn = (torch.ones((b, s), dtype=torch.float32, device=h.device)
                  if znorm is None
                  else znorm.reshape(b, s).to(torch.float32))
            if shared and len(ws) > 1:
                if not spec.supports_shared:
                    raise ValueError(f"estimator {cfg.kind_name!r} does not "
                                     f"support shared plans")
                if norm_reduce is not None:
                    raise ValueError("a shared plan is column-parallel: its "
                                     "H is replicated")
                z3s = _SampledLinearShared.apply(h3, zn, cfg, gen, plan, stash,
                                                 *ws)
            else:
                z3s = tuple(_SampledLinear.apply(h3, w, zn, cfg, gen, plan,
                                                 stash, norm_reduce)
                            for w in ws)
            zs = tuple(z[0] if squeeze else z.reshape(lead + (z.shape[-1],))
                       for z in z3s)

        if biases is not None:
            zs = tuple(z if bias is None else z + bias
                       for z, bias in zip(zs, biases))
    return zs


def wtacrs_linear(h: torch.Tensor, w: torch.Tensor,
                  key: Optional[int] = None,
                  znorm: Optional[torch.Tensor] = None,
                  cfg: WTACRSConfig = WTACRSConfig(),
                  bias: Optional[torch.Tensor] = None,
                  plan: Optional[Plan] = None,
                  stash: Optional[RematStash] = None,
                  norm_reduce=None) -> torch.Tensor:
    """Linear layer with estimator-approximated weight gradient.

    Args:
      h: activations (..., S, d_in); sampling happens over S per leading
        index.  2-D inputs (n, d_in) are treated as one sample of n rows.
      w: weight (d_in, d_out).
      key: integer seed for the sampling plans (not needed for estimators
        whose registry entry declares ``needs_key=False``, e.g.
        EXACT/DET_TOPK, nor with ``plan``).
      znorm: gradient-norm estimates, shape h.shape[:-1]; consulted for
        sampling only under ``NormSource.CACHED_GRAD``, but the
        gradient-norm tap always flows back through this argument (give
        it ``requires_grad=True`` and read ``znorm.grad``).
      cfg: estimator configuration.
      bias: optional (d_out,), added exactly.
      plan: optional ready (idx, scale) of shape (B, k) used instead of
        building one.
      stash: a :class:`RematStash` recording or replaying the kept
        tensors (layer rematerialisation).
      norm_reduce: for an H sharded on its features (a row-parallel
        weight), the all-reduce of the rows' partial squared norms, so
        every rank draws the plan of the whole rows.
    """
    return _dispatch_sampled_dense(h, (w,), key, znorm, cfg,
                                   biases=(bias,), plan=plan,
                                   stash=stash, norm_reduce=norm_reduce)[0]


def wtacrs_linear_shared(h: torch.Tensor, ws, key: Optional[int] = None,
                         znorm=None, cfg: WTACRSConfig = WTACRSConfig(),
                         biases=None, plan: Optional[Plan] = None,
                         stash: Optional[RematStash] = None):
    """Shared-plan multi-linear: returns one output per weight in ``ws``.

    h: (..., S, d_in); every w: (d_in, d_out_i).  One plan and ONE stored
    H' serve all weights (see ``_SampledLinearShared``)."""
    return _dispatch_sampled_dense(h, tuple(ws), key, znorm, cfg,
                                   biases=biases, shared=True, plan=plan,
                                   stash=stash)


# ---------------------------------------------------------------------------
# Expert-batched sampled linear (MoE)
# ---------------------------------------------------------------------------

class _ExpertSampledLinear(torch.autograd.Function):
    """E experts' linears in one: h (E, C, D) by stacked weights
    (E, D, F_i), one output (E, C, F_i) per weight.  Each expert's C rows
    are ``groups`` samples of C/G rows with a plan each (E·G plans from
    one batched build); several weights share the plans and ONE stored H'
    (an expert's wi/wg, as ``_SampledLinearShared``).  Saves (H', idx,
    scale) and the weights; the backward's dW of every expert is one
    launch of ``fused_sampled_dw`` over the expert axis a weight.  No
    gradient-norm tap: the reference caches none for the experts."""

    @staticmethod
    def forward(ctx, h, cfg, gen, groups, stash, *ws):
        zs = tuple(torch.bmm(h, w) for w in ws)
        e, c, d = h.shape
        samples = h.reshape(e * groups, c // groups, d)
        ctx.save_for_backward(*_kept(samples, None, cfg, gen, None, stash),
                              *ws)
        ctx.cfg, ctx.groups = cfg, groups
        return zs

    @staticmethod
    def backward(ctx, *dzs):
        h_sub, idx, scale, *ws = ctx.saved_tensors
        e, g, k = ws[0].shape[0], ctx.groups, idx.shape[-1]
        dh, dws = None, []
        for dz, w in zip(dzs, ws):
            dz = dz.contiguous()
            d = torch.bmm(dz, w.transpose(1, 2))
            dh = d if dh is None else dh + d
            dws.append(_sampled_dw(
                h_sub.view(e, g, k, h_sub.shape[-1]),
                dz.view(e, g, dz.shape[1] // g, dz.shape[2]),
                idx.view(e, g, k), scale.view(e, g, k), ctx.cfg, w.dtype))
        return (dh.to(h_sub.dtype), None, None, None, None, *dws)


def expert_linear(h: torch.Tensor, ws, key: Optional[int],
                  cfg: WTACRSConfig = WTACRSConfig(), groups: int = 1,
                  stash: Optional[RematStash] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """Every expert's linear at once, estimator-approximated weight
    gradients: h (E, C, D), every w (E, D, F_i) -> one (E, C, F_i) a
    weight.  The forward is exact (``torch.bmm``); each expert's C rows
    are sampled as ``groups`` plans of C/G rows (C % groups == 0) and
    several weights share them (``_ExpertSampledLinear``).  As for a
    dense linear, the EXACT kind or a budget covering all C/G rows runs
    the plain products.  ``key`` seeds one ``torch.Generator`` that draws
    all E·G plans in one batched build (independent rows of one draw)."""
    e, c, _ = h.shape
    if c % groups:
        raise ValueError(f"{c} capacity slots do not split into {groups} "
                         f"sampling groups")
    rows = c // groups
    if cfg.is_exact or cfg.budget_rows(rows) >= rows:
        return tuple(torch.bmm(h, w) for w in ws)
    spec = registry.get_estimator(cfg.kind)
    if len(ws) > 1 and not spec.supports_shared:
        raise ValueError(f"estimator {cfg.kind_name!r} does not support "
                         f"shared plans")
    gen = None
    if spec.needs_key:
        if key is None:
            raise ValueError(f"estimator {cfg.kind_name!r} requires a key")
        gen = generator(h.device, key)
    return _ExpertSampledLinear.apply(h, cfg, gen, groups, stash, *ws)


def read_grad_norm_tap(grads_znorm: torch.Tensor) -> torch.Tensor:
    """Convert tap gradients (squared norms) into gradient norms."""
    return torch.sqrt(torch.clamp(grads_znorm, min=0.0))
