"""Common model substrate: norms, rotary embeddings, and the WTA-CRS
linear context threaded through every block.

Parameters are plain nested dicts of tensors (see ``models/lm.py`` for
the tree); weights are stored (d_in, d_out) as in the reference.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import estimator_registry as est_registry
from repro_torch.core.config import EstimatorKind, WTACRSConfig
from repro_torch.core.linear import (RematStash, wtacrs_linear,
                                     wtacrs_linear_shared)
from repro_torch.core.lora import (LoRAConfig, lora_linear,
                                   lora_linear_parallel)
from repro_torch.core.policy import PolicyRules
from repro_torch.core.seeds import fold_seed  # noqa: F401  (re-exported)
from repro_torch.launch import collectives


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, device, scale=None):
    """Normal(0, scale^2), scale = 1/sqrt(fan_in) by default — the
    reference's distribution (not its random stream)."""
    if scale is None:
        scale = 1.0 / shape[0] ** 0.5
    v = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (v * scale).to(dtype)



def init_norm(cfg, dtype, device):
    p = {"gamma": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["beta"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def _mean_sq(x: torch.Tensor) -> torch.Tensor:
    # f32-accumulated mean of squares without keeping an f32 copy of x
    # for the backward (vector_norm converts on the fly)
    nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True,
                                   dtype=torch.float32)
    return nrm * nrm / x.shape[-1]


def rms_norm(x, gamma, eps: float):
    inv = torch.rsqrt(_mean_sq(x) + eps).to(x.dtype)
    return x * inv * gamma.to(x.dtype)


def layer_norm(x, gamma, beta, eps: float):
    mu = torch.sum(x, dim=-1, keepdim=True, dtype=torch.float32) / x.shape[-1]
    xc = x - mu.to(x.dtype)
    inv = torch.rsqrt(_mean_sq(xc) + eps).to(x.dtype)
    return xc * inv * gamma.to(x.dtype) + beta.to(x.dtype)


def apply_norm(cfg, p, x):
    if "beta" in p:
        return layer_norm(x, p["gamma"], p["beta"], cfg.norm_eps)
    return rms_norm(x, p["gamma"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                       # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) integer."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (B,S,Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions3 (3, B, S) = (t, h, w) ids.

    The head_dim/2 frequency slots are split into three contiguous
    sections (temporal, height, width; (32, 16, 16) at head_dim 128), each
    rotated by its own position stream (arXiv:2409.12191); angles and the
    rotation in f32, rounded once to x's dtype."""
    half = x.shape[-1] // 2
    if sections is None:
        t = half // 2
        hw = (half - t) // 2
        sections = (t, hw, half - t - hw)
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)][:half], dtype=torch.int64,
                          device=x.device)                   # (half,)
    # the position stream of each slot: (half, B, S) -> (B, S, half)
    pos = positions3.to(torch.float32)[sec_id].permute(1, 2, 0)
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# The per-forward context: policy + seed + gradient-norm cache plumbing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Policy:
    """What estimator applies to this forward pass.

    ``wtacrs`` is the network-wide default estimator config; ``lora``
    the LoRA wrapper a ``Ctx.linear(..., lora=)`` call takes when
    enabled.  ``rules``
    (optional) layers per-tag overrides and budget schedules on top:
    every ``Ctx.linear`` resolves its fully-prefixed tag through
    ``config_for``.  ``step`` is the concrete trainer step the rules'
    budget schedules resolve against.  ``rule_budgets`` pins one budget
    per rule (aligned with ``rules.rules``, ``None`` = unpinned).
    ``remat`` rematerialises each layer in the backward: ``"none"``
    stores every activation, ``"full"`` only the layer's input (the
    recompute rebuilds the plans), ``"wtacrs_names"`` the layer's input
    and the sampled linears' kept tensors (H', idx, scale), which the
    recompute reuses.  ``flash_block`` / ``flash_mode`` set the attention
    block size and whether the causal upper triangle of block pairs is
    skipped (``triangular``) or masked (``full``).  ``moe_groups`` splits
    an MoE layer's tokens into dispatch groups and each expert's capacity
    slots into as many sampling plans (``models/mlp.py``).
    """
    wtacrs: WTACRSConfig = WTACRSConfig(kind=EstimatorKind.EXACT)
    lora: LoRAConfig = LoRAConfig()
    rules: Optional[PolicyRules] = None
    step: int = 0
    rule_budgets: Optional[Tuple[Optional[float], ...]] = None
    remat: str = "none"            # none | full | wtacrs_names
    flash_block: int = 512
    flash_mode: str = "full"       # full | triangular
    # the reference's MoE dispatch sharding constraint (expert axis,
    # capacity axes), as its optimized dry run sets it.  The port's
    # program is explicit: a model-parallel mesh's ranks each hold E/M
    # experts, and moe_groups (the data ranks there) splits the capacity
    # into group-local dispatch; the spec itself is carried, not read.
    moe_pspec: Optional[Tuple] = None
    # WTA-CRS sampling groups over the expert capacity dim (and the token
    # groups of the dispatch): each expert draws moe_groups plans
    moe_groups: int = 1

    def __post_init__(self):
        if self.moe_groups < 1:
            raise ValueError(f"moe_groups must be >= 1, got "
                             f"{self.moe_groups}")

    def config_for(self, tag: str) -> WTACRSConfig:
        """Estimator config for one fully-prefixed linear tag."""
        if self.rules is None:
            return self.wtacrs
        return self.rules.resolve(tag, step=self.step,
                                  fallback=self.wtacrs,
                                  rule_budgets=self.rule_budgets)

    def at_step(self, step: int) -> "Policy":
        """Resolve budget schedules against a concrete trainer step."""
        return dataclasses.replace(self, step=int(step))

    def with_rule_budgets(self, budgets) -> "Policy":
        """Pin per-rule budgets (controller decisions resolved by the training loop)."""
        budgets = None if budgets is None else tuple(budgets)
        return dataclasses.replace(self, rule_budgets=budgets)

    def with_kernel(self, kernel) -> "Policy":
        """Apply one :class:`~repro_torch.core.kernel_config.KernelConfig`
        to every estimator config this policy can resolve to: the default
        ``wtacrs``, the rules' ``default``, and each rule's explicit
        config.  A rule without a config inherits the converted fallback.
        This is how ``RunSpec.kernel`` threads one kernel decision through
        the whole policy."""
        wtacrs = self.wtacrs.with_kernel(kernel)
        rules = self.rules
        if rules is not None:
            new_rules = tuple(
                r if r.config is None else dataclasses.replace(
                    r, config=r.config.with_kernel(kernel))
                for r in rules.rules)
            default = (None if rules.default is None
                       else rules.default.with_kernel(kernel))
            rules = dataclasses.replace(rules, rules=new_rules,
                                        default=default)
        return dataclasses.replace(self, wtacrs=wtacrs, rules=rules)

    def schedule_signature(self) -> Tuple[float, ...]:
        """Changes exactly when a schedule crosses a plateau boundary or
        a pinned budget changes (empty for static policies)."""
        if self.rules is None:
            return ()
        return self.rules.schedule_signature(self.step,
                                             rule_budgets=self.rule_budgets,
                                             fallback=self.wtacrs)


def _tag_seed(tag: str) -> int:
    return zlib.crc32(tag.encode()) & 0x7FFFFFFF


# Sampled-dimension tag metadata.  A linear whose input is (..., S, D)
# draws one plan per leading index over the S (token) dim; a 2-D input
# (N, D) is a single flattened sample over all N rows.  Consumers that
# assume per-dataset-sample structure (the znorm cache) must check it.
SAMPLED_DIM_TOKEN = "token"   # per-sample plans over the token dim
SAMPLED_DIM_ROWS = "rows"     # one plan over all (flattened) rows


class tag_recorder:
    """Records every ``Ctx.linear`` tag of the contexts it is handed to,
    in call order; ``.dims`` maps each recorded tag to its sampled
    dimension (SAMPLED_DIM_*), and ``.calls`` holds the tags of every
    ``Ctx.linear`` / ``Ctx.linear_shared`` call, one tuple a call, repeats
    included.  ``.expert_calls`` holds one ``(tag, weights_per_plan)`` for
    every MoE expert FFN (``models/mlp.py::_expert_ffn``: the experts'
    ``<prefix>moe_expert`` plans, not ``Ctx.linear`` tags, so they stay out
    of ``.tags``).  Pass the recorder as ``Ctx(recorder=...)`` — there is
    no module-level sink."""

    def __init__(self):
        self.tags: list = []
        self.dims: Dict[str, str] = {}
        self.calls: list = []
        self.expert_calls: list = []

    def record(self, tag: str, sampled_dim: str) -> None:
        if tag not in self.tags:
            self.tags.append(tag)
        prev = self.dims.setdefault(tag, sampled_dim)
        if prev != sampled_dim:
            raise ValueError(
                f"linear tag {tag!r} sampled over {sampled_dim!r} but "
                f"was previously recorded sampling over {prev!r}; one "
                f"tag must sample one dimension")


@dataclasses.dataclass
class Ctx:
    """Threaded through blocks; routes every linear through the policy.

    ``key`` is an integer seed (``None`` = no randomness available: only
    keyless estimators can run).  znorms maps linear tags -> per-token
    gradient-norm estimates with the token shape of the current
    activation (e.g. (B, S)).  Missing tag -> activation-only
    probabilities.  ``stash`` records or replays the sampled linears'
    kept tensors while a layer is rematerialised (``RematStash``).

    ``mesh``: a mesh whose ``model`` axis holds several ranks (tensor and
    expert parallelism; None runs the one-rank program).  The parameters
    are then this rank's shards, and ``linear`` / ``linear_shared`` take
    a ``parallel`` argument: ``"column"`` for a weight sharded on its
    output features (its replicated input passes Megatron's *f*, and so
    does the znorm whose tap then all-reduces, as squares, over
    ``model``), ``"row"`` for one sharded on its input features (the
    plan's row norms are the square roots of the all-reduced partial
    squares, and the output passes *g* before the bias), ``"row_scatter"``
    for a row-parallel one whose output each rank reads only its slice of
    (the partial sums reduce-scattered onto the last dim).  Every model
    rank draws the same plan: the same seed from the same norms.
    """
    policy: Policy
    key: Optional[int] = None
    znorms: Optional[Dict[str, torch.Tensor]] = None
    recorder: Optional[tag_recorder] = None
    compute_dtype: Optional[torch.dtype] = None   # weights cast at use
    tag_prefix: str = ""                          # disambiguates positions
    stash: Optional[RematStash] = None
    mesh: Optional[object] = None

    def _key_for(self, tag: str) -> Optional[int]:
        if self.key is None:
            return None
        return fold_seed(self.key, _tag_seed(tag))

    def _record_call(self, tags, h) -> None:
        if self.recorder is not None:
            for tag in tags:
                self.recorder.record(tag, SAMPLED_DIM_TOKEN if h.ndim >= 3
                                     else SAMPLED_DIM_ROWS)
            self.recorder.calls.append(tuple(tags))

    def _znorm_for(self, tag: str, h):
        if self.znorms is None or tag not in self.znorms:
            return None
        zn = self.znorms[tag]
        lead = h.shape[:-1]
        if zn.shape != lead:   # broadcast per-sample cache over positions
            zn = zn.reshape(zn.shape + (1,) * (len(lead) - zn.ndim)
                            ).expand(lead)
        return zn

    def _cast(self, t):
        if t is None or self.compute_dtype is None:
            return t
        return t.to(self.compute_dtype)

    def linear(self, tag: str, h, w, bias=None, lora=None, parallel=None):
        """Estimator (+optionally LoRA) linear.  The estimator config is
        resolved per fully-prefixed tag through ``Policy.config_for``.
        ``lora``: ``{"lora_a", "lora_b"}`` adapter parameters, used when
        ``policy.lora.enabled`` (W frozen, only ``h @ A`` sampled; with
        ``parallel``, this rank's shards of them, split as their weight
        is: ``core.lora.lora_linear_parallel``).
        ``parallel``: ``None``, ``"column"``, ``"row"`` or
        ``"row_scatter"`` (see the class doc; ignored without a
        model-parallel mesh)."""
        tag = self.tag_prefix + tag
        self._record_call((tag,), h)
        cfg = self.policy.config_for(tag)
        w, bias = self._cast(w), self._cast(bias)
        zn = self._znorm_for(tag, h)
        if self.mesh is None:
            parallel = None
        if lora is not None and self.policy.lora.enabled:
            if parallel is not None:
                return lora_linear_parallel(
                    h, w, lora["lora_a"], lora["lora_b"], self.policy.lora,
                    parallel, self.mesh, key=self._key_for(tag), znorm=zn,
                    cfg=cfg, bias=bias)
            return lora_linear(h, w, lora["lora_a"], lora["lora_b"],
                               self.policy.lora, key=self._key_for(tag),
                               znorm=zn, cfg=cfg, bias=bias)
        if parallel == "column":
            h = collectives.copy_to_model(h, self.mesh)
            zn = collectives.copy_to_model(zn, self.mesh)
        elif parallel in ("row", "row_scatter"):
            z = wtacrs_linear(h, w, key=self._key_for(tag), znorm=zn,
                              cfg=cfg, stash=self.stash,
                              norm_reduce=self._norm_reduce)
            if parallel == "row_scatter":
                z = collectives.scatter_to_model(z, self.mesh)
            else:
                z = collectives.reduce_from_model(z, self.mesh)
            return z if bias is None else z + bias
        elif parallel is not None:
            raise ValueError(f"parallel must be None, 'column', 'row' or "
                             f"'row_scatter', got {parallel!r}")
        return wtacrs_linear(h, w, key=self._key_for(tag), znorm=zn,
                             cfg=cfg, bias=bias, stash=self.stash)

    def _norm_reduce(self, sq):
        return collectives.all_reduce(sq, self.mesh, "model")

    def linear_shared(self, tags, h, ws, biases=None, parallel=None):
        """Shared-plan multi-linear (one stored H' for all of ``ws``).

        Per-tag resolution: sharing a plan requires all tags to resolve
        to the SAME config whose estimator supports shared plans; when
        rules split the group (e.g. attn_q sampled, attn_k exact) each
        weight falls back to its own independent linear.  Fallback and
        shared keys fold the PREFIXED tags, so plans never correlate
        across blocks.

        ``parallel``: one entry a weight, ``"column"`` or ``None`` (a
        replicated weight; see the class doc).  On a model-parallel mesh
        the column-parallel weights read *f* of ``h`` (and of the
        znorms) and the replicated ones ``h`` itself, each set through
        one call drawing the same plan from the same key; the shared tap
        sums both."""
        full_tags = [self.tag_prefix + t for t in tags]
        self._record_call(full_tags, h)
        if self.mesh is None or parallel is None:
            parallel = (None,) * len(ws)
        cfgs = [self.policy.config_for(t) for t in full_tags]
        split = len(plan_groups(self.policy, full_tags,
                                keyed=self.key is not None)) > 1
        key = self._key_for("+".join(full_tags))
        outs = [None] * len(ws)
        for column in (True, False):
            idx = [i for i, p in enumerate(parallel)
                   if (p == "column") == column]
            if not idx:
                continue
            f = ((lambda x: collectives.copy_to_model(x, self.mesh))
                 if column else (lambda x: x))
            hs = f(h)
            wl = [self._cast(ws[i]) for i in idx]
            bs = (None if biases is None
                  else [self._cast(biases[i]) for i in idx])
            if split:             # each weight its own linear and znorm
                got = [wtacrs_linear(
                    hs, w, key=self._key_for(full_tags[i]),
                    znorm=f(self._znorm_for(full_tags[i], h)), cfg=cfgs[i],
                    bias=None if bs is None else bs[j], stash=self.stash)
                    for j, (i, w) in enumerate(zip(idx, wl))]
            else:                 # the group's tap rides its first tag
                zn = f(self._znorm_for(full_tags[0], h))
                got = (wtacrs_linear_shared(hs, wl, key=key, znorm=zn,
                                            cfg=cfgs[0], biases=bs,
                                            stash=self.stash)
                       if len(wl) > 1 else
                       [wtacrs_linear(hs, wl[0], key=key, znorm=zn,
                                      cfg=cfgs[0],
                                      bias=None if bs is None else bs[0],
                                      stash=self.stash)])
            for i, z in zip(idx, got):
                outs[i] = z
        return tuple(outs)

    def fold(self, i: int) -> "Ctx":
        """Sub-context for layer/repeat i (derives the child seed)."""
        key = None if self.key is None else fold_seed(self.key, int(i))
        return dataclasses.replace(self, key=key)


def plan_groups(policy: Policy, tags, keyed: bool = True) -> list:
    """How ``Ctx.linear_shared`` splits its (fully prefixed) ``tags`` into
    plans: one group sharing one plan and one stored H' when every tag
    resolves to the same sampling config whose estimator supports shared
    plans and a key is there to draw it; else one group a tag."""
    cfgs = [policy.config_for(t) for t in tags]
    if (keyed and all(c == cfgs[0] for c in cfgs) and not cfgs[0].is_exact
            and est_registry.get_estimator(cfgs[0].kind).supports_shared):
        return [tuple(tags)]
    return [(t,) for t in tags]


EXACT_POLICY = Policy()
