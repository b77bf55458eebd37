"""Dataset-level gradient-norm cache (Algorithm 1's ``Cache``).

The optimal column-row distribution (Eq. 3) needs ||dZ_i,:|| which is
unknown during the forward pass.  The paper keeps a per-sample cache of
the previous step's gradient norms.  In the port:

  * the cache is part of the train state: {tag: (n_repeats, N_dataset)}
    float32 tensors on the state's device, one scalar per (layer-repeat,
    sample),
  * before the step, columns for the batch's sample ids are gathered and
    threaded into the forward as the ``znorms`` dict,
  * the fresh norms come back as the *gradients of those znorms* (the
    tap — see ``repro_torch.core.linear``), and are scattered back.

Tag enumeration runs the model's forward once on the ``meta`` device
(shapes only, no storage) with a tag recorder (``trace_linears``), so the
cache keys exactly match the sampled linears of the architecture.  With a per-layer policy,
pass it to ``collect_linear_tags`` so exact-ruled tags are excluded.

Schedule consistency: a tag whose budget schedule is in its exact phase
(or whose rule is exact) returns an all-zero tap.  The train step
resolves the policy's active tags (``sampling_active_tags``) and
``scatter`` leaves inactive tags' cache entries untouched, so an exact
warmup cannot poison the cache with zeros before sampling begins —
while genuine zero norms from active layers are still written
faithfully.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.core import plans
from repro_torch.core.config import EstimatorKind, NormSource, WTACRSConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import registry

_EPS = 1e-20


def policy_requirements(policy: cm.Policy) -> Dict[str, bool]:
    """What a policy demands of the train state / step builder.

    Returns ``{"cached_grad": ..., "stats_controllers": ...}``:

      * ``cached_grad`` — some reachable estimator config sets
        ``norm_source=CACHED_GRAD``, i.e. the dataset gradient-norm
        cache must exist and be threaded through the step
        (``use_znorm_cache=True``) for the config to mean anything.
      * ``stats_controllers`` — some rule carries a stats-driven budget
        controller, i.e. the state additionally needs ``budget_stats``
        (and the cache, which feeds them through the tap).

    Reachable configs are the fallback (``policy.wtacrs``), the rules'
    ``default``, and every rule resolved at step 0 — ``norm_source`` is
    never schedule-dependent, so step 0 sees every value that can occur.
    """
    cfgs = [policy.wtacrs]
    stats_controllers = False
    if policy.rules is not None:
        base = (policy.rules.default
                if policy.rules.default is not None else policy.wtacrs)
        cfgs.append(base)
        for r in policy.rules.rules:
            cfgs.append(r.resolve(base, step=0))
            if (r.controller is not None
                    and getattr(r.controller, "needs_stats", True)):
                stats_controllers = True
    cached = any(not c.is_exact
                 and c.norm_source == NormSource.CACHED_GRAD
                 for c in cfgs)
    return {"cached_grad": cached,
            "stats_controllers": stats_controllers}


def trace_linears(cfg) -> cm.tag_recorder:
    """The linear calls of one forward of an architecture, as a filled
    ``cm.tag_recorder`` (tags, their sampled dims, the tags of each call).

    The recorder notes every ``Ctx.linear`` tag before its config is
    consulted, so the trace runs the forward with exact linears on
    ``meta`` tensors (the reference's batch of ``registry.train_batch_specs``
    at batch 2 and ``8 * len(pattern)`` positions — a VLM's all patches
    and no text, an encoder-decoder's half frames and half tokens —
    parameters without storage): no full-width parameter set is allocated
    and no plan is built.  An encoder-decoder's encoder and decoder
    record the same tags, each call in ``.calls``."""
    params = registry.init_params(cfg, 0, device="meta")
    seq = 2 * len(cfg.pattern) * 4
    batch = {name: torch.empty(shape, dtype=dtype, device="meta")
             for name, (shape, dtype)
             in registry.train_batch_specs(cfg, 2, seq).items()}
    rec = cm.tag_recorder()
    with torch.no_grad():
        registry.forward(
            cfg, params, batch,
            cm.Policy(wtacrs=WTACRSConfig(kind=EstimatorKind.EXACT)),
            recorder=rec)
    return rec


def collect_linear_tags(cfg, policy: Optional[cm.Policy] = None
                        ) -> List[str]:
    """Cache-eligible linear tags of an architecture, in trace order
    (``trace_linears``).

    Only tags that sample over the TOKEN dim are returned: the cache is
    keyed per dataset sample, so a tag whose plan runs over flattened
    rows has no per-sample tap to store.

    ``policy``: optional per-layer policy; tags whose resolved estimator
    is EXACT (at every schedule phase: kind, not budget, decides) are
    also dropped, so the znorm cache only tracks linears that can sample.
    """
    rec = trace_linears(cfg)
    out = [t for t in rec.tags if rec.dims.get(t) == cm.SAMPLED_DIM_TOKEN]
    if policy is not None:
        out = [t for t in out if not policy.config_for(t).is_exact]
    return out


def init_cache(cfg, tags: List[str], n_dataset: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """All-ones init: first step behaves like activation-only sampling."""
    device = resolve_device(device)
    return {t: torch.ones((cfg.n_repeats, n_dataset), dtype=torch.float32,
                          device=device)
            for t in tags}


def gather(cache: Dict[str, torch.Tensor], sample_ids: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """-> znorms dict {tag: (n_repeats, B)} for this batch."""
    return {t: c[:, sample_ids] for t, c in cache.items()}


def sampling_active_tags(policy: cm.Policy, tags,
                         seq_len: Optional[int] = None) -> frozenset:
    """Tags whose resolved config actually samples this step — the tags
    whose taps carry fresh norms.

    Mirrors the dispatch short-circuit in ``core.linear``: a layer runs
    exact (zero tap) when the kind is exact OR ``budget_rows(S) >= S``
    (min_rows floors small sequences into the exact path even at
    budget < 1).  Pass the batch token length as ``seq_len`` to apply
    the full condition; without it only ``budget < 1.0`` is checked.
    """
    out = []
    for t in tags:
        c = policy.config_for(t)
        if c.is_exact:
            continue
        if seq_len is not None:
            if c.budget_rows(seq_len) < seq_len:
                out.append(t)
        elif c.budget < 1.0:
            out.append(t)
    return frozenset(out)


def scatter(cache: Dict[str, torch.Tensor], sample_ids: torch.Tensor,
            tap_grads: Dict[str, torch.Tensor],
            active_tags=None) -> Dict[str, torch.Tensor]:
    """Write back sqrt(tap) (tap carries squared norms, summed over seq)
    into a new cache dict; the caller's tensors are not modified.

    ``active_tags``: tags whose layer actually ran the sampled path
    this step (see ``sampling_active_tags``).  Inactive tags return
    all-zero taps that would poison the cache, so their entries are left
    untouched; active tags write their taps verbatim.  ``None`` treats
    every tag as active."""
    out = {}
    for t, c in cache.items():
        if active_tags is not None and t not in active_tags:
            out[t] = c
            continue
        z = torch.sqrt(torch.clamp(tap_grads[t], min=0.0))       # (R, B)
        want = (c.shape[0], len(sample_ids))
        if tuple(z.shape) != want:
            raise ValueError(
                f"znorm tap for tag {t!r} has shape {tuple(z.shape)}, cache "
                f"scatter expects (n_repeats, batch) == {want}; this tag "
                f"does not sample per dataset sample over the token dim "
                f"(see collect_linear_tags) and cannot live in the cache")
        new = c.clone()
        new[:, sample_ids] = z.to(c.dtype)
        out[t] = new
    return out


# ---------------------------------------------------------------------------
# Online per-tag statistics for adaptive budget controllers
# ---------------------------------------------------------------------------
#
# One (N_STATS,) f32 vector per cache tag, EMA-updated from the same tap
# the scatter consumes, and read on the host by the scheduled step
# (repro_torch.core.controller maps them to budgets).  Masking semantics
# are identical to ``scatter``: the update iterates the stats dict (whose
# keys come from ``collect_linear_tags`` — token-dim, non-exact tags
# only), holds inactive tags, and never reads taps that are not its keys.

N_STATS = 4
STAT_ESS = 0      # effective-sample-size fraction (Σz)² / (n·Σz²)
STAT_COND = 1     # Theorem-2 condition rate (EMA of the Eq. 7 indicator)
STAT_UTIL = 2     # budget utilization: top-k probability mass at budget
STAT_COUNT = 3    # number of EMA updates absorbed
STATS_DECAY = 0.8


def init_stats(tags, device="cuda") -> Dict[str, torch.Tensor]:
    """Neutral init (uniform-looking, zero count): controllers hold
    until ``STAT_COUNT`` clears their warmup, and the first genuine
    update overwrites these values outright (see ``update_stats``)."""
    device = resolve_device(device)
    base = torch.zeros((N_STATS,), dtype=torch.float32, device=device)
    base[STAT_ESS] = 1.0
    base[STAT_UTIL] = 1.0
    return {t: base.clone() for t in tags}


def _stat_vector(tap_sq: torch.Tensor, budget: float) -> torch.Tensor:
    """(ess, cond, util) from one tag's squared-norm tap (R, B).

    The atoms are the batch's per-(repeat, sample) gradient norms — the
    same z that lands in the cache — and ``k = round(budget * n)`` plays
    the role of the sampling budget over them.  Stays on the tap's
    device: nothing is read back here."""
    z = torch.sqrt(torch.clamp(tap_sq.to(torch.float32), min=0.0)
                   ).reshape(-1)
    n = z.shape[0]
    s1 = torch.sum(z)
    s2 = torch.sum(z * z)
    ess = torch.where(s2 > 0, (s1 * s1) / (n * torch.clamp(s2, min=_EPS)),
                      torch.ones_like(s1))
    # probability atoms (uniform fallback mirrors column_row_probabilities)
    p = torch.where(s1 > 0, z / torch.clamp(s1, min=_EPS),
                    torch.full_like(z, 1.0 / n))
    k = max(1, min(n, int(round(float(budget) * n))))
    csum = torch.cumsum(torch.sort(p, descending=True).values, dim=0)
    c_star = plans.optimal_c_size(csum, k).to(torch.int64)
    det_mass = torch.where(c_star == 0, torch.zeros_like(csum[0]),
                           csum[torch.clamp(c_star - 1, min=0)])
    holds = det_mass > c_star.to(p.dtype) / k                 # Eq. 7
    util = csum[k - 1]                                        # top-k mass
    return torch.stack([ess, holds.to(torch.float32), util])


def update_stats(stats: Dict[str, torch.Tensor],
                 tap_grads: Dict[str, torch.Tensor],
                 budgets: Dict[str, float],
                 active_tags=None,
                 decay: float = STATS_DECAY) -> Dict[str, torch.Tensor]:
    """EMA the fresh tap statistics into the running per-tag vectors
    (new tensors; the caller's are not modified).

    ``budgets``: resolved budget per tag (fixes the k the condition and
    utilization stats are evaluated at).  ``active_tags`` follows
    ``scatter``: tags that ran exact this step would feed all-zero taps,
    so they hold — their count does not advance either, keeping
    controller warmups honest.  The first genuine update replaces the
    neutral init outright (alpha=1 at count 0)."""
    out = {}
    for t, prev in stats.items():
        if active_tags is not None and t not in active_tags:
            out[t] = prev
            continue
        if t not in tap_grads:
            out[t] = prev
            continue
        x = _stat_vector(tap_grads[t], budgets[t])
        cnt = prev[STAT_COUNT]
        alpha = torch.where(cnt > 0, 1.0 - decay, 1.0)
        ema = prev[:STAT_COUNT] + alpha * (x - prev[:STAT_COUNT])
        out[t] = torch.cat([ema, (cnt + 1.0)[None]])
    return out
