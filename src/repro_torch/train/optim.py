"""Optimizer + LR schedules written out (not ``torch.optim``).

AdamW with decoupled weight decay as the reference writes it: the decay
term enters the *step* (``step += wd * p`` before ``p -= lr * step``),
moments are f32 whatever the parameter dtype, and the new parameter is
computed in f32 and cast back to ``p.dtype``.  ``torch.optim.AdamW``
differs on each of these, so it is not used.  Schedules:

  * ``linear_warmup_constant`` — the paper's: constant after warmup.
  * ``cosine``
  * ``wsd`` — Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395).

Optimizer state is two trees shaped like the parameters (m, v).  The
update runs under ``no_grad`` and writes parameters and moments IN PLACE:
at 16 bytes a parameter (p, g, m, v in f32) a second copy of the state
is what a full-width model cannot afford.  The caller's trees are the
new state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Tuple

import torch


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a nested dict/list/tuple tree, in a
    fixed order (dict keys sorted, lists by index), the path's parts
    joined with "/" (``layers/3/mlp/wi``)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        raise TypeError(f"not a parameter tree node: {type(tree).__name__}")
    return [leaf for name, child in items for leaf in named_leaves(
        child, f"{prefix}/{name}" if prefix else name)]


def tree_leaves(tree) -> List[torch.Tensor]:
    """Tensors of a nested dict/list/tuple tree, in ``named_leaves``'s
    order."""
    return [x for _, x in named_leaves(tree)]


def tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"not a parameter tree node: {type(tree).__name__}")


@dataclasses.dataclass
class AdamWState:
    count: int              # optimizer steps taken
    m: object               # tree like params, f32
    v: object               # tree like params, f32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0    # 0 = off


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr: float,
                 cfg: AdamWConfig = AdamWConfig(), gnorm=None):
    """Updates ``params`` and ``state`` in place; returns
    (params, state, metrics).  ``gnorm``: the gradient norm where the
    leaves are shards (a model-parallel step); by default theirs."""
    if gnorm is None:
        gnorm = global_norm(grads)
    flat_g = tree_leaves(grads)
    if cfg.grad_clip_norm > 0:
        scale = torch.clamp(cfg.grad_clip_norm
                            / torch.clamp(gnorm, min=1e-12), max=1.0)
        flat_g = [g * scale.to(g.dtype) for g in flat_g]
    state.count += 1
    bc1 = 1.0 - cfg.b1 ** state.count
    bc2 = 1.0 - cfg.b2 ** state.count

    for g, m, v, p in zip(flat_g, tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        adamw_leaf_update(g, m, v, p, lr, cfg, bc1, bc2)
    return params, state, {"grad_norm": gnorm}


def adamw_leaf_update(g, m, v, p, lr: float, cfg, bc1: float,
                      bc2: float) -> None:
    """One leaf of AdamW, in place: the f32 moments ``m``/``v``, then the
    parameter.  ``cfg`` carries ``b1``, ``b2``, ``eps`` and
    ``weight_decay`` (an ``AdamWConfig`` or an ``OptimSpec``: the dense
    layout of ``repro_torch.optim`` runs exactly this)."""
    g32 = g.to(torch.float32)
    m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
    # (m / bc1) / (sqrt(v / bc2) + eps), each operation rounded as written,
    # with two parameter-sized temporaries where the expression takes three
    step = v / bc2
    step.sqrt_().add_(cfg.eps)
    step = torch.div(m / bc1, step, out=step)
    apply_step(p, step, lr, cfg.weight_decay)


def apply_step(p, step, lr: float, weight_decay: float) -> None:
    """``p <- p - lr * (step + weight_decay * p)`` in f32, rounded once to
    ``p.dtype``, in place; ``step`` (f32) is overwritten."""
    if weight_decay:
        step.add_(weight_decay * p.to(torch.float32))
    step.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_((p.to(torch.float32) - step).to(p.dtype))


# ---------------------------------------------------------------------------
# Schedules (step -> lr), plain floats on the host
# ---------------------------------------------------------------------------

def linear_warmup_constant(base_lr: float, warmup: int = 500
                           ) -> Callable[[int], float]:
    def f(step):
        return base_lr * min(1.0, (step + 1) / warmup)
    return f


def cosine(base_lr: float, total_steps: int, warmup: int = 500,
           final_frac: float = 0.1) -> Callable[[int], float]:
    def f(step):
        warm = min(1.0, (step + 1) / warmup)
        t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0),
                1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi
                                                                   * t))
        return base_lr * warm * cos
    return f


def wsd(base_lr: float, total_steps: int, warmup: int = 500,
        decay_frac: float = 0.1,
        final_frac: float = 0.01) -> Callable[[int], float]:
    """MiniCPM Warmup-Stable-Decay."""
    decay_start = int(total_steps * (1 - decay_frac))

    def f(step):
        warm = min(1.0, (step + 1) / warmup)
        t = min(max((step - decay_start)
                    / max(total_steps - decay_start, 1), 0.0), 1.0)
        decay = final_frac ** t      # exponential anneal over the tail
        return base_lr * warm * decay
    return f


SCHEDULES = {"constant": linear_warmup_constant, "cosine": cosine,
             "wsd": wsd}


def make_schedule(name: str, base_lr: float, total_steps: int = 0,
                  warmup: int = 500) -> Callable[[int], float]:
    """LR schedule by name; ``total_steps`` is ignored by ``constant``."""
    if name == "constant":
        return linear_warmup_constant(base_lr, warmup=warmup)
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; "
                         f"one of {sorted(SCHEDULES)}")
    return SCHEDULES[name](base_lr, total_steps=total_steps, warmup=warmup)
