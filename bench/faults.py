"""Faults planted under the timed path, to show that the check catches
them (``tests/``, ``calibrate.py``).  A run never plants one: the
harness's context carries ``fault=None``.

train:   ``state_unchanged`` (the optimizer's update does nothing),
         ``half_batch`` (the step sees the first half of each batch, its
         loss the mean over those rows), ``loss_altered`` (the loss a
         step returns is off by 1 %).
prefill: ``state_unchanged`` (the KV caches come back as allocated, all
         zeros), ``half_batch`` (the second half of the prompts answered
         with the first half's outputs), ``answer_altered`` (one prompt's
         logits shifted by one place).
"""
from __future__ import annotations

FAULTS = {"train": ("state_unchanged", "half_batch", "loss_altered"),
          "prefill": ("state_unchanged", "half_batch", "answer_altered")}

_PATCHED = []


def _patch(module, name, value):
    _PATCHED.append((module, name, getattr(module, name)))
    setattr(module, name, value)


def unplant() -> None:
    while _PATCHED:
        module, name, value = _PATCHED.pop()
        setattr(module, name, value)


def _half(batch):
    b = batch["tokens"].shape[0]
    return {k: v[:b // 2] for k, v in batch.items()}


def plant(fault, mode: str, fn):
    """``fn`` (the program's step) with ``fault`` planted; ``fn`` itself
    where ``fault`` is None."""
    if fault is None:
        return fn
    if fault not in FAULTS[mode]:
        raise ValueError(f"no fault {fault!r} for {mode}")
    import torch
    if mode == "train":
        if fault == "state_unchanged":
            from repro_torch.train import optim

            def frozen(grads, state, params, lr, cfg=None, gnorm=None):
                return params, state, {"grad_norm": torch.zeros(())}
            _patch(optim, "adamw_update", frozen)
            return fn
        if fault == "half_batch":
            return lambda state, batch: fn(state, _half(batch))

        def altered(state, batch):
            state, m = fn(state, batch)
            return state, dict(m, loss=m["loss"] * 1.01)
        return altered

    def broken(params, batch):
        if fault == "half_batch":
            logits, states = fn(params, _half(batch))
            return (torch.cat([logits, logits]),
                    tuple({k: torch.cat([v, v], dim=1) for k, v in s.items()}
                          for s in states))
        logits, states = fn(params, batch)
        if fault == "state_unchanged":
            return logits, tuple({k: torch.zeros_like(v)
                                  for k, v in s.items()} for s in states)
        logits = logits.clone()
        logits[0] = logits[0].roll(1)
        return logits, states
    return broken
