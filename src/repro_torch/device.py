"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``.  Asking for a card that is not there raises here — nothing
carries on quietly on the CPU.  The CPU is used only when the caller
names it (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU on purpose")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    return dev


def resolve_or_meta(device="cuda") -> torch.device:
    """``resolve_device``, or the ``meta`` device (shapes without
    storage) where the caller names it."""
    if str(device) == "meta":
        return torch.device("meta")
    return resolve_device(device)
