#!/usr/bin/env python3
"""Where a train step of the port spends the card's time.

    python3 tools/profile_train_step.py [--layers 12] [--kind wta_crs|exact]
                                        [--out FILE.json]

Runs the configuration ``chip_smoke.py`` trains (qwen2.5-3b at published
width, depth cut to ``--layers``, B=4, S=1024, budget 0.3, one fixed batch),
warms up two steps, times six untraced steps on the host's clock
(``host_ms``: until the step call returns, i.e. the host's dispatch;
``wall_ms``: until the card has finished it; medians), then traces two
steps with ``torch.profiler`` (CPU + CUDA activities) and prints: the wall
time of the traced steps, the device-busy time (sum of kernel durations)
and its share of the wall time, kernel time by category, and the 30
kernels with the most device time.
Needs one NVIDIA GPU; exits 1 without one or if the trace holds no device
time (then time with CUDA events instead).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import EXACT_CONFIG, WTACRSConfig  # noqa: E402
from repro_torch.launch import train_steps  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.train import data, optim  # noqa: E402

B, S = 4, 1024
N_UNTRACED = 6

# first match wins; names are substrings of CUDA kernel names
CATEGORIES = [
    ("fused_sampled_dw (hand kernel)", ("fused_dw_",)),
    ("row_norms (hand kernel)", ("row_norms_kernel",)),
    ("gather_scale (hand kernel)", ("gather_scale_kernel",)),
    ("matmul (cuBLAS/cutlass)", ("gemm", "cutlass", "cublas", "xmma", "gemv",
                                 "nvjet")),
    ("sort / scan / search (plans)", ("sort", "scan", "searchsorted",
                                      "bitonic", "radix")),
    ("gather / index / scatter", ("gather", "index", "scatter")),
    ("reduce / norm / softmax", ("reduce", "softmax", "norm")),
    ("copy / cast", ("copy", "memcpy", "memset", "cast")),
    ("elementwise", ("elementwise", "vectorized", "foreach")),
]


def categorise(name: str) -> str:
    low = name.lower()
    for cat, needles in CATEGORIES:
        if any(n in low for n in needles):
            return cat
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--kind", choices=("wta_crs", "exact"),
                    default="wta_crs")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_step: needs a CUDA device", file=sys.stderr)
        return 1

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=args.layers)
    wta = (EXACT_CONFIG if args.kind == "exact" else
           WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=4))
    state = train_steps.init_train_state(cfg, 0)
    step = train_steps.make_train_step(
        cfg, cm.Policy(wtacrs=wta), optim.AdamWConfig(),
        optim.linear_warmup_constant(1e-4, 2))
    ds = data.SyntheticLM(cfg.vocab_size, S, B, seed=0)
    for i in range(2):
        state, _ = step(state, ds.batch_at(i, B))
    torch.cuda.synchronize()

    host_ms, wall_ms_untraced = [], []
    for i in range(N_UNTRACED):
        batch = ds.batch_at(i, B)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (t1 - t0))
        wall_ms_untraced.append(1e3 * (time.perf_counter() - t0))

    n_traced = 2
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_traced):
            state, _ = step(state, ds.batch_at(2 + i, B))
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)

    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += ev.device_time_total / 1e3          # us -> ms
    busy_ms = sum(v[1] for v in kernels.values())
    if busy_ms <= 0:
        print("profile_train_step: the trace holds no device time",
              file=sys.stderr)
        return 1
    by_cat = {}
    for name, (count, ms) in kernels.items():
        c = by_cat.setdefault(categorise(name), [0, 0.0])
        c[0] += count
        c[1] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:30]
    result = {
        "device": torch.cuda.get_device_name(0), "kind": args.kind,
        "layers": args.layers, "batch": B, "seq": S,
        "steps_untraced": N_UNTRACED,
        "host_ms_per_step_untraced": statistics.median(host_ms),
        "wall_ms_per_step_untraced": statistics.median(wall_ms_untraced),
        "host_ms_untraced": host_ms, "wall_ms_untraced": wall_ms_untraced,
        "steps_traced": n_traced,
        "wall_ms_per_step_traced": wall_ms / n_traced,
        "device_busy_ms_per_step": busy_ms / n_traced,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": sum(v[0] for v in kernels.values())
        / n_traced,
        "ms_per_step_by_category": {
            c: {"launches": n / n_traced, "ms": ms / n_traced}
            for c, (n, ms) in sorted(by_cat.items(),
                                     key=lambda kv: -kv[1][1])},
        "top_kernels_ms_per_step": [
            {"name": name[:120], "launches": n / n_traced,
             "ms": ms / n_traced} for name, (n, ms) in top],
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
