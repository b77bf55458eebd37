#!/usr/bin/env python3
"""``flash_attention_fwd``'s bf16 routes side by side on one card.

    python3 tools/time_flash_routes.py [--shapes ssm,tp,...] [--out FILE]

For each shape (B, H, KVH, S, Dh, causal) it runs every route the C
interface takes for it (``wgmma`` and ``mma``, each unless the C refuses
it; the wrapper itself always takes ``flash_route``'s pick), holds each
against ``flash_attention_fwd_plain`` at flash's bf16 tolerance (1e-2),
and times it beside one ``scaled_dot_product_attention`` call on the same inputs
(``autotune.time_ms``: CUDA events, median of 5 groups of 10, L2-warm).
The bound is ``costs.flash``'s useful flops and bytes against an H100's
989 TFLOP/s and 3.35 TB/s.  Prints one JSON line a shape, then the card's
name and power limit; ``--out`` also writes them as one JSON object.
Needs one NVIDIA GPU; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.kernels import _build, costs  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.autotune import card_line, time_ms  # noqa: E402

PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
TOL = 1e-2
# (B, H, KVH, S, Dh, causal): zamba2-2.7b's prefill (32/32 heads of 80)
# and one rank's 16 heads at model = 2; qwen2.5-3b's (16/2 of 128); the
# head dims around 80 at zamba2's heads and length
SHAPES = {
    "ssm": (2, 32, 32, 2048, 80, True),
    "tp": (2, 16, 16, 1024, 80, True),
    "train": (4, 16, 2, 2048, 128, True),
    "dh64": (2, 32, 32, 2048, 64, True),
    "dh72": (2, 32, 32, 2048, 72, True),
    "dh96": (2, 32, 32, 2048, 96, True),
    "dh112": (2, 32, 32, 2048, 112, True),
    "dh128": (2, 32, 32, 2048, 128, True),
}


def launch(route, q, k, v, causal):
    """One launch on ``route``, whatever ``flash_route`` would pick; None
    if the C interface refuses the shape on that route (-2)."""
    out = torch.empty_like(q)
    code = _build.library().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.shape[0], k.shape[0], q.shape[1], k.shape[1], q.shape[2],
        int(causal), _build.DTYPE_CODES[q.dtype],
        flash_mod.ROUTES.index(route), torch.cuda.current_stream().cuda_stream)
    if code == -2:
        return None
    _build.check_launch(code, f"flash_attention_fwd ({route} route)")
    return out


def measure(name, b, h, kvh, s, dh, causal, gen):
    bh, bkvh, group = b * h, b * kvh, h // kvh
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((bh, s, dh), (bkvh, s, dh),
                                      (bkvh, s, dh)))
    want = flash_mod.flash_attention_fwd_plain(q, k, v, group=group,
                                               causal=causal)
    flops, nbytes = costs.flash(bh, bkvh, s, s, dh, causal, 2)
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    rec = {"shape": name, "B": b, "H": h, "KVH": kvh, "S": s, "Dh": dh,
           "causal": causal, "picked": flash_mod.flash_route(dh, q.dtype),
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    for route in ("wgmma", "mma"):
        got = launch(route, q, k, v, causal)
        if got is None:
            rec[route] = "refused"
            continue
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=TOL, atol=TOL):
            raise SystemExit(f"{name}: the {route} route is off the plain "
                             f"version by {err}")
        ms = time_ms(lambda: launch(route, q, k, v, causal))
        rec[route] = {"ms": ms, "ms_per_bound": ms / rec["bound_ms"],
                      "max_abs_err": err}
    q4, k4, v4 = (t.view(b, -1, s, dh) for t in (q, k, v))
    rec["sdpa_ms"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=True))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated subset of " + ",".join(SHAPES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_flash_routes: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    recs = []
    for name in args.shapes.split(","):
        recs.append(measure(name, *SHAPES[name], gen))
        print(json.dumps(recs[-1]), flush=True)
    card = card_line()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "shapes": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
