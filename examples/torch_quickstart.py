"""Quickstart (PyTorch/CUDA port): fine-tune a small LM with WTA-CRS@0.3
and watch the loss.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 40] \
        [--budget 0.3] [--device cuda]

One declarative RunSpec replaces the hand-wired trainer assembly: pick a
policy, Run.fit.  The estimator swaps in at the linear-layer level — no
model-code changes; on the card every sampled linear runs the
hand-written row_norms / gather_scale / fused_sampled_dw kernels.
``--per-layer`` upgrades the single global config to a PolicyRules
policy: attention output projections stay exact while the MLP block
samples at half the headline budget.  The default arch is qwen2.5-3b
(the JAX example's default arch is not ported yet).
"""
import argparse

from repro_torch.api import DataSpec, Run, RunSpec
from repro_torch.core import PolicyRules, WTACRSConfig
from repro_torch.models import common as cm
from repro_torch.train import optim


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--budget", type=float, default=0.3)
    ap.add_argument("--per-layer", action="store_true",
                    help="exact attn_o + aggressive MLP via PolicyRules")
    ap.add_argument("--schedule", default="constant",
                    choices=sorted(optim.SCHEDULES))
    ap.add_argument("--full-size", action="store_true",
                    help="use the published config instead of the reduced")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    rules = None
    if args.per_layer:
        rules = PolicyRules.of(
            ("*attn_o", {"kind": "exact"}),
            ("*mlp_*", {"budget": args.budget / 2}),
        )
    policy = cm.Policy(
        wtacrs=WTACRSConfig(kind="wta_crs", budget=args.budget, min_rows=4),
        rules=rules)

    run = Run(RunSpec(
        arch=args.arch, reduced=not args.full_size, policy=policy,
        steps=args.steps, batch_size=8, lr=3e-3,
        lr_schedule=args.schedule, warmup=5,
        data=DataSpec(seq_len=32, n_samples=128, branching=2)),
        device=args.device)
    run.fit(log_every=5)
    print("done.")


if __name__ == "__main__":
    main()
