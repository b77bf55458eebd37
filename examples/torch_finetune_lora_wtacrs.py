"""End-to-end example (PyTorch/CUDA port): WTA-CRS fine-tuning with the
dataset-level gradient-norm cache (Algorithm 1), fault-tolerant
checkpointing, and automatic bit-faithful resume — all through one
RunSpec.

    PYTHONPATH=src python examples/torch_finetune_lora_wtacrs.py \
        --steps 200 --ckpt-dir wtacrs_ckpt [--device cuda]

Kill it at any point and re-run the same command: ``Run.resume`` restores
params, optimizer, znorm cache, budget statistics AND the adaptive
controller's band state from the last durable checkpoint, so the budget
trajectory continues instead of resetting.  ``--adaptive`` attaches an
ESSProportional budget controller to the MLP blocks; the run report
prints its trajectory.  The default arch is qwen2.5-3b (the JAX
example's default, xlstm-125m, needs the recurrent blocks, which are not
ported yet); ``--full-size`` trains its published config.
"""
import argparse
import dataclasses

from repro_torch.api import DataSpec, Run, RunSpec
from repro_torch.core import (BudgetSchedule, ESSProportional, LoRAConfig,
                              PolicyRules, Rule, WTACRSConfig)
from repro_torch.models import common as cm
from repro_torch.train import optim


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="wtacrs_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--budget", type=float, default=0.3)
    ap.add_argument("--warmup-exact", type=int, default=0,
                    help="steps to run every sampled layer exact before "
                         "dropping to --budget (BudgetSchedule)")
    ap.add_argument("--adaptive", action="store_true",
                    help="ESSProportional budget controller on the MLPs")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # CACHED_GRAD: the dataset gradient-norm cache drives the column-row
    # probabilities — RunSpec sees it and wires the cache, the sample_ids
    # plumbing and (for --adaptive) budget_stats by itself.
    base = WTACRSConfig(kind="wta_crs", budget=args.budget, min_rows=4,
                        norm_source="cached_grad")
    rules = None
    if args.adaptive:
        rules = PolicyRules.of(Rule.of(
            "*mlp*", base,
            ESSProportional(b_min=0.1, b_max=0.6, levels=6, warmup=3)))
    elif args.warmup_exact > 0:
        # MoE routers and experts sample flattened rows (the router all
        # B·S rows, an expert its capacity slots): the per-sample
        # gradient-norm cache has no column for them (PT003), so they take
        # activation norms while everything else uses the cache.
        rows = dataclasses.replace(base, norm_source="activation_only")
        rules = PolicyRules.of(
            ("*moe_*", rows),
            ("*", base, BudgetSchedule.warmup_exact(
                begin_step=args.warmup_exact, end=args.budget)))
    policy = cm.Policy(
        wtacrs=base, rules=rules,
        # the models hold no adapter parameters (as in the reference);
        # Ctx.linear(..., lora=) takes them when enabled
        lora=LoRAConfig(rank=16, enabled=False))

    spec = RunSpec(
        arch=args.arch, reduced=not args.full_size, policy=policy,
        steps=args.steps, batch_size=args.batch,
        optimizer=optim.AdamWConfig(weight_decay=0.0, grad_clip_norm=1.0),
        lr=3e-3, lr_schedule="wsd", warmup=10,
        data=DataSpec(seq_len=args.seq, n_samples=512, branching=2),
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every)

    run = Run.resume(spec, device=args.device)
    if run.state is not None:
        print(f"resumed from step {int(run.state['step'])}")
    print(f"{len(run.tags)} WTA-CRS'd linears; dataset cache over "
          f"{spec.data.n_samples} samples")
    run.fit(log_every=10)
    run.save()
    print(run.report())
    print("final checkpoint written; re-run to verify resume is a no-op")


if __name__ == "__main__":
    main()
