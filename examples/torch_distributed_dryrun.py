"""Multi-pod dry run for one cell, end to end, with the roofline readout
(PyTorch/CUDA port).

    PYTHONPATH=src python examples/torch_distributed_dryrun.py \
        --arch dbrx-132b --shape train_4k --mesh multi

Traces one rank of the paper-faithful WTA-CRS train/serve step on the
2x16x16 (or 16x16) production mesh through ``run.dryrun()``: rank 0's
shards of the state under the data / tensor / expert shardings, its step
run on the ``meta`` device, its collectives recorded.  Prints the
per-device memory, flops and collectives and the run report's §Roofline
section (H100 peak rates) — what the full sweep (python -m
repro_torch.launch.dryrun --all) records per cell.  No card is needed:
nothing is allocated.  ``--reduced`` traces the reduced arch (seconds
instead of minutes).
"""
import argparse

from repro_torch.api import Run, RunSpec
from repro_torch.launch.dryrun import dryrun_policy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="multi", choices=["single", "multi"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    run = Run(RunSpec(arch=args.arch, reduced=args.reduced,
                      policy=dryrun_policy()), device=args.device)
    rec = run.dryrun(shape=args.shape, mesh=args.mesh)
    if rec["status"] != "ok":
        print(rec)
        return
    m = rec["memory"]
    print(f"cell: {args.arch} x {args.shape} x {args.mesh}")
    print(f"  per-device memory: args {m['argument_bytes'] / 2**30:.2f} GiB"
          f" + temps {m['temp_bytes'] / 2**30:.2f} GiB")
    print(f"  per-device FLOPs (trip-aware): {rec['cost']['flops']:.4g}")
    print(f"  collectives: {rec['collectives']['counts']} "
          f"({rec['collectives']['total_bytes'] / 2**30:.2f} GiB/device)")
    print(run.report())


if __name__ == "__main__":
    main()
