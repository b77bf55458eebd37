"""Readings that the limits of ``correct`` are set from, on the card, at
the cell's own size: the program against the reference on many seeds
(the lower readings), the control (the reference computed with float8
e4m3 products, put in the program's place) against the reference (the
upper readings), and the program with a fault planted (``faults.py``).

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults half_batch,loss_altered] \\
        [--fault-seeds 1,2,3]

One JSON line a reading on standard output, with ``check.judge``'s
verdict at the cell's limits (``correct``, and the numbers over their
limit).  No window is timed: a
training cell's readings come from its set-up's followed steps, a
prefill cell's from its last warm-up call, which run the window's own
call at the window's sizes.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


def _seeds(text):
    return [int(x) for x in text.split(",") if x]


def readings(cell, seed, device, control, faults):
    """The program's numbers for ``seed`` (and the control's, and each
    fault's), each a dict."""
    import check
    import faults as fault_lib

    out = []
    drv = cell.mode.Driver(harness.Context(cell, seed, device))
    t = time.time()
    drv.setup()
    if cell.spec["mode"] == "train":
        prog = drv.program_readings()
        drv.free()
        ref = drv.reference("f32")
        out.append(("program", check.train_numbers(prog, ref)))
        if control:
            out.append(("control", check.train_numbers(
                drv.reference("fp8"), ref)))
        for name in faults:
            bad = cell.mode.Driver(harness.Context(cell, seed, device, name))
            bad.setup()
            got = bad.program_readings()
            bad.free()
            fault_lib.unplant()
            out.append((name, check.train_numbers(got, ref)))
    else:
        j, (logits, states) = drv.last
        out.append(("program", drv.compare(j, logits, states)))
        del logits, states, drv.last
        if control:
            out.append(("control", drv.control(j)))
        drv.free()
        for name in faults:
            bad = cell.mode.Driver(harness.Context(cell, seed, device, name))
            bad.setup()
            j, (logits, states) = bad.last
            del bad.last
            bad.free()
            out.append((name, bad.compare(j, logits, states)))
    return out, time.time() - t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import check
    import torch
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    faults = [f for f in args.faults.split(",") if f]
    for seed in args.seeds:
        got, secs = readings(cell, seed, "cuda",
                             seed in args.control_seeds,
                             faults if seed in args.fault_seeds else [])
        for kind, numbers in got:
            ok, _, _ = check.judge(numbers, cell.spec["limits"])
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "kind": kind, "numbers": numbers,
                              "correct": ok, "failed": sorted(
                                  name for name, limit in
                                  cell.spec["limits"].items()
                                  if not numbers[name] <= limit),
                              "seconds": secs}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
