"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Exits non-zero and prints no result without them, when the
program cannot be imported, or when a JAX module is loaded once the
window has closed.  The last line of standard output is the result (see
``harness.result``); the numbers ``correct`` was decided by are the
last lines of standard error.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402

START = harness.process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_cache_dirs()
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell(args.workload)

    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.spec["chips"]):
        print(f"no card: the cell asks for {cell.spec['chips']} CUDA "
              f"device(s)", file=sys.stderr)
        return 2
    ctx = harness.Context(cell, args.seed, "cuda")
    rec = harness.measure(ctx, args.seconds, bool(args.trace), START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.spec["chips"],
              "memory_peak_bytes": rec["peak_bytes"],
              "name_and_power_limit": harness.power_limit()}
    line = harness.result(cell, rec, bool(args.trace), spec, device)
    sys.stdout.flush()
    for text in rec["check_lines"]:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
