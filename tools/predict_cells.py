"""The dry run's predictions for the cells ``chip_smoke.py`` measures on
the card, on the host alone (``meta`` device, no card needed).

    PYTHONPATH=src python tools/predict_cells.py

Prints one JSON line a cell: the train phase's cell (12-layer qwen2.5-3b,
B=4, S=1024, WTA-CRS 0.3, AdamW, one rank) and the tp phase's steps at
model = 2, rank 0 (qwen2.5-3b depth 4, B=2, S=1024; zamba2-2.7b depth 6,
B=2, S=1024; xlstm-125m depth 2, B=2, S=512; whisper-base, B=4 of 1024
frames + 1024 tokens; qwen2.5-3b depth 2 under the factored and low-rank
optimizer specs): predicted peak bytes,
flops, bytes accessed, the step's bound on an H100
(max(flops / 989.4e12, bytes / 3.35e12)), kernel launches, collectives.
"""
import dataclasses
import json

from repro_torch import optim as optim_lib
from repro_torch.configs.base import InputShape
from repro_torch.core import WTACRSConfig
from repro_torch.launch import dryrun, mesh as mesh_lib, roofline
from repro_torch.models import common as cm
from repro_torch.models.registry import get_config


def predict(name, cfg, shape, mesh, policy, opt=None):
    c, _, _ = dryrun.trace_step(cfg, shape, mesh, policy, opt=opt)
    bound = max(c.flops / roofline.PEAK_FLOPS,
                c.bytes_accessed / roofline.HBM_BW)
    return {"cell": name, "peak_bytes": c.peak,
            "argument_bytes": c.argument_bytes, "flops": c.flops,
            "bytes_accessed": c.bytes_accessed, "bound_ms": 1e3 * bound,
            "launches": c.launches,
            "collectives": {f"{op} over {axis}": v for (op, axis), v
                            in c.collectives.by_axis().items()},
            "trace_s": c.seconds}


def main():
    wta = cm.Policy(wtacrs=WTACRSConfig(kind="wta_crs", budget=0.3,
                                        min_rows=4),
                    remat="none", flash_block=512)
    qwen = get_config("qwen2.5-3b")
    tp = mesh_lib.make_mesh((1, 2), ("data", "model"))
    cells = [
        ("train (12 layers, B=4, S=1024, 1 rank)",
         dataclasses.replace(qwen, n_layers=12),
         InputShape("train", 1024, 4, "train"),
         mesh_lib.make_mesh((1, 1), ("data", "model"))),
        ("tp qwen (4 layers, B=2, S=1024, model 2, rank 0)",
         dataclasses.replace(qwen, n_layers=4),
         InputShape("tp", 1024, 2, "train"), tp),
        ("tp zamba2 (6 layers, B=2, S=1024, model 2, rank 0)",
         dataclasses.replace(get_config("zamba2-2.7b"), n_layers=6),
         InputShape("tp", 1024, 2, "train"), tp),
        ("tp xlstm (2 layers, B=2, S=512, model 2, rank 0)",
         dataclasses.replace(get_config("xlstm-125m"), n_layers=2),
         InputShape("tp", 512, 2, "train"), tp),
        ("tp whisper (6 + 6 layers, B=4, 1024 + 1024, model 2, rank 0)",
         get_config("whisper-base"), InputShape("tp", 2048, 4, "train"),
         tp),
    ]
    for name, cfg, shape, mesh in cells:
        print(json.dumps(predict(name, cfg, shape, mesh, wta)), flush=True)
    # the tp phase's optimizer legs: qwen2.5-3b depth 2 at model = 2 under
    # bench_memory.py's factored and low-rank specs (the first step: a
    # low-rank refresh)
    specs = {"factored_came": [dict(pattern="*", layout="factored",
                                    momentum=True)],
             "factored": [dict(pattern="*", layout="factored",
                               momentum=False)],
             "mixed": [dict(pattern="unit/*", layout="lowrank", rank=8),
                       dict(pattern="embed*", layout="factored",
                            momentum=False)]}
    for name, rules in specs.items():
        print(json.dumps(predict(
            f"tp_optim {name} (2 layers, B=2, S=1024, model 2, rank 0)",
            dataclasses.replace(qwen, n_layers=2),
            InputShape("tp", 1024, 2, "train"), tp, wta,
            opt=optim_lib.OptimSpec.of(*rules))), flush=True)


if __name__ == "__main__":
    main()
