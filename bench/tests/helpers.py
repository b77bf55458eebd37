"""Small cells on the CPU: configuration files at each configuration's
``REDUCED`` size (the port's CPU-test presets), cells over them, and
the harness run on them."""
import dataclasses
import json
import time

import harness

BASE_CELL = {"mode": "train", "batch": 2, "seq": 64, "estimator": "wta_crs",
             "budget": 0.3, "remat": "none", "lr": 1e-4,
             "followed_steps": 3, "chips": 1, "why": "a CPU test",
             "limits": {"loss_gap": 1e-5, "grad_gap": 1e-5,
                        "change_gap": 1e-4}}
PREFILL_CELL = {"mode": "prefill", "batch": 4, "seq": 64,
                "warmup_steps": 2, "chips": 1, "why": "a CPU test",
                "limits": {"logit_gap": 1e-5, "kv_gap": 1e-5}}


def reduced_conf(name: str, compute_dtype: str = "float32"):
    """``configs/<name>.json`` at the arch's ``REDUCED`` sizes; for an
    arch of the port that no configuration of the benchmark names (the
    hybrid ``zamba2-2.7b``, whose reference the tests still hold), the
    port's own ``REDUCED`` preset."""
    from repro_torch.configs import get_config
    path = harness.BENCH / "configs" / f"{name}.json"
    conf = (json.loads(path.read_text()) if path.is_file()
            else {"arch": name})
    small = dataclasses.asdict(get_config(conf["arch"], reduced=True))
    if not path.is_file():
        conf.update(small)
    for key in list(conf):
        if key in small:
            conf[key] = small[key]
    conf["pattern"] = list(small["pattern"])
    conf["compute_dtype"] = compute_dtype
    return conf


def write_cell(tmp, name, conf_name, conf, **cell):
    (tmp / "configs").mkdir(exist_ok=True)
    (tmp / "cells").mkdir(exist_ok=True)
    (tmp / "configs" / f"{conf_name}.json").write_text(json.dumps(conf))
    (tmp / "cells" / f"{name}.json").write_text(json.dumps(
        dict(cell, config=conf_name)))
    return harness.Cell(name, tmp)


def run(cell, seed=2 ** 31 + 11, fault=None, seconds=0.2, trace=False):
    harness.set_cache_dirs()
    ctx = harness.Context(cell, seed, "cpu", fault)
    return harness.measure(ctx, seconds, trace, time.time())
