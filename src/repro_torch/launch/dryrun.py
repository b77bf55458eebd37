"""Multi-pod dry run: trace one rank of every (arch x shape x mesh) cell.

The reference lowers and compiles each cell as one SPMD program on 512
host devices (``repro/launch/dryrun.py``).  The port cannot compile an
SPMD program; its honest counterpart runs ONE rank's program on the
``meta`` device, where tensors have shapes and no storage and the
collectives the program issues are recorded rather than sent.  For each
cell this:

  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod)
     abstractly, seen from rank 0 (``launch.mesh.meta_mesh``),
  2. takes rank 0's shards of the abstract train state / parameters /
     decode state (``train_state_shardings`` / ``param_shardings`` /
     ``decode_state_specs``) and of the batch,
  3. runs one step of the port's own step function on them under
     ``launch/cost.py``'s counter (flops, bytes, peak live bytes,
     collectives, the hand kernels' meta launches),
  4. writes experiments/dryrun/<arch>__<shape>__<mesh>[__tag].json with
     the reference's record keys.

Keys that only XLA has are ``null``: ``cost.xla_flops_loopbody_once``,
``cost.xla_bytes_loopbody_once`` and ``collectives.loopbody_once``;
``lower_s`` and ``compile_s`` become one ``trace_s``.  The microbatches
of a train step are one program run 8 times: the counter traces one and
counts its flops, bytes and collectives 8 times, never its peak.  A cell
whose trace raises records ``status: "error"`` with the message, as the
reference records a failed lowering; a cell ``shape_applicable``
rejects, ``status: "skipped"``.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
      PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
          --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core.config import EstimatorKind, WTACRSConfig
from repro_torch.launch import cost as cost_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch import train_steps
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.models import ssm as ssm_lib
from repro_torch.train import optim


def dryrun_policy() -> cm.Policy:
    """The paper-faithful production policy: WTA-CRS@0.3 on every linear,
    with the remat policy that keeps exactly the sub-sampled activations
    (the sampled linears' H', idx, scale) and the per-layer inputs."""
    return cm.Policy(wtacrs=WTACRSConfig(kind=EstimatorKind.WTA_CRS,
                                         budget=0.3),
                     remat="wtacrs_names")


def exact_policy() -> cm.Policy:
    return cm.Policy(wtacrs=WTACRSConfig(kind=EstimatorKind.EXACT),
                     remat="wtacrs_names")


MICROBATCHES = 8        # gradient-accumulation splits for train cells


def _fresh(tree):
    """Each meta tensor of ``tree`` as a tensor of its own (a slice of a
    meta tensor would count its whole storage)."""
    return shard_lib._rebuild(tree, lambda _, x: torch.empty(
        x.shape, dtype=x.dtype, device="meta"))


def model_axis_notes(cfg, mesh) -> dict:
    """How the port's program splits the attention over ``model`` where
    GSPMD's might differ: q heads sliced through (q all-gathered before
    the scores, every rank attending over every head), kv heads
    replicated; and which path each recurrent block type takes
    (``models/ssm.py``): its heads split over the ranks, or gathered (every
    rank running every head)."""
    m = mesh.shape["model"]
    notes = {}
    attention = cfg.is_encdec or any(
        b not in ssm_lib.RECURRENT for b in cfg.pattern)
    if attention and m > 1 and cfg.n_heads * cfg.head_dim % m == 0 \
            and cfg.n_heads % m:
        notes["q_heads"] = ("sliced through heads: q all-gathered before "
                            "the scores")
    if attention and m > 1 and cfg.n_kv_heads % m:
        notes["kv_heads"] = "replicated"
    for btype in dict.fromkeys(cfg.pattern):
        if m > 1 and btype in ssm_lib.RECURRENT:
            notes[btype] = ("heads split over model"
                            if ssm_lib.splits_heads(cfg, btype, m) else
                            "gathered: every rank runs every head")
    return notes


def trace_step(cfg, shape, mesh, policy, microbatches: int = 1,
               opt=None):
    """One rank's step of ``shape`` on ``mesh`` (an abstract mesh) on the
    ``meta`` device under a ``CostCounter``; returns (counter, output
    bytes, alias bytes).  ``opt``: an ``OptimSpec`` for a train step (the
    legacy AdamW by default)."""
    mm = mesh_lib.meta_mesh(mesh)
    if shape.kind == "train":
        state, axes = train_steps.abstract_train_state(cfg, opt=opt)
        sh = train_steps.train_state_shardings(cfg, state, axes, mesh)
        args = (train_steps.shard_train_state(state, sh, mm),)
        batch = registry.input_specs(cfg, shape)
        args += (_fresh(shard_lib.shard_batch(batch, mm)),)
        step_fn = train_steps.make_train_step(
            cfg, policy, opt or optim.AdamWConfig(),
            optim.linear_warmup_constant(1e-4), microbatches=microbatches,
            device="meta", mesh=mm, data_axes=mesh_lib.data_axes(mesh))
    else:
        params, axes = registry.abstract_params(cfg)
        p_sh = shard_lib.param_shardings(
            axes, params, mesh, rules=shard_lib.arch_rules(cfg, mesh))
        params = shard_lib.shard_params(params, p_sh, mm)
        if shape.kind == "prefill":
            batch = registry.input_specs(cfg, shape)
            args = (params, _fresh(shard_lib.shard_batch(batch, mm)))
            step_fn = train_steps.make_prefill_step(cfg, policy,
                                                    device="meta", mesh=mm)
        else:
            token, pos, states = registry.decode_specs(
                cfg, shape.global_batch, shape.seq_len)
            st_sh = shard_lib.decode_state_specs(
                cfg, states, mesh, shape.global_batch)
            token = _fresh(shard_lib.shard_batch({"t": token}, mm))["t"]
            args = (params, token, pos,
                    shard_lib.shard_tree(states, st_sh, mm))
            step_fn = train_steps.make_serve_step(cfg, policy,
                                                  device="meta", mesh=mm)
    with cost_lib.CostCounter() as counter:
        counter.track(*args)
        out = step_fn(*args)
        out_bytes, alias = counter.bytes_of(out)
    return counter, out_bytes, alias


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               policy: Optional[cm.Policy] = None,
               flash_block: Optional[int] = None,
               microbatches: Optional[int] = None,
               optimized: bool = False, cfg=None):
    """Trace one cell; returns (record, counter, None) — the reference's
    (record, compiled, lowered), where the ``CostCounter`` stands in for
    the compiled program and nothing is lowered.  ``cfg``: the arch's
    config to trace (its published one by default; ``Run.dryrun`` hands
    its own, reduced or not).

    ``optimized=True`` applies the beyond-paper §Perf settings: MoE
    capacity split over the data axes with group-local dispatch, and
    triangular (lower-triangle-only) flash attention.
    """
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}, None, None

    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    if policy is None:
        policy = dryrun_policy()
    if optimized:
        dp = mesh_lib.data_axes(mesh)
        policy = dataclasses.replace(
            policy, moe_pspec=("model", dp),
            moe_groups=mesh_lib.mesh_size(mesh, dp),
            flash_mode="triangular")
    if shape.kind != "train":
        # estimator only affects training; serve path is exact, and
        # serving streams bf16 weights (decode is weight-bound — §Perf)
        policy = dataclasses.replace(policy, wtacrs=WTACRSConfig(
            kind=EstimatorKind.EXACT))
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if flash_block:
        policy = dataclasses.replace(policy, flash_block=flash_block)

    counter, out_bytes, alias = trace_step(
        cfg, shape, mesh, policy,
        microbatches=((microbatches if microbatches is not None
                       else MICROBATCHES) if shape.kind == "train" else 1))
    coll = counter.collectives
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": shape.kind,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "trace_s": round(counter.seconds, 2),
        "memory": {
            "argument_bytes": counter.argument_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": counter.peak - counter.argument_bytes,
            "alias_bytes": alias,
            "peak_per_device_bytes": counter.peak,
        },
        "cost": {"flops": counter.flops,
                 "bytes_accessed": counter.bytes_accessed,
                 "xla_flops_loopbody_once": None,
                 "xla_bytes_loopbody_once": None},
        "collectives": {"total_bytes": coll.total_bytes,
                        "counts": coll.counts,
                        "bytes": coll.bytes,
                        "loopbody_once": None},
        "kernels": {"launches": dict(counter.launches),
                    "flops": counter.kernel_flops,
                    "bytes": counter.kernel_bytes},
        "model_axis": model_axis_notes(cfg, mesh),
    }
    return record, counter, None


def run_cells(cells, out_dir: str, policy=None, tag: str = "",
              optimized: bool = False):
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch, shape_name, multi_pod in cells:
        mesh_name = "multi" if multi_pod else "single"
        name = f"{arch}__{shape_name}__{mesh_name}"
        if tag:
            name += f"__{tag}"
        print(f"[dryrun] {name} ...", flush=True)
        try:
            record, _, _ = lower_cell(arch, shape_name, multi_pod,
                                      policy=policy, optimized=optimized)
        except Exception as e:
            record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                      "status": "error", "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-2000:]}
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(record, f, indent=1)
        status = record["status"]
        extra = ""
        if status == "ok":
            mem = record["memory"]["peak_per_device_bytes"] / 2**30
            extra = (f" mem/dev={mem:.2f}GiB "
                     f"flops={record['cost']['flops']:.3g} "
                     f"coll={record['collectives']['total_bytes']:.3g}B "
                     f"trace={record['trace_s']}s")
        print(f"[dryrun] {name}: {status}{extra}", flush=True)
        results.append(record)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_NAMES + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES.keys()) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--exact", action="store_true",
                    help="baseline exact-GEMM policy instead of WTA-CRS")
    ap.add_argument("--optimized", action="store_true",
                    help="beyond-paper perf settings (EXPERIMENTS §Perf)")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    policy = exact_policy() if args.exact else None
    return run_cells(cells, args.out, policy=policy, tag=args.tag,
                     optimized=args.optimized)


if __name__ == "__main__":
    main()
