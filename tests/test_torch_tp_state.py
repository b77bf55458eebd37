"""The rest of the model axis: the optimizer's factored and low-rank
layouts over sharded weights, checkpoints, generation and serving at
``model = 2``, and LoRA over a model-parallel weight.

One gloo pair on the CPU (a ``torch.multiprocessing`` spawn for the
module, ``make_host_mesh(model_parallel=2)``: a 1 x 2 mesh) runs the
port; beside it, in two subprocesses, the reference runs its own 1 x 2
sharded programs (``XLA_FLAGS=--xla_force_host_platform_device_count=2``):
``jax.jit`` with ``train_state_shardings`` (which carries
``optim.state_shardings`` for an ``OptimSpec``) for three steps under
each of ``bench_memory``'s factored and low-rank specs, and
``Run(mesh="host", model_parallel=2)``'s ``generate`` and ``serve``.
Reduced qwen2.5-3b, granite-moe-1b-a400m (expert parallel) and
zamba2-2.7b, f32, the same parameters on both sides
(``convert.params_from_jax``, norm gains redrawn as in
``test_torch_tp.py``).  Checkpoints are held against a one-rank run of
the port, LoRA against the reference's ``lora_linear`` on the whole
weight.  Tolerances stand beside each assert."""
import dataclasses
import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_config as jax_get_config
from repro.core import linear as jax_linear
from repro.core import lora as jax_lora
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.launch import train_steps as jax_train_steps
from repro_torch import convert
from repro_torch import optim as optim_lib
from repro_torch.api import DataSpec, Run, RunSpec
from repro_torch.api import run as run_mod
from repro_torch.configs import ARCH_NAMES
from repro_torch.core import LoRAConfig, RankController, WTACRSConfig
from repro_torch.core import lora as lora_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, train_steps
from repro_torch.models import common as cm
from repro_torch.models import encdec, lm, registry
from repro_torch.models.registry import get_config
from repro_torch.serve import spec as serve_spec
from repro_torch.train import checkpoint, data, optim

torch.set_num_threads(1)

WORLD = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# --- A.14: the layouts over shards ------------------------------------------
OPTIM_ARCHS = ("qwen2.5-3b", "granite-moe-1b-a400m")
KINDS = ("exact", "det_topk")
SEQ, BATCH, N_SAMPLES, STEPS, LR, WARMUP = 32, 4, 32, 3, 1e-3, 2
# bench_memory.py's specs at Adam eps 1e-5 (as test_torch_tp.py: attn/bk's
# gradient is rounding noise), refresh_every 2 so that step 3 rotates the
# subspace; each low-rank rule carries a RankController so that its
# captured energy rides budget_stats (make_train_step never migrates the
# rank, so the controller changes nothing else)
SPECS = {
    "factored_came": [dict(pattern="*", layout="factored", momentum=True)],
    "factored": [dict(pattern="*", layout="factored", momentum=False)],
    "lowrank@8": [dict(pattern="*", layout="lowrank", rank=8,
                       refresh_every=2, controller=True)],
    "mixed": [dict(pattern="unit/*", layout="lowrank", rank=8,
                   refresh_every=2, controller=True),
              dict(pattern="embed*", layout="factored", momentum=False)],
}
SPEC_NAMES = tuple(SPECS)
# CAME divides its momentum by the root of its instability estimate: where
# a gradient is rounding noise (attn/bk's: a k bias shifts every score of
# a query alike) that ratio is O(1) at eps 1e-5, and the bias would move
# by lr a step in the noise's direction in either program; at eps 1e-3
# the parameters carry the program, not the noise
EPS = {"factored_came": 1e-3}

# --- A.15: generation and serving -------------------------------------------
# (prompt, new tokens): 32 positions split on the sequence; 14 (fewer than
# head_dim 16) and 17 (odd) split on head_dim
GENERATE = ((16, 16), (8, 6), (9, 8))
# (prompt, new tokens) of 6 requests of mixed lengths, within 24 and 12
LONG = ((3, 5), (9, 3), (1, 6), (14, 4), (6, 7), (11, 2))
SHORT = ((3, 5), (5, 3), (1, 6), (7, 4), (2, 7), (8, 2))
# (arch, max_len, page_size, requests): a 24-position slot splits each
# page's positions (2 of 4 a rank); a 12-position one (fewer than
# head_dim) splits head_dim
SERVE_CASES = {"qwen2.5-3b/pages": ("qwen2.5-3b", 24, 4, LONG),
               "qwen2.5-3b/dh": ("qwen2.5-3b", 12, 4, SHORT),
               "zamba2-2.7b/pages": ("zamba2-2.7b", 24, 4, LONG)}
SERVE_SLOTS, SERVE_CHUNK = 4, 4

# --- A.16: LoRA -------------------------------------------------------------
LORA_MODES = ("column", "row", "row_scatter")
LORA_KINDS = ("wta_crs", "det_topk")

# --- decode at every cache length --------------------------------------------
# each arch's reduced config, and qwen2.5-3b with 16 heads of 4 on 8 kv
# heads (more kv heads than head_dim: the rule splits the kv heads of a
# short cache)
DECODE_CASES = {a: (a, {}) for a in ARCH_NAMES}
DECODE_CASES["qwen2.5-3b/kv8dh4"] = ("qwen2.5-3b", {
    "n_heads": 16, "n_kv_heads": 8, "d_head": 4})


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _f32_configs():
    """``Run`` and ``ServeSpec`` build f32 configs (returns a restore)."""
    old = [(m, m.get_config) for m in (run_mod, serve_spec)]
    for m, get in old:
        m.get_config = (lambda g: lambda a, reduced=False: _f32(g(
            a, reduced=reduced)))(get)

    def restore():
        for m, get in old:
            m.get_config = get
    return restore


def _cfg(arch, get=None, **over):
    return dataclasses.replace((get or get_config)(arch, reduced=True),
                               compute_dtype="float32", **over)


def _optim_spec(pkg, controller_cls, name):
    rules = []
    for r in SPECS[name]:
        r = dict(r)
        if r.pop("controller", False):
            r["controller"] = controller_cls()
        rules.append(r)
    return pkg.OptimSpec.of(*rules, eps=EPS.get(name, 1e-5))


def _policy(arch, kind):
    est = (WTACRSConfig(kind="exact") if kind == "exact" else
           WTACRSConfig(kind="det_topk", budget=0.3, min_rows=4))
    moe = (dict(moe_pspec=("model", ("data",)), moe_groups=1)
           if "moe" in arch else {})
    return cm.Policy(wtacrs=est, **moe)


def _initial_params(arch):
    """The reference's initial parameters of the reduced arch, numpy, norm
    gains redrawn from [0.5, 1.5] (at gains of 1, top-k is decided by the
    last bit)."""
    state = jax_train_steps.init_train_state(
        _cfg(arch, jax_get_config), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def redraw(path, a):
        a = np.array(a)
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, state["params"])


# The reference's three steps under each spec on a 1 x 2 host mesh.
REFERENCE_OPTIM = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import optim as optim_lib
from repro.configs import get_config
from repro.core.config import WTACRSConfig
from repro.core.controller import RankController
from repro.launch import mesh as mesh_lib, sharding as shard_lib, train_steps
from repro.models import common as cm, registry
from repro.train import data, optim

work, arch = sys.argv[1:3]
with open(work + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
seq, batch, n, steps, lr, warmup = inputs["train"]
mesh = mesh_lib.make_host_mesh(model_parallel=2)
assert dict(mesh.shape) == {"data": 1, "model": 2}, mesh.shape
out = {}
cfg = dataclasses.replace(get_config(arch, reduced=True),
                          compute_dtype="float32")
ds = data.SyntheticLM(cfg.vocab_size, seq, n, seed=0)
_, axes = registry.abstract_params(cfg)
for name, rules in inputs["specs"].items():
    rs = []
    for r in rules:
        r = dict(r)
        if r.pop("controller", False):
            r["controller"] = RankController()
        rs.append(r)
    spec = optim_lib.OptimSpec.of(*rs, eps=inputs["eps"].get(name, 1e-5))
    for kind in ("exact", "det_topk"):
        est = (WTACRSConfig(kind="exact") if kind == "exact" else
               WTACRSConfig(kind="det_topk", budget=0.3, min_rows=4))
        moe = (dict(moe_pspec=("model", ("data",)), moe_groups=1)
               if "moe" in arch else {})
        policy = cm.Policy(wtacrs=est, **moe)
        state = train_steps.init_train_state(cfg, jax.random.PRNGKey(0),
                                             opt=spec)
        state = dict(state, params=jax.tree.map(jnp.asarray,
                                                inputs[arch]))
        sh = train_steps.train_state_shardings(cfg, state, axes, mesh)
        b0 = {k: v for k, v in ds.batch_at(0, batch).items()
              if k != "sample_ids"}
        b_sh = shard_lib.batch_shardings(b0, mesh)
        with mesh_lib.use_mesh(mesh):
            state = jax.device_put(state, sh)
            step = jax.jit(train_steps.make_train_step(
                cfg, policy, spec,
                optim.linear_warmup_constant(float(lr), int(warmup))),
                in_shardings=(sh, b_sh), out_shardings=(sh, None))
            rec = {"loss": []}
            for i in range(steps):
                b = {k: v for k, v in ds.batch_at(i, batch).items()
                     if k != "sample_ids"}
                state, m = step(state, b)
                rec["loss"].append(float(m["loss"]))
        rec["params"] = jax.tree.map(np.asarray, state["params"])
        rec["opt"] = jax.tree.map(np.asarray, state["opt"])
        rec["stats"] = {k: np.asarray(v) for k, v
                        in state.get("budget_stats", {}).items()}
        out[(arch, name, kind)] = rec
with open(work + f"/reference_optim_{arch}.pkl", "wb") as f:
    pickle.dump(out, f)
"""

# The reference's Run(mesh="host", model_parallel=2): generate, and a
# ServeSession, in f32.
REFERENCE_SERVE = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.api import DataSpec, Run, RunSpec
from repro.configs import get_config
import repro.serve.spec as serve_spec

work = sys.argv[1]
with open(work + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
f32 = lambda c: dataclasses.replace(c, compute_dtype="float32")
serve_spec.get_config = lambda a, reduced=False: f32(get_config(
    a, reduced=reduced))


def run_of(arch):
    run = Run(RunSpec(arch=arch, mesh="host", model_parallel=2,
                      prefill_chunk=inputs["chunk"],
                      data=DataSpec(seq_len=16, n_samples=8)))
    assert dict(run.mesh.shape) == {"data": 1, "model": 2}
    run.cfg = f32(run.cfg)
    run.init()
    run.state = run._shard(dict(run.state, params=jax.tree.map(
        jnp.asarray, inputs[arch])))
    return run


out = {}
run = run_of("qwen2.5-3b")
for prompt_len, gen in inputs["generate"]:
    prompts = inputs["prompts"][:, :prompt_len]
    toks = np.asarray(run.generate(prompts, gen))
    tok, pos, states = run.prefill(prompts, gen=gen)
    for t in range(pos, pos + gen):
        tok, logits, states = run.decode(tok, t, states)
    out[("generate", prompt_len, gen)] = {"tokens": toks,
                                          "last_logits": np.asarray(logits)}
for case, (arch, max_len, page, _) in inputs["serve_cases"].items():
    r = run if arch == "qwen2.5-3b" else run_of(arch)
    sess = r.serve(max_slots=inputs["slots"], page_size=page,
                   max_len=max_len)
    hs = [sess.submit(p, max_new=m) for p, m in inputs["requests"][case]]
    sess.run_until_idle()
    out[("serve", case)] = [list(h.result(0)) for h in hs]
with open(work + "/reference_serve.pkl", "wb") as f:
    pickle.dump(out, f)
"""


# ---------------------------------------------------------------------------
# the gloo pair
# ---------------------------------------------------------------------------

def _whole_specs(cfg, mesh, opt):
    """``train_state_shardings`` of ``cfg``'s state under ``opt``."""
    whole, axes = train_steps.abstract_train_state(cfg, opt=opt)
    return train_steps.train_state_shardings(cfg, whole, axes, mesh)


def _replicated_slots(state):
    """Every optimizer slot a rank holds whole (its shape the reference
    leaf's slot's): the factored vectors, the low-rank subspace."""
    return {f"{ref}/{name}": t.clone()
            for ref, slots in state["opt"]["leaves"].items()
            for name, t in slots.items()
            if name in ("v_row", "v_col", "u_row", "u_col", "proj")
            or (name in ("m", "v") and "proj" in slots)}


def _optim_leg(inputs, mesh):
    out = {}
    for arch in OPTIM_ARCHS:
        cfg = _cfg(arch)
        full = convert.params_from_jax(cfg, inputs[arch], device="cpu")
        ds = data.SyntheticLM(cfg.vocab_size, SEQ, N_SAMPLES, seed=0)
        for name in SPEC_NAMES:
            spec = _optim_spec(optim_lib, RankController, name)
            for kind in KINDS:
                whole = train_steps.init_train_state(
                    cfg, 0, device="cpu", opt=spec,
                    params=optim.tree_map(torch.clone, full))
                sh = _whole_specs(cfg, mesh, spec)
                state = train_steps.shard_train_state(whole, sh, mesh)
                del whole
                step = train_steps.make_train_step(
                    cfg, _policy(arch, kind), spec,
                    optim.linear_warmup_constant(LR, WARMUP), device="cpu",
                    mesh=mesh)
                rec = {"loss": []}
                for i in range(STEPS):
                    state, m = step(state, ds.batch_at(i, BATCH))
                    rec["loss"].append(float(m["loss"]))
                rec["replicated"] = _replicated_slots(state)
                rec["local_shapes"] = {
                    f"{ref}/{n}": tuple(t.shape)
                    for ref, slots in state["opt"]["leaves"].items()
                    for n, t in slots.items()}
                whole = train_steps.gather_train_state(state, sh, mesh)
                rec["params"] = convert.params_to_numpy(cfg, whole["params"])
                rec["opt"] = convert.opt_state_to_numpy(whole["opt"])
                rec["stats"] = {k: v.numpy().copy() for k, v
                                in whole.get("budget_stats", {}).items()}
                out[(arch, name, kind)] = rec
    return out


def _checkpoint_spec(ckpt, every=2, **kw):
    return RunSpec(arch="qwen2.5-3b", policy=cm.Policy(), steps=4,
                   optimizer=_optim_spec(optim_lib, RankController,
                                         "factored_came"),
                   batch_size=4, lr=LR, warmup=WARMUP,
                   data=DataSpec(seq_len=16, n_samples=32),
                   checkpoint_dir=ckpt, checkpoint_every=every, **kw)


def _checkpoint_leg(work, mesh, rank):
    """fit 4 steps at model = 2 saving at steps 2 and 4; fit 2 steps into
    another directory, then a new Run resumes and fits to 4."""
    writes = []
    save = checkpoint.save

    def counted(*a, **kw):
        writes.append(a[1])
        return save(*a, **kw)

    checkpoint.save = counted
    try:
        m2 = dict(mesh="host", model_parallel=2)
        run = Run(_checkpoint_spec(os.path.join(work, "ckpt_m2"), **m2),
                  device="cpu")
        run.fit()
        whole = run._gather(run.state)
        out = {"history": run.history,
               "params": convert.params_to_numpy(run.cfg, whole["params"]),
               "opt": convert.opt_state_to_numpy(whole["opt"]),
               "local": [t.clone() for t in
                         optim.tree_leaves(run.state["params"])]}
        killed = Run(_checkpoint_spec(os.path.join(work, "ckpt_kill"),
                                      **m2), device="cpu")
        killed.fit(steps=2)
        del killed
        resumed = Run.resume(_checkpoint_spec(os.path.join(
            work, "ckpt_kill"), **m2), device="cpu")
        out["resumed_at"] = int(resumed.state["step"])
        resumed.fit()
        out["resumed_history"] = resumed.history
        out["resumed_local"] = [t.clone() for t in
                                optim.tree_leaves(resumed.state["params"])]
        out["resumed_opt"] = {
            f"{ref}/{n}": t.clone()
            for ref, slots in resumed.state["opt"]["leaves"].items()
            for n, t in slots.items()}
        out["opt_local"] = {
            f"{ref}/{n}": t.clone()
            for ref, slots in run.state["opt"]["leaves"].items()
            for n, t in slots.items()}
    finally:
        checkpoint.save = save
    out["writes"] = writes
    return out


def _run_with(arch, full_numpy, mesh_kw):
    run = Run(RunSpec(arch=arch, prefill_chunk=SERVE_CHUNK,
                      data=DataSpec(seq_len=16, n_samples=8), **mesh_kw),
              device="cpu")
    full = convert.params_from_jax(run.cfg, full_numpy, device="cpu")
    run._params = (full if run.mesh is None else sharding.shard_params(
        full, run._param_specs(), run.mesh))
    return run


def _serving_leg(inputs, mesh):
    out = {}
    m2 = dict(mesh="host", model_parallel=2)
    run = _run_with("qwen2.5-3b", inputs["qwen2.5-3b"], m2)
    for prompt_len, gen in GENERATE:
        prompts = inputs["prompts"][:, :prompt_len]
        toks = run.generate(prompts, gen)
        tok, pos, states = run.prefill(prompts, gen=gen)
        split = lm.kv_split(run.cfg, states[0]["k"][0], run.mesh)
        for t in range(pos, pos + gen):
            tok, logits, states = run.decode(tok, t, states)
        out[("generate", prompt_len, gen)] = {
            "tokens": toks.numpy(), "last_logits": logits.numpy(),
            "split": split, "local_k": tuple(states[0]["k"].shape)}
    for case, (arch, max_len, page, _) in SERVE_CASES.items():
        r = run if arch == "qwen2.5-3b" else _run_with(arch, inputs[arch],
                                                       m2)
        sess = r.serve(max_slots=SERVE_SLOTS, page_size=page,
                       max_len=max_len)
        rec = {"kv": sess.scheduler.shards.kv,
               "pool_k": tuple(sess.scheduler.pool[-1].get(
                   "k", torch.empty(0)).shape)}
        if case == "qwen2.5-3b/pages":
            # the async loop: admissions sent from model rank 0
            with sess.start():
                hs = [sess.submit(p, max_new=m)
                      for p, m in inputs["requests"][case]]
                rec["tokens"] = [h.result(120) for h in hs]
        else:
            hs = [sess.submit(p, max_new=m)
                  for p, m in inputs["requests"][case]]
            sess.run_until_idle()
            rec["tokens"] = [h.result(0) for h in hs]
        out[("serve", case)] = rec
    return out


def _lora_leg(inputs, mesh):
    """``lora_linear_parallel`` (the plan injected) and ``Ctx.linear(lora=,
    parallel=)`` (det_topk: the plan from the norms) on this rank's
    shards; outputs and the gradients of h, A and B gathered whole."""
    m = mesh_lib.model_index(mesh)
    lcfg = LoRAConfig(rank=4, alpha=8.0, enabled=True)
    out = {}
    h, w, a, b, zn, ct = (torch.from_numpy(x.copy())
                          for x in inputs["lora"]["arrays"])
    for mode in LORA_MODES:
        col = mode == "column"
        half_in, half_out = w.shape[0] // 2, w.shape[1] // 2
        rows = slice(m * half_in, (m + 1) * half_in)
        cols = slice(m * half_out, (m + 1) * half_out)
        out_cols = cols if mode != "row" else slice(None)
        for kind in LORA_KINDS:
            hl = (h if col else h[..., rows]).clone().requires_grad_(True)
            wl = w[:, cols] if col else w[rows]
            al = (a if col else a[rows]).clone().requires_grad_(True)
            bl = (b[:, cols] if col else b).clone().requires_grad_(True)
            tcfg = WTACRSConfig(kind=kind, budget=0.5, min_rows=4)
            if kind == "wta_crs":
                idx, scale = inputs["lora"]["plan"]
                z = lora_lib.lora_linear_parallel(
                    hl, wl, al, bl, lcfg, mode, mesh, key=7,
                    znorm=zn, cfg=tcfg,
                    plan=(torch.from_numpy(idx), torch.from_numpy(scale)))
            else:
                ctx = cm.Ctx(policy=cm.Policy(wtacrs=tcfg, lora=lcfg),
                             key=3, mesh=mesh)
                z = ctx.linear("mlp_wi", hl, wl,
                               lora={"lora_a": al, "lora_b": bl},
                               parallel=mode)
            (z * ct[..., out_cols]).sum().backward()
            g_h, g_a, g_b = hl.grad, al.grad, bl.grad
            if col:
                z = sharding.gather_leaf(z.detach(), (None, None, "model"),
                                         mesh)
                g_b = sharding.gather_leaf(g_b, (None, "model"), mesh)
            else:
                if mode == "row_scatter":
                    z = sharding.gather_leaf(z.detach(),
                                             (None, None, "model"), mesh)
                g_h = sharding.gather_leaf(g_h, (None, None, "model"), mesh)
                g_a = sharding.gather_leaf(g_a, ("model", None), mesh)
            out[(mode, kind)] = {"z": z.detach().numpy(),
                                 "h": g_h.numpy(), "a": g_a.numpy(),
                                 "b": g_b.numpy(),
                                 "w_grad": wl.grad is None}
    return out


def _decode_leg(mesh):
    """One decode step at position L - 1 over random caches of every
    length L in 1 .. 2·head_dim + 1, for every arch (and a config whose
    short caches split on the kv heads), on this rank's shards
    (``serving_state_specs``) and on one rank's whole caches: the split
    the rule picked and the logits of both."""
    out = {}
    for case, (arch, over) in DECODE_CASES.items():
        cfg = _cfg(arch, **over)
        params = registry.init_params(cfg, 0, device="cpu")
        local = sharding.shard_params(
            params, train_steps.model_param_specs(cfg, mesh), mesh)
        gen = torch.Generator().manual_seed(0)
        tok = torch.tensor([3, 5])
        for length in range(1, 2 * cfg.head_dim + 2):
            if cfg.is_encdec:
                states = encdec.decode_state_init(cfg, 2, length, 4,
                                                  device="cpu")
            else:
                states = registry.decode_state_init(cfg, 2, length,
                                                    device="cpu")
            for path, x in optim.named_leaves(states):
                if path.split("/")[-1] in ("k", "v", "xk", "xv"):
                    x.copy_(torch.randn(x.shape, generator=gen))
            specs = sharding.serving_state_specs(cfg, states, mesh, 2)
            mine = sharding.shard_tree(states, specs, mesh)
            pos = length - 1
            _, got, mine = train_steps.make_serve_step(
                cfg, cm.Policy(), device="cpu", mesh=mesh)(
                    local, tok, pos, mine)
            _, want, _ = train_steps.make_serve_step(
                cfg, cm.Policy(), device="cpu")(params, tok, pos, states)
            kv = [p for p in specs if p.split("/")[-1] == "k"]
            split = (lm.kv_split(cfg, dict(optim.named_leaves(mine))[
                kv[0]][0], mesh) if kv else None)
            out[(case, length)] = {"got": got.numpy(), "want": want.numpy(),
                                   "split": split}
    return out


def _rank_main(rank, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=WORLD)
    try:
        with open(os.path.join(work, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        _f32_configs()
        mesh = mesh_lib.make_host_mesh(model_parallel=2, device="cpu")
        out = {"optim": _optim_leg(inputs, mesh),
               "checkpoint": _checkpoint_leg(work, mesh, rank),
               "serving": _serving_leg(inputs, mesh),
               "lora": _lora_leg(inputs, mesh),
               "decode": _decode_leg(mesh)}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _lora_inputs():
    rng = np.random.RandomState(0)
    b, s, d, e, r = 2, 32, 64, 48, 4
    return (rng.randn(b, s, d).astype(np.float32),
            (rng.randn(d, e) / 8).astype(np.float32),
            (rng.randn(d, r) / 2).astype(np.float32),
            (rng.randn(r, e) / 10).astype(np.float32),
            (np.abs(rng.randn(b, s)) + 0.1).astype(np.float32),
            rng.randn(b, s, e).astype(np.float32))


def _lora_reference(arrays, kind):
    """The reference's ``lora_linear`` on the whole weight: its output and
    the gradients of h, A and B, and (wta_crs) the plan of its
    down-projection (its key folded by 1)."""
    h, w, a, b, zn, ct = (jnp.asarray(x) for x in arrays)
    cfg = JaxWTACRSConfig(kind=kind, budget=0.5, min_rows=4)
    lcfg = jax_lora.LoRAConfig(rank=4, alpha=8.0, enabled=True)
    key = jax.random.PRNGKey(1)

    def f(hh, aa, bb):
        z = jax_lora.lora_linear(hh, w, aa, bb, lcfg, key=key, znorm=zn,
                                 cfg=cfg)
        return jnp.sum(z * ct), z

    (_, z), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                       has_aux=True)(h, a, b)
    k = cfg.budget_rows(h.shape[1])
    idx, scale = jax_linear._make_plans(
        h, zn, jax.random.key_data(jax.random.fold_in(key, 1)), cfg, k)
    return ({"z": np.asarray(z), "h": np.asarray(grads[0]),
             "a": np.asarray(grads[1]), "b": np.asarray(grads[2])},
            (np.array(idx), np.array(scale)))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The reference's 1 x 2 programs and the port's gloo pair, side by
    side; returns (reference, [rank 0, rank 1], work dir)."""
    work = str(tmp_path_factory.mktemp("tp_state"))
    archs = set(OPTIM_ARCHS) | {c[0] for c in SERVE_CASES.values()}
    inputs = {arch: _initial_params(arch) for arch in archs}
    arrays = _lora_inputs()
    lora_ref = {kind: _lora_reference(arrays, kind) for kind in LORA_KINDS}
    inputs.update(
        train=(SEQ, BATCH, N_SAMPLES, STEPS, LR, WARMUP),
        specs=SPECS, eps=EPS, generate=GENERATE,
        prompts=data.SyntheticLM(256, 16, 8, seed=3).batch_at(
            0, 2)["tokens"].astype(np.int64),
        requests={case: [(np.random.RandomState(i).randint(0, 256, n), m)
                         for i, (n, m) in enumerate(c[3])]
                  for case, c in SERVE_CASES.items()},
        serve_cases=SERVE_CASES, slots=SERVE_SLOTS, chunk=SERVE_CHUNK,
        lora={"arrays": arrays, "plan": lora_ref["wta_crs"][1]})
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    # one reference process an arch's optimizer steps, one for serving
    refs = [subprocess.Popen([sys.executable, "-c", script, work, *args],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for script, args in [(REFERENCE_OPTIM, (a,)) for a in OPTIM_ARCHS]
            + [(REFERENCE_SERVE, ())]]
    try:
        mp.start_processes(_rank_main, args=(work,), nprocs=WORLD,
                           start_method="spawn")
    finally:
        errs = [p.communicate(timeout=600)[1] for p in refs]
    for p, err in zip(refs, errs):
        assert p.returncode == 0, err[-3000:]
    reference = {}
    for name in [f"reference_optim_{a}.pkl" for a in OPTIM_ARCHS] + [
            "reference_serve.pkl"]:
        with open(os.path.join(work, name), "rb") as f:
            reference.update(pickle.load(f))
    reference["lora"] = {k: v[0] for k, v in lora_ref.items()}
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return reference, ranks, work


def _pairs(got, want):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    return [(jax.tree_util.keystr(p), np.asarray(g), np.asarray(w))
            for (p, g), (_, w) in zip(flat_g, flat_w)]


# ---------------------------------------------------------------------------
# A.14: the factored and low-rank layouts against the reference's sharded
# steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("arch", OPTIM_ARCHS)
def test_sharded_layouts_equal_the_reference_sharded_steps(pair, arch,
                                                           name, kind):
    reference, (r0, _), _ = pair
    want, got = reference[(arch, name, kind)], r0["optim"][(arch, name,
                                                            kind)]
    # f32, the same plans: the order of the sums only (the row-parallel
    # partial products, the statistics summed or gathered over the ranks):
    # 1e-5
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for path, g, w in _pairs(got["params"], want["params"]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"params{path}")
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == STEPS
    compared = 0
    for ref, slots in want["opt"]["leaves"].items():
        for slot in ("v_row", "v_col", "v"):
            if slot not in slots:
                continue
            # proj and m are never compared: an SVD fixes a singular
            # vector up to its sign; v, v_row and v_col do not depend on it
            np.testing.assert_allclose(
                got["opt"]["leaves"][ref][slot], slots[slot], rtol=1e-5,
                atol=1e-5, err_msg=f"{ref}/{slot}")
            compared += 1
    assert compared
    # the captured energy of each low-rank rule, riding budget_stats: 1e-5
    assert set(got["stats"]) == set(want["stats"])
    for key, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][key], w, rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    if "lowrank" in name or name == "mixed":
        assert want["stats"], "no energy captured"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("arch", OPTIM_ARCHS)
def test_replicated_slots_are_bit_identical_and_shards_have_their_shapes(
        pair, arch, name, kind):
    reference, (r0, r1), _ = pair
    a, b = r0["optim"][(arch, name, kind)], r1["optim"][(arch, name, kind)]
    assert a["loss"] == b["loss"]
    assert a["replicated"]
    for path, x in a["replicated"].items():
        # every rank computes a replicated slot from the same gathered or
        # summed statistics, and a refresh takes model rank 0's SVD
        assert torch.equal(x, b["replicated"][path]), path
    # a rank holds the reference's whole shape of a replicated slot and
    # its shard of a slot with its parameter's shape
    want = reference[(arch, name, kind)]["opt"]["leaves"]
    halved = 0
    for path, shape in a["local_shapes"].items():
        ref, slot = path.rsplit("/", 1)
        whole = want[ref][slot].shape
        if path in a["replicated"]:
            assert shape == whole, path
        else:
            assert len(shape) == len(whole)
            assert [w // s for w, s in zip(whole, shape)
                    if w != s] in ([], [2]), (path, shape, whole)
            halved += shape != whole
    if name == "factored_came":
        assert halved, "CAME's momentum keeps its parameter's shard"


# ---------------------------------------------------------------------------
# A.15: checkpoints, resume, a checkpoint across model-parallel widths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def restored_at_one_rank(pair):
    """The model-parallel run's step-2 checkpoint restored at M = 1 and fit
    to step 4; and a one-rank run of the same spec that saves at step 2."""
    _, _, work = pair
    restore = _f32_configs()
    try:
        run = Run.restore(_checkpoint_spec(os.path.join(work, "ckpt_m2"),
                                           every=0), step=2, device="cpu")
        at = int(run.state["step"])
        run.fit()
        one = Run(_checkpoint_spec(os.path.join(work, "ckpt_m1")),
                  device="cpu")
        one.fit(steps=2)
    finally:
        restore()
    return {"at": at, "history": run.history,
            "params": convert.params_to_numpy(run.cfg, run.params),
            "opt": convert.opt_state_to_numpy(run.state["opt"])}


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: (z[k].shape, z[k].dtype) for k in z.files}


def test_model_parallel_checkpoint_is_a_one_rank_checkpoint(
        pair, restored_at_one_rank):
    _, _, work = pair
    m2 = checkpoint.read_manifest(os.path.join(work, "ckpt_m2"), 2)
    m1 = checkpoint.read_manifest(os.path.join(work, "ckpt_m1"), 2)
    # the same keys, dtypes and array shapes as a one-rank checkpoint of
    # the same spec: the whole state, the reference's format
    assert m2["keys"] == m1["keys"]
    assert m2["dtypes"] == m1["dtypes"]
    assert _arrays(os.path.join(work, "ckpt_m2", "step_0000000002")) == \
        _arrays(os.path.join(work, "ckpt_m1", "step_0000000002"))
    assert any(k.endswith("/v_row") for k in m2["keys"])


def test_only_the_global_rank_0_writes(pair):
    _, (r0, r1), work = pair
    # the uninterrupted run's steps 2 and 4, the killed run's step 2 and
    # the resumed run's step 4
    assert r0["checkpoint"]["writes"] == [2, 4, 2, 4]
    assert r1["checkpoint"]["writes"] == []
    assert checkpoint.list_steps(os.path.join(work, "ckpt_m2")) == [2, 4]


def test_kill_and_resume_at_model_parallel_is_bit_faithful(pair):
    _, ranks, _ = pair
    for rank in ranks:
        rec = rank["checkpoint"]
        assert rec["resumed_at"] == 2
        assert rec["resumed_history"][-2:] == rec["history"][-2:]
        for a, b in zip(rec["resumed_local"], rec["local"]):
            assert torch.equal(a, b)
        for path, x in rec["opt_local"].items():
            assert torch.equal(rec["resumed_opt"][path], x), path
    assert ranks[0]["checkpoint"]["history"] == \
        ranks[1]["checkpoint"]["history"]


def test_checkpoint_restores_at_one_rank_and_continues(pair,
                                                       restored_at_one_rank):
    _, (r0, _), _ = pair
    got, want = restored_at_one_rank, r0["checkpoint"]
    assert got["at"] == 2
    # the restored history is the model-parallel run's, bit for bit
    assert got["history"][:2] == want["history"][:2]
    # then two f32 steps at one rank against two at model = 2: the order
    # of the sums only (1e-5)
    np.testing.assert_allclose([h["loss"] for h in got["history"][2:]],
                               [h["loss"] for h in want["history"][2:]],
                               rtol=1e-5)
    for path, g, w in _pairs(got["params"], want["params"]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    for ref, slots in want["opt"]["leaves"].items():
        for slot, w in slots.items():
            np.testing.assert_allclose(
                got["opt"]["leaves"][ref][slot], w, rtol=1e-5, atol=1e-5,
                err_msg=f"{ref}/{slot}")


# ---------------------------------------------------------------------------
# A.15: generate and serve against the reference's Run on its 1 x 2 mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt_len,gen", GENERATE)
def test_generate_equals_the_reference(pair, prompt_len, gen):
    reference, ranks, _ = pair
    want = reference[("generate", prompt_len, gen)]
    for rank in ranks:
        got = rank["serving"][("generate", prompt_len, gen)]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        # f32 logits, the same weights: the order of the sums only (1e-5)
        np.testing.assert_allclose(got["last_logits"], want["last_logits"],
                                   rtol=1e-5, atol=1e-5)
        total = prompt_len + gen
        # 32 positions split on the sequence; 14 (< head_dim) and 17 (odd)
        # on head_dim
        split = "seq" if total % 2 == 0 and total >= 16 else "dh"
        assert got["split"] == split, (total, got["split"])
        assert got["local_k"][{"seq": 2, "dh": 4}[split]] == \
            {"seq": total, "dh": 16}[split] // 2
    np.testing.assert_array_equal(
        ranks[0]["serving"][("generate", prompt_len, gen)]["last_logits"],
        ranks[1]["serving"][("generate", prompt_len, gen)]["last_logits"])


@pytest.mark.parametrize("case", tuple(SERVE_CASES))
def test_serve_equals_the_reference_session(pair, case):
    reference, ranks, _ = pair
    want = reference[("serve", case)]
    assert [len(t) for t in want] == [m for _, m in SERVE_CASES[case][3]]
    for rank in ranks:
        got = rank["serving"][("serve", case)]
        # greedy f32 tokens: equal
        assert got["tokens"] == want, (got["tokens"], want)
        assert got["kv"] == case.split("/")[1]
        if got["kv"] == "pages":
            assert got["pool_k"][2] == SERVE_CASES[case][2] // 2
        else:
            assert got["pool_k"][4] == 8


# ---------------------------------------------------------------------------
# A.16: LoRA over a model-parallel weight
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", LORA_KINDS)
@pytest.mark.parametrize("mode", LORA_MODES)
def test_lora_over_a_model_parallel_weight_equals_the_reference(pair, mode,
                                                                kind):
    reference, ranks, _ = pair
    want = reference["lora"][kind]
    for rank in ranks:
        got = rank["lora"][(mode, kind)]
        # the base weight is frozen: no gradient reaches it
        assert got["w_grad"]
        # f32, the same plan: the order of the sums only, 1e-5 of each
        # tensor's largest magnitude (dB sums 64 products of up to ~200)
        for name in ("z", "h", "a", "b"):
            scale = float(np.abs(want[name]).max())
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=name)


# ---------------------------------------------------------------------------
# KV caches split on whatever dim the rule picks
# ---------------------------------------------------------------------------

def _rule_pick(cfg, length):
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    spec = sharding.kv_cache_spec(cfg, 2, length, mesh)
    dims = [i for i, p in enumerate(spec) if p is not None]
    return {1: "seq", 2: "kvh", 3: "dh"}[dims[0]] if dims else None


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_the_rule_picks_a_dim_for_every_cache_length(arch):
    """Which dim of a (B, L, KVH, Dh) cache the rule splits at M = 2, for
    every L in 1 .. 2·Dh + 1 of the published config: the sequence where
    L is even and at least as long as head_dim and the kv heads, else the
    larger of head_dim and the kv heads that divides (head_dim is even in
    every config)."""
    cfg = get_config(arch)
    picks = {}
    for length in range(1, 2 * cfg.head_dim + 2):
        pick = _rule_pick(cfg, length)
        picks[length] = pick
        if length % 2 == 0 and length >= max(cfg.head_dim, cfg.n_kv_heads):
            assert pick == "seq", (length, pick)
        else:
            assert pick in ("dh", "kvh"), (length, pick)
    assert picks[2 * cfg.head_dim] == "seq"
    assert picks[cfg.head_dim - 1] == picks[2 * cfg.head_dim + 1] == "dh"


@pytest.mark.parametrize("case", tuple(DECODE_CASES))
def test_decode_at_every_cache_length_equals_one_rank(pair, case):
    _, ranks, _ = pair
    arch, over = DECODE_CASES[case]
    cfg = _cfg(arch, **over)
    seen = set()
    for length in range(1, 2 * cfg.head_dim + 2):
        for rank in ranks:
            rec = rank["decode"][(case, length)]
            # f32 logits, whole on every rank: the order of the sums only
            # (2e-5 of the logits' scale, ~1, as test_torch_tp.py)
            np.testing.assert_allclose(rec["got"], rec["want"], rtol=2e-5,
                                       atol=2e-5, err_msg=f"L={length}")
        split = ranks[0]["decode"][(case, length)]["split"]
        if arch != "xlstm-125m":
            assert split == _rule_pick(cfg, length), (length, split)
        seen.add(split)
    if case == "qwen2.5-3b/kv8dh4":
        assert seen == {"seq", "kvh"}
    elif arch != "xlstm-125m":
        assert seen == {"seq", "dh"}


# ---------------------------------------------------------------------------
# what still raises names a ROADMAP item that exists
# ---------------------------------------------------------------------------

def test_every_roadmap_item_the_port_names_exists():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        items = set(re.findall(r"\*\*(A\.\d+)[:*]", f.read()))
    named = set()
    for base, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(base, name)) as f:
                    named |= set(re.findall(r"ROADMAP Queue (A\.\d+)",
                                            f.read()))
    assert named <= items, named - items
    assert not named & {"A.14", "A.15", "A.16"}
