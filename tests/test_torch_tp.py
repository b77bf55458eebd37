"""Tensor and expert parallelism: the ``model`` axis.

A gloo pair on the CPU (one ``torch.multiprocessing`` spawn for the
module) runs the port at ``model = 2`` (``make_host_mesh(model_parallel=
2)``: a 1 x 2 mesh), and beside it, in a subprocess, the reference runs
its own sharded program on a 1 x 2 host mesh (``jax.jit`` with
``train_state_shardings``, ``XLA_FLAGS=
--xla_force_host_platform_device_count=2``), from the same parameters
(``convert.params_from_jax``, norm gains redrawn as in
``test_torch_train.py``, then ``shard_params``).  Reduced qwen2.5-3b and
reduced granite-moe-1b-a400m (expert parallel, ``Policy.moe_pspec`` set
as the reference's optimized dry run sets it), f32, two steps under the
exact estimator and under ``det_topk``; then a prefill and four decode
steps.  The pair also holds ``shard_params`` / ``gather_params`` as a
bit-exact round trip, the ranks' replicated leaves bit-identical, and
``Run(mesh="host", model_parallel=2)`` against a one-rank Run.  The
optimizer layouts, checkpoints, generation, serving and LoRA over the
model axis are ``test_torch_tp_state.py``'s.  Tolerances stand beside
each assert."""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_config as jax_get_config
from repro.launch import train_steps as jax_train_steps
from repro_torch import convert
from repro_torch.api import DataSpec, Run, RunSpec
from repro_torch.core import WTACRSConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, train_steps
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.models.registry import get_config
from repro_torch.train import data, optim

torch.set_num_threads(1)

# (arch, config overrides) of each case: the reduced archs, and reduced
# qwen2.5-3b with one kv head (replicated over model: every rank projects
# it whole and its q heads read it; the rules' choice at 16 ranks for
# qwen2.5-3b, nemotron-4-15b, command-r-35b and dbrx-132b) and with 3 q
# heads on it (q's features split through a head, as minicpm-2b's 36 on
# 16: q all-gathered before the scores)
CASES = {"qwen2.5-3b": ("qwen2.5-3b", {}),
         "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}),
         "qwen2.5-3b/kv1": ("qwen2.5-3b", {"n_kv_heads": 1}),
         "qwen2.5-3b/h3kv1": ("qwen2.5-3b", {"n_heads": 3,
                                              "n_kv_heads": 1})}
ARCHS = tuple(CASES)
KINDS = ("exact", "det_topk")
SEQ, BATCH, N_SAMPLES, STEPS, LR, WARMUP, WORLD = 32, 4, 32, 2, 1e-3, 2, 2
PROMPT, DECODE, CACHE = 16, 4, 32
# Adam at eps 1e-5 (as test_torch_ssm.py's xlstm parity): attn/bk's
# gradient is zero but for rounding (a k bias shifts every score of a
# query alike), and at the default eps 1e-8 Adam divides that noise by
# itself, so the parameters would hold the noise's sign, not the program
ADAM = optim.AdamWConfig(eps=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _cfg(case, get=None):
    """The case's reduced config in f32 compute (``get``: the reference's
    ``get_config``; the port's by default)."""
    arch, over = CASES[case]
    return dataclasses.replace((get or get_config)(arch, reduced=True),
                               compute_dtype="float32", **over)


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


def _tokens(arch):
    cfg = _cfg(arch)
    return data.SyntheticLM(cfg.vocab_size, SEQ, N_SAMPLES, seed=0)


# The reference's sharded program on a 1 x 2 host mesh, in its own process.
REFERENCE = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.config import WTACRSConfig
from repro.launch import mesh as mesh_lib, sharding as shard_lib, train_steps
from repro.models import common as cm, registry
from repro.train import data, optim

work, seq, batch, n, steps, lr, warmup, prompt, decode, cache = sys.argv[1:11]
seq, batch, n, steps = int(seq), int(batch), int(n), int(steps)
prompt, decode, cache = int(prompt), int(decode), int(cache)
with open(work + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
mesh = mesh_lib.make_host_mesh(model_parallel=2)
assert dict(mesh.shape) == {"data": 1, "model": 2}, mesh.shape
out = {}
for arch, (name, over) in inputs["cases"].items():
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              compute_dtype="float32", **over)
    ds = data.SyntheticLM(cfg.vocab_size, seq, n, seed=0)
    _, axes = registry.abstract_params(cfg)
    for kind in ("exact", "det_topk"):
        est = (WTACRSConfig(kind="exact") if kind == "exact" else
               WTACRSConfig(kind="det_topk", budget=0.3, min_rows=4))
        moe = (dict(moe_pspec=("model", ("data",)), moe_groups=1)
               if "moe" in arch else {})
        policy = cm.Policy(wtacrs=est, **moe)
        state = train_steps.init_train_state(cfg, jax.random.PRNGKey(0))
        state = dict(state, params=jax.tree.map(jnp.asarray,
                                                inputs[arch]))
        sh = train_steps.train_state_shardings(cfg, state, axes, mesh)
        b0 = {k: v for k, v in ds.batch_at(0, batch).items()
              if k != "sample_ids"}
        b_sh = shard_lib.batch_shardings(b0, mesh)
        with mesh_lib.use_mesh(mesh):
            state = jax.device_put(state, sh)
            step = jax.jit(train_steps.make_train_step(
                cfg, policy, optim.AdamWConfig(eps=1e-5),
                optim.linear_warmup_constant(float(lr), int(warmup))),
                in_shardings=(sh, b_sh), out_shardings=(sh, None))
            rec = {"loss": [], "grad_norm": []}
            for i in range(steps):
                b = {k: v for k, v in ds.batch_at(i, batch).items()
                     if k != "sample_ids"}
                state, m = step(state, b)
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
            rec["params"] = jax.tree.map(np.asarray, state["params"])
            rec["m"] = jax.tree.map(np.asarray, state["opt"].m)
        out[(arch, kind)] = rec
    # serving from the parameters after the exact steps
    params = jax.tree.map(jnp.asarray, out[(arch, "exact")]["params"])
    p_sh = shard_lib.param_shardings(axes, params, mesh,
                                     rules=shard_lib.arch_rules(cfg, mesh))
    toks = ds.batch_at(5, 2)["tokens"]
    policy = cm.Policy()
    with mesh_lib.use_mesh(mesh):
        params = jax.device_put(params, p_sh)
        pb = {"tokens": toks[:, :prompt]}
        pre = jax.jit(train_steps.make_prefill_step(cfg, policy),
                      in_shardings=(p_sh, shard_lib.batch_shardings(pb,
                                                                    mesh)))
        last, _ = pre(params, pb)
        states = registry.decode_state_init(cfg, 2, cache)
        st_sh = shard_lib.decode_state_shardings(states, mesh, 2)
        states = jax.device_put(states, st_sh)
        serve = jax.jit(train_steps.make_serve_step(cfg, policy))
        logits = []
        for t in range(prompt + decode):
            _, lg, states = serve(params, jnp.asarray(toks[:, t]),
                                  jnp.int32(t), states)
            logits.append(np.asarray(lg))
    out[(arch, "serve")] = {"prefill": np.asarray(last), "decode": logits}
with open(work + "/reference.pkl", "wb") as f:
    pickle.dump(out, f)
"""


def _specs(cfg, mesh):
    params, axes = registry.abstract_params(cfg)
    return sharding.param_shardings(axes, params, mesh,
                                    rules=sharding.arch_rules(cfg, mesh))


def _numpy(cfg, params):
    return jax.tree.map(np.array, convert.params_to_numpy(cfg, params))


def _train(arch, kind, full, mesh):
    """STEPS train steps from ``full`` (whole parameters) on ``mesh`` (or
    on one rank); returns the record and the final (local) parameters."""
    cfg = _cfg(arch)
    params = full if mesh is None else sharding.shard_params(
        full, _specs(cfg, mesh), mesh)
    state = {"params": params, "opt": optim.adamw_init(params), "step": 0,
             "base_seed": 11}
    step = train_steps.make_train_step(
        cfg, _policy(arch, kind), ADAM,
        optim.linear_warmup_constant(LR, WARMUP), device="cpu", mesh=mesh)
    ds = _tokens(arch)
    rec = {"loss": [], "grad_norm": []}
    for i in range(STEPS):
        state, m = step(state, ds.batch_at(i, BATCH))
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
    whole, m1 = state["params"], state["opt"].m
    if mesh is not None:
        specs = _specs(cfg, mesh)
        whole = sharding.gather_params(whole, specs, mesh)
        m1 = sharding.gather_tree(m1, specs, mesh)
    rec["params"] = _numpy(cfg, whole)
    rec["m"] = _numpy(cfg, m1)
    rec["local"] = {p: x.clone()
                    for p, x in optim.named_leaves(state["params"])}
    return rec, state["params"]


def _serve(arch, local, mesh):
    """Prefill of the first PROMPT tokens, and PROMPT + DECODE decode
    steps fed the same tokens from an empty cache of CACHE positions
    (each rank holding its slice of the sequence)."""
    cfg = _cfg(arch)
    toks = _tokens(arch).batch_at(5, 2)["tokens"]
    last, _ = train_steps.make_prefill_step(
        cfg, cm.Policy(), device="cpu", mesh=mesh)(
            local, {"tokens": toks[:, :PROMPT]})
    states = registry.decode_state_init(cfg, 2, CACHE, device="cpu")
    specs = sharding.decode_state_shardings(states, mesh, 2)
    states = sharding.shard_tree(states, specs, mesh)
    serve = train_steps.make_serve_step(cfg, cm.Policy(), device="cpu",
                                        mesh=mesh)
    logits = []
    for t in range(PROMPT + DECODE):
        _, lg, states = serve(local, torch.as_tensor(toks[:, t]), t, states)
        logits.append(lg.numpy().copy())
    return {"prefill": last.numpy(), "decode": logits,
            "kv_spec": specs["0/k"], "kv_local": tuple(states[0]["k"].shape)}


def _run_spec(**kw):
    return RunSpec(arch="qwen2.5-3b", policy=cm.Policy(), steps=2,
                   optimizer=ADAM,
                   batch_size=4, lr=LR, warmup=WARMUP,
                   data=DataSpec(seq_len=16, n_samples=32), **kw)


def _run(spec):
    run = Run(spec, device="cpu")
    run.cfg = _f32(run.cfg)
    return run


def _rank_main(rank, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=WORLD)
    try:
        with open(os.path.join(work, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        mesh = mesh_lib.make_host_mesh(model_parallel=2, device="cpu")
        out = {"shape": dict(mesh.shape), "model_index":
               mesh_lib.model_index(mesh), "data_index":
               mesh_lib.data_index(mesh)}
        for arch in ARCHS:
            cfg = _cfg(arch)
            full = convert.params_from_jax(cfg, inputs[arch], device="cpu")
            specs = _specs(cfg, mesh)
            back = sharding.gather_params(
                sharding.shard_params(full, specs, mesh), specs, mesh)
            out[(arch, "round_trip")] = all(
                torch.equal(a, b) for a, b in zip(optim.tree_leaves(full),
                                                  optim.tree_leaves(back)))
            out[(arch, "sharded")] = sorted(
                p for p, s in specs.items() if any(x for x in s))
            for kind in KINDS:
                rec, local = _train(arch, kind, full, mesh)
                out[(arch, kind)] = rec
                if kind == "exact":
                    out[(arch, "serve")] = _serve(arch, local, mesh)
        run = _run(_run_spec(mesh="host", model_parallel=2))
        run.fit()
        out["run"] = {"history": run.history,
                      "params": _numpy(run.cfg, run.gathered_params())}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The reference's 1 x 2 run and the port's gloo pair, side by side;
    returns (reference, [rank 0, rank 1])."""
    work = str(tmp_path_factory.mktemp("tp"))
    inputs = {arch: _initial_params(arch) for arch in ARCHS}
    inputs["cases"] = dict(CASES)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, work, str(SEQ), str(BATCH),
         str(N_SAMPLES), str(STEPS), str(LR), str(WARMUP), str(PROMPT),
         str(DECODE), str(CACHE)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.start_processes(_rank_main, args=(work,), nprocs=WORLD,
                           start_method="spawn")
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with open(os.path.join(work, "reference.pkl"), "rb") as f:
        reference = pickle.load(f)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return reference, ranks


def _pairs(got, want):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    return [(jax.tree_util.keystr(p), np.asarray(g), np.asarray(w))
            for (p, g), (_, w) in zip(flat_g, flat_w)]


# ---------------------------------------------------------------------------
# the mesh and the shards
# ---------------------------------------------------------------------------

def test_the_pair_is_one_model_group(pair):
    _, ranks = pair
    for r, rank in enumerate(ranks):
        assert rank["shape"] == {"data": 1, "model": 2}
        assert (rank["data_index"], rank["model_index"]) == (0, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_then_gather_is_bit_exact(pair, arch):
    _, ranks = pair
    for rank in ranks:
        assert rank[(arch, "round_trip")] is True
        # the rules shard something: the embedding over the vocabulary,
        # the q heads, the MLP or the experts
        assert any("embed" == p for p in rank[(arch, "sharded")])
        assert any(p.endswith("attn/wq") for p in rank[(arch, "sharded")])


# ---------------------------------------------------------------------------
# two train steps against the reference's sharded program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_steps_equal_the_reference_sharded_steps(pair, arch, kind):
    reference, (r0, _) = pair
    want, got = reference[(arch, kind)], r0[(arch, kind)]
    # f32, the same plans (exact, or top-k of the same norms with the
    # gains redrawn): only the order of the sums differs — the partial
    # products of the row-parallel weights, the all-reduced norms, the
    # vocab-parallel softmax: 1e-5
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-5)
    for name in ("params", "m"):
        for path, g, w in _pairs(got[name], want[name]):
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-5 * (scale if name == "m" else 1),
                err_msg=f"{name}{path}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaves_are_bit_identical_across_the_ranks(pair, arch,
                                                             kind):
    _, (r0, r1) = pair
    a, b = r0[(arch, kind)], r1[(arch, kind)]
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    sharded = set(r0[(arch, "sharded")])
    replicated = [p for p in a["local"] if p not in sharded]
    assert replicated and sharded
    # every model rank computes a replicated leaf's update from the same
    # all-reduced values: bit for bit
    for path in replicated:
        assert torch.equal(a["local"][path], b["local"][path]), path
    for path in sharded:
        assert a["local"][path].shape == b["local"][path].shape
    # and the gathered parameters are the same on both ranks
    for _, x, y in _pairs(a["params"], b["params"]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# prefill and decode against the reference's sharded serving steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_and_decode_equal_the_reference(pair, arch):
    reference, (r0, r1) = pair
    want, got = reference[(arch, "serve")], r0[(arch, "serve")]
    # the caches are split on their sequence dim, as
    # decode_state_shardings says, each rank holding half the positions
    assert got["kv_spec"][2] == "model"
    assert got["kv_local"][2] == CACHE // 2
    # f32 logits, the same weights: summation order only (2e-5 of the
    # logits' scale, ~1)
    np.testing.assert_allclose(got["prefill"], want["prefill"], rtol=2e-5,
                               atol=2e-5)
    assert len(got["decode"]) == len(want["decode"]) == PROMPT + DECODE
    for t, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5,
                                   err_msg=f"decode step {t}")
    for g, w in zip(got["decode"], r1[(arch, "serve")]["decode"]):
        np.testing.assert_array_equal(g, w)    # both ranks: whole logits


# ---------------------------------------------------------------------------
# Run(mesh="host", model_parallel=2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank_run():
    run = _run(_run_spec())
    run.fit()
    return {"history": run.history, "params": _numpy(run.cfg, run.params)}


def test_model_parallel_run_equals_the_one_rank_run(pair, one_rank_run):
    _, (r0, r1) = pair
    got, want = r0["run"], one_rank_run
    # the same parameters from the seed, exact linears in f32: sums in
    # another order only (1e-5; parameters after Adam 1e-5 — see
    # test_tp_steps_equal_the_reference_sharded_steps)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got["history"]],
                                   [h[key] for h in want["history"]],
                                   rtol=1e-5)
    for path, g, w in _pairs(got["params"], want["params"]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    assert r0["run"]["history"] == r1["run"]["history"]
