"""Data parallelism: ``train/compression.py``, ``make_shardmap_dp_step``,
the data-parallel ``make_train_step`` and ``Run(mesh="host")``.

At one rank, ``compression`` against the reference's ``pmean_tree`` in a
one-device ``shard_map``, bit for bit, in every mode.  At two ranks, a
gloo pair on the CPU (one ``torch.multiprocessing`` spawn for the
module) against the reference on a two-device host mesh, run once in a
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=2``):
``pmean_tree`` on the same per-rank inputs bit for bit, and
``make_shardmap_dp_step`` from the same parameters (carried by
``convert.params_from_jax``, norm gains redrawn as in
``test_torch_train.py``) under ``det_topk`` in all three modes.  The pair
also runs ``Run(mesh="host")``, held against a one-rank ``Run`` on the
global batch, and a kill / resume; the ranks are held bit-identical.
Tolerances stand beside each assert."""
import dataclasses
import os
import pickle
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
from repro.launch import train_steps as jax_train_steps
from repro.train import compression as jax_compression
from repro_torch import convert
from repro_torch.api import DataSpec, Run, RunSpec
from repro_torch.core import ESSProportional, PolicyRules, Rule, WTACRSConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, train_steps
from repro_torch.models import common as cm
from repro_torch.models.registry import get_config
from repro_torch.train import compression, data, optim

torch.set_num_threads(1)

ARCH, SEQ, BATCH, N_SAMPLES, STEPS = "qwen2.5-3b", 32, 4, 32, 2
LR, WARMUP, WORLD = 1e-3, 2, 2
MODES = ("none", "bf16", "int8")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _grad_tree(seed, scale=1.0):
    """A gradient-like tree: three f32 leaves of mixed magnitudes."""
    rng = np.random.RandomState(seed)
    return {"a": (scale * rng.randn(7, 5)).astype(np.float32),
            "b": (scale * 1e-3 * rng.randn(33)).astype(np.float32),
            "c": {"d": (scale * rng.standard_t(2, (4, 6))).astype(
                np.float32)}}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _policy():
    return cm.Policy(wtacrs=WTACRSConfig(kind="det_topk", budget=0.3,
                                         min_rows=4))


def _initial_params():
    """The reference's initial parameters of the reduced arch, numpy, with
    the norm gains redrawn from [0.5, 1.5] (see ``test_torch_train.py``:
    at gains of 1 top-k is decided by the last bit)."""
    state = jax_train_steps.init_train_state(
        _f32(jax_get_config(ARCH, reduced=True)), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def redraw(path, a):
        a = np.array(a)
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, state["params"])


# the reference on a two-device host mesh, in its own process: pmean_tree
# on per-device inputs and make_shardmap_dp_step under det_topk
REFERENCE = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.core.config import WTACRSConfig
from repro.launch import mesh as mesh_lib, train_steps
from repro.models import common as cm
from repro.train import compression, data, optim

work, arch, seq, batch, n, steps, lr, warmup = sys.argv[1:9]
seq, batch, n, steps = int(seq), int(batch), int(n), int(steps)
with open(work + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
mesh = mesh_lib.make_host_mesh()
assert mesh.shape["data"] == 2, mesh.shape
out = {"pmean": {}, "dp": {}}
stacked = jax.tree.map(lambda *x: jnp.stack(x), *inputs["grads"])
for mode in ("none", "bf16", "int8"):
    fn = jax.shard_map(
        lambda t: compression.pmean_tree(
            jax.tree.map(lambda x: x[0], t), "data", mode),
        mesh=mesh, in_specs=P("data"), out_specs=P(), check_vma=False)
    out["pmean"][mode] = jax.tree.map(np.asarray, jax.jit(fn)(stacked))
cfg = dataclasses.replace(get_config(arch, reduced=True),
                          compute_dtype="float32")
policy = cm.Policy(wtacrs=WTACRSConfig(kind="det_topk", budget=0.3,
                                       min_rows=4))
ds = data.SyntheticLM(cfg.vocab_size, seq, n, seed=0)
for mode in ("none", "bf16", "int8"):
    state = train_steps.init_train_state(cfg, jax.random.PRNGKey(0))
    state = dict(state, params=jax.tree.map(jnp.asarray, inputs["params"]))
    step = jax.jit(train_steps.make_shardmap_dp_step(
        cfg, policy, optim.AdamWConfig(),
        optim.linear_warmup_constant(float(lr), int(warmup)), mesh,
        compress=mode))
    rec = {"loss": [], "grad_norm": []}
    for i in range(steps):
        b = {k: v for k, v in ds.batch_at(i, batch).items()
             if k != "sample_ids"}
        state, m = step(state, b)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec[f"params{i + 1}"] = jax.tree.map(np.asarray, state["params"])
    out["dp"][mode] = rec
with open(work + "/reference.pkl", "wb") as f:
    pickle.dump(out, f)
"""


def _run_policy():
    """CACHED_GRAD on the MLPs under an ESSProportional controller, top-k
    plans: the znorm cache, the statistics and a controller all in play,
    no random draw."""
    return cm.Policy(rules=PolicyRules.of(Rule.of(
        "*mlp*", WTACRSConfig(kind="det_topk", budget=0.3, min_rows=2,
                              norm_source="cached_grad"),
        ESSProportional(b_min=0.1, b_max=0.6, levels=6, warmup=1))))


def _run_spec(**kw):
    return RunSpec(arch=ARCH, policy=_run_policy(), steps=3, batch_size=4,
                   lr=LR, warmup=WARMUP,
                   data=DataSpec(seq_len=16, n_samples=32), **kw)


def _run(spec, params=None, restore=False):
    """A CPU Run in f32 compute; ``params``: values copied in after init
    (the same on every rank)."""
    run = Run.restore(spec, device="cpu") if restore else Run(
        spec, device="cpu")
    run.cfg = _f32(run.cfg)
    run.init()
    if params is not None:
        with torch.no_grad():
            for dst, src in zip(optim.tree_leaves(run.state["params"]),
                                optim.tree_leaves(params)):
                dst.copy_(src)
    return run


def _run_record(run):
    st = run.state
    return {"params": [p.clone() for p in optim.tree_leaves(st["params"])],
            "m": [x.clone() for x in optim.tree_leaves(st["opt"].m)],
            "znorm": {t: x.clone() for t, x in st["znorm"].items()},
            "budget_stats": {t: x.clone()
                             for t, x in st["budget_stats"].items()},
            "history": [dict(h) for h in run.history],
            "trajectory": [dict(r) for r in run.schedule_state.trajectory]}


def _run_start_params():
    """The Run's parameters: its seed's, norm gains redrawn."""
    cfg = _f32(get_config(ARCH, reduced=True))
    params = train_steps.init_train_state(cfg, 0, device="cpu")["params"]
    gen = torch.Generator().manual_seed(1)
    for path, p in optim.named_leaves(params):
        if path.endswith("gamma"):
            p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
    return params


def _rank_main(rank, work):
    """One rank of the gloo pair; writes its results to rank<r>.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=WORLD)
    try:
        with open(os.path.join(work, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        mesh = mesh_lib.make_host_mesh(device="cpu")
        out = {"world": mesh.shape["data"], "index":
               mesh_lib.data_index(mesh), "pmean": {}, "dp": {}}
        mine = _torch_tree(inputs["grads"][rank])
        for mode in MODES:
            got = compression.pmean_tree(
                optim.tree_map(torch.clone, mine), mesh, mode)
            out["pmean"][mode] = optim.tree_map(lambda t: t.numpy(), got)
        same = compression.pmean_tree(_torch_tree(_grad_tree(3)), mesh,
                                      "int8")
        out["pmean_same"] = optim.tree_map(lambda t: t.numpy(), same)
        cfg = _f32(get_config(ARCH, reduced=True))
        ds = data.SyntheticLM(cfg.vocab_size, SEQ, N_SAMPLES, seed=0)
        for mode in MODES:
            params = convert.params_from_jax(cfg, inputs["params"],
                                             device="cpu")
            state = {"params": params, "opt": optim.adamw_init(params),
                     "step": 0, "base_seed": 11}
            step = train_steps.make_shardmap_dp_step(
                cfg, _policy(), optim.AdamWConfig(),
                optim.linear_warmup_constant(LR, WARMUP), mesh,
                compress=mode, device="cpu")
            rec = {"loss": [], "grad_norm": []}
            for i in range(STEPS):
                state, m = step(state, sharding.shard_batch(
                    ds.batch_at(i, BATCH), mesh))
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
                # a copy: the step updates the parameters in place
                rec[f"params{i + 1}"] = jax.tree.map(
                    np.array, convert.params_to_numpy(cfg, state["params"]))
            out["dp"][mode] = rec
        # two parameters swapped on rank 1 (their leaf's sum unchanged):
        # the replication check refuses the Run on both ranks
        bad = Run(_run_spec(mesh="host"), device="cpu")
        bad.cfg = _f32(bad.cfg)
        path, leaf = next((p, x) for p, x in optim.named_leaves(bad.params)
                          if x.numel() > 1 and x.view(-1)[0] != x.view(-1)[1])
        if rank == 1:
            with torch.no_grad():
                leaf.view(-1)[:2] = leaf.view(-1)[:2].flip(0).clone()
        try:
            bad.init()
            out["mismatch"] = (path, None)
        except RuntimeError as e:
            out["mismatch"] = (path, str(e))
        del bad
        start = _run_start_params()
        for mb in (1, 2):
            run = _run(_run_spec(mesh="host", microbatches=mb), start)
            run.fit()
            out[f"run_mb{mb}"] = _run_record(run)
        # kill after 2 steps, restore on both ranks, finish the 3
        spec = _run_spec(mesh="host",
                         checkpoint_dir=os.path.join(work, "ckpt"))
        killed = _run(spec, start)
        killed.fit(steps=2)
        killed.save()
        killed.fit()                 # the killed run goes on past its save
        del killed
        back = _run(spec, restore=True)
        back.fit()
        out["resumed"] = _run_record(back)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The reference's two-device run and the port's gloo pair, side by
    side; returns (reference, [rank 0, rank 1])."""
    work = str(tmp_path_factory.mktemp("dp"))
    inputs = {"params": _initial_params(),
              "grads": [_grad_tree(10 + r) for r in range(WORLD)]}
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, work, ARCH, str(SEQ), str(BATCH),
         str(N_SAMPLES), str(STEPS), str(LR), str(WARMUP)],
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


@pytest.fixture(scope="module")
def one_rank_runs():
    """The one-rank Runs on the global batch (no mesh)."""
    start = _run_start_params()
    out = {}
    for mb in (1, 2):
        run = _run(_run_spec(microbatches=mb), start)
        run.fit()
        out[mb] = _run_record(run)
    return out


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["psum", "pmean"])
@pytest.mark.parametrize("mode", MODES)
def test_one_rank_compression_equals_the_reference_one_device_mesh(op,
                                                                   mode):
    tree = _grad_tree(3)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    fn = jax.shard_map(
        lambda t: getattr(jax_compression, f"{op}_tree")(t, "data", mode),
        mesh=mesh, in_specs=jax.sharding.PartitionSpec(),
        out_specs=jax.sharding.PartitionSpec(), check_vma=False)
    want = jax.jit(fn)(jax.tree.map(jnp.asarray, tree))
    got = getattr(compression, f"{op}_tree")(_torch_tree(tree), None,
                                             mode)
    # the same f32 operations on the same values: bit for bit
    for g, w in zip(_leaves(optim.tree_map(lambda t: t.numpy(), got)),
                    _leaves(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", MODES)
def test_two_rank_pmean_equals_the_reference_two_device_mesh(pair, mode):
    reference, ranks = pair
    # the same per-rank inputs, the same operations: bit for bit, and the
    # same on both ranks
    for rank in ranks:
        for g, w in zip(_leaves(rank["pmean"][mode]),
                        _leaves(reference["pmean"][mode])):
            np.testing.assert_array_equal(g, w)


def test_payload_bytes():
    tree = _torch_tree(_grad_tree(0))
    n = sum(t.numel() for t in optim.tree_leaves(tree))     # 35 + 33 + 24
    assert compression.payload_bytes(tree, "none") == 4 * n
    assert compression.payload_bytes(tree, "bf16") == 2 * n
    # the int32 cast, plus one f32 maximum a leaf
    assert compression.payload_bytes(tree, "int8") == 4 * n + 4 * 3
    with pytest.raises(ValueError):
        compression.payload_bytes(tree, "fp8")


def test_reference_int8_all_reduces_int32_payload():
    """ROADMAP Queue C: the reference's int8 mode sums the int32 cast, so
    its payload is 4 bytes an element, as under none; the port mirrors it
    in ``payload_bytes``."""
    tree = jax.tree.map(jnp.asarray, _grad_tree(0))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    fn = jax.shard_map(
        lambda t: jax_compression.psum_tree(t, "data", "int8"), mesh=mesh,
        in_specs=jax.sharding.PartitionSpec(),
        out_specs=jax.sharding.PartitionSpec(), check_vma=False)
    text = str(jax.make_jaxpr(fn)(tree))
    summed = [ln for ln in text.splitlines() if "psum" in ln]
    # per leaf: one f32 psum of the maximum, one int32 psum of the values
    assert sum("i32[" in ln for ln in summed) == 3
    assert not any("i8[" in ln for ln in summed)
    port = _torch_tree(_grad_tree(0))
    assert compression.payload_bytes(port, "int8") > \
        compression.payload_bytes(port, "none")


def test_int8_shared_scale_is_the_sum_of_the_ranks_maxima(pair):
    """ROADMAP Queue C: the shared scale is the SUM of the ranks' maxima.
    Both ranks hand in the same tree, so the mean should be that tree; its
    values come out as whole multiples of W * max|g| / 127 (a shared max
    would give max|g| / 127), and the error reaches past half of the
    finer quantum."""
    _, ranks = pair
    want = _grad_tree(3)
    got = ranks[0]["pmean_same"]
    for g, w in zip(_leaves(got), _leaves(want)):
        fine = np.float32(np.abs(w).max()) / np.float32(127.0)
        steps = g / (WORLD * fine)
        # float32 rounding of the dequantized value only: 1e-4 of a step
        np.testing.assert_allclose(steps, np.round(steps), atol=1e-4)
        err = np.abs(g - w).max()
        assert fine / 2 < err <= WORLD * fine / 2 * (1 + 1e-5)


# ---------------------------------------------------------------------------
# make_shardmap_dp_step at two ranks against the reference's
# ---------------------------------------------------------------------------

def _param_pairs(got, want):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    return [(jax.tree_util.keystr(p), g, w)
            for (p, g), (_, w) in zip(flat_g, flat_w)]


@pytest.mark.parametrize("mode", MODES)
def test_dp_step_equals_the_reference_shard_map_step(pair, mode):
    reference, ranks = pair
    want, got = reference["dp"][mode], ranks[0]["dp"][mode]
    # f32 compute, the same plans: summation orders differ (1e-4, as
    # test_torch_train.py)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    if mode == "none":
        for name, g, w in _param_pairs(got["params2"], want["params2"]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        return
    # bf16 / int8 round each rank's gradient: where the two frameworks'
    # f32 gradients (equal to ~1e-6) fall on two sides of a rounding
    # midpoint, the reduced gradient differs by one quantum and the
    # element's first Adam step (lr * g / (|g| + eps)) by at most lr —
    # at most 0.1 % of the elements.  The second step's plans then see
    # different parameters (top-k is decided by such ties), so the
    # parameters are compared after the first step.
    off = total = 0
    for name, g, w in _param_pairs(got["params1"], want["params1"]):
        far = ~np.isclose(g, w, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_less(np.abs(g - w)[far], LR * 1.0001,
                                     err_msg=name)
        off, total = off + far.sum(), total + far.size
    assert off <= total // 1000, (off, total)


@pytest.mark.parametrize("what", [f"dp_{m}" for m in MODES]
                         + ["run_mb1", "run_mb2", "resumed"])
def test_ranks_are_bit_identical(pair, what):
    _, (r0, r1) = pair
    assert (r0["world"], r0["index"], r1["world"], r1["index"]) == \
        (2, 0, 2, 1)
    if what.startswith("dp_"):
        a, b = (r["dp"][what[3:]] for r in (r0, r1))
        assert a["loss"] == b["loss"]
        for x, y in zip(_leaves(a["params2"]), _leaves(b["params2"])):
            np.testing.assert_array_equal(x, y)
        return
    a, b = r0[what], r1[what]
    assert a["history"] == b["history"]
    assert a["trajectory"] == b["trajectory"]
    for name in ("params", "m"):
        for x, y in zip(a[name], b[name]):
            assert torch.equal(x, y), name
    for name in ("znorm", "budget_stats"):
        for t in a[name]:
            assert torch.equal(a[name][t], b[name][t]), (name, t)


def test_ranks_that_drew_different_parameters_are_refused(pair):
    _, ranks = pair
    for rank in ranks:
        path, msg = rank["mismatch"]
        assert msg is not None and "different parameters" in msg, msg
        assert f"first at {path}" in msg, msg


# ---------------------------------------------------------------------------
# Run(mesh="host") at two ranks against one rank on the global batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mb", [1, 2])
def test_two_rank_run_equals_the_one_rank_run(pair, one_rank_runs, mb):
    _, (r0, _) = pair
    got, want = r0[f"run_mb{mb}"], one_rank_runs[mb]
    # the same plans on the same rows; the batch's sums split over two
    # ranks and the taps' 1/4 are exact, so only the order of the sums
    # differs: rtol 1e-5, atol 1e-6
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]], **tol)
    np.testing.assert_allclose([h["grad_norm"] for h in got["history"]],
                               [h["grad_norm"] for h in want["history"]],
                               **tol)
    assert got["trajectory"] == want["trajectory"]
    assert any(r["prev"] is not None for r in got["trajectory"])
    assert set(got["znorm"]) == set(want["znorm"]) != set()
    for name in ("znorm", "budget_stats"):
        for t in want[name]:
            np.testing.assert_allclose(got[name][t].numpy(),
                                       want[name][t].numpy(), **tol,
                                       err_msg=f"{name}/{t}")
    # the first moments are linear in the gradients, whose rounding noise
    # is relative to the largest terms summed: rtol 1e-5, atol 1e-5 of the
    # leaf's largest moment
    for x, y in zip(got["m"], want["m"]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(y.abs().max()))
    # Adam divides by sqrt(v): where a gradient is as small as its rounding
    # noise (some of attn/bk's, ~1e-9 against eps 1e-8) the update is that
    # noise over eps, so the parameters are held as test_torch_train.py
    # holds them after Adam: 1e-4
    for x, y in zip(got["params"], want["params"]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_two_rank_kill_and_resume_is_bit_equal(pair):
    _, ranks = pair
    for rank in ranks:
        a, b = rank["run_mb1"], rank["resumed"]
        assert a["history"] == b["history"]
        assert a["trajectory"] == b["trajectory"]
        for name in ("params", "m"):
            for x, y in zip(a[name], b[name]):
                assert torch.equal(x, y), name
        for name in ("znorm", "budget_stats"):
            for t in a[name]:
                assert torch.equal(a[name][t], b[name][t]), (name, t)


# ---------------------------------------------------------------------------
# meshes and the data-parallel arguments
# ---------------------------------------------------------------------------

def test_host_mesh_without_a_process_group_is_one_rank(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = mesh_lib.make_host_mesh(device="cpu")
    assert (dict(mesh.shape), mesh.axis_names, mesh.group) == \
        ({"data": 1, "model": 1}, ("data", "model"), None)
    assert mesh_lib.data_index(mesh) == 0
    assert mesh_lib.data_axes(mesh) == ("data",)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_lib.make_host_mesh(device="cpu")
    # one rank does not split into a model axis of two
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.make_host_mesh(model_parallel=2, device="cpu")


def test_production_meshes_are_the_references():
    one, multi = (mesh_lib.make_production_mesh(multi_pod=m)
                  for m in (False, True))
    assert dict(one.shape) == {"data": 16, "model": 16}
    assert one.axis_names == ("data", "model") and one.group is None
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert mesh_lib.data_axes(multi) == ("pod", "data")
    assert mesh_lib.mesh_size(multi, ("pod", "data")) == 32
    assert mesh_lib.model_axis(multi) == "model"


def test_steps_refuse_a_mesh_that_is_not_live():
    cfg = get_config(ARCH, reduced=True)
    sched = optim.linear_warmup_constant(LR, WARMUP)
    abstract = mesh_lib.make_production_mesh()
    with pytest.raises(ValueError, match="live mesh"):
        train_steps.make_shardmap_dp_step(cfg, _policy(), optim.AdamWConfig(),
                                          sched, abstract, device="cpu")
    live = mesh_lib.make_host_mesh(device="cpu")
    with pytest.raises(ValueError, match="does not have"):
        train_steps.make_train_step(cfg, _policy(), optim.AdamWConfig(),
                                    sched, device="cpu", mesh=live,
                                    data_axes=("pod",))
    with pytest.raises(ValueError, match="compress"):
        train_steps.make_shardmap_dp_step(cfg, _policy(), optim.AdamWConfig(),
                                          sched, live, compress="fp8",
                                          device="cpu")


def test_one_rank_dp_step_none_equals_make_train_step():
    """World 1: the all-reduce is the identity and the mean divides by 1,
    so ``none`` is bit-equal to ``make_train_step`` under ``det_topk``
    (which draws nothing, so the folded seed does not matter)."""
    cfg = _f32(get_config(ARCH, reduced=True))
    ds = data.SyntheticLM(cfg.vocab_size, SEQ, N_SAMPLES, seed=0)
    sched = optim.linear_warmup_constant(LR, WARMUP)
    mesh = mesh_lib.make_host_mesh(device="cpu")
    out = []
    for dp in (True, False):
        state = train_steps.init_train_state(cfg, 0, device="cpu")
        step = (train_steps.make_shardmap_dp_step(
            cfg, _policy(), optim.AdamWConfig(), sched, mesh, device="cpu")
            if dp else train_steps.make_train_step(
                cfg, _policy(), optim.AdamWConfig(), sched, device="cpu"))
        losses = []
        for i in range(STEPS):
            state, m = step(state, ds.batch_at(i, BATCH))
            losses.append(float(m["loss"]))
        out.append((losses, optim.tree_leaves(state["params"])))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
