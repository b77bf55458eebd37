"""The recurrent blocks and the encoder-decoder over the ``model`` axis.

As ``test_torch_tp.py`` does for the dense and MoE blocks: a gloo pair on
the CPU (one ``torch.multiprocessing`` spawn for the module) runs the
port at ``model = 2`` (``make_host_mesh(model_parallel=2)``), and beside
it, in a subprocess, the reference runs its own sharded program on a
1 x 2 host mesh (``jax.jit`` with ``train_state_shardings``,
``XLA_FLAGS=--xla_force_host_platform_device_count=2``), from the same
parameters (``convert.params_from_jax``, norm gains redrawn, then
``shard_params``) and the same numpy batches.  Reduced zamba2-2.7b
(Mamba2 split by heads, and with a state width of 7, which takes the
gathered path), reduced xlstm-125m (mLSTM / sLSTM split by heads, and
with one head, gathered), reduced whisper-base (a vocab-parallel tied
head, and with 255 tokens, a whole one); f32, two steps under the exact
estimator and under ``det_topk``; then a prefill (whisper:
``prime_cross_cache``) and decode steps from an empty cache, the states
gathered into the reference's whole layout.  The pair also holds
``shard_params`` / ``gather_params`` as a bit-exact round trip with the
fused projections split segment by segment, the ranks' replicated leaves
bit-identical, and the gradient of the gated RMSNorm's two-way
all-reduce against one rank's.  Tolerances stand beside each assert."""
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
from repro_torch.core import WTACRSConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, train_steps
from repro_torch.models import common as cm
from repro_torch.models import encdec, registry, ssm
from repro_torch.models.registry import get_config
from repro_torch.train import data, optim

torch.set_num_threads(1)

# (arch, config overrides) of each case
CASES = {"zamba2-2.7b": ("zamba2-2.7b", {}),
         "zamba2-2.7b/n7": ("zamba2-2.7b", {"ssm_state": 7}),
         "xlstm-125m": ("xlstm-125m", {}),
         "xlstm-125m/h1": ("xlstm-125m", {"n_heads": 1, "n_kv_heads": 1}),
         "whisper-base": ("whisper-base", {}),
         "whisper-base/v255": ("whisper-base", {"vocab_size": 255})}
# zamba2's gradients carry rounding noise of up to ~1.5e-4 of a small
# leaf's scale (conv_b, dt_bias, a_log: sums over B·L of terms that
# cancel) in every program: the one-rank port is 13x test_torch_tp.py's
# first-moment tolerance from the reference, and after Adam 53x on one
# embedding entry with a noise-level gradient.  Its cases are held at the
# one-rank port's own distance from the reference (the largest over the
# tree, as a multiple of the tolerance), doubled.
CALIBRATED = ("zamba2-2.7b", "zamba2-2.7b/n7")
KINDS = ("exact", "det_topk")
SEQ, BATCH, N_SAMPLES, STEPS, LR, WARMUP, WORLD = 32, 4, 32, 2, 1e-3, 2, 2
PROMPT, DECODE, CACHE, ENC = 16, 4, 32, 16
ADAM = optim.AdamWConfig(eps=1e-5)     # as test_torch_tp.py
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _cfg(case, get=None):
    arch, over = CASES[case]
    return dataclasses.replace((get or get_config)(arch, reduced=True),
                               compute_dtype="float32", **over)


def _policy(kind):
    return cm.Policy(wtacrs=(
        WTACRSConfig(kind="exact") if kind == "exact" else
        WTACRSConfig(kind="det_topk", budget=0.3, min_rows=4)))


def _initial_params(case):
    """The reference's initial parameters, numpy, norm gains redrawn from
    [0.5, 1.5] (at gains of 1, top-k is decided by the last bit)."""
    state = jax_train_steps.init_train_state(
        _cfg(case, jax_get_config), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def redraw(path, a):
        a = np.array(a)
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, state["params"])


def _inputs(case):
    """The numpy batches of the steps and of serving: tokens from
    ``SyntheticLM``; an enc-dec's halves of SEQ, with frames drawn from
    a seeded normal."""
    cfg = _cfg(case)
    ds = data.SyntheticLM(cfg.vocab_size, SEQ, N_SAMPLES, seed=0)
    steps = []
    for i in range(STEPS):
        b = ds.batch_at(i, BATCH)
        b = {"tokens": b["tokens"], "labels": b["labels"]}
        if cfg.is_encdec:
            b = {"tokens": b["tokens"][:, :SEQ // 2],
                 "labels": b["labels"][:, :SEQ // 2],
                 "frames": np.random.RandomState(i).randn(
                     BATCH, SEQ // 2, cfg.d_model).astype(np.float32)}
        steps.append(b)
    serve = {"tokens": ds.batch_at(5, 2)["tokens"]}
    if cfg.is_encdec:
        serve["frames"] = np.random.RandomState(5).randn(
            2, ENC, cfg.d_model).astype(np.float32)
    return {"params": _initial_params(case), "steps": steps,
            "serve": serve}


# The reference's sharded program on a 1 x 2 host mesh, in its own process.
REFERENCE = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.config import WTACRSConfig
from repro.launch import mesh as mesh_lib, sharding as shard_lib, train_steps
from repro.models import common as cm, encdec, registry
from repro.train import optim

work, steps, lr, warmup, prompt, decode, cache, enc = sys.argv[1:9]
steps, prompt, decode = int(steps), int(prompt), int(decode)
cache, enc = int(cache), int(enc)
with open(work + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
mesh = mesh_lib.make_host_mesh(model_parallel=2)
assert dict(mesh.shape) == {"data": 1, "model": 2}, mesh.shape
out = {}
np_tree = lambda t: jax.tree.map(np.asarray, t)
for case, (name, over) in inputs["cases"].items():
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              compute_dtype="float32", **over)
    case_in = inputs[case]
    _, axes = registry.abstract_params(cfg)
    for kind in ("exact", "det_topk"):
        est = (WTACRSConfig(kind="exact") if kind == "exact" else
               WTACRSConfig(kind="det_topk", budget=0.3, min_rows=4))
        policy = cm.Policy(wtacrs=est)
        state = train_steps.init_train_state(cfg, jax.random.PRNGKey(0))
        state = dict(state, params=jax.tree.map(jnp.asarray,
                                                case_in["params"]))
        sh = train_steps.train_state_shardings(cfg, state, axes, mesh)
        b_sh = shard_lib.batch_shardings(case_in["steps"][0], mesh)
        with mesh_lib.use_mesh(mesh):
            state = jax.device_put(state, sh)
            step = jax.jit(train_steps.make_train_step(
                cfg, policy, optim.AdamWConfig(eps=1e-5),
                optim.linear_warmup_constant(float(lr), int(warmup))),
                in_shardings=(sh, b_sh), out_shardings=(sh, None))
            rec = {"loss": [], "grad_norm": []}
            for b in case_in["steps"][:steps]:
                state, m = step(state, b)
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
            rec["params"] = np_tree(state["params"])
            rec["m"] = np_tree(state["opt"].m)
        out[(case, kind)] = rec
    # serving from the parameters after the exact steps
    params = jax.tree.map(jnp.asarray, out[(case, "exact")]["params"])
    p_sh = shard_lib.param_shardings(axes, params, mesh,
                                     rules=shard_lib.arch_rules(cfg, mesh))
    toks = case_in["serve"]["tokens"]
    policy = cm.Policy()
    rec = {}
    with mesh_lib.use_mesh(mesh):
        params = jax.device_put(params, p_sh)
        if cfg.is_encdec:
            xk, xv = jax.jit(lambda p, f: encdec.prime_cross_cache(
                cfg, p, f, policy))(params, case_in["serve"]["frames"])
            rec["prefill_states"] = {"xk": np.asarray(xk),
                                     "xv": np.asarray(xv)}
            states = dict(encdec.decode_state_init(cfg, 2, cache, enc),
                          xk=xk, xv=xv)
        else:
            pb = {"tokens": toks[:, :prompt]}
            pre = jax.jit(train_steps.make_prefill_step(cfg, policy),
                          in_shardings=(p_sh, shard_lib.batch_shardings(
                              pb, mesh)))
            last, pstates = pre(params, pb)
            rec["prefill"] = np.asarray(last)
            rec["prefill_states"] = np_tree(pstates)
            states = registry.decode_state_init(cfg, 2, cache)
        st_sh = shard_lib.decode_state_shardings(states, mesh, 2)
        states = jax.device_put(states, st_sh)
        serve = jax.jit(train_steps.make_serve_step(cfg, policy))
        logits = []
        for t in range(prompt + decode):
            _, lg, states = serve(params, jnp.asarray(toks[:, t]),
                                  jnp.int32(t), states)
            logits.append(np.asarray(lg))
    rec["decode"] = logits
    rec["states"] = np_tree(states)
    out[(case, "serve")] = rec
with open(work + "/reference.pkl", "wb") as f:
    pickle.dump(out, f)
"""


def _specs(cfg, mesh):
    params, axes = registry.abstract_params(cfg)
    return sharding.param_shardings(axes, params, mesh,
                                    rules=sharding.arch_rules(cfg, mesh))


def _numpy(cfg, params):
    return jax.tree.map(np.array, convert.params_to_numpy(cfg, params))


def _tree_numpy(tree):
    return jax.tree.map(lambda x: x.numpy().copy(), tree)


def _train(case, kind, full, mesh, steps):
    """STEPS train steps from ``full`` on ``mesh`` (None: one rank): the
    record and the final (local) parameters."""
    cfg = _cfg(case)
    mesh = _one_rank() if mesh is None else mesh
    specs = _specs(cfg, mesh)
    params = sharding.shard_params(full, specs, mesh)
    state = {"params": params, "opt": optim.adamw_init(params), "step": 0,
             "base_seed": 11}
    step = train_steps.make_train_step(
        cfg, _policy(kind), ADAM, optim.linear_warmup_constant(LR, WARMUP),
        device="cpu", mesh=mesh)
    rec = {"loss": [], "grad_norm": []}
    for b in steps:
        state, m = step(state, b)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
    rec["params"] = _numpy(cfg, sharding.gather_params(state["params"],
                                                       specs, mesh))
    rec["m"] = _numpy(cfg, sharding.gather_tree(state["opt"].m, specs,
                                                mesh))
    rec["local"] = {p: x.clone()
                    for p, x in optim.named_leaves(state["params"])}
    return rec, state["params"]


def _gathered(cfg, local, whole, mesh):
    """``local`` decode states (this rank's) gathered into the whole
    layout of ``whole`` (whole-shape states of the same tree)."""
    specs = sharding.decode_state_specs(cfg, whole, mesh, 2)
    return _tree_numpy(sharding.gather_tree(local, specs, mesh))


def _one_rank():
    return mesh_lib.Mesh({"data": 1, "model": 1}, ("data", "model"),
                         device=torch.device("cpu"))


def _serve(case, local, mesh, inputs):
    """Prefill of the first PROMPT tokens (an enc-dec: its cross caches
    primed from the frames), then PROMPT + DECODE decode steps fed the
    same tokens from an empty cache of CACHE positions."""
    cfg = _cfg(case)
    toks = torch.as_tensor(inputs["tokens"])
    out = {}
    if cfg.is_encdec:
        xk, xv = encdec.prime_cross_cache(
            cfg, local, torch.as_tensor(inputs["frames"]), cm.Policy(),
            mesh=mesh)
        whole = encdec.decode_state_init(cfg, 2, CACHE, ENC, device="cpu")
        cross = {"xk": xk, "xv": xv}
        out["prefill_states"] = _gathered(
            cfg, cross, {k: whole[k] for k in cross}, mesh)
        states = dict(whole, **{k: torch.as_tensor(v) for k, v in
                                out["prefill_states"].items()})
        out["cross_local"] = tuple(xk.shape)
    else:
        last, pstates = train_steps.make_prefill_step(
            cfg, cm.Policy(), device="cpu", mesh=mesh)(
                local, {"tokens": toks[:, :PROMPT]})
        out["prefill"] = last.numpy()
        out["prefill_states"] = _gathered(
            cfg, pstates, registry.decode_state_init(cfg, 2, PROMPT,
                                                     device="meta"), mesh)
        states = registry.decode_state_init(cfg, 2, CACHE, device="cpu")
    specs = sharding.decode_state_specs(cfg, states, mesh, 2)
    whole = jax.tree.map(lambda x: torch.empty_like(x, device="meta"),
                         states)
    states = sharding.shard_tree(states, specs, mesh)
    out["state_specs"] = {p: tuple(s) for p, s in specs.items()}
    out["local_states"] = {p: tuple(x.shape)
                           for p, x in optim.named_leaves(states)}
    serve = train_steps.make_serve_step(cfg, cm.Policy(), device="cpu",
                                        mesh=mesh)
    logits = []
    for t in range(PROMPT + DECODE):
        _, lg, states = serve(local, toks[:, t], t, states)
        logits.append(lg.numpy().copy())
    out["decode"] = logits
    out["states"] = _gathered(cfg, states, whole, mesh)
    return out


def _segments_hold(cfg, full, local, specs, mesh):
    """Each segmented leaf's shard is this rank's 1/M of every segment,
    in order."""
    m, r = 2, mesh_lib.model_index(mesh)
    whole, mine = dict(optim.named_leaves(full)), dict(
        optim.named_leaves(local))
    seen = []
    for path, spec in specs.items():
        if not isinstance(spec, sharding.Segmented):
            continue
        want = torch.cat([seg.narrow(-1, r * (w // m), w // m) for seg, w in
                          zip(whole[path].split(spec.widths, -1),
                              spec.widths)], -1)
        if not torch.equal(mine[path], want):
            return None
        seen.append(path)
    return sorted(seen)


def _rms_norm_grads(mesh):
    """The gated RMSNorm's sum of squares all-reduced both ways: output and
    gradients of y and the gain on this rank's features, gathered, and
    the same on one rank."""
    gen = torch.Generator().manual_seed(3)
    y = torch.randn((2, 5, 24), generator=gen)
    g = torch.rand((24,), generator=gen) + 0.5
    w = torch.randn((2, 5, 24), generator=gen)
    r, part = mesh_lib.model_index(mesh), 12
    ys = y[..., r * part:(r + 1) * part].clone().requires_grad_()
    gs = g[r * part:(r + 1) * part].clone().requires_grad_()
    sh = ssm._Shards(2, r, "heads", mesh)
    out = sh.rms_norm(ys, gs, 1e-5)
    (out * w[..., r * part:(r + 1) * part]).sum().backward()
    got = [torch.cat(_all(t, mesh), -1)
           for t in (out.detach(), ys.grad, gs.grad)]
    y1, g1 = y.clone().requires_grad_(), g.clone().requires_grad_()
    out1 = cm.rms_norm(y1, g1, 1e-5)
    (out1 * w).sum().backward()
    return [x.numpy() for x in got], [out1.detach().numpy(),
                                      y1.grad.numpy(), g1.grad.numpy()]


def _all(t, mesh):
    parts = [torch.empty_like(t) for _ in range(WORLD)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return parts


def _rank_main(rank, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=WORLD)
    try:
        with open(os.path.join(work, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        mesh = mesh_lib.make_host_mesh(model_parallel=2, device="cpu")
        out = {"rms_norm": _rms_norm_grads(mesh)}
        for case in CASES:
            cfg = _cfg(case)
            case_in = inputs[case]
            full = convert.params_from_jax(cfg, case_in["params"],
                                           device="cpu")
            specs = _specs(cfg, mesh)
            local = sharding.shard_params(full, specs, mesh)
            back = sharding.gather_params(local, specs, mesh)
            out[(case, "round_trip")] = all(
                torch.equal(a, b) for a, b in zip(optim.tree_leaves(full),
                                                  optim.tree_leaves(back)))
            out[(case, "segmented")] = _segments_hold(cfg, full, local,
                                                      specs, mesh)
            out[(case, "sharded")] = sorted(
                p for p, s in specs.items() if any(x for x in s))
            for kind in KINDS:
                rec, params = _train(case, kind, full, mesh,
                                     case_in["steps"])
                out[(case, kind)] = rec
                if kind == "exact":
                    out[(case, "serve")] = _serve(case, params, mesh,
                                                  case_in["serve"])
                if rank == 0 and case in CALIBRATED:
                    one, whole = _train(case, kind, full, None,
                                        case_in["steps"])
                    out[(case, kind, "one rank")] = one
                    if kind == "exact":
                        out[(case, "serve", "one rank")] = _serve(
                            case, whole, _one_rank(), case_in["serve"])
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The reference's 1 x 2 run and the port's gloo pair, side by side;
    returns (reference, [rank 0, rank 1])."""
    work = str(tmp_path_factory.mktemp("tp_blocks"))
    inputs = {case: _inputs(case) for case in CASES}
    inputs["cases"] = dict(CASES)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, work, str(STEPS), str(LR),
         str(WARMUP), str(PROMPT), str(DECODE), str(CACHE), str(ENC)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.start_processes(_rank_main, args=(work,), nprocs=WORLD,
                           start_method="spawn")
    finally:
        _, err = ref.communicate(timeout=900)
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
# the shards
# ---------------------------------------------------------------------------

SEGMENTED = {"zamba2-2.7b": ["in_proj", "conv_w", "conv_b"],
             "zamba2-2.7b/n7": [],
             "xlstm-125m": ["up"], "xlstm-125m/h1": ["up"],
             "whisper-base": [], "whisper-base/v255": []}


@pytest.mark.parametrize("case", list(CASES))
def test_shard_then_gather_is_bit_exact(pair, case):
    _, ranks = pair
    cfg = _cfg(case)
    for rank in ranks:
        assert rank[(case, "round_trip")] is True
        # every fused projection is split segment by segment, each rank's
        # shard its 1/M of every segment (a state width of 7 does not
        # divide 2: Mamba2's in_proj and conv split contiguously, as the
        # reference's rules split them)
        seg = rank[(case, "segmented")]
        assert seg is not None
        assert sorted({p.split("/")[-1] for p in seg}) == \
            sorted(SEGMENTED[case])
        sharded = rank[(case, "sharded")]
        assert ("embed" in sharded) == (cfg.vocab_size % 2 == 0)
        inner = {"zamba2-2.7b": "mamba/out_proj", "xlstm-125m": "mlstm/wq",
                 "whisper-base": "xattn/wq"}[CASES[case][0]]
        assert any(p.endswith(inner) for p in sharded)


def test_gated_rms_norm_sums_squares_and_gradients_over_the_ranks(pair):
    _, ranks = pair
    for rank in ranks:
        got, want = rank["rms_norm"]
        # f32, the same values: the sum of squares in two halves (1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# two train steps against the reference's sharded steps
# ---------------------------------------------------------------------------

def _hold(got, want, one, rtol, atol, what, scaled=False):
    """Every leaf of ``got`` against ``want`` at ``atol + rtol·|want|``
    (``scaled``: atol a fraction of the leaf's largest magnitude); where
    ``one`` (the one-rank port's tree) is given, at that bound times the
    factor the one-rank port needs, doubled."""
    def bound(w):
        scale = max(float(np.abs(w).max()), 1e-30) if scaled else 1.0
        return atol * scale + rtol * np.abs(w)

    factor = 1.0
    if one is not None:
        factor = max([1.0] + [2 * float((np.abs(o - w) / bound(w)).max())
                              for _, o, w in _pairs(one, want)])
    for path, g, w in _pairs(got, want):
        excess = float((np.abs(g - w) / (factor * bound(w))).max())
        assert excess <= 1.0, (f"{what}{path}: {excess:.3g} of the bound "
                               f"(factor {factor:.3g})")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(CASES))
def test_tp_steps_equal_the_reference_sharded_steps(pair, case, kind):
    reference, (r0, _) = pair
    want, got = reference[(case, kind)], r0[(case, kind)]
    one = r0.get((case, kind, "one rank"))
    # f32, the same plans: only the order of the sums differs (the row-
    # parallel partial products, the all-reduced norms and squares, the
    # vocab-parallel softmax): test_torch_tp.py's 1e-5 (CALIBRATED: see
    # there)
    for key in ("loss", "grad_norm"):
        _hold(got[key], want[key], None if one is None else one[key], 1e-5,
              0.0, key)
    _hold(got["params"], want["params"], one and one["params"], 1e-5, 1e-5,
          "params")
    _hold(got["m"], want["m"], one and one["m"], 1e-5, 1e-5, "m",
          scaled=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_are_bit_identical_across_the_ranks(pair, case,
                                                             kind):
    _, (r0, r1) = pair
    a, b = r0[(case, kind)], r1[(case, kind)]
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    sharded = set(r0[(case, "sharded")])
    replicated = [p for p in a["local"] if p not in sharded]
    assert replicated and sharded
    # every rank computes a replicated leaf's update from the same
    # all-reduced values: bit for bit (the per-head leaves a_log, r, bias,
    # if_bias among them)
    for path in replicated:
        assert torch.equal(a["local"][path], b["local"][path]), path
    for _, x, y in _pairs(a["params"], b["params"]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# prefill and decode against the reference's sharded serving
# ---------------------------------------------------------------------------

def _heads_dim(case, path):
    """Where decode_state_specs puts "model" in the leaf at ``path``."""
    cfg = _cfg(case)
    if cfg.is_encdec:
        return {"xk": 3, "xv": 3}.get(path, 2)
    btype = cfg.pattern[int(path.split("/")[0])]
    if btype not in ssm.RECURRENT:
        return 2                       # a KV cache: its sequence
    if not ssm.splits_heads(cfg, btype, 2):
        return None                    # gathered: whole on each rank
    return 3 if path.endswith("/conv") else 2


@pytest.mark.parametrize("case", list(CASES))
def test_tp_prefill_and_decode_equal_the_reference(pair, case):
    reference, (r0, r1) = pair
    want, got = reference[(case, "serve")], r0[(case, "serve")]
    for path, spec in got["state_specs"].items():
        dim = _heads_dim(case, path)
        assert [i for i, s in enumerate(spec) if s == "model"] == \
            ([] if dim is None else [dim]), (path, spec)
    # f32 logits and states, the same weights: summation order only
    # (2e-5 of the logits' scale, ~1; CALIBRATED: see there)
    one = r0.get((case, "serve", "one rank"))
    assert len(got["decode"]) == len(want["decode"]) == PROMPT + DECODE
    for name in ("prefill", "prefill_states", "states", "decode"):
        if name in want:
            _hold(got[name], want[name], one and one[name], 2e-5, 2e-5,
                  name)
    for g, w in zip(got["decode"], r1[(case, "serve")]["decode"]):
        np.testing.assert_array_equal(g, w)    # both ranks: whole logits
