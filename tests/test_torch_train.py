"""The slice as a whole: both packages' ``make_train_step`` on the same
``SyntheticLM`` batches, parameters carried across by ``params_from_jax``.

Under ``det_topk`` no random number is drawn, so every gradient and the
updated parameters must agree; under ``wta_crs`` the two frameworks draw
different plans, so only the (exact) forward loss of step 0 agrees and
the port's loss must fall on its own."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import optim as jax_optim_lib
from repro.configs import get_config as jax_get_config
from repro.core.config import WTACRSConfig as JaxWTACRSConfig
from repro.launch import train_steps as jax_train_steps
from repro.models import common as jax_cm
from repro.train import data as jax_data
from repro.train import optim as jax_optim
from repro_torch import convert
from repro_torch.core import WTACRSConfig
from repro_torch.launch import train_steps
from repro_torch.models import common as cm
from repro_torch.models.registry import get_config
from repro_torch.train import data, optim

torch.set_num_threads(1)

SEQ, BATCH, N_SAMPLES = 32, 4, 32
LR, WARMUP = 1e-3, 2


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _jax_state_and_port_state(arch):
    """Both packages' train state on the same parameter values: the JAX
    initialiser's, with the norm gains redrawn from [0.5, 1.5].  With the
    initial gains of exactly 1 every row of a normed activation has the
    same length up to an ulp, the sampling probabilities are all but
    uniform and a top-k over them is decided by the last bit — which the
    two frameworks do not share.  Gains as a trained model has them give
    top-k a real ordering."""
    jcfg = _f32(jax_get_config(arch, reduced=True))
    tcfg = _f32(get_config(arch, reduced=True))
    jstate = jax_train_steps.init_train_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def redraw(path, a):
        a = np.array(a)
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(redraw, jstate["params"])
    jstate = dict(jstate, params=jax.tree.map(jax.numpy.asarray, tree))
    params = convert.params_from_jax(tcfg, tree, device="cpu")
    tstate = {"params": params, "opt": optim.adamw_init(params), "step": 0,
              "base_seed": 11}
    return jcfg, tcfg, jstate, tstate


def _assert_params_close(tcfg, tstate, jstate, **tol):
    got = convert.params_to_numpy(tcfg, tstate["params"])
    want = jax.tree.map(np.asarray, jstate["params"])
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(
            g, w, err_msg=jax.tree_util.keystr(path), **tol)


def test_synthetic_lm_batches_are_byte_identical():
    a = jax_data.SyntheticLM(256, SEQ, N_SAMPLES, seed=3)
    b = data.SyntheticLM(256, SEQ, N_SAMPLES, seed=3)
    for step in (0, 5, 17):
        ba, bb = a.batch_at(step, BATCH), b.batch_at(step, BATCH)
        assert sorted(ba) == sorted(bb)
        for name in ba:
            assert ba[name].dtype == bb[name].dtype
            assert ba[name].tobytes() == bb[name].tobytes()
    ca, cb = jax_data.copy_task(64, 16, 8, 1), data.copy_task(64, 16, 8, 1)
    for name in ca:
        assert ca[name].tobytes() == cb[name].tobytes()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm-2b", "nemotron-4-15b",
                                  "command-r-35b", "granite-moe-1b-a400m",
                                  "dbrx-132b", "zamba2-2.7b", "xlstm-125m"])
def test_three_det_topk_steps_match_reference(arch):
    """f32 compute, ``kind="det_topk"``: loss, grad norm and the updated
    parameters of three whole steps agree to 1e-4.  A near-tie in the
    sampling probabilities could flip a top-k slot between the frameworks;
    the data seed is fixed to one where none does (the tolerance is not
    loosened for it).  xlstm-125m runs Adam at eps 1e-5: its sLSTM i-gate
    bias has a gradient of rounding noise whose sign the frameworks do not
    share, which Adam at eps 1e-8 turns into +-lr (ROADMAP Queue C)."""
    jcfg, tcfg, jstate, tstate = _jax_state_and_port_state(arch)
    wta = dict(kind="det_topk", budget=0.3, min_rows=4)
    eps = dict(eps=1e-5) if arch == "xlstm-125m" else {}
    jstep = jax.jit(jax_train_steps.make_train_step(
        jcfg, jax_cm.Policy(wtacrs=JaxWTACRSConfig(**wta)),
        jax_optim.AdamWConfig(**eps),
        jax_optim.linear_warmup_constant(LR, WARMUP)))
    tstep = train_steps.make_train_step(
        tcfg, cm.Policy(wtacrs=WTACRSConfig(**wta)), optim.AdamWConfig(**eps),
        optim.linear_warmup_constant(LR, WARMUP), device="cpu")
    ds = data.SyntheticLM(tcfg.vocab_size, SEQ, N_SAMPLES, seed=0)
    for i in range(3):
        batch = ds.batch_at(i, BATCH)
        jstate, jm = jstep(jstate, {k: v for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        # f32 on both sides; only summation orders differ
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        _assert_params_close(tcfg, tstate, jstate, rtol=1e-4, atol=1e-4)
    assert tstate["step"] == 3 and int(jstate["step"]) == 3
    assert tstate["opt"].count == 3


def test_wta_crs_step0_loss_matches_and_port_loss_falls():
    """``wta_crs`` draws plans from framework-specific generators, so the
    gradients differ — but the forward is exact, so the loss of step 0
    agrees; and the port, left running on its own, learns."""
    arch = "qwen2.5-3b"
    jcfg, tcfg, jstate, tstate = _jax_state_and_port_state(arch)
    wta = dict(kind="wta_crs", budget=0.3, min_rows=4)
    jstep = jax.jit(jax_train_steps.make_train_step(
        jcfg, jax_cm.Policy(wtacrs=JaxWTACRSConfig(**wta)),
        jax_optim.AdamWConfig(),
        jax_optim.linear_warmup_constant(LR, WARMUP)))
    tstep = train_steps.make_train_step(
        tcfg, cm.Policy(wtacrs=WTACRSConfig(**wta)), optim.AdamWConfig(),
        optim.linear_warmup_constant(1e-2, WARMUP), device="cpu")
    ds = data.SyntheticLM(tcfg.vocab_size, SEQ, N_SAMPLES, seed=0)
    _, jm = jstep(jstate, ds.batch_at(0, BATCH))
    losses = []
    for i in range(20):
        tstate, tm = tstep(tstate, ds.batch_at(i, BATCH))
        losses.append(float(tm["loss"]))
    # exact forward, f32 on both sides
    np.testing.assert_allclose(losses[0], float(jm["loss"]), rtol=1e-4)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < losses[0] - 0.2, losses


def test_same_seed_and_step_reproduce_the_step():
    """Sampling seeds derive from (base_seed, step): two runs from the same
    state take bit-identical steps; another base seed takes another."""
    tcfg = _f32(get_config("qwen2.5-3b", reduced=True))
    wta = WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=4)
    ds = data.SyntheticLM(tcfg.vocab_size, SEQ, N_SAMPLES, seed=0)

    def run(base_seed):
        state = train_steps.init_train_state(tcfg, 3, device="cpu")
        state["base_seed"] = base_seed
        step = train_steps.make_train_step(
            tcfg, cm.Policy(wtacrs=wta), optim.AdamWConfig(),
            optim.linear_warmup_constant(LR, WARMUP), device="cpu")
        for i in range(2):
            state, m = step(state, ds.batch_at(i, BATCH))
        return float(m["grad_norm"]), state["params"]["layers"][0]["mlp"]["wo"]

    g1, w1 = run(5)
    g2, w2 = run(5)
    g3, w3 = run(6)
    assert g1 == g2 and torch.equal(w1, w2)
    assert g1 != g3 and not torch.equal(w1, w3)


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_lr_schedules_match_reference(name):
    js = jax_optim.make_schedule(name, 3e-3, total_steps=50, warmup=5)
    ts = optim.make_schedule(name, 3e-3, total_steps=50, warmup=5)
    for step in (0, 1, 4, 5, 20, 44, 45, 49, 60):
        # the reference computes in f32, the port in Python floats
        np.testing.assert_allclose(
            ts(step), float(js(jax.numpy.asarray(step, jax.numpy.int32))),
            rtol=1e-5)


def test_adamw_with_decay_and_clip_matches_reference():
    rng = np.random.RandomState(0)
    p = {"a": rng.randn(5, 3).astype(np.float32),
         "b": {"c": rng.randn(7).astype(np.float32)}}
    cfg = dict(weight_decay=0.1, grad_clip_norm=0.5)
    jp = jax.tree.map(jax.numpy.asarray, p)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    jst, tst = jax_optim.adamw_init(jp), optim.adamw_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), p)
        jp, jst, jm = jax_optim.adamw_update(
            jax.tree.map(jax.numpy.asarray, g), jst, jp,
            jax.numpy.float32(1e-2), jax_optim.AdamWConfig(**cfg))
        tp, tst, tm = optim.adamw_update(
            jax.tree.map(torch.from_numpy, g), tst, tp, 1e-2,
            optim.AdamWConfig(**cfg))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for a, b in zip(optim.tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)
