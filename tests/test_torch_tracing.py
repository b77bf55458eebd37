"""The port's span recorder (``repro_torch.tracing``) on the CPU: off, it
records nothing and changes no bit of a step; on, one train step and one
prefill call give the span tree the module doc lists, with every span
closed, nested in time inside its parent, holding ints and strings
only, and on the clock of the profiler's host events."""
import collections
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import WTACRSConfig
from repro_torch.core import linear as lin
from repro_torch.launch import train_steps
from repro_torch.models import common as cm
from repro_torch.models.registry import get_config
from repro_torch.train import data, optim

torch.set_num_threads(1)

ARCH = "nemotron-4-15b"
ESTIMATORS = ["wta_crs", "exact"]
REMATS = ["none", "wtacrs_names"]
# a nemotron block's weights (q, k, v, o, MLP in and out) and its sampled
# linears (q/k/v on one shared plan); exact, each weight is a linear
WEIGHTS, SHARED = 6, 4


@pytest.fixture(autouse=True)
def _off_after():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _cfg():
    return dataclasses.replace(get_config(ARCH, reduced=True),
                               compute_dtype="float32")


def _step(kind, remat):
    cfg = _cfg()
    policy = cm.Policy(wtacrs=WTACRSConfig(kind=kind, budget=0.3),
                       remat=remat)
    state = train_steps.init_train_state(cfg, 0, device="cpu")
    fn = train_steps.make_train_step(
        cfg, policy, optim.AdamWConfig(),
        optim.linear_warmup_constant(1e-3, 1), device="cpu")
    batch = data.SyntheticLM(cfg.vocab_size, 32, 8, seed=0).batch_at(0, 2)
    return cfg, state, fn, batch


def _traced_step(kind, remat):
    cfg, state, fn, batch = _step(kind, remat)
    tracing.enable()
    state, metrics = fn(state, batch)
    tracing.disable()
    return cfg, state, metrics, tracing.drain()


def _paths(spans):
    by = {s["id"]: s for s in spans}

    def path(s):
        out = []
        while s is not None:
            out.append(s["name"])
            s = by.get(s["parent"])
        return "/".join(reversed(out))

    return collections.Counter(path(s) for s in spans)


def _train_tree(n, kind, remat):
    sampled = kind != "exact"
    linears = (SHARED if sampled else WEIGHTS) * n
    tree = {"train_step": 1, "train_step/forward": 1,
            "train_step/forward/embed": 1, "train_step/forward/head": 1,
            "train_step/forward/loss": 1, "train_step/backward": 1,
            "train_step/optimizer": 1,
            "train_step/forward/block": n,
            "train_step/forward/block/attention": n,
            "train_step/forward/block/linear": linears,
            "train_step/backward/attention.bwd": n}
    if sampled:
        tree.update({"train_step/forward/block/linear/plan": linears,
                     "train_step/forward/block/linear/gather": linears,
                     "train_step/backward/linear.bwd": linears,
                     "train_step/backward/linear.bwd/dx": WEIGHTS * n,
                     "train_step/backward/linear.bwd/dw": WEIGHTS * n})
    if remat != "none":
        # the recompute's own spans; its plans come back from the stash
        tree.update({"train_step/backward/block": n,
                     "train_step/backward/block/attention": n,
                     "train_step/backward/block/linear": linears})
    return tree


def _well_formed(spans):
    by = {s["id"]: s for s in spans}
    assert len(by) == len(spans)
    for s in spans:
        assert s["end_ns"] is not None, s["name"]
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"]:
            p = by[s["parent"]]
            assert p["start_ns"] <= s["start_ns"]
            assert s["end_ns"] <= p["end_ns"], (s["name"], p["name"])
        for v in s.values():
            assert v is None or type(v) in (int, str), (s["name"], v)


def test_off_records_nothing_and_changes_no_bit():
    cfg, state, fn, batch = _step("wta_crs", "none")
    assert not tracing.enabled()
    state, metrics = fn(state, batch)
    assert tracing.drain() == []
    _, on_state, on_metrics, spans = _traced_step("wta_crs", "none")
    assert spans
    assert torch.equal(metrics["loss"], on_metrics["loss"])
    for (name, a), (_, b) in zip(optim.named_leaves(state["params"]),
                                 optim.named_leaves(on_state["params"])):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("kind", ESTIMATORS)
def test_train_step_span_tree(kind, remat):
    cfg, _, _, spans = _traced_step(kind, remat)
    _well_formed(spans)
    assert _paths(spans) == _train_tree(cfg.n_layers, kind, remat)
    by = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] in ("attention.bwd", "linear.bwd"):
            assert by[s["caused_by"]]["name"] == s["name"][:-len(".bwd")]
        else:
            assert s["caused_by"] == 0


def test_prefill_span_tree():
    cfg = _cfg()
    params = train_steps.init_train_state(cfg, 0, device="cpu")["params"]
    fn = train_steps.make_prefill_step(cfg, cm.Policy(), device="cpu")
    batch = data.SyntheticLM(cfg.vocab_size, 32, 8, seed=0).batch_at(0, 2)
    tracing.enable()
    fn(params, {"tokens": batch["tokens"]})
    spans = tracing.drain()
    _well_formed(spans)
    n = cfg.n_layers
    assert _paths(spans) == {
        "prefill_step": 1, "prefill_step/embed": 1, "prefill_step/head": 1,
        "prefill_step/block": n, "prefill_step/block/attention": n,
        "prefill_step/block/linear": WEIGHTS * n}


def test_sampled_linear_backward_spans_with_the_tap():
    h = torch.randn(2, 16, 8, requires_grad=True)
    w = torch.randn(8, 4, requires_grad=True)
    zn = torch.ones(2, 16, requires_grad=True)
    tracing.enable()
    with tracing.span("outer"):
        z = lin.wtacrs_linear(h, w, key=3, znorm=zn,
                              cfg=WTACRSConfig(budget=0.5))
    z.square().sum().backward()
    spans = tracing.drain()
    _well_formed(spans)
    assert _paths(spans) == {"outer": 1, "outer/linear": 1,
                             "outer/linear/plan": 1,
                             "outer/linear/gather": 1, "linear.bwd": 1,
                             "linear.bwd/dx": 1, "linear.bwd/dw": 1,
                             "linear.bwd/tap": 1}


def test_spans_share_the_profiler_clock():
    """Every ``aten::mm`` of a WTA-CRS step starts and ends inside the
    span that issued it: one in each ``dx``, one a weight in each
    ``linear``, the rest the head's forward and its backward."""
    _, state, fn, batch = _step("wta_crs", "none")
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(state, batch)
    spans = tracing.drain()
    mms = [(e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    inner = collections.Counter()
    for a, b in mms:
        over = [s for s in spans if s["start_ns"] <= a < s["end_ns"]]
        s = max(over, key=lambda s: s["start_ns"])
        assert b <= s["end_ns"], s["name"]
        inner[s["name"]] += 1
    n = _cfg().n_layers
    assert inner == {"linear": WEIGHTS * n, "dx": WEIGHTS * n, "head": 1,
                     "backward": 2}
    for s in spans:
        if s["name"] == "dx":
            assert sum(s["start_ns"] <= a < s["end_ns"] for a, _ in mms) == 1
