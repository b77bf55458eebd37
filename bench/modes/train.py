"""Training cells: the step ``repro_torch.launch.train_steps.make_train_step``
returns, ``(state, batch) -> (state, metrics)``, with AdamW over every
weight and one rank.

Set-up builds one train state from weights made from the seed, drives it
through its first ``followed_steps`` steps with the window's own call and
feed (batches 0, 1, 2 of the pool, which all differ), keeps what the
check compares (each step's loss; every leaf's first gradient, from
Adam's first moment after one step: m₁ = (1 - β₁)·g₁; every leaf's change
after the last of them), and hands the same state to the window, which
goes on with batch i mod 8.  No host read of a loss inside the window.
"""
from __future__ import annotations

import gc

import torch

import check
import weights
from reference import train as ref_train


def state_seed(seed: int) -> int:
    return weights.mix(seed, 3)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.conf, self.cell = ctx.conf, ctx.spec
        self.n_follow = self.cell["followed_steps"]

    def setup(self):
        import harness
        from faults import plant
        from repro_torch.core.config import WTACRSConfig
        from repro_torch.launch import train_steps
        from repro_torch.models import common as cm
        from repro_torch.train import optim

        conf, cell, dev = self.conf, self.cell, self.ctx.device
        cfg = harness.arch_config(conf)
        policy = cm.Policy(
            wtacrs=WTACRSConfig(kind=cell["estimator"], budget=cell["budget"]),
            remat=cell["remat"])
        self.adam = optim.AdamWConfig()
        params = weights.make_params(conf, self.ctx.seed, dev)
        self.batches = weights.make_batches(conf, cell, self.ctx.seed, dev)
        self._release()
        self.state = train_steps.init_train_state(
            cfg, state_seed(self.ctx.seed), params=params, device=dev)
        self.fn = train_steps.make_train_step(
            cfg, policy, self.adam,
            optim.linear_warmup_constant(cell["lr"], 1), device=dev)
        self.fn = plant(self.ctx.fault, "train", self.fn)
        self.losses, self.window_losses = [], []
        named = optim.named_leaves
        for i in range(self.n_follow):
            self.state, m = self.fn(self.state, self.batches[i])
            self.losses.append(m["loss"])
            if i == 0:
                moments = dict(named(self.state["opt"].m))
                self.names = list(moments)
                self.g1 = torch.stack([
                    torch.linalg.vector_norm(x.float())
                    for x in moments.values()]) / (1.0 - self.adam.b1)
                # the output head's whole first gradient, kept in host
                # memory: it reads the forward's precision and no plan
                self.head_g1 = (moments[check.head_leaf(conf)].float()
                                / (1.0 - self.adam.b1)).cpu()
        first = weights.make_flat(conf, self.ctx.seed, dev)
        self.change = torch.stack([
            torch.linalg.vector_norm(x.float() - first[n])
            for n, x in named(self.state["params"])])
        del first
        self._release()

    def _release(self):
        # hand the set-up's large transient blocks back, so the window's
        # steps do not split them
        gc.collect()
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    def step(self, i: int):
        b = self.batches[(self.n_follow + i) % len(self.batches)]
        self.state, m = self.fn(self.state, b)
        self.window_losses.append(m["loss"])

    def work(self):
        import costs
        cell = self.cell
        return {"tokens_per_step": cell["batch"] * cell["seq"],
                "flops_per_step": costs.train_step_flops(self.conf, cell),
                "dw_bound_per_step": costs.step_dw_bound(self.conf, cell),
                "mode": "train"}

    def program_readings(self):
        return {"losses": [float(x) for x in self.losses],
                "grad_norms": dict(zip(self.names, self.g1.tolist())),
                "change_norms": dict(zip(self.names, self.change.tolist())),
                "head_grad": self.head_g1}

    def free(self):
        del self.state, self.fn
        self._release()

    def reference(self, precision="f32"):
        params = weights.make_flat(self.conf, self.ctx.seed, self.ctx.device)
        return ref_train.follow(self.conf, self.cell, params,
                                self.batches[:self.n_follow],
                                state_seed(self.ctx.seed), self.n_follow,
                                precision)

    def check(self):
        attempted = len(self.window_losses)
        failed = attempted - int(torch.isfinite(
            torch.stack(self.window_losses).float()).sum())
        prog = self.program_readings()
        self.free()
        numbers = check.train_numbers(prog, self.reference())
        ok, checks, lines = check.judge(numbers, self.cell["limits"])
        return {"correct": ok and failed == 0, "attempted": attempted,
                "failed": failed, "checks": checks, "check_lines": lines,
                "numbers": numbers}
