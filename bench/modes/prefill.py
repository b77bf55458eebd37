"""Prefill cells: the step ``repro_torch.launch.train_steps.make_prefill_step``
returns, ``(params, batch) -> (last_logits (B, V), states)``: every prompt
of the batch through the stack, attention on the ``flash_attention_fwd``
kernel, the KV caches of every attention layer kept.

Set-up makes the weights and the pool of 8 batches on the card and warms
the call with ``warmup_steps`` calls; the window issues calls back to back
over the pool.  The check takes the window's last call: its logits and
caches, every prompt, against the reference's float32 forward of the same
prompts.  The reference covers attention layers only (a cell of a
recurrent configuration would compare its states too).
"""
from __future__ import annotations

import gc

import torch

import check
import weights
from reference import model


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.conf, self.cell = ctx.conf, ctx.spec

    def setup(self):
        import harness
        from faults import plant
        from repro_torch.launch import train_steps
        from repro_torch.models import common as cm

        conf, dev = self.conf, self.ctx.device
        if any(t != "attn" for t in conf["pattern"]):
            raise ValueError("the prefill check compares attention caches "
                             "only")
        cfg = harness.arch_config(conf)
        self.params = weights.make_params(conf, self.ctx.seed, dev)
        self.batches = weights.make_batches(conf, self.cell, self.ctx.seed,
                                            dev)
        self.fn = plant(self.ctx.fault, "prefill",
                        train_steps.make_prefill_step(cfg, cm.Policy(),
                                                      device=dev))
        # set-up's transient blocks go back before the warm-up calls, whose
        # blocks the window's calls then reuse: no cudaMalloc in the window
        self._release()
        self.finite = []
        self.warm = self.cell["warmup_steps"]
        for i in range(self.warm):
            self.last = (i, self.fn(self.params, self.batches[i]))
            # the window's own reduction too, so no kernel loads there
            torch.isfinite(self.last[1][0]).all(-1).sum()

    def step(self, i: int):
        j = (self.warm + i) % len(self.batches)
        out = self.fn(self.params, self.batches[j])
        self.finite.append(torch.isfinite(out[0]).all(-1).sum())
        self.last = (j, out)

    def work(self):
        import costs
        cell = self.cell
        return {"tokens_per_step": cell["batch"] * cell["seq"],
                "flops_per_step": costs.prefill_flops(self.conf, cell),
                "flash_bound_per_step": costs.prefill_flash_bound(self.conf,
                                                                  cell),
                "mode": "prefill"}

    def compare(self, j, logits, states, precision="f32"):
        """{logit_gap, kv_gap} of one call's outputs on batch ``j``
        against the reference (``precision``) computed prompt by
        prompt."""
        p = weights.make_flat(self.conf, self.ctx.seed, self.ctx.device)
        arith = model.Arith(precision)
        tokens = self.batches[j]["tokens"]
        period = len(self.conf["pattern"])
        logit_gap = kv_gap = 0.0
        for r in range(tokens.shape[0]):
            ref_logits, kv = model.prefill_seq(self.conf, p, tokens[r], arith)
            logit_gap = max(logit_gap, check.rel(logits[r], ref_logits))
            for layer, (k, v) in enumerate(kv):
                ridx, jj = divmod(layer, period)
                kv_gap = max(kv_gap,
                             check.rel(states[jj]["k"][ridx, r], k),
                             check.rel(states[jj]["v"][ridx, r], v))
        return {"logit_gap": logit_gap, "kv_gap": kv_gap}

    def control(self, j):
        """{logit_gap, kv_gap} of the control (the reference with float8
        products) against the reference, on batch ``j``."""
        p = weights.make_flat(self.conf, self.ctx.seed, self.ctx.device)
        tokens = self.batches[j]["tokens"]
        logit_gap = kv_gap = 0.0
        for r in range(tokens.shape[0]):
            want, kv = model.prefill_seq(self.conf, p, tokens[r],
                                         model.Arith("f32"))
            got, kv8 = model.prefill_seq(self.conf, p, tokens[r],
                                         model.Arith("fp8"))
            logit_gap = max(logit_gap, check.rel(got, want))
            for (k, v), (k8, v8) in zip(kv, kv8):
                kv_gap = max(kv_gap, check.rel(k8, k), check.rel(v8, v))
        return {"logit_gap": logit_gap, "kv_gap": kv_gap}

    def _release(self):
        gc.collect()
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    def free(self):
        del self.params, self.fn
        self._release()

    def check(self):
        attempted = len(self.finite) * self.cell["batch"]
        failed = attempted - int(torch.stack(self.finite).sum())
        j, (logits, states) = self.last
        self.free()
        numbers = self.compare(j, logits, states)
        ok, checks, lines = check.judge(numbers, self.cell["limits"])
        return {"correct": ok and failed == 0, "attempted": attempted,
                "failed": failed, "checks": checks, "check_lines": lines,
                "numbers": numbers}
