#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on a GPU.

    python3 chip_smoke.py

needs one NVIDIA GPU (written for an H100, sm_90a), ``nvcc`` and PyTorch
with CUDA; it imports only ``repro_torch`` (never jax, never the JAX
package).  Phases, each printing one JSON line; any failure exits non-zero:

  env      card name and power limit (nvidia-smi), torch and CUDA versions
  build    nvcc-builds the kernel library from src/repro_torch/kernels/csrc
  kernels  every kernel against its plain PyTorch version ON THE CARD, at
           the main path's shapes and at ragged ones, bf16/f32/f16; timed
           with CUDA events beside the plain version, a library
           composition and the card's bound
  parity   one det_topk train step of a reduced config: card (kernels)
           against CPU (plain versions), f32
  train    qwen2.5-3b at published width, depth cut to 12 layers, B=4,
           S=1024, WTA-CRS at budget 0.3: 6 steps through
           get_config -> init_train_state -> make_train_step -> train_step;
           losses finite and falling, launch counts as expected
  memory   the same for 2 steps under EXACT_CONFIG; both peaks side by side

then the ``{"kernels": [...]}`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import EXACT_CONFIG, WTACRSConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_sampling, ops  # noqa: E402
from repro_torch.kernels import row_norms as row_norms_mod  # noqa: E402
from repro_torch.launch import train_steps  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.train import data, optim  # noqa: E402

# Published dense peaks of one H100 SXM (NVIDIA data sheet), the yardstick
# every bound below is computed against.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}    # f32 outside the tensor cores

ALL_PHASES = ("env", "build", "kernels", "parity", "train", "memory")
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16"}

# Main-path shapes of qwen2.5-3b at B=4, S=1024, budget 0.3 (k = 307).
B, S, K = 4, 1024, 307
ROW_NORM_MAIN = [(B * S, 2048), (B * S, 11008)]
FUSED_MAIN = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]
ROW_NORM_RAGGED = [(33, 130), (7, 5)]
# (B, k, n, d_in, d_out)
FUSED_RAGGED = [(2, 20, 50, 130, 70), (1, 16, 64, 32, 24), (3, 13, 40, 33, 17)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of (CUDA-event time of ``inner`` back-to-back
    calls) / inner, after ``warmup`` calls.  Inputs stay L2-warm between
    calls, as they are for the real caller (dz and h come straight out of
    the preceding matmul)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

def check_close(name, got, want, rtol, atol):
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values in the kernel's output")
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    max_err = float(err.max())
    if bool((err > bound).any()):
        worst = float((err - bound).max())
        fail(f"{name}: kernel disagrees with its plain version: "
             f"max_abs_err {max_err:.3e}, exceeds rtol {rtol} / atol "
             f"{atol:.3e} by {worst:.3e}")
    return max_err


def row_norms_case(n, d, dtype, gen, timed):
    x = torch.randn((n, d), generator=gen, device="cuda",
                    dtype=torch.float32).to(dtype)
    got = ops.row_norms(x)
    torch.cuda.synchronize()
    want = row_norms_mod.row_norms_plain(x)
    # Kernel and plain version both square and add in f32 from the same
    # values; only the order of the d additions differs, which moves a sum
    # of d positive terms by a few f32 ulps: rtol/atol 1e-5, whatever the
    # input dtype.
    rtol = atol = 1e-5
    case = {
        "name": "row_norms", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_norms.cu",
        "replaces": "src/repro/kernels/row_norms.py:49",
        "shape": [n, d], "dtype": DTYPE_NAMES[dtype],
        "max_abs_err": check_close(f"row_norms{(n, d)} {dtype}", got, want,
                                   rtol, atol),
        "tol": {"rtol": rtol, "atol": atol},
    }
    if timed:
        nbytes = n * d * x.element_size() + 4 * n
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2 * n * d / PEAK_FLOPS[torch.float32]
        case.update({
            "ms": time_ms(lambda: ops.row_norms(x)),
            "plain_ms": time_ms(lambda: row_norms_mod.row_norms_plain(x)),
            "library_ms": time_ms(lambda: torch.linalg.vector_norm(
                x, dim=-1, dtype=torch.float32)),
            "library": "torch.linalg.vector_norm(x, dim=-1, dtype=float32)",
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
    return case


def library_dw(hsub, dz, idx, scale):
    """The library composition of the same function: gather, scale, one
    batched contraction in the input dtype (f32 accumulation inside the
    GEMM, output rounded to the input dtype).  Timed as a yardstick only;
    the port never calls it."""
    b, k, _ = hsub.shape
    rows = idx.to(torch.int64)[:, :, None].expand(b, k, dz.shape[2])
    dz_sub = (torch.gather(dz, 1, rows).to(torch.float32)
              * scale[:, :, None]).to(dz.dtype)
    return torch.einsum("bki,bkj->ij", hsub, dz_sub)


def fused_case(b, k, n, d_in, d_out, dtype, gen, timed):
    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    hsub, dz = rnd((b, k, d_in)), rnd((b, n, d_out))
    idx = torch.randint(0, n, (b, k), generator=gen, device="cuda"
                        ).to(torch.int32)
    scale = torch.rand((b, k), generator=gen, device="cuda") * 2.0 + 0.25
    want = fused_sampling.fused_sampled_dw_plain(hsub, dz, idx, scale)
    # Kernel and plain version round dz*scale to the input dtype by the
    # same f32 multiply, so the factors of every product are bit-identical
    # and each product is exact in f32 (bf16/f16) or rounded alike (f32);
    # only the order of the B*k f32 additions differs.  For unit-variance
    # inputs that is a random walk of f32 roundings: rtol 1e-4 and
    # atol 1e-4 * sqrt(B*k) — far inside the 3e-2 a bf16 ROUNDING
    # difference would show, so a dropped slot or a misplaced rounding
    # fails.
    rtol, atol = 1e-4, 1e-4 * math.sqrt(b * k)
    tiles = (None,) if dtype == torch.float32 else (None, 64, 128)
    max_err = 0.0
    for tile in tiles:
        got = ops.fused_sampled_dw(hsub, dz, idx, scale, tile=tile)
        torch.cuda.synchronize()
        max_err = max(max_err, check_close(
            f"fused_sampled_dw B={b} k={k} n={n} ({d_in},{d_out}) {dtype} "
            f"tile={tile}", got, want, rtol, atol))
    case = {
        "name": "fused_sampled_dw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_sampled_dw.cu",
        "replaces": "src/repro/kernels/fused_sampling.py:127",
        "shape": {"B": b, "k": k, "n": n, "d_in": d_in, "d_out": d_out},
        "dtype": DTYPE_NAMES[dtype], "max_abs_err": max_err,
        "tol": {"rtol": rtol, "atol": atol},
    }
    if timed:
        item = hsub.element_size()
        # each input read once: only the dz rows this plan names, once each
        rows = sum(int(torch.unique(idx[i]).numel()) for i in range(b))
        nbytes = (item * (b * k * d_in + rows * d_out) + 8 * b * k
                  + 4 * d_in * d_out)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2 * b * k * d_in * d_out / PEAK_FLOPS[dtype]
        case.update({
            "ms": time_ms(lambda: ops.fused_sampled_dw(hsub, dz, idx,
                                                       scale)),
            "plain_ms": time_ms(
                lambda: fused_sampling.fused_sampled_dw_plain(
                    hsub, dz, idx, scale)),
            "library_ms": time_ms(lambda: library_dw(hsub, dz, idx, scale)),
            "library": "torch.gather + scale + torch.einsum('bki,bkj->ij') "
                       "in the input dtype",
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
        if dtype != torch.float32:
            for tile in (64, 128):
                case[f"ms_tile{tile}"] = time_ms(
                    lambda: ops.fused_sampled_dw(hsub, dz, idx, scale,
                                                 tile=tile))
    return case


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for n, d in ROW_NORM_MAIN:
            cases.append(row_norms_case(n, d, dtype, gen, timed=True))
        for d_in, d_out in FUSED_MAIN:
            cases.append(fused_case(B, K, S, d_in, d_out, dtype, gen,
                                    timed=True))
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for n, d in ROW_NORM_RAGGED:
            cases.append(row_norms_case(n, d, dtype, gen, timed=False))
        for shape in FUSED_RAGGED:
            cases.append(fused_case(*shape, dtype, gen, timed=False))
    # a view that starts off a 16-byte boundary takes the element-wise path
    flat = torch.randn((64 * 256 + 8,), generator=gen, device="cuda")
    x = flat.to(torch.bfloat16)[1:1 + 64 * 256].reshape(64, 256)
    check_close("row_norms misaligned", ops.row_norms(x),
                row_norms_mod.row_norms_plain(x), 1e-5, 1e-5)
    emit({"phase": "kernels", "cases": cases})
    return cases


# ---------------------------------------------------------------------------
# model phases
# ---------------------------------------------------------------------------

def reset_launches():
    ops.row_norms.launches = 0
    ops.fused_sampled_dw.launches = 0


def phase_parity():
    """The kernels inside the whole step: one det_topk train step (no
    random draw, so card and CPU build the same plan) of the reduced
    qwen2.5-3b in f32, card against CPU.  The norm gains are redrawn from
    [0.5, 1.5]: at their initial 1.0 all rows of a normed activation have
    the same length up to an ulp and top-k would be decided by the last
    bit, which card and CPU do not share."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b", reduced=True),
                              compute_dtype="float32")
    policy = cm.Policy(wtacrs=WTACRSConfig(kind="det_topk", budget=0.3,
                                           min_rows=4))
    ds = data.SyntheticLM(cfg.vocab_size, 64, 16, seed=1)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    start = train_steps.init_train_state(cfg, 0, device="cpu")["params"]
    for layer in start["layers"] + [start]:
        for name in ("norm1", "norm2", "final_norm"):
            if name in layer:
                g = layer[name]["gamma"]
                g.copy_(torch.rand(g.shape, generator=gen) + 0.5)
    out = {}
    for dev in ("cuda", "cpu"):
        params = optim.tree_map(lambda t: t.to(dev, copy=True), start)
        state = {"params": params, "opt": optim.adamw_init(params),
                 "step": 0, "base_seed": 1}
        step = train_steps.make_train_step(
            cfg, policy, optim.AdamWConfig(),
            optim.linear_warmup_constant(1e-3, 1), device=dev)
        reset_launches()
        state, m = step(state, ds.batch_at(0, 4))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    [p.detach().cpu() for p in
                     optim.tree_leaves(state["params"])])
        want = (4 * cfg.n_layers, 7 * cfg.n_layers) if dev == "cuda" \
            else (0, 0)
        got = (ops.row_norms.launches, ops.fused_sampled_dw.launches)
        if got != want:
            fail(f"parity on {dev}: launches {got}, expected {want}")
    # f32 everywhere; card and CPU differ in summation order only: 1e-4
    rel = [abs(a - b) / max(abs(b), 1e-12)
           for a, b in zip(out["cuda"][:2], out["cpu"][:2])]
    perr = max(float((a - b).abs().max())
               for a, b in zip(out["cuda"][2], out["cpu"][2]))
    if max(rel) > 1e-4 or perr > 1e-4:
        fail(f"parity: card vs CPU loss/grad_norm rel {rel}, "
             f"max param diff {perr}")
    emit({"phase": "parity", "loss": out["cuda"][0],
          "loss_cpu": out["cpu"][0], "rel_loss_gnorm": rel,
          "max_param_diff": perr})


def run_steps(cfg, wtacrs_cfg, n_steps, batch, seq, ds):
    """Fresh state, ``n_steps`` train steps; returns losses, step times
    (host clock around a step that ends in a synchronize) and the peak."""
    policy = cm.Policy(wtacrs=wtacrs_cfg, remat="none", flash_block=512)
    state = train_steps.init_train_state(cfg, 0)
    step = train_steps.make_train_step(
        cfg, policy, optim.AdamWConfig(),
        optim.linear_warmup_constant(1e-4, 2), microbatches=1,
        use_znorm_cache=False)
    before = [p[:64].flatten()[:64].clone()
              for p in optim.tree_leaves(state["params"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        state, m = step(state, ds.batch_at(i, batch))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    after = [p[:64].flatten()[:64] for p in
             optim.tree_leaves(state["params"])]
    changed = sum(bool((a != b).any()) for a, b in zip(after, before))
    n_params = sum(p.numel() for p in optim.tree_leaves(state["params"]))
    del state, step
    torch.cuda.empty_cache()
    return losses, times, peak, changed, len(before), n_params


def phase_train(cfg, ds, n_steps):
    reset_launches()
    wta = WTACRSConfig(kind="wta_crs", budget=0.3, min_rows=4)
    losses, times, peak, changed, n_leaves, n_params = run_steps(
        cfg, wta, n_steps, B, S, ds)
    launches = {"row_norms": ops.row_norms.launches,
                "fused_sampled_dw": ops.fused_sampled_dw.launches}
    emit({"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_params": n_params, "batch": B, "seq": S, "budget": 0.3,
          "losses": losses, "step_ms": times,
          "step_ms_median_after_first": statistics.median(times[1:]),
          "peak_bytes": peak, "launches": launches})
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall: {losses}")
    want = {"row_norms": 4 * cfg.n_layers * n_steps,
            "fused_sampled_dw": 7 * cfg.n_layers * n_steps}
    if launches != want:
        fail(f"train: kernel launches {launches}, expected {want}")
    # gamma of the norms and the biases move too: every leaf must change
    if changed != n_leaves:
        fail(f"train: only {changed} of {n_leaves} parameter leaves changed")
    return launches, peak


def phase_memory(cfg, ds, wta_peak):
    losses, times, peak, *_ = run_steps(cfg, EXACT_CONFIG, 2, B, S, ds)
    if not all(math.isfinite(x) for x in losses):
        fail(f"memory: non-finite loss in {losses}")
    emit({"phase": "memory", "exact_losses": losses, "exact_step_ms": times,
          "peak_bytes_exact": peak, "peak_bytes_wta_crs": wta_peak,
          "exact_over_wta_crs": (peak / wta_peak) if wta_peak else None})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    # every f32 comparison below assumes full-precision f32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()

    if "env" in phases:
        emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "device_name": torch.cuda.get_device_name(0),
              "capability": list(torch.cuda.get_device_capability(0))})
    if "build" in phases or "kernels" in phases or "train" in phases:
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        log = (lib.parent / "build.log").read_text()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "library": os.path.relpath(lib),
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]})

    cases = phase_kernels() if "kernels" in phases else []
    if "parity" in phases:
        phase_parity()

    launches = {}
    if "train" in phases or "memory" in phases:
        cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=12)
        # as many samples as the batch holds: every step sees the same
        # sequences, so a falling loss is the optimizer's doing and not
        # the luck of the next batch
        ds = data.SyntheticLM(cfg.vocab_size, S, B, seed=0)
        wta_peak = None
        if "train" in phases:
            launches, wta_peak = phase_train(cfg, ds, n_steps=6)
        if "memory" in phases:
            phase_memory(cfg, ds, wta_peak)

    if set(phases) == set(ALL_PHASES):
        # the summary the port is judged by: the main path's kernels at the
        # main path's shapes and dtype, with the launches the train phase
        # counted
        summary = []
        for c in cases:
            if "ms" in c and c["dtype"] == "bfloat16":
                summary.append(dict(c, launches=launches[c["name"]]))
        emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
