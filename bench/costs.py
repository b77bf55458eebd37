"""The benchmark's yardstick: peaks, kernel bounds and the flops a step
requires, computed from a cell's shapes alone.

Frozen copies: a later change to the program cannot move them.  Each
function names the file and line it was copied from.  They read the
configuration file's sizes (``configs/<name>.json``) and the cell's
(``cells/<name>.json``), never the program's objects.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# src/repro_torch/launch/roofline.py:28-30 (NVIDIA H100 SXM5 datasheet):
# dense bf16 tensor-core rate and HBM3 bandwidth of one card, at its
# full 700 W power limit.
PEAK_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def budget_rows(budget: float, n_rows: int, min_rows: int = 8) -> int:
    """k of a sampled linear over ``n_rows`` positions.
    Copied from src/repro_torch/core/config.py:91-98."""
    k = max(min_rows, int(round(budget * n_rows)))
    return min(k, n_rows)


def sampled_dw(e: int, b: int, k: int, d_in: int, d_out: int, itemsize: int,
               distinct=None) -> Tuple[float, float]:
    """(flops, bytes) of the sampled weight gradient over E experts:
    2·E·B·k·d_in·d_out flops; H' and the ``distinct`` dZ rows (E·B·k where
    unknown) read once, idx / scale read once, the f32 dW written once.
    Copied from src/repro_torch/kernels/costs.py:54-64."""
    rows = e * b * k if distinct is None else distinct
    nbytes = (itemsize * (e * b * k * d_in + rows * d_out) + 8 * e * b * k
              + 4 * e * d_in * d_out)
    return 2.0 * e * b * k * d_in * d_out, float(nbytes)


def dw_bound(b: int, k: int, d_in: int, d_out: int, itemsize: int = 2
             ) -> float:
    """Least seconds of one sampled weight gradient: the larger of its
    flops at the peak and its bytes at the memory rate.  Copied from
    chip_smoke.py:957-970, with the plan's rows taken as B·k (the shapes
    fix no duplicate)."""
    flops, nbytes = sampled_dw(1, b, k, d_in, d_out, itemsize)
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def flash_visible(sq: int, skv: int, causal: bool) -> int:
    """Keys a query sees, summed over the queries.
    Copied from src/repro_torch/kernels/costs.py:67-75."""
    if not causal:
        return sq * skv
    if sq <= skv:
        return sq * (sq + 1) // 2
    return skv * (skv + 1) // 2 + (sq - skv) * skv


def flash(bh: int, bkvh: int, sq: int, skv: int, dh: int, causal: bool,
          itemsize: int) -> Tuple[float, float]:
    """(flops, bytes) of the attention forward.
    Copied from src/repro_torch/kernels/costs.py:78-85."""
    flops = 4.0 * bh * dh * flash_visible(sq, skv, causal)
    nbytes = (2 * bh * sq + 2 * bkvh * skv) * dh * itemsize
    return flops, float(nbytes)


def flash_bound(bh: int, bkvh: int, sq: int, skv: int, dh: int,
                causal: bool = True, itemsize: int = 2) -> float:
    """Least seconds of one attention forward.
    Copied from chip_smoke.py:1321-1328."""
    flops, nbytes = flash(bh, bkvh, sq, skv, dh, causal, itemsize)
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# The model's shapes, from the configuration file
# ---------------------------------------------------------------------------

def head_dim(conf: Dict) -> int:
    return conf.get("d_head") or conf["d_model"] // conf["n_heads"]


def layer_types(conf: Dict) -> List[str]:
    pattern = conf["pattern"]
    return [pattern[i % len(pattern)] for i in range(conf["n_layers"])]


def mamba_dims(conf: Dict) -> Tuple[int, int, int, int]:
    """(inner width, heads, head size, state size) of a Mamba2 mixer."""
    di = conf["ssm_expand"] * conf["d_model"]
    return di, di // conf["ssm_head_dim"], conf["ssm_head_dim"], \
        conf["ssm_state"]


def attn_linears(conf: Dict) -> List[List[Tuple[int, int]]]:
    """The (d_in, d_out) of an attention block's linears, grouped by the
    input they read (one sampling plan a group)."""
    d, dh = conf["d_model"], head_dim(conf)
    hq, hkv, f = conf["n_heads"] * dh, conf["n_kv_heads"] * dh, conf["d_ff"]
    groups = [[(d, hq), (d, hkv), (d, hkv)], [(hq, d)]]
    if conf["mlp_type"] == "swiglu":
        groups.append([(d, f), (d, f)])
    else:
        groups.append([(d, f)])
    groups.append([(f, d)])
    return groups


def mamba_linears(conf: Dict) -> List[List[Tuple[int, int]]]:
    d = conf["d_model"]
    di, nh, _, n = mamba_dims(conf)
    return [[(d, 2 * di + 2 * n + nh)], [(di, d)]]


def step_linears(conf: Dict) -> List[List[Tuple[int, int]]]:
    """Every layer's linear groups, in order (a shared block once a use);
    the output head is not among them."""
    out = []
    for btype in layer_types(conf):
        out += mamba_linears(conf) if btype == "mamba" else attn_linears(conf)
    return out


def attention_uses(conf: Dict) -> int:
    return sum(t != "mamba" for t in layer_types(conf))


def ssd_forward_flops(conf: Dict, b: int, s: int, chunk: int = 256
                      ) -> float:
    """Products of one chunked SSD forward (Mamba2, one group of B/C):
    within each chunk the causal half of C·Bᵀ and of the scores times
    x, then the chunk states and their read-out."""
    _, nh, p, n = mamba_dims(conf)
    c = min(chunk, s)
    pairs = (s // c) * c * (c + 1) // 2
    return b * (2.0 * pairs * (n + nh * p) + 4.0 * s * n * nh * p)


def train_step_flops(conf: Dict, cell: Dict) -> float:
    """The flops one training step requires: forward and dX of every
    linear at B·S rows, dW at B·k rows where sampled and B·S where exact,
    the output head exact, attention's causal half (the backward twice
    the forward), the SSD's products likewise; no recompute, no
    elementwise work."""
    b, s = cell["batch"], cell["seq"]
    rows = b * s
    sampled = cell["estimator"] != "exact"
    k = budget_rows(cell["budget"], s) if sampled else s
    total = 0.0
    for group in step_linears(conf):
        for d_in, d_out in group:
            total += 4.0 * rows * d_in * d_out + 2.0 * b * k * d_in * d_out
    total += 6.0 * rows * conf["d_model"] * conf["vocab_size"]
    dh = head_dim(conf)
    attn = 4.0 * b * conf["n_heads"] * dh * flash_visible(s, s, True)
    total += 3.0 * attn * attention_uses(conf)
    if "mamba" in conf["pattern"]:
        n_mamba = layer_types(conf).count("mamba")
        total += 3.0 * ssd_forward_flops(conf, b, s) * n_mamba
    return total


def prefill_flops(conf: Dict, cell: Dict) -> float:
    """The flops one prefill call requires: every linear's forward at B·S
    rows, attention's causal half, the SSD's forward, the head at the
    last position only."""
    b, s = cell["batch"], cell["seq"]
    total = 0.0
    for group in step_linears(conf):
        for d_in, d_out in group:
            total += 2.0 * b * s * d_in * d_out
    total += 2.0 * b * conf["d_model"] * conf["vocab_size"]
    dh = head_dim(conf)
    total += (4.0 * b * conf["n_heads"] * dh * flash_visible(s, s, True)
              * attention_uses(conf))
    if "mamba" in conf["pattern"]:
        total += ssd_forward_flops(conf, b, s) * layer_types(conf).count(
            "mamba")
    return total


def step_dw_bound(conf: Dict, cell: Dict) -> float:
    """Least seconds of all the sampled weight gradients one training step
    requires (0 where the cell's estimator is exact)."""
    if cell["estimator"] == "exact":
        return 0.0
    b, s = cell["batch"], cell["seq"]
    k = budget_rows(cell["budget"], s)
    return sum(dw_bound(b, k, d_in, d_out)
               for group in step_linears(conf) for d_in, d_out in group)


def prefill_flash_bound(conf: Dict, cell: Dict) -> float:
    """Least seconds of one prefill call's attention forwards."""
    b, s = cell["batch"], cell["seq"]
    one = flash_bound(b * conf["n_heads"], b * conf["n_kv_heads"], s, s,
                      head_dim(conf))
    return one * attention_uses(conf)
