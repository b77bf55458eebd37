"""Weights and batches made from ``--seed`` on the device, in a few large
draws, in the layout the program and the reference both read.

The parameter tree is the one ``repro_torch.models.lm`` takes (plain dicts
of tensors, weights (d_in, d_out)); the reference reads the same tree.
Distributions: dense weights N(0, 1/fan_in), the embedding N(0, 0.02²),
norm gains 1 + N(0, 0.1²) and biases N(0, 0.02²) (a fine-tuned model's
gains are not all one), Mamba2's decay ``a_log`` = log U(1, 16) and
``dt_bias`` the inverse softplus of a log-uniform step in [1e-3, 1e-1]
(Mamba2's published initialisation), ``d_skip`` 1 + N(0, 0.1²).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 28          # elements a draw


def mix(seed: int, salt: int) -> int:
    """A 63-bit child seed of (seed, salt) (splitmix64's finaliser)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xD1B54A32D192ED03
         + 0x2545F4914F6CDD1D) & (2 ** 64 - 1)
    x ^= x >> 31
    x = (x * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    x ^= x >> 29
    x = (x * 0x94D049BB133111EB) & (2 ** 64 - 1)
    x ^= x >> 32
    return x & ((1 << 63) - 1)


def _head_dim(conf):
    return conf.get("d_head") or conf["d_model"] // conf["n_heads"]


def _norm_specs(conf, path):
    out = [(path + "/gamma", (conf["d_model"],), "gain")]
    if conf["norm_type"] == "layernorm":
        out.append((path + "/beta", (conf["d_model"],), "bias"))
    return out


def _attn_specs(conf, path):
    d, dh, f = conf["d_model"], _head_dim(conf), conf["d_ff"]
    hq, hkv = conf["n_heads"] * dh, conf["n_kv_heads"] * dh
    out = _norm_specs(conf, path + "/norm1")
    out += [(path + "/attn/wq", (d, hq), "dense"),
            (path + "/attn/wk", (d, hkv), "dense"),
            (path + "/attn/wv", (d, hkv), "dense"),
            (path + "/attn/wo", (hq, d), "dense")]
    out += _norm_specs(conf, path + "/norm2")
    out.append((path + "/mlp/wi", (d, f), "dense"))
    if conf["mlp_type"] == "swiglu":
        out.append((path + "/mlp/wg", (d, f), "dense"))
    out.append((path + "/mlp/wo", (f, d), "dense"))
    return out


def _mamba_specs(conf, path):
    d = conf["d_model"]
    di = conf["ssm_expand"] * d
    nh, n = di // conf["ssm_head_dim"], conf["ssm_state"]
    conv = di + 2 * n
    out = _norm_specs(conf, path + "/norm1")
    m = path + "/mamba/"
    out += [(m + "in_proj", (d, 2 * di + 2 * n + nh), "dense"),
            (m + "conv_w", (conf["ssm_conv"], conv), "conv"),
            (m + "conv_b", (conv,), "bias"),
            (m + "a_log", (nh,), "a_log"),
            (m + "d_skip", (nh,), "gain"),
            (m + "dt_bias", (nh,), "dt_bias"),
            (m + "norm_g", (di,), "gain"),
            (m + "out_proj", (di, d), "dense")]
    return out


def leaf_specs(conf: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(path, shape, kind) of every parameter, in a fixed order."""
    out = [("embed", (conf["vocab_size"], conf["d_model"]), "embed")]
    pattern = conf["pattern"]
    shared = False
    for i in range(conf["n_layers"]):
        btype = pattern[i % len(pattern)]
        if btype == "mamba":
            out += _mamba_specs(conf, f"layers/{i}")
        elif btype == "shared_attn":
            if not shared:
                out += _attn_specs(conf, "shared")
                shared = True
        else:
            out += _attn_specs(conf, f"layers/{i}")
    out += _norm_specs(conf, "final_norm")
    if not conf["tie_embeddings"]:
        out.append(("head", (conf["d_model"], conf["vocab_size"]), "dense"))
    return out


def _fill(flat: torch.Tensor, gen: torch.Generator, uniform: bool) -> None:
    for part in torch.split(flat, CHUNK):
        if uniform:
            part.uniform_(generator=gen)
        else:
            part.normal_(generator=gen)


def make_flat(conf: Dict, seed: int, device, dtype=torch.float32
              ) -> Dict[str, torch.Tensor]:
    """{path: tensor} of every parameter from ``seed``: one normal draw
    over all the parameters' elements and one uniform draw over the few
    that are uniform at heart, then each leaf cut out and scaled."""
    specs = leaf_specs(conf)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, 1))
    normal = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    _fill(normal, gen, uniform=False)
    n_uni = sum(n for n, (_, _, kind) in zip(sizes, specs)
                if kind in ("a_log", "dt_bias"))
    uni = torch.empty(max(n_uni, 1), dtype=torch.float32, device=device)
    _fill(uni, gen, uniform=True)
    out, off, uoff = {}, 0, 0
    for (path, shape, kind), n in zip(specs, sizes):
        z = normal[off:off + n].view(shape)
        off += n
        if kind in ("a_log", "dt_bias"):
            u = uni[uoff:uoff + n].view(shape)
            uoff += n
        if kind == "dense":
            x = z * (1.0 / math.sqrt(shape[0]))
        elif kind == "embed":
            x = z * 0.02
        elif kind == "conv":
            x = z * 0.5
        elif kind == "gain":
            x = 1.0 + 0.1 * z
        elif kind == "bias":
            x = 0.02 * z
        elif kind == "a_log":
            x = torch.log(1.0 + 15.0 * u)
        else:                                        # dt_bias
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1)
                                                  - math.log(1e-3)))
            x = dt + torch.log(-torch.expm1(-dt))
        out[path] = x.to(dtype)
    del normal, uni
    return out


def tree(conf: Dict, flat: Dict[str, torch.Tensor]):
    """The nested tree the program takes: ``layers`` a list (a
    ``shared_attn`` layer's slot ``{}``, its parameters under
    ``shared``)."""
    params = {"layers": [{} for _ in range(conf["n_layers"])]}
    for path, x in flat.items():
        parts = path.split("/")
        node = params
        if parts[0] == "layers":
            node = params["layers"][int(parts[1])]
            parts = parts[2:]
        for name in parts[:-1]:
            node = node.setdefault(name, {})
        node[parts[-1]] = x
    return params


def make_params(conf: Dict, seed: int, device, dtype=torch.float32):
    return tree(conf, make_flat(conf, seed, device, dtype))


def make_batches(conf: Dict, cell: Dict, seed: int, device,
                 n: int = 8) -> List[Dict[str, torch.Tensor]]:
    """The pool of ``n`` batches: token sequences uniform over the
    vocabulary, drawn in one call; each batch's labels are its tokens
    shifted by one (next-token prediction)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, 2))
    b, s = cell["batch"], cell["seq"]
    seqs = torch.randint(0, conf["vocab_size"], (n, b, s + 1),
                         generator=gen, device=device, dtype=torch.int64)
    seqs = seqs.to(torch.int32)
    return [{"tokens": seqs[i, :, :-1].contiguous(),
             "labels": seqs[i, :, 1:].contiguous()} for i in range(n)]
