"""Model API dispatch: config lookup, parameter init, the loss, the
serving entry points and one training batch's specs for every
architecture: the decoder-only LMs (``models/lm.py``: dense, MoE, SSM,
hybrid, VLM) and the encoder-decoder (``models/encdec.py``).

``abstract_params``, ``input_specs`` and ``decode_specs`` give the same
trees on the ``meta`` device (shapes and dtypes, no storage), with the
logical axis names of every parameter that the sharding rules
(``launch/sharding.py``) read.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config  # noqa: F401  (re-export)
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shard_lib
from repro_torch.models import encdec, lm
from repro_torch.train.optim import named_leaves


def init_params(cfg: ArchConfig, seed: int, device="cuda"):
    if cfg.is_encdec:
        return encdec.init_params(cfg, seed, device=device)
    return lm.init_params(cfg, seed, device=device)


# ---------------------------------------------------------------------------
# Logical axes of every parameter (the reference's ``Boxed`` annotations,
# less the stacked ``layers`` dim: the port holds one tensor a layer)
# ---------------------------------------------------------------------------

_ATTN = {"wq": ("embed", "qheads"), "wk": ("embed", "kvheads"),
         "wv": ("embed", "kvheads"), "wo": ("qheads", "embed"),
         "bq": ("qheads",), "bk": ("kvheads",), "bv": ("kvheads",)}
_AXES = {
    "attn": _ATTN, "xattn": _ATTN,
    "mlp": {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
            "wo": ("mlp", "embed")},
    "moe": {"router": ("embed", None),
            "wi": ("experts", "embed", "mlp"),
            "wg": ("experts", "embed", "mlp"),
            "wo": ("experts", "mlp", "embed")},
    "mamba": {"in_proj": ("embed", "ssm_inner"),
              "conv_w": (None, "ssm_inner"), "conv_b": ("ssm_inner",),
              "a_log": (None,), "d_skip": (None,), "dt_bias": (None,),
              "norm_g": ("ssm_inner",), "out_proj": ("ssm_inner", "embed")},
    "mlstm": {"up": ("embed", "ssm_inner"),
              "wq": ("ssm_inner", "ssm_inner"),
              "wk": ("ssm_inner", "ssm_inner"),
              "wv": ("ssm_inner", "ssm_inner"),
              "w_if": ("ssm_inner", None), "if_bias": (None,),
              "down": ("ssm_inner", "embed")},
    "slstm": {"w_in": ("embed", "ssm_inner"), "r": (None, None, None),
              "bias": (None,), "down": ("ssm_inner", "embed")},
}
_TOP = {"embed": ("vocab", "embed"), "head": ("embed", "vocab"),
        "vis_proj": ("embed", "embed"), "pos_embed": (None, "embed"),
        "pos_enc": (None, "embed"), "pos_dec": (None, "embed")}


def _param_axes(path: str) -> Tuple[Optional[str], ...]:
    """Logical axis names of the parameter at ``path`` (a
    ``named_leaves`` path: ``layers/3/attn/wq``, ``shared/mlp/wo``,
    ``final_norm/gamma``, ``embed``)."""
    parts = path.split("/")
    if len(parts) == 1:
        return _TOP[path]
    module, leaf = parts[-2], parts[-1]
    if module.startswith("norm") or module.endswith("_norm"):
        return ("embed",)                   # a norm's gain or bias
    return _AXES[module][leaf]


def _leaf_axes(cfg: ArchConfig, path: str):
    """``_param_axes``, as ``sharding.Segmented`` axes for a fused
    projection (``models/ssm.py::segments``)."""
    axes = _param_axes(path)
    parts = path.split("/")
    seg = (lm.ssm_lib.segments(cfg, parts[-2], parts[-1])
           if len(parts) > 1 else None)
    if seg is None:
        return axes
    return shard_lib.Segmented(axes, len(axes) - 1, *seg)


def abstract_params(cfg: ArchConfig):
    """(params on the ``meta`` device, {leaf path: logical axes}) without
    any allocation."""
    params = init_params(cfg, 0, device="meta")
    axes = {path: _leaf_axes(cfg, path) for path, _ in named_leaves(params)}
    return params, axes


def model_parallel_mesh(mesh):
    """``mesh`` where its ``model`` axis holds several ranks (the model
    code's tensor / expert parallelism), else None."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh


def forward(cfg, params, batch, policy, key=None, znorms=None,
            recorder=None, mesh=None):
    """``mesh``: a model-parallel mesh (``models/lm.py``), or None."""
    mesh = model_parallel_mesh(mesh)
    if cfg.is_encdec:
        return encdec.forward(cfg, params, batch, policy, key, znorms,
                              recorder=recorder, mesh=mesh)
    return lm.forward(cfg, params, batch, policy, key, znorms,
                      recorder=recorder, mesh=mesh)


def loss_fn(cfg, params, batch, policy, key=None, znorms=None, mesh=None):
    mesh = model_parallel_mesh(mesh)
    if cfg.is_encdec:
        return encdec.loss(cfg, params, batch, policy, key, znorms,
                           mesh=mesh)
    return lm.lm_loss(cfg, params, batch, policy, key, znorms, mesh=mesh)


def prefill(cfg, params, batch, policy, mesh=None):
    if cfg.is_encdec:
        raise NotImplementedError(
            "enc-dec prefill == prime_cross_cache + decode loop")
    return lm.prefill(cfg, params, batch, policy,
                      mesh=model_parallel_mesh(mesh))


def decode_state_init(cfg, batch_size: int, max_len: int, device="cuda"):
    """An enc-dec arch's cross caches get ``max_len // 2`` rows, as in
    the reference; ``device="meta"`` gives the shapes without storage."""
    if cfg.is_encdec:
        return encdec.decode_state_init(cfg, batch_size, max_len,
                                        enc_len=max_len // 2, device=device)
    return lm.decode_state_init(cfg, batch_size, max_len, device=device)


def decode_step(cfg, params, token, pos, states, policy, mesh=None,
                kv_positions=None):
    """``pos``: scalar (aligned batch) or (B,) per-slot positions
    (continuous batching; decoder-only LMs only).  ``kv_positions``: see
    ``lm.decode_step`` (the slot pool's paged caches)."""
    mesh = model_parallel_mesh(mesh)
    if cfg.is_encdec:
        return encdec.decode_step(cfg, params, token, pos, states, policy,
                                  mesh=mesh)
    return lm.decode_step(cfg, params, token, pos, states, policy,
                          mesh=mesh, kv_positions=kv_positions)


def block_decode_init(cfg, btype: str, batch_size: int, max_len: int,
                      device="cuda"):
    """Un-stacked decode state of one block type (serve-pool builder)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            "enc-dec decode state is monolithic (decode_state_init); "
            "the per-block slot pool serves decoder-only LMs")
    return lm.block_decode_init(cfg, btype, batch_size, max_len,
                                device=device)


def serve_compatible(cfg: ArchConfig) -> Tuple[bool, str]:
    """Whether the continuous-batching serve path supports this arch,
    with the reason when it does not (surfaced by ``ServeSpec`` at
    construction instead of erroring mid-serve)."""
    if cfg.is_encdec:
        return False, (
            "encoder-decoder arch: decode requires a primed per-batch "
            "cross-attention cache and a shared scalar position, which "
            "the ragged slot pool cannot provide; serve decoder-only "
            "LMs (dense/MoE/SSM/hybrid/VLM)")
    return True, ""


# ---------------------------------------------------------------------------
# One training batch
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ArchConfig, batch: int, seq: int
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of one training / prefill batch of ``seq``
    positions: a VLM's are ``s_vis = max(8, ⌊seq·vis_tokens_frac⌋ // 8 ·
    8)`` patch embeddings and ``seq - s_vis`` text tokens (labels on the
    text), with (3, batch, seq) M-RoPE positions; an enc-dec's ``seq //
    2`` frame embeddings and ``seq // 2`` tokens."""
    i32 = torch.int32
    if cfg.family == "vlm":
        s_vis = int(seq * cfg.vis_tokens_frac)
        s_vis = max(8, (s_vis // 8) * 8)     # aligned, never zero
        s_txt = seq - s_vis
        return {"tokens": ((batch, s_txt), i32),
                "labels": ((batch, s_txt), i32),
                "patches": ((batch, s_vis, cfg.d_model), cfg.cdtype),
                "positions3": ((3, batch, seq), i32)}
    if cfg.is_encdec:
        s_half = seq // 2
        return {"frames": ((batch, s_half, cfg.d_model), cfg.cdtype),
                "tokens": ((batch, s_half), i32),
                "labels": ((batch, s_half), i32)}
    return {"tokens": ((batch, seq), i32), "labels": ((batch, seq), i32)}


def make_synthetic_batch(cfg: ArchConfig, batch: int, seq: int, seed: int,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch of ``train_batch_specs``'s shapes on ``device``:
    tokens and labels uniform over the vocabulary, embeddings standard
    normal (drawn in f32, then cast), ``positions3`` ``arange(seq)`` on
    each stream.  Each entry is drawn from its own ``torch.Generator``,
    seeded from ``seed`` and the entry's name (crc32)."""
    device = resolve_device(device)
    out = {}
    for name, (shape, dtype) in train_batch_specs(cfg, batch, seq).items():
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) * 1_000_003
                         + zlib.crc32(name.encode())) % (2 ** 63))
        if name in ("tokens", "labels"):
            out[name] = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                      dtype=dtype, device=device)
        elif name == "positions3":
            out[name] = torch.arange(shape[-1], dtype=dtype,
                                     device=device).expand(shape).clone()
        else:
            out[name] = torch.randn(shape, generator=gen,
                                    dtype=torch.float32,
                                    device=device).to(dtype)
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def decode_specs(cfg: ArchConfig, batch: int, kv_len: int):
    """(token, pos, states) of one serve step on the ``meta`` device."""
    token = _meta((batch,), torch.int32)
    pos = _meta((), torch.int32)
    states = decode_state_init(cfg, batch, kv_len, device="meta")
    return token, pos, states


def input_specs(cfg: ArchConfig, shape: InputShape):
    """Every model input of one (arch x shape) cell on the ``meta``
    device: a training / prefill batch, or a decode step's (token, pos,
    states)."""
    if shape.kind in ("train", "prefill"):
        return {name: _meta(s, dtype) for name, (s, dtype)
                in train_batch_specs(cfg, shape.global_batch,
                                     shape.seq_len).items()}
    return decode_specs(cfg, shape.global_batch, shape.seq_len)
