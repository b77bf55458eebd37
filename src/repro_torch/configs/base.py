"""Architecture configuration schema.

Every architecture instantiates ``ArchConfig`` in its own module
(``repro_torch/configs/<id>.py``) with the exact published
hyper-parameters, and provides a ``REDUCED`` variant of the same family
for CPU tests.  The schema is the reference's field for field (so a
config reads the same in both packages); the dtype table holds torch
dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads
    # block stacking: the repeating unit; n_layers must divide evenly
    pattern: Tuple[str, ...] = ("attn",)
    # attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos_mode: str = "rope"         # rope | mrope | learned | none
    # mlp
    mlp_type: str = "swiglu"       # swiglu | gelu | relu2
    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # ssm / recurrent (mamba2, xlstm)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    # norm / residual
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-5
    residual_scale: float = 1.0    # depth scaling (MiniCPM)
    tie_embeddings: bool = False
    # encoder-decoder (whisper): encoder depth; n_layers is the decoder depth
    encoder_layers: int = 0
    # modality frontend stub: input_specs() provides precomputed embeddings
    frontend: str = "none"         # none | audio_frames | vision_patches
    vis_tokens_frac: float = 0.25  # VLM: fraction of seq that is patches
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    max_learned_pos: int = 4096

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern of length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def pdtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (state-based) sequence mixing => long_500k runs."""
        return any(b in ("mamba", "mlstm", "slstm") for b in self.pattern)

    def n_params(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs)."""
        d, dff, dh = self.d_model, self.d_ff, self.head_dim
        per_attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) \
            + (self.n_heads * dh) * d
        if self.mlp_type == "swiglu":
            per_mlp = 3 * d * dff
        else:
            per_mlp = 2 * d * dff
        total = 0
        for b in self.pattern * self.n_repeats:
            if b in ("attn", "xattn", "shared_attn"):
                total += per_attn + per_mlp
                if b == "xattn":
                    total += per_attn  # cross-attention projections
            elif b == "attn_moe":
                total += per_attn + self.n_experts * 3 * d * dff
            elif b == "mamba":
                d_in = self.ssm_expand * d
                # in_proj (d -> 2*di + 2*N + H), conv, out_proj
                nh = d_in // self.ssm_head_dim
                total += d * (2 * d_in + 2 * self.ssm_state + nh) \
                    + (d_in + 2 * self.ssm_state) * self.ssm_conv \
                    + d_in * d
            elif b == "mlstm":
                d_in = self.ssm_expand * d
                # up (d -> 2di), q/k/v (di x di), gates, down (di -> d)
                total += 2 * d * d_in + 3 * d_in * d_in \
                    + 2 * d_in * self.n_heads + d_in * d
            elif b == "slstm":
                dh_ = d // self.n_heads
                # w_in (d -> 4d), recurrent R (H, dh, 4dh), down (d -> d)
                total += 4 * d * d + self.n_heads * dh_ * 4 * dh_ + d * d
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            # encoder blocks + decoder cross-attention + learned positions
            total += self.encoder_layers * (per_attn + per_mlp)
            total += self.n_layers * per_attn
            total += 2 * self.max_learned_pos * d
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.n_experts == 0:
            return self.n_params()
        d, dff = self.d_model, self.d_ff
        dense_experts = self.n_layers * self.n_experts * 3 * d * dff
        active_experts = self.n_layers * self.moe_top_k * 3 * d * dff
        return self.n_params() - dense_experts + active_experts


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One input cell of the reference's grid: ``global_batch`` sequences
    of ``seq_len`` positions, for a ``train`` | ``prefill`` | ``decode``
    step."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, with the reason if skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention architecture: 500k-token decode "
                       "needs sub-quadratic sequence mixing (DESIGN.md "
                       "S Arch-applicability)")
    return True, ""
