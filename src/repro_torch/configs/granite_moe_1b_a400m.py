"""Granite-3.0 1B-A400M: 32-expert top-8 MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=512, vocab_size=49155,
    pattern=("attn_moe",), n_experts=32, moe_top_k=8, mlp_type="swiglu",
    rope_theta=10000.0, tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, vocab_size=256, n_experts=4, moe_top_k=2,
    capacity_factor=8.0)
