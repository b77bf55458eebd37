"""Zamba2-2.7B: Mamba2 backbone with a shared attention block every 6th
layer (one parameter set, distinct KV caches). [arXiv:2411.15242; hf]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    mlp_type="swiglu", rope_theta=10000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=256, ssm_state=8, ssm_head_dim=16)
