"""DBRX-132B: fine-grained MoE, 16 experts top-4, GQA.
[hf:databricks/dbrx-base; unverified]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=10752, vocab_size=100352, pattern=("attn_moe",),
    n_experts=16, moe_top_k=4, mlp_type="swiglu", rope_theta=500000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=96, vocab_size=256, n_experts=4, moe_top_k=2,
    capacity_factor=8.0)
