"""Qwen2.5-3B: dense, GQA kv=2, QKV bias, tied embeddings.
[hf:Qwen/Qwen2.5-3B (family config per assignment); hf]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, d_ff=11008, vocab_size=151936,
    mlp_type="swiglu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1000000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256)
