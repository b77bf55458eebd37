"""Command-R 35B: dense, GQA, no biases, tied embeddings, LayerNorm.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22528, vocab_size=256000,
    mlp_type="swiglu", norm_type="layernorm", tie_embeddings=True,
    rope_theta=8000000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256)
