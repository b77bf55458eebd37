"""Qwen2-VL 2B backbone: M-RoPE, GQA kv=2; vision frontend is a stub
(the batch carries patch embeddings). [arXiv:2409.12191; hf]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936,
    mlp_type="swiglu", qkv_bias=True, tie_embeddings=True,
    pos_mode="mrope", rope_theta=1000000.0, vis_tokens_frac=0.25,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256)
