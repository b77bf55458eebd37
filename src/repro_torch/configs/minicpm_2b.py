"""MiniCPM-2B: llama-like dense MHA with depth-scaled residuals; the
WSD LR schedule lives in repro_torch.train.optim. [arXiv:2404.06395; hf]"""
import dataclasses
import math
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
    n_heads=36, n_kv_heads=36, d_ff=5760, vocab_size=122753,
    mlp_type="swiglu", tie_embeddings=True,
    residual_scale=1.4 / math.sqrt(40), rope_theta=10000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=256, residual_scale=1.4 / math.sqrt(2))
