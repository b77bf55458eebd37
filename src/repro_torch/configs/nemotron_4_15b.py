"""Nemotron-4 15B: dense, GQA, squared-ReLU MLP. [arXiv:2402.16819;
unverified]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=24576, vocab_size=256000,
    mlp_type="relu2", norm_type="layernorm", rope_theta=10000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256)
