"""Whisper-base backbone: 6+6 encoder-decoder, GELU, learned positions,
LayerNorm; conv/log-mel frontend stubbed (the batch carries frame
embeddings). [arXiv:2212.04356; unverified]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
    mlp_type="gelu", norm_type="layernorm", pos_mode="learned",
    encoder_layers=6, tie_embeddings=True, frontend="audio_frames",
    max_learned_pos=32768,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab_size=256,
    max_learned_pos=128)
