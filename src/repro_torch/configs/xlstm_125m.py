"""xLSTM-125M: alternating mLSTM (matrix memory) and sLSTM (scalar
memory) blocks; no separate FFN (d_ff=0). [arXiv:2405.04517;
unverified]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab_size=50304, pattern=("mlstm", "slstm"),
    ssm_expand=2, pos_mode="none",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    vocab_size=256)
