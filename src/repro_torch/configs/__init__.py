"""Architecture registry: one module per ported architecture.

Each module exposes CONFIG (exact published hyper-parameters) and
REDUCED (same family, CPU-test sized).
"""
from repro_torch.configs.base import ArchConfig

__all__ = ["ArchConfig", "ARCHS", "ARCH_NAMES", "get_config"]

# the reference's order, so that ARCH_NAMES reads the same in both packages
_ARCH_MODULES = [
    "dbrx_132b", "granite_moe_1b_a400m", "nemotron_4_15b", "qwen2_5_3b",
    "command_r_35b", "minicpm_2b", "qwen2_vl_2b", "xlstm_125m",
    "whisper_base", "zamba2_2_7b",
]


def _load():
    import importlib
    archs = {}
    for m in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        archs[mod.CONFIG.name] = (mod.CONFIG, mod.REDUCED)
    return archs


ARCHS = _load()
ARCH_NAMES = list(ARCHS.keys())


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCH_NAMES}")
    return ARCHS[name][1 if reduced else 0]
