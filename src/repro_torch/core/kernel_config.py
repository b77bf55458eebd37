"""Kernel configuration of the port.

The port has no backend switch: a CUDA tensor always goes through the
hand-written kernel and a CPU tensor through its plain version (see
``repro_torch.kernels.ops``), so nothing of the reference's
``backend`` / ``interpret`` / autotune fields has a meaning here.  What
remains is the one tiling decision a caller may want to pin.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

_DW_TILES = (64, 128)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Attributes:
      dw_tile: output tile (64 or 128) of the bf16/f16 ``fused_sampled_dw``
        kernel.  ``None`` lets the kernel choose from the shape (128 when
        that still gives every SM a tile, else 64).
    """

    dw_tile: Optional[int] = None

    def __post_init__(self):
        if self.dw_tile is not None and self.dw_tile not in _DW_TILES:
            raise ValueError(f"KernelConfig.dw_tile must be one of "
                             f"{_DW_TILES} or None, got {self.dw_tile!r}")


DEFAULT_KERNEL_CONFIG = KernelConfig()
